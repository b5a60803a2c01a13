#!/usr/bin/env python3
"""The control of a cell's check: the plain reference computed in bfloat16
(the precision below the configurations' float32) put in the program's
place, on the cell's own scene and solves, judged by the harness's own
check (``harness.check``: the widest gap against the float64 reference
beside the cell's limit), which has to find it not correct. Each limit in
``limits/`` lies between the largest gap sound runs of the program read and
the smallest the control reads. The benchmark's runs do not run this.

    python3 vfbench/control.py --workload <cell> --seeds 1,2,3 [--solves 2] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--solves", type=int, default=2, help="solves a seed: k = 1 .. solves")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, str(ROOT))
    from vfbench import harness

    cell = harness.Cell.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        meshes = cell.meshes(seed)
        for k in range(1, args.solves + 1):
            qmc = harness.solve_seed(seed, k)
            t0 = time.perf_counter()
            low = harness.reference_solve(cell.traffic, meshes, qmc, args.device,
                                          torch.bfloat16)
            t1 = time.perf_counter()
            run = harness.Run(cell=cell, seed=seed, walls=[t1 - t0])
            harness.check(run, meshes, [low], [qmc], args.device)
            print(json.dumps({"workload": args.workload, "seed": seed, "solve": k,
                              "correct": run.correct,
                              "control_gap": run.checks["gap"]["value"],
                              "limit": run.checks["gap"]["limit"],
                              "control_s": t1 - t0,
                              "reference_s": time.perf_counter() - t1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
