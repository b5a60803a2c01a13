#!/usr/bin/env python3
"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 vfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``raystrack_tpu_torch``: builds the
cell's scene from ``--seed``, sets up one ``PreparedSolver`` and warms it up
with one solve, solves back to back for ``--seconds`` (solve k with a QMC
seed drawn from the seed and k), checks a sample of the window's answers
against the plain reference in ``vfbench/reference/``, and prints the
compared numbers with their limits as the last lines of standard error and
one JSON result line as the last line of standard output: the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics from a
profile of the window's first ``harness.TRACE_SECONDS``. It needs a CUDA card and
exits non-zero without one, printing no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "raystrack_tpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vfbench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    sys.path.insert(0, str(ROOT))
    from vfbench import harness

    cell = harness.Cell.load(args.workload, bench)
    run = harness.measure(cell, args.seed, args.seconds, trace=bool(args.trace),
                          t_start=T_START)
    line = harness.result(run, bool(args.trace))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"vfbench: the process holds {', '.join(loaded)}", file=sys.stderr)
        return 3
    walls = sorted(run.walls) or [float("nan")]
    print(f"vfbench: {args.workload} seed {args.seed}: {len(run.walls)} solves (wall min "
          f"{walls[0]:.4f} s, median {walls[len(walls) // 2]:.4f} s, max {walls[-1]:.4f} s), "
          f"{run.failed} failed, {run.checked} checked; set-up spans "
          + ", ".join(f"{k} {v:.3f} s" for k, v in run.spans.items() if k != "solve"),
          file=sys.stderr)
    for name, c in run.checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
