#!/usr/bin/env python3
"""Where the time goes in the port's warm solves, on one CUDA card.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_profile.py [--reps 5] [--traced 3] [plates canyon district soup]

For each solve of chip_smoke.py (all four by default), after one warm-up
solve, it prints:

- the untraced warm wall time over ``--reps`` solves: median, min and max;
- for each of ``--traced`` solves under ``torch.profiler``: its wall time,
  the device busy time (the union of CUDA kernel intervals), busy as a
  share of that traced wall time and of the untraced median, the sweep
  kernel's share of busy time, and the chunks and iterations dispatched;
- the largest device kernels of the last traced solve.

The card's name and power limit come first; one JSON line ends each
solve's block. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def busy_seconds(intervals) -> float:
    """Length of the union of (start, end) microsecond intervals, in s."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e6


def traced_solve(solve):
    """One solve under torch.profiler: (wall s, device kernel events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, kernels


def profile_case(name, meshes, params, reps: int, n_traced: int, card: str) -> None:
    import chip_smoke
    import raystrack_tpu_torch.solver as solver_mod
    from raystrack_tpu_torch import PreparedSolver, view_factor_matrix

    prepared = PreparedSolver(meshes)
    solve = lambda: view_factor_matrix(meshes, params, prepared=prepared)  # noqa: E731
    solve()  # set-up and first build outside every timing
    warm = chip_smoke.wall_times(solve, reps)
    median = float(np.median(warm))
    print(f"[{name}] untraced warm solve {chip_smoke.spread(warm)}")

    chunks = []
    dispatch = solver_mod._EmitterRun.dispatch_chunk

    def counted(self, chunk):
        chunks.append(chunk)
        return dispatch(self, chunk)

    runs = []
    solver_mod._EmitterRun.dispatch_chunk = counted
    try:
        for i in range(n_traced):
            chunks.clear()
            wall, kernels = traced_solve(solve)
            if not kernels:
                raise SystemExit(f"FAILED: {name}: the trace holds no device kernel")
            busy = busy_seconds((e.time_range.start, e.time_range.end) for e in kernels)
            sweep = sum(e.time_range.elapsed_us() for e in kernels
                        if "sweep_kernel" in e.name) / 1e6
            run = dict(wall_s=wall, busy_s=busy, busy_share=busy / wall,
                       busy_share_of_untraced_median=busy / median,
                       sweep_s=sweep, sweep_share_of_busy=sweep / busy,
                       chunks=len(chunks), iters=sum(chunks),
                       kernels_per_chunk=len(kernels) / max(1, len(chunks)))
            runs.append(run)
            print(f"[{name}] traced run {i + 1}: wall {wall:.4f} s, busy {busy:.4f} s "
                  f"= {run['busy_share']:.1%} of it ({run['busy_share_of_untraced_median']:.1%} "
                  f"of the untraced median); sweep {sweep * 1e3:.3f} ms = "
                  f"{run['sweep_share_of_busy']:.1%} of busy; {len(chunks)} chunks, "
                  f"{sum(chunks)} iterations, {run['kernels_per_chunk']:.1f} kernels/chunk")
    finally:
        solver_mod._EmitterRun.dispatch_chunk = dispatch

    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    for kname, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"[{name}]   {us / 1e3:9.3f} ms {n:6d}x  {kname[:100]}")
    print(json.dumps({"solve": name, "card": card, "warm_s": warm, "traced": runs}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("solves", nargs="*",
                        default=["plates", "canyon", "district", "soup"])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--traced", type=int, default=3)
    args = parser.parse_args()
    if args.reps < 1 or args.traced < 1:
        parser.error("--reps and --traced must be at least 1")
    if not torch.cuda.is_available():
        print("chip_profile.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import raystrack_tpu_torch.solver as solver_mod

    solver_mod._log = lambda line: None  # progress lines would flood the output
    card = chip_smoke.card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    cases = chip_smoke.solve_cases()
    for name in args.solves:
        meshes, params = cases[name]
        profile_case(name, meshes, params, args.reps, args.traced, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
