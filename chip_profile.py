#!/usr/bin/env python3
"""Where the time goes in the port's warm solves, on one CUDA card.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_profile.py [--reps 5] [--traced 3] [--route auto|scheduled|grouped]
                            [--count kernel|plain] [plates canyon district soup soup8]

For each solve of chip_smoke.py (all five by default), after one warm-up
solve, it prints:

- the untraced warm wall time over ``--reps`` solves: median, min and max;
- for each of ``--traced`` solves under ``torch.profiler``: its wall time,
  the device busy time (the union of CUDA kernel intervals), busy as a
  share of that traced wall time and of the untraced median, the sweep
  kernels' share of busy time, the device time of the count kernel and of
  the torch ops under ``ops.trace.count_codes`` ("histogram": the zero
  fill, or the whole count with ``--count plain``), of ray generation and
  of the masks, the per-emitter chunks and scheduled rounds dispatched
  with their rows of ``RAY_BLOCK`` rays, and device kernels per dispatch;
- the largest device kernels of the last traced solve.

``--route`` picks the multi-emitter route (``RAYSTRACK_TPU_SCHEDULER``):
``auto`` (scheduled on the card), ``scheduled`` or ``grouped`` (per
emitter). ``--count plain`` counts with the count kernel's plain tensor
version on the card instead of the kernel, to time the two formulations
against each other; the solve's result does not change. The card's name
and power limit come first; one JSON line ends each solve's block.
Imports nothing of JAX.
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


# ops.trace functions whose device time is reported apart: label -> names
STAGES = {
    "histogram": ("count_codes",),
    "raygen": ("generate_rays", "scheduled_rays"),
    "masks": ("emitter_operands", "combined_masks"),
}


def stage_device_us(event) -> float:
    """Device microseconds of the torch kernels launched under a CPU event
    and its descendants. The profiler also files a stage annotation's own
    device-side span under it: left out. It files the kernels launched
    through ctypes under no op, so those are timed by name instead."""
    own = sum(k.duration for k in event.kernels if k.name not in STAGES)
    return own + sum(stage_device_us(ch) for ch in event.cpu_children)


def traced_solve(solve):
    """One solve under torch.profiler: (wall s, device kernel events, device
    seconds per STAGES label)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    # the stage annotations also appear as device-side spans: not kernels
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in STAGES]
    stages = {label: sum(stage_device_us(e) for e in events if e.name == label
                         and e.device_type == torch.autograd.DeviceType.CPU) / 1e6
              for label in STAGES}
    return wall, kernels, stages


def plain_count(codes, n_valid, n_surf):
    """``count_codes`` through its plain tensor version, on any device."""
    from raystrack_tpu_torch.ops.count_cuda import count_codes_reference

    counts = count_codes_reference(codes, n_valid, n_surf).view(codes.shape[0], n_surf, 2)
    return counts[:, :, 1], counts[:, :, 0]


def profile_case(name, meshes, params, reps: int, n_traced: int, card: str,
                 route: str, count: str) -> None:
    import chip_smoke
    import raystrack_tpu_torch.solver as solver_mod
    from raystrack_tpu_torch import PreparedSolver, view_factor_matrix
    from raystrack_tpu_torch.config import RAY_BLOCK
    from raystrack_tpu_torch.ops import trace as trace_mod

    real_count = trace_mod.count_codes
    if count == "plain":
        trace_mod.count_codes = plain_count
    prepared = PreparedSolver(meshes)
    solve = lambda: view_factor_matrix(meshes, params, prepared=prepared)  # noqa: E731
    solve()  # set-up and first build outside every timing
    warm = chip_smoke.wall_times(solve, reps)
    median = float(np.median(warm))
    print(f"[{name}] route {route}, count {count}: untraced warm solve "
          f"{chip_smoke.spread(warm)}")

    chunks, chunk_rows, rounds = [], [], []
    dispatch = solver_mod._EmitterRun.dispatch_chunk
    real_round = trace_mod.scheduled_trace
    real_stage = {fn: getattr(trace_mod, fn) for names in STAGES.values() for fn in names}

    def counted(self, chunk):
        chunks.append(chunk)
        chunk_rows.append(chunk * self.em_pack.n_rays_pad // RAY_BLOCK)
        return dispatch(self, chunk)

    def counted_round(*args, **kwargs):
        rounds.append(int(args[10].shape[0]))  # schedule rows
        return real_round(*args, **kwargs)

    def labelled(label, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return run

    runs = []
    solver_mod._EmitterRun.dispatch_chunk = counted
    trace_mod.scheduled_trace = counted_round
    for label, names in STAGES.items():
        for fn in names:
            setattr(trace_mod, fn, labelled(label, real_stage[fn]))
    try:
        for i in range(n_traced):
            chunks.clear()
            chunk_rows.clear()
            rounds.clear()
            wall, kernels, stages = traced_solve(solve)
            if not kernels:
                raise SystemExit(f"FAILED: {name}: the trace holds no device kernel")
            busy = busy_seconds((e.time_range.start, e.time_range.end) for e in kernels)
            sweep = sum(e.time_range.elapsed_us() for e in kernels
                        if "sweep_kernel" in e.name or "sweep_sched_kernel" in e.name) / 1e6
            count_k = sum(e.time_range.elapsed_us() for e in kernels
                          if "count_codes_kernel" in e.name) / 1e6
            dispatches = len(chunks) + len(rounds)
            run = dict(wall_s=wall, busy_s=busy, busy_share=busy / wall,
                       busy_share_of_untraced_median=busy / median,
                       sweep_s=sweep, sweep_share_of_busy=sweep / busy,
                       histogram_s=stages["histogram"], count_kernel_s=count_k,
                       raygen_s=stages["raygen"],
                       masks_s=stages["masks"],
                       chunks=len(chunks), chunk_rows=sum(chunk_rows), rounds=len(rounds),
                       round_rows=list(rounds),
                       kernels_per_dispatch=len(kernels) / max(1, dispatches))
            runs.append(run)
            print(f"[{name}] traced run {i + 1}: wall {wall:.4f} s, busy {busy:.4f} s "
                  f"= {run['busy_share']:.1%} of it ({run['busy_share_of_untraced_median']:.1%} "
                  f"of the untraced median); sweep {sweep * 1e3:.3f} ms = "
                  f"{run['sweep_share_of_busy']:.1%} of busy; histogram "
                  f"{stages['histogram'] * 1e3:.3f} ms (count kernel {count_k * 1e3:.3f} ms), "
                  f"raygen {stages['raygen'] * 1e3:.3f} ms, "
                  f"masks {stages['masks'] * 1e3:.3f} ms; {len(chunks)} chunks "
                  f"({sum(chunks)} iterations, {sum(chunk_rows)} rows), {len(rounds)} rounds "
                  f"({sum(rounds)} rows), "
                  f"{run['kernels_per_dispatch']:.1f} device kernels per chunk or round")
    finally:
        solver_mod._EmitterRun.dispatch_chunk = dispatch
        trace_mod.scheduled_trace = real_round
        for fn, f in real_stage.items():
            setattr(trace_mod, fn, f)
        trace_mod.count_codes = real_count

    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    for kname, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"[{name}]   {us / 1e3:9.3f} ms {n:6d}x  {kname[:100]}")
    print(json.dumps({"solve": name, "route": route, "count": count, "card": card,
                      "warm_s": warm, "traced": runs}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("solves", nargs="*",
                        default=["plates", "canyon", "district", "soup", "soup8"])
    parser.add_argument("--route", choices=("auto", "scheduled", "grouped"),
                        default="auto")
    parser.add_argument("--count", choices=("kernel", "plain"), default="kernel")
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
    from raystrack_tpu_torch import config

    config.SCHEDULER = args.route
    solver_mod._log = lambda line: None  # progress lines would flood the output
    card = chip_smoke.card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    cases = chip_smoke.solve_cases()
    for name in args.solves:
        meshes, params = cases[name]
        profile_case(name, meshes, params, args.reps, args.traced, card, args.route,
                     args.count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
