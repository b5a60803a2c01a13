#!/usr/bin/env python3
"""Where the time goes in the port's warm solves, on one CUDA card.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_profile.py [--reps 5] [--traced 3] [--route auto|scheduled|grouped]
                            [--count kernel|plain] [--bvh auto|off] [--slim] [--timeline]
                            [--splits] [--force-split 1|4]
                            [plates canyon district soup soup8 city city_matrix city_plates
                             city10m]

For each solve of chip_smoke.py (the first five by default; ``city`` is the
1M-triangle occluded city's ground -> city solve, ``city_matrix`` its
two-emitter matrix, ``city_plates`` the matrix of the city with its ground
split into ten plates, ``city10m`` the ground -> city solve of the
10M-triangle city), after one warm-up solve, it prints:

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
emitter). ``--bvh off`` solves without the AABB gate (the default is each
solve's own setting; the city's is the gate). ``--count plain`` counts
with the count kernel's plain tensor
version on the card instead of the kernel, to time the two formulations
against each other; the solve's result does not change. ``--slim`` packs
every scene slim (pack-resident: ``config.SLIM_PACK_MIN_TRIS`` set to 1 for
the run), so each solve goes emitter by emitter through kernel #1's
code_bounds mode on the scene's one resident pack. ``--timeline`` instead
prints what the per-block timeline of the two gated launches chip_smoke.py
times says (the city chunk of kernel #1, the ``city_plates`` round of kernel
#2): the kernel's span, how full its resident slots were, the slowest block,
the tail after the first SM ran dry and the fitted cost of a swept tile and
of a visit that ends at the block's vote. ``--splits`` instead times
ungated kernel #1 on the leading blocks of the soup chunk at each triangle
split it is built at, from 32 blocks to the chunk's 1,024, and the whole
chunk in every output and mask variant: the measurement behind
``trace_cuda.sweep_split``. ``--variants`` instead times kernels #1
(the soup chunk) and #2 (the soup8 round) in their matrix, any-only and
matrix + any variants at the wrapper's split, beside each one's FP32 SASS
instructions a pair: the sky's and the workflow's launches, and the A/B of
a kernel change when run in two trees in one call. ``--force-split N`` solves with every ungated
sweep at N threads a ray instead of the rule's choice. The card's name
and power limit come first; one JSON line ends each solve's block.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
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


# functions whose device time is reported apart: label -> names, in ops.trace
# unless prefixed "trace_cuda."
STAGES = {
    "histogram": ("count_codes",),
    "raygen": ("generate_rays", "scheduled_rays"),
    "masks": ("emitter_operands", "slim_operands", "combined_masks"),
    "gate": ("_sorted_for_gate", "trace_cuda._gate_tables"),
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


def plain_count(codes, n_valid, n_surf, *, valid=None):
    """``count_codes`` through its plain tensor version, on any device."""
    from raystrack_tpu_torch.ops.count_cuda import count_codes_reference

    counts = count_codes_reference(codes, n_valid, n_surf, valid).view(
        codes.shape[0], n_surf, 2)
    return counts[:, :, 1], counts[:, :, 0]


def profile_case(name, meshes, params, reps: int, n_traced: int, card: str,
                 route: str, count: str, slim: bool = False) -> None:
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
    if prepared.get_scene_pack(
            use_accel=solver_mod._select_bvh(params.bvh, prepared.total_faces),
            device=solver_mod._resolve_device(params.device)).slim != slim:
        raise SystemExit(f"FAILED: {name}: the scene pack is not {'slim' if slim else 'full'}")
    warm = chip_smoke.wall_times(solve, reps)
    median = float(np.median(warm))
    print(f"[{name}] route {route}, count {count}, {'slim' if slim else 'full'} pack: "
          f"untraced warm solve {chip_smoke.spread(warm)}")

    chunks, chunk_rows, rounds = [], [], []
    dispatch = solver_mod._EmitterRun.dispatch_chunk
    real_round = trace_mod.scheduled_trace
    from raystrack_tpu_torch.ops import trace_cuda

    def owner(fn):
        """(module, attribute) of a STAGES name."""
        mod, _, attr = fn.rpartition(".")
        return (trace_cuda if mod == "trace_cuda" else trace_mod), attr

    real_stage = {fn: getattr(*owner(fn)) for names in STAGES.values() for fn in names}

    def counted(self, chunk, **kwargs):
        chunks.append(chunk)
        chunk_rows.append(chunk * self.em_pack.n_rays_pad // RAY_BLOCK)
        return dispatch(self, chunk, **kwargs)

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
            setattr(*owner(fn), labelled(label, real_stage[fn]))
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
                        if any(k in e.name for k in ("sweep_kernel", "sweep_code_kernel",
                                                     "sweep_sched_kernel"))) / 1e6
            # the gate's per-call tables and the coherence sort: torch ops and
            # the crossing kernel, which the profiler files under no op
            cross = sum(e.time_range.elapsed_us() for e in kernels
                        if "gate_cross_kernel" in e.name) / 1e6
            gate = stages["gate"] + cross
            count_k = sum(e.time_range.elapsed_us() for e in kernels
                          if "count_codes_kernel" in e.name) / 1e6
            dispatches = len(chunks) + len(rounds)
            run = dict(wall_s=wall, busy_s=busy, busy_share=busy / wall,
                       busy_share_of_untraced_median=busy / median,
                       sweep_s=sweep, sweep_share_of_busy=sweep / busy,
                       histogram_s=stages["histogram"], count_kernel_s=count_k,
                       raygen_s=stages["raygen"],
                       masks_s=stages["masks"], gate_s=gate, gate_cross_kernel_s=cross,
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
                  f"masks {stages['masks'] * 1e3:.3f} ms, gate tables and ray sort "
                  f"{gate * 1e3:.3f} ms (crossing kernel {cross * 1e3:.3f} ms); "
                  f"{len(chunks)} chunks "
                  f"({sum(chunks)} iterations, {sum(chunk_rows)} rows), {len(rounds)} rounds "
                  f"({sum(rounds)} rows), "
                  f"{run['kernels_per_dispatch']:.1f} device kernels per chunk or round")
    finally:
        solver_mod._EmitterRun.dispatch_chunk = dispatch
        trace_mod.scheduled_trace = real_round
        for fn, f in real_stage.items():
            setattr(*owner(fn), f)
        trace_mod.count_codes = real_count

    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    for kname, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"[{name}]   {us / 1e3:9.3f} ms {n:6d}x  {kname[:100]}")
    print(json.dumps({"solve": name, "route": route, "count": count, "slim": slim,
                      "card": card, "warm_s": warm, "traced": runs}))


def timeline_stats(label: str, timeline, visits, n_sms: int) -> dict:
    """What a gated launch's per-block timeline says: ``timeline`` (blocks,
    4) int64 holds each block's start and end on the card's nanosecond timer,
    its SM and the visit positions it walked; ``visits`` its swept tiles."""
    t = timeline.cpu().numpy()
    swept = visits.cpu().numpy().astype(np.float64)
    start, end, sm, walked = t[:, 0], t[:, 1], t[:, 2], t[:, 3].astype(np.float64)
    t0, t1 = start.min(), end.max()
    span = float(t1 - t0)
    spans = (end - start).astype(np.float64)
    slots = 0  # blocks resident at once on one SM
    last_end = []
    for s_id in np.unique(sm):
        on = sm == s_id
        edges = sorted([(a, 1) for a in start[on]] + [(b, -1) for b in end[on]],
                       key=lambda e: (e[0], e[1]))
        level = 0
        for _, step in edges:
            level += step
            slots = max(slots, level)
        last_end.append(end[on].max())
    dry = float(min(last_end))  # the first SM with nothing left to run
    idle_tail = sum(float(t1 - e) for e in last_end) / (len(last_end) * span)
    # block span ~ a * swept tiles + c * positions that ended at the vote + d
    voted = walked - swept
    A = np.stack([swept, voted, np.ones_like(swept)], axis=1)
    (a, c, d), *_ = np.linalg.lstsq(A, spans, rcond=None)
    out = dict(
        label=label, blocks=int(t.shape[0]), sms_used=int(len(last_end)), slots_per_sm=slots,
        span_ms=span / 1e6, fill=float(spans.sum()) / (n_sms * slots * span),
        slowest_block_ms=float(spans.max()) / 1e6, tail_ms=(float(t1) - dry) / 1e6,
        tail_share=(float(t1) - dry) / span, sm_idle_share_after_last_block=idle_tail,
        swept_tiles=int(swept.sum()), walked_positions=int(walked.sum()),
        fit_us_per_swept_tile=a / 1e3, fit_us_per_vote_only_visit=c / 1e3,
        fit_us_per_block=d / 1e3)
    print(f"[timeline] {label}: {out['blocks']} blocks on {out['sms_used']} SMs, at most "
          f"{slots} resident on one SM; kernel span {out['span_ms']:.3f} ms; sum of block "
          f"spans over ({n_sms} SMs x {slots} slots x span) {out['fill']:.1%}; slowest block "
          f"{out['slowest_block_ms']:.3f} ms; from the first SM running dry to the end "
          f"{out['tail_ms']:.3f} ms = {out['tail_share']:.1%} of the span (mean SM idle after "
          f"its last block {idle_tail:.1%} of the span); {out['swept_tiles']} tiles swept of "
          f"{out['walked_positions']} positions walked; least-squares block span = "
          f"{out['fit_us_per_swept_tile']:.3f} us x swept tiles + "
          f"{out['fit_us_per_vote_only_visit']:.3f} us x visits that end at the vote + "
          f"{out['fit_us_per_block']:.1f} us")
    return out


def profile_timelines(card: str) -> None:
    """The per-block timeline of the two gated launches chip_smoke.py times:
    kernel #1 on the first chunk of the city's ground -> city solve and
    kernel #2 on the first round of its ten-plate matrix, as the wrappers
    launch them, on tables built once."""
    import chip_smoke
    from raystrack_tpu_torch import PreparedSolver, view_factor, view_factor_matrix
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.ops import trace as trace_mod
    from raystrack_tpu_torch.ops import trace_cuda
    from raystrack_tpu_torch.ops.trace_cuda import sweep_rays, sweep_rays_scheduled

    cases = chip_smoke.solve_cases()
    city, vf_params = cases["city"]
    plates, plates_params = cases["city_plates"]
    chunk_call = chip_smoke.first_call(trace_mod, "chunk_body", lambda: view_factor(
        city[0], city[1], vf_params, prepared=PreparedSolver(city)))
    round_call = chip_smoke.first_call(trace_mod, "scheduled_trace", lambda: view_factor_matrix(
        plates, plates_params, prepared=PreparedSolver(plates)))
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    kw = dict(tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False)
    rays, pack, mask, accel, _, _ = chip_smoke.city_chunk_inputs(chunk_call)
    rays2, pack2, masks, emap, accel2, _, _ = chip_smoke.city_round_inputs(round_call)
    launches = {
        "kernel #1 gated, city chunk": (rays, pack.shape[1], accel, lambda **dbg: sweep_rays(
            rays, pack, mask, masks_baked=True, accel=accel, **kw, **dbg)),
        "kernel #2 gated, city_plates round": (
            rays2, pack2.shape[1], accel2, lambda **dbg: sweep_rays_scheduled(
                rays2, pack2, masks, emap, accel=accel2, **kw, **dbg)),
    }
    out = []
    for label, (r, tpad, boxes, launch) in launches.items():
        dev = r.device
        n_blocks = -(-r.shape[1] // chip_smoke.RAY_SUB)
        tile = trace_cuda.sweep_tile_width(tpad, PALLAS_TRI_TILE)
        gate = trace_cuda._gate_for(boxes, r, tpad, tile, PALLAS_TRI_TILE, dev)
        split = trace_cuda.sweep_split(n_blocks, True, n_sms)
        visits = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
        timeline = torch.zeros((n_blocks, 4), dtype=torch.int64, device=dev)
        with chip_smoke.forced_launch(gate=gate):
            launch()  # warm
            ms, _ = chip_smoke.cuda_ms(
                lambda: launch(visits=visits, timeline=timeline))  # noqa: B023
        torch.cuda.synchronize()
        stats = timeline_stats(f"{label}, {split} threads a ray", timeline, visits, n_sms)
        stats.update(kernel_ms=ms, split=split)
        out.append(stats)
        swept = visits.double()
        print(f"[timeline] {label}: correlation of a block's crossed boxes with its swept "
              f"tiles "
              f"{float(torch.corrcoef(torch.stack([gate.counts.double(), swept]))[0, 1]):.3f}; "
              f"crossed boxes per block: median {float(gate.counts.double().median()):g}, "
              f"at most {int(gate.counts.max())}")
    print(json.dumps({"timelines": out, "card": card}))


SPLIT_BLOCKS = (32, 66, 128, 132, 160, 200, 264, 300, 396, 528, 792, 1024)


def profile_splits(card: str) -> None:
    """Ungated kernel #1 (matrix, baked pack) on the leading B blocks of 256
    rays of the soup chunk (98,304 triangles, 48 tiles), B from 32 to the
    chunk's 1,024, at each triangle split the ungated kernels are built for:
    best of 3 by CUDA events, every split equal to the first, and the split
    the wrapper's rule (``trace_cuda.sweep_split``) picks. The measurement
    behind that rule's thresholds."""
    import chip_smoke
    from raystrack_tpu_torch import PreparedSolver
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.ops import trace_cuda

    dev = torch.device("cuda", torch.cuda.current_device())
    soup, params = chip_smoke.solve_cases()["soup"]
    scene, rays, m_any, m_mat, tpad, _ = chip_smoke.soup_inputs(
        dev, PreparedSolver(soup), params.seed)
    pack = trace_cuda.build_tri_pack(scene, m_any, m_mat, bake=m_mat)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for n_blocks in SPLIT_BLOCKS:
        sub = rays[:, : n_blocks * chip_smoke.RAY_SUB].contiguous()
        launch = lambda: trace_cuda.sweep_rays(  # noqa: E731
            sub, pack, m_mat, tri_tile=PALLAS_TRI_TILE, want_matrix=True,  # noqa: B023
            want_any=False, masks_baked=True)
        times, first = {}, None
        for split in trace_cuda.UNGATED_SPLITS:
            with chip_smoke.forced_launch(split):
                launch()  # warm
                times[split], out = chip_smoke.cuda_ms(launch)
            first = first or out
            chip_smoke.check(torch.equal(out[0], first[0]) and torch.equal(out[1], first[1]),
                             f"{n_blocks} blocks: {split} threads a ray != the first split")
        chosen = trace_cuda.sweep_split(n_blocks, False, n_sms)
        best = min(times, key=times.get)
        rows.append(dict(blocks=n_blocks, blocks_per_sm=n_blocks / n_sms, ms=times,
                         rule=chosen, fastest=best))
        print(f"[splits] {n_blocks:5d} blocks ({n_blocks / n_sms:.2f} an SM) x {tpad} triangles: "
              + ", ".join(f"{sp} thread(s) a ray {t:.3f} ms" for sp, t in times.items())
              + f"; fastest {best}, the rule picks {chosen} "
                f"({times[chosen] / times[best] - 1:+.1%} on the fastest)")
    # the whole chunk in every output and mask variant of kernel #1
    variants = {}
    for baked in (True, False):
        for wm, wa in ((True, False), (False, True), (True, True)):
            prim = m_any if wa else m_mat
            vpack = trace_cuda.build_tri_pack(scene, m_any, m_mat, bake=prim if baked else None)
            launch = lambda: trace_cuda.sweep_rays(  # noqa: E731
                rays, vpack, prim, tri_tile=PALLAS_TRI_TILE, want_matrix=wm,  # noqa: B023
                want_any=wa, masks_baked=baked)  # noqa: B023
            name = (f"{'matrix+any' if wm and wa else 'matrix' if wm else 'any'},"
                    f"{'baked' if baked else 'rows'}")
            times = {}
            for split in trace_cuda.UNGATED_SPLITS:
                with chip_smoke.forced_launch(split):
                    launch()
                    times[split], _ = chip_smoke.cuda_ms(launch)
            variants[name] = times
            print(f"[splits] whole chunk, {name}: "
                  + ", ".join(f"{sp} thread(s) a ray {t:.3f} ms" for sp, t in times.items()))
    print(json.dumps({"splits": rows, "variants": variants, "card": card, "sms": n_sms}))


def profile_variants(card: str) -> None:
    """Kernels #1 (the soup chunk, baked pack) and #2 (the soup8 round) in
    their matrix, any-only and matrix + any variants at the split the
    wrapper picks: best of 5 by CUDA events after a warm launch, beside
    each instantiation's FP32 SASS instructions per pair. The sky launches
    the any-only variants, the workflow the matrix + any ones; run in two
    trees in one call, it compares two builds of the kernels."""
    import chip_smoke
    import raystrack_tpu_torch.solver as solver_mod
    from raystrack_tpu_torch import PreparedSolver, view_factor_matrix
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.ops import build, trace_cuda
    from raystrack_tpu_torch.ops import trace as trace_mod

    dev = torch.device("cuda", torch.cuda.current_device())
    ops = chip_smoke.sass_pair_ops(chip_smoke.sass_functions(build.build().path))
    cases = chip_smoke.solve_cases()
    soup, params = cases["soup"]
    scene, rays, m_any, m_mat, tpad, _ = chip_smoke.soup_inputs(
        dev, PreparedSolver(soup), params.seed)
    soup8, params8 = cases["soup8"]
    captured = []
    real_round = trace_mod.scheduled_trace
    trace_mod.scheduled_trace = lambda *a, **k: captured.append((a, k)) or real_round(*a, **k)
    solver_mod._log = lambda line: None
    try:
        view_factor_matrix(soup8, params8, prepared=PreparedSolver(soup8))
    finally:
        trace_mod.scheduled_trace = real_round
    (scene8, pack8, tables, geom, cp, surf, emit, mins, once, plane, schedule, sel), kw = \
        captured[0]
    masks = trace_mod.combined_masks(scene8, surf, emit, mins, plane)
    o, d, _ = trace_mod.scheduled_rays(tables, geom, cp, once, schedule, sel,
                                       sched_block=kw["sched_block"])
    rays8 = trace_mod.ray_pack(o, d)
    emap = schedule[:, 0].repeat_interleave(kw["sched_block"] // chip_smoke.RAY_SUB)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for wm, wa in ((True, False), (False, True), (True, True)):
        name = "matrix+any" if wm and wa else "matrix" if wm else "any"
        flags = "".join(str(int(f)) for f in (wm, wa))
        prim = m_any if wa else m_mat
        pack = trace_cuda.build_tri_pack(scene, m_any, m_mat, bake=prim)
        split1 = trace_cuda.sweep_split(rays.shape[1] // chip_smoke.RAY_SUB, False, n_sms)
        split2 = trace_cuda.sweep_split(rays8.shape[1] // chip_smoke.RAY_SUB, False, n_sms)
        sym1 = f"sweep_kernel<{','.join(flags)},1,0>" + (f"x{split1}" if split1 > 1 else "")
        sym2 = f"sweep_sched_kernel<{','.join(flags)},0>" + (f"x{split2}" if split2 > 1 else "")
        for label, sym, launch in (
            ("kernel #1, soup chunk", sym1, lambda: trace_cuda.sweep_rays(  # noqa: E731
                rays, pack, prim, tri_tile=PALLAS_TRI_TILE, want_matrix=wm,  # noqa: B023
                want_any=wa, masks_baked=True)),  # noqa: B023
            ("kernel #2, soup8 round", sym2, lambda: trace_cuda.sweep_rays_scheduled(  # noqa: E731
                rays8, pack8, masks, emap, tri_tile=PALLAS_TRI_TILE, want_matrix=wm,  # noqa: B023
                want_any=wa)),  # noqa: B023
        ):
            launch()
            ms, (codes, any_hit) = chip_smoke.cuda_ms(launch, reps=5)
            rows[f"{label}, {name}"] = dict(
                ms=ms, instantiation=sym, fp32_per_pair=ops[sym][0],
                all_per_pair=ops[sym][2], hits=int((codes >= 0).sum()),
                blocked=int(any_hit.sum()))
            print(f"[variants] {label}, {name} ({sym}): {ms:.3f} ms best of 5; "
                  f"{ops[sym][0]:g} FP32 SASS instructions a pair ({ops[sym][2]:g} in all); "
                  f"hits {rows[f'{label}, {name}']['hits']}, any-hits "
                  f"{rows[f'{label}, {name}']['blocked']}")
    print(json.dumps({"variants": rows, "card": card}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("solves", nargs="*",
                        default=["plates", "canyon", "district", "soup", "soup8"])
    parser.add_argument("--route", choices=("auto", "scheduled", "grouped"),
                        default="auto")
    parser.add_argument("--count", choices=("kernel", "plain"), default="kernel")
    parser.add_argument("--bvh", choices=("auto", "off"), default=None)
    parser.add_argument("--slim", action="store_true")
    parser.add_argument("--timeline", action="store_true")
    parser.add_argument("--splits", action="store_true")
    parser.add_argument("--variants", action="store_true")
    parser.add_argument("--force-split", type=int, default=None)
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
    if args.slim:
        config.SLIM_PACK_MIN_TRIS = 1
    solver_mod._log = lambda line: None  # progress lines would flood the output
    if args.force_split is not None:
        from raystrack_tpu_torch.ops import trace_cuda

        rule = trace_cuda.sweep_split
        trace_cuda.sweep_split = lambda n_blocks, gated, n_sms: (
            rule(n_blocks, gated, n_sms) if gated else args.force_split)
    card = chip_smoke.card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    if args.timeline:
        profile_timelines(card)
        return 0
    if args.splits:
        profile_splits(card)
        return 0
    if args.variants:
        profile_variants(card)
        return 0
    cases = chip_smoke.solve_cases()
    if "city10m" in args.solves:  # built only on request: 10M triangles on the host
        cases["city10m"] = (chip_smoke.city_meshes(chip_smoke.BIG_CITY_TRIS), cases["city"][1])
    for name in args.solves:
        meshes, params = cases[name]
        if args.bvh:
            params = dataclasses.replace(params, bvh=args.bvh)
        profile_case(name, meshes, params, args.reps, args.traced, card, args.route,
                     args.count, args.slim)
    return 0


if __name__ == "__main__":
    sys.exit(main())
