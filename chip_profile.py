#!/usr/bin/env python3
"""Where the time goes in the port's warm solves, on one CUDA card.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_profile.py [--reps 5] [--traced 3] [--route auto|scheduled|grouped]
                            [--count kernel|plain] [--bvh auto|off] [--slim] [--timeline]
                            [--splits] [--variants] [--halton] [--masks]
                            [--force-split N|GEOMETRY]
                            [--launches [--tree DIR]] [--sass [--loop NAME]] [--range N]
                            [--dump FILE [--dump-traced]]
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
  the torch ops under the program's spans (``raystrack_tpu_torch/tracing.py``):
  ``raystrack.ops.count`` ("histogram": the count kernel, or the whole
  count in torch ops with ``--count plain``), ray generation, the masks
  and the gate (its tables, the crossing kernel and the ray sort), the per-emitter
  chunks and scheduled rounds dispatched (its ``raystrack.chunk.dispatch``
  spans, and the ``raystrack.round.build`` spans that launched a sweep),
  the rows of ``RAY_BLOCK`` rays, real rays, pairs tested and tiles swept
  of the program's counters, and device kernels per dispatch;
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
a kernel change when run in two trees in one call. ``--halton`` instead measures the
set-up of ex02's matrix (the canyon and its 89M-ray ground) and of ``city_plates``
at one sample per m², with the Halton tables built on the card and on the host
(``RAYSTRACK_TPU_DEVICE_HALTON=0``). ``--masks`` instead times the mask rows
kernel of a scheduled round against its bytes bound and its plain version,
and their device memory a call, on the round of the most rows of the
benchmark's ``canyon_matrix`` and ``city_buildings`` (:func:`profile_masks`).
``--sass`` instead prints every kernel instantiation's registers and spills
and the SASS instructions a pair of the sweeps' pair loops (``--loop NAME`` prints that loop). ``--dump FILE``
instead solves each named case once and writes the dicts to FILE (run in
two trees, equal files mean bitwise equal solves; with ``--dump-traced``
each solve runs under ``torch.profiler``, so the program's tracing is on). ``--force-split N`` solves (and times
``--launches``) with every ungated sweep at N threads a ray, a whole block a
CTA, or at the geometry named (``256x2r4``), instead of the rule's choice. The card's name
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


# the program's spans whose device time is reported apart, by label
STAGES = {
    "histogram": "raystrack.ops.count",
    "raygen": "raystrack.ops.raygen",
    "masks": "raystrack.ops.masks",
    "gate": "raystrack.ops.gate",
}


def stage_device_us(event) -> float:
    """Device microseconds of the kernels launched under a CPU event and its
    descendants: the torch ops' and, under a program span, the hand-written
    kernels' launched through ctypes (outside every span the profiler files
    those under no op)."""
    return (sum(k.duration for k in event.kernels)
            + sum(stage_device_us(ch) for ch in event.cpu_children))


def _holds(event, name: str) -> bool:
    """Whether a CPU event has a descendant named ``name``."""
    return any(ch.name == name or _holds(ch, name) for ch in event.cpu_children)


def traced_solve(solve):
    """One solve under torch.profiler: (wall s, device kernel events, device
    seconds per STAGES label, chunks and rounds dispatched, the change of
    the program's counters). Chunks and rounds are the program's
    ``raystrack.chunk.dispatch`` spans and its ``raystrack.round.build``
    spans that launched a sweep."""
    from torch.profiler import ProfilerActivity, profile

    from raystrack_tpu_torch import tracing

    before = tracing.counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    moved = tracing.since(before)
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    stages = {label: sum(stage_device_us(e) for e in cpu if e.name == span) / 1e6
              for label, span in STAGES.items()}
    chunks = sum(e.name == "raystrack.chunk.dispatch" for e in cpu)
    rounds = sum(e.name == "raystrack.round.build" and _holds(e, "raystrack.ops.sweep")
                 for e in cpu)
    return wall, kernels, stages, chunks, rounds, moved


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

    runs = []
    try:
        for i in range(n_traced):
            wall, kernels, stages, chunks, rounds, moved = traced_solve(solve)
            if not kernels:
                raise SystemExit(f"FAILED: {name}: the trace holds no device kernel")
            busy = busy_seconds((e.time_range.start, e.time_range.end) for e in kernels)
            sweep = sum(e.time_range.elapsed_us() for e in kernels
                        if any(k in e.name for k in ("sweep_kernel", "sweep_code_kernel",
                                                     "sweep_sched_kernel"))) / 1e6
            # the gate's per-call tables and the coherence sort: torch ops and
            # the crossing kernel (also timed by name)
            cross = sum(e.time_range.elapsed_us() for e in kernels
                        if "gate_cross_kernel" in e.name) / 1e6
            gate = stages["gate"]
            count_k = sum(e.time_range.elapsed_us() for e in kernels
                          if "count_codes_kernel" in e.name) / 1e6
            rows = moved["rays_padded"] // RAY_BLOCK
            run = dict(wall_s=wall, busy_s=busy, busy_share=busy / wall,
                       busy_share_of_untraced_median=busy / median,
                       sweep_s=sweep, sweep_share_of_busy=sweep / busy,
                       histogram_s=stages["histogram"], count_kernel_s=count_k,
                       raygen_s=stages["raygen"],
                       masks_s=stages["masks"], gate_s=gate, gate_cross_kernel_s=cross,
                       chunks=chunks, rounds=rounds, rows=rows,
                       rays_real=moved["rays_real"], pairs_tested=moved["pairs_tested"],
                       tiles_swept=moved["tiles_swept"], tiles_offered=moved["tiles_offered"],
                       kernels_per_dispatch=len(kernels) / max(1, chunks + rounds))
            runs.append(run)
            print(f"[{name}] traced run {i + 1}: wall {wall:.4f} s, busy {busy:.4f} s "
                  f"= {run['busy_share']:.1%} of it ({run['busy_share_of_untraced_median']:.1%} "
                  f"of the untraced median); sweep {sweep * 1e3:.3f} ms = "
                  f"{run['sweep_share_of_busy']:.1%} of busy; histogram "
                  f"{stages['histogram'] * 1e3:.3f} ms (count kernel {count_k * 1e3:.3f} ms), "
                  f"raygen {stages['raygen'] * 1e3:.3f} ms, "
                  f"masks {stages['masks'] * 1e3:.3f} ms, gate tables and ray sort "
                  f"{gate * 1e3:.3f} ms (crossing kernel {cross * 1e3:.3f} ms); "
                  f"{chunks} chunks and {rounds} rounds ({rows} rows of {RAY_BLOCK} rays, "
                  f"{moved['rays_real']} real rays), {moved['pairs_tested'] / 1e9:.4f} Gpairs "
                  f"tested on {moved['tiles_swept']} of {moved['tiles_offered']} tiles offered, "
                  f"{run['kernels_per_dispatch']:.1f} device kernels per chunk or round")
    finally:
        trace_mod.count_codes = real_count

    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    for kname, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"[{name}]   {us / 1e3:9.3f} ms {n:6d}x  {kname[:100]}")
    print(json.dumps({"solve": name, "route": route, "count": count, "slim": slim,
                      "card": card, "warm_s": warm, "traced": runs}))


def timeline_stats(label: str, timeline, visits, n_sms: int, per_block: int = 1) -> dict:
    """What a gated launch's per-CTA timeline says: ``timeline`` (CTAs, 4)
    int64 holds each CTA's start and end on the card's nanosecond timer, its
    SM and the visit positions it walked; ``visits`` its swept tiles; CTA c
    serves block c // ``per_block`` of 256 rays."""
    t = timeline.cpu().numpy()
    swept = visits.cpu().numpy().astype(np.float64)
    start, end, sm, walked = t[:, 0], t[:, 1], t[:, 2], t[:, 3].astype(np.float64)
    t0, t1 = start.min(), end.max()
    span = float(t1 - t0)
    spans = (end - start).astype(np.float64)
    slots = 0  # CTAs resident at once on one SM
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
    # CTA span ~ a * swept tiles + c * positions that ended at the vote + d
    voted = walked - swept
    A = np.stack([swept, voted, np.ones_like(swept)], axis=1)
    (a, c, d), *_ = np.linalg.lstsq(A, spans, rcond=None)
    slowest = int(spans.argmax())
    out = dict(
        label=label, ctas=int(t.shape[0]), ctas_a_block=per_block, sms_used=int(len(last_end)),
        slots_per_sm=slots, span_ms=span / 1e6,
        fill=float(spans.sum()) / (n_sms * slots * span),
        slowest_cta_ms=float(spans.max()) / 1e6, slowest_cta_block=slowest // per_block,
        slowest_cta_swept=int(swept[slowest]), tail_ms=(float(t1) - dry) / 1e6,
        tail_share=(float(t1) - dry) / span, sm_idle_share_after_last_cta=idle_tail,
        swept_tiles=int(swept.sum()), walked_positions=int(walked.sum()),
        fit_us_per_swept_tile=a / 1e3, fit_us_per_vote_only_visit=c / 1e3,
        fit_us_per_cta=d / 1e3)
    print(f"[timeline] {label}: {out['ctas']} CTAs ({per_block} a block) on {out['sms_used']} "
          f"SMs, at most {slots} resident on one SM; kernel span {out['span_ms']:.3f} ms; sum of "
          f"CTA spans over ({n_sms} SMs x {slots} slots x span) {out['fill']:.1%}; slowest CTA "
          f"{out['slowest_cta_ms']:.3f} ms (block {out['slowest_cta_block']}, "
          f"{out['slowest_cta_swept']} tiles swept); from the first SM running dry to the end "
          f"{out['tail_ms']:.3f} ms = {out['tail_share']:.1%} of the span (mean SM idle after "
          f"its last CTA {idle_tail:.1%} of the span); {out['swept_tiles']} tiles swept of "
          f"{out['walked_positions']} positions walked; least-squares CTA span = "
          f"{out['fit_us_per_swept_tile']:.3f} us x swept tiles + "
          f"{out['fit_us_per_vote_only_visit']:.3f} us x visits that end at the vote + "
          f"{out['fit_us_per_cta']:.1f} us")
    return out


def gated_launches(card: str, range_tris: int = 0) -> tuple:
    """The gated launches the rule is measured on, as (rays, n_tri_pad,
    accel, launch(rays, **debug)) by label: kernel #1 on the first chunk of
    the 1M city's ground -> city solve, kernel #2 on the first round of its
    ten-plate matrix and, with ``range_tris``, kernel #1 in code mode on the
    gated full chunk of city_100m_torch.py's city of that size (slim, the
    two-level gate); and the 1M chunk's (pack, tile, tile flags) for its
    plain version."""
    import chip_smoke
    from raystrack_tpu_torch import PreparedSolver, view_factor, view_factor_matrix
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.ops import trace as trace_mod
    from raystrack_tpu_torch.ops.trace_cuda import sweep_rays, sweep_rays_scheduled

    cases = chip_smoke.solve_cases()
    city, vf_params = cases["city"]
    plates, plates_params = cases["city_plates"]
    chunk_call = chip_smoke.first_call(trace_mod, "chunk_body", lambda: view_factor(
        city[0], city[1], vf_params, prepared=PreparedSolver(city)))
    round_call = chip_smoke.first_call(trace_mod, "scheduled_trace", lambda: view_factor_matrix(
        plates, plates_params, prepared=PreparedSolver(plates)))
    kw = dict(tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False)
    rays, pack, mask, accel, tile, tiles_on = chip_smoke.city_chunk_inputs(chunk_call)
    rays2, pack2, masks, emap, accel2, _, _ = chip_smoke.city_round_inputs(round_call)
    out = {
        "kernel #1 gated, city chunk": (rays, pack.shape[1], accel, lambda r, **dbg: sweep_rays(
            r, pack, mask, masks_baked=True, **{**kw, "accel": accel, **dbg})),
        "kernel #2 gated, city_plates round": (
            rays2, pack2.shape[1], accel2, lambda r, **dbg: sweep_rays_scheduled(
                r, pack2, masks, emap[: r.shape[1] // 256].contiguous(),
                **{**kw, "accel": accel2, **dbg})),
    }
    if range_tris:
        import city_100m_torch as big

        dev = rays.device
        meshes = big.city_meshes(range_tris)
        ps = PreparedSolver(meshes)
        rpack, _ = big.prepare(ps, dev, big.DeviceMemory(dev))
        em = ps.get_emitter_pack(0, samples=1, rays=1, flip_faces=False, device=dev)
        tri_pack, rmask, bounds = big.operands(rpack, dev)
        rrays = big.chunk_rays(rpack, em, dev)
        out[f"kernel #1 gated, range chunk ({range_tris} triangles)"] = (
            rrays, tri_pack.shape[1], rpack.accel, lambda r, **dbg: sweep_rays(
                r, tri_pack, rmask, code_bounds=bounds, **{**kw, "accel": rpack.accel, **dbg}))
    return out, (pack, tile, tiles_on)


def profile_timelines(card: str, range_tris: int = 0) -> None:
    """The per-CTA timeline of the gated launches (:func:`gated_launches`) at
    the geometry the wrapper's rule picks, on tables built once."""
    import chip_smoke
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.ops import trace_cuda

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for label, (r, tpad, boxes, launch) in gated_launches(card, range_tris)[0].items():
        dev = r.device
        n_blocks = -(-r.shape[1] // chip_smoke.RAY_SUB)
        tile = trace_cuda.sweep_tile_width(tpad, PALLAS_TRI_TILE)
        gate = trace_cuda._gate_for(boxes, r, tpad, tile, PALLAS_TRI_TILE, dev)
        geo = trace_cuda._geometry(trace_cuda.sweep_split(n_blocks, True, n_sms))
        visits = torch.zeros(geo.units(r.shape[1]), dtype=torch.int32, device=dev)
        timeline = torch.zeros((geo.units(r.shape[1]), 4), dtype=torch.int64, device=dev)
        with chip_smoke.forced_launch(gate=gate):
            launch(r)  # warm
            ms, _ = chip_smoke.cuda_ms(
                lambda: launch(r, visits=visits, timeline=timeline))  # noqa: B023
        torch.cuda.synchronize()
        stats = timeline_stats(f"{label}, {geo.rays} rays x {geo.split} threads a CTA",
                               timeline, visits, n_sms, geo.per_block)
        stats.update(kernel_ms=ms, rays_a_cta=geo.rays, split=geo.split)
        out.append(stats)
    print(json.dumps({"timelines": out, "card": card}))


SPLIT_BLOCKS = (32, 66, 128, 132, 160, 192, 200, 264, 300, 396, 528, 792, 1024)
GATED_BLOCKS = (32, 132, 192, 264, 528, 1024)


def profile_splits(card: str, range_tris: int = 0) -> None:
    """The measurement behind ``trace_cuda.sweep_split``: every geometry the
    kernels are built at (``trace_cuda.BUILT_GEOMETRIES``), best of 3 by
    CUDA events, each equal to the first (codes, flags and, gated, the
    per-block visits), beside the geometry the rule picks:

    - ungated kernel #1 (matrix, baked pack) on the leading B blocks of 256
      rays of the soup chunk (98,304 triangles, 48 tiles), B from 32 to the
      chunk's 1,024;
    - the gated launches of :func:`gated_launches` (tables built once), on
      their leading B blocks and whole: the kernel's ms, its own pair tests
      (per-CTA swept tiles x rays a CTA x tile) against the 256-ray walk's,
      the FP32 bound of the latter, and the per-CTA timeline's fill, slowest
      CTA and tail; the 3e7-style chunk also ungated at each geometry;
    - the tile segments of a gated walk, which the kernels do not cut: the
      plain version's swept tiles at 2 and 4 segments on the 1M chunk's
      leading blocks, against one.
    """
    import chip_smoke
    from raystrack_tpu_torch import PreparedSolver
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.ops import trace_cuda
    from raystrack_tpu_torch.ops.build import build
    from raystrack_tpu_torch.ops.trace_cuda import SweepGeometry

    dev = torch.device("cuda", torch.cuda.current_device())
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ops = chip_smoke.sass_pair_ops(chip_smoke.sass_functions(build().path))
    fp32 = ops["sweep_kernel<1,0,1,0>"][0]
    soup, params = chip_smoke.solve_cases()["soup"]
    scene, rays, m_any, m_mat, tpad, _ = chip_smoke.soup_inputs(
        dev, PreparedSolver(soup), params.seed)
    pack = trace_cuda.build_tri_pack(scene, m_any, m_mat, bake=m_mat)
    rows = []
    for n_blocks in SPLIT_BLOCKS:
        sub = rays[:, : n_blocks * chip_smoke.RAY_SUB].contiguous()
        launch = lambda: trace_cuda.sweep_rays(  # noqa: E731
            sub, pack, m_mat, tri_tile=PALLAS_TRI_TILE, want_matrix=True,  # noqa: B023
            want_any=False, masks_baked=True)
        times, first = {}, None
        for geo in trace_cuda.BUILT_GEOMETRIES[False]:
            with chip_smoke.forced_launch(geo):
                launch()  # warm
                times[geo.name], out = chip_smoke.cuda_ms(launch)
            first = first or out
            chip_smoke.check(torch.equal(out[0], first[0]) and torch.equal(out[1], first[1]),
                             f"{n_blocks} blocks: {geo} != the first geometry")
        chosen = trace_cuda.sweep_split(n_blocks, False, n_sms).name
        best = min(times, key=times.get)
        bound = n_blocks * 256 * tpad * fp32 / chip_smoke.PEAK_FP32_INSTR * 1e3
        rows.append(dict(blocks=n_blocks, blocks_per_sm=n_blocks / n_sms, ms=times,
                         rule=chosen, fastest=best, bound_ms=bound))
        print(f"[splits] ungated {n_blocks:5d} blocks ({n_blocks / n_sms:.2f} an SM) x {tpad} "
              f"triangles: " + ", ".join(f"{g} {t:.3f} ms ({bound / t:.1%})"
                                         for g, t in times.items())
              + f"; fastest {best}, the rule picks {chosen} "
                f"({times[chosen] / times[best] - 1:+.1%} on the fastest)")
    gated_rows = []
    launches, (c_pack, c_tile, c_tiles_on) = gated_launches(card, range_tris)
    for label, (r_all, t_pad, boxes, launch) in launches.items():
        tile = trace_cuda.sweep_tile_width(t_pad, PALLAS_TRI_TILE)
        n_all = -(-r_all.shape[1] // 256)
        sizes = sorted({b for b in GATED_BLOCKS if b < n_all} | {n_all})
        if label != "kernel #1 gated, city chunk":
            sizes = [n_all]
        for n_blocks in sizes:
            r = r_all[:, : n_blocks * 256].contiguous()
            gate = trace_cuda._gate_for(boxes, r, t_pad, tile, PALLAS_TRI_TILE, dev)
            times, ref, row = {}, None, dict(launch=label, blocks=n_blocks, geometries={})
            for geo in trace_cuda.BUILT_GEOMETRIES[True]:
                name = geo.name
                units = geo.units(r.shape[1])
                v_block = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
                v_cta = torch.zeros(units, dtype=torch.int32, device=dev)
                timeline = torch.zeros((units, 4), dtype=torch.int64, device=dev)
                with chip_smoke.forced_launch(geo, gate=gate):
                    launch(r)  # warm
                    ms, out = chip_smoke.cuda_ms(lambda: launch(r))  # noqa: B023
                    launch(r, visits=v_block)
                    launch(r, visits=v_cta, timeline=timeline)
                torch.cuda.synchronize()
                if ref is None:
                    ref = (out, v_block)
                chip_smoke.check(torch.equal(out[0], ref[0][0]) and torch.equal(out[1], ref[0][1])
                                 and torch.equal(v_block, ref[1]),
                                 f"{label}, {n_blocks} blocks: {name} != the first geometry")
                walk_pairs = int(v_block.sum()) * 256 * tile
                own_pairs = int(v_cta.sum()) * geo.rays * tile
                bound = walk_pairs * fp32 / chip_smoke.PEAK_FP32_INSTR * 1e3
                stats = timeline_stats(f"{label}, {n_blocks} blocks, {name}", timeline, v_cta,
                                       n_sms, geo.per_block)
                row["geometries"][name] = dict(ms=ms, bound_ms=bound, share=bound / ms,
                                               pairs=own_pairs, walk_pairs=walk_pairs,
                                               fill=stats["fill"], tail_share=stats["tail_share"],
                                               slowest_cta_ms=stats["slowest_cta_ms"])
                times[name] = ms
                print(f"[splits] {label}, {n_blocks} blocks, {name}: {ms:.3f} ms, bound "
                      f"{bound:.3f} ms ({bound / ms:.1%}; the 256-ray walk's {walk_pairs:.4g} "
                      f"pairs), the kernel's own pairs {own_pairs:.4g} "
                      f"({own_pairs / max(walk_pairs, 1):.3f} of the walk's)")
            chosen = trace_cuda.sweep_split(n_blocks, True, n_sms).name
            row.update(rule=chosen, fastest=min(times, key=times.get))
            print(f"[splits] {label}, {n_blocks} blocks: fastest {row['fastest']}, the rule "
                  f"picks {chosen} ({times[chosen] / times[row['fastest']] - 1:+.1%})")
            gated_rows.append(row)
        if "range" in label:  # the range chunk ungated at each geometry
            times = {}
            for geo in trace_cuda.BUILT_GEOMETRIES[False]:
                with chip_smoke.forced_launch(geo):
                    t, _ = chip_smoke.cuda_ms(lambda: launch(r_all, accel=None), reps=1)  # noqa
                times[geo.name] = t
            print(f"[splits] {label} ungated: " + ", ".join(
                f"{g} {t:.3f} ms" for g, t in times.items()) + f"; the rule picks "
                f"{trace_cuda.sweep_split(n_all, False, n_sms).name}")
            gated_rows.append(dict(launch=label + " ungated", blocks=n_all, ms=times))
    # tile segments of a gated walk, which the kernels do not cut: its visits
    seg = {}
    r_all, t_pad, boxes, _ = launches["kernel #1 gated, city chunk"]
    r = r_all[:, : 16 * 256].contiguous()
    gate = trace_cuda._gate_for(boxes, r, t_pad, c_tile, PALLAS_TRI_TILE, dev)
    for g in (1, 2, 4):
        v = torch.zeros(16 * g, dtype=torch.int32, device=dev)
        trace_cuda.sweep_rays_reference(
            r, c_pack, trace_cuda._gated_tiles_on(c_tiles_on, gate), c_tile, want_matrix=True,
            want_any=False, masks_baked=True, gate=gate, visits=v,
            split=SweepGeometry(256, 4, g))
        seg[g] = int(v.sum())
    print(f"[splits] tile segments of the gated walk, plain version, city chunk, 16 leading "
          f"blocks: swept tiles at 1 / 2 / 4 segments {seg[1]} / {seg[2]} / {seg[4]} "
          f"({seg[2] / seg[1]:.3f}x, {seg[4] / seg[1]:.3f}x)")
    print(json.dumps({"splits": rows, "gated": gated_rows, "segments": seg, "card": card,
                      "sms": n_sms}))


def profile_launches(card: str, range_tris: int = 0) -> None:
    """The launches PERF.md section 6 times, each at the geometry the
    tree's wrapper picks, best of 5 by CUDA events after a warm call: kernel
    #1 on the soup chunk (matrix and any-only, baked pack), #2 on the soup8
    round, #1 gated on the 1M city's first ground -> city chunk and #2
    gated on the first ``city_plates`` round (the gate's tables built once),
    ex06's row (each kernel #1 launch of the row, 50 back to back; ms a
    launch) and #1 gated on the 10M city's first chunk. With ``--tree`` the
    package and chip_smoke.py come from that tree: run a parent tree and
    this one in turns in one call to A/B a kernel change. With ``range_tris``
    also the gated and ungated chunk of the range's city of that size
    (:func:`range_launches`)."""
    import chip_smoke
    from raystrack_tpu_torch import PreparedSolver, view_factor, view_factor_matrix
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.ops import trace_cuda as tc

    dev = torch.device("cuda", torch.cuda.current_device())
    cases = chip_smoke.solve_cases()
    out = {}

    def best(label, fn, reps=5):
        fn()
        out[label] = chip_smoke.cuda_ms(fn, reps)[0]
        print(f"[launches] {label}: {out[label]:.4f} ms", flush=True)

    def visit_share(label, fn, active, n_blocks):
        """The (block, tile) pairs the launch's blocks swept (``fn(visits)``,
        one row a block) over its ``active`` ones: below 1 where the any-only
        stop cut tiles."""
        v = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
        fn(v)
        out[f"{label}, visit share"] = int(v.sum()) / max(active, 1)
        print(f"[launches] {label}: {int(v.sum())} of {active} active (block, tile) pairs swept "
              f"({out[f'{label}, visit share']:.4f})", flush=True)

    soup, params = cases["soup"]
    scene, rays, m_any, m_mat, _, _ = chip_smoke.soup_inputs(dev, PreparedSolver(soup),
                                                             params.seed)
    tile = tc.sweep_tile_width(m_mat.shape[0], PALLAS_TRI_TILE)
    n_blocks = -(-rays.shape[1] // 256)
    for label, wm, wa, prim in (("soup chunk, matrix", True, False, m_mat),
                                ("soup chunk, any-only", False, True, m_any)):
        pack = tc.build_tri_pack(scene, m_any, m_mat, bake=prim)
        best(label, lambda: tc.sweep_rays(rays, pack, prim, tri_tile=PALLAS_TRI_TILE,  # noqa
                                          want_matrix=wm, want_any=wa, masks_baked=True))  # noqa
        visit_share(label, lambda v: tc.sweep_rays(  # noqa: B023
            rays, pack, prim, tri_tile=PALLAS_TRI_TILE, want_matrix=wm, want_any=wa,  # noqa
            masks_baked=True, visits=v),
            int(prim.reshape(-1, tile).any(dim=1).sum()) * n_blocks, n_blocks)
    del scene, rays, pack
    # the canyon's sky at validation 07's settings: its first round, kernel
    # #2's any-only variant
    from examples.ex00_street_canyon_geometry import build_street_canyon
    from raystrack_tpu_torch import SkyParams, view_factor_to_tregenza_sky

    a, k = chip_smoke.first_call(T, "sweep_rays_scheduled", lambda: view_factor_to_tregenza_sky(
        build_street_canyon(), SkyParams(**chip_smoke.sky_base())))
    best("canyon sky round, any-only", lambda: tc.sweep_rays_scheduled(*a, **k))
    tile = tc.sweep_tile_width(a[1].shape[1], k["tri_tile"])
    active = tc.scheduled_tiles_on(a[2], tile, want_matrix=False, want_any=True)[a[3].long()]
    visit_share("canyon sky round, any-only", lambda v: tc.sweep_rays_scheduled(
        *a, **k, visits=v), int(active.sum()), a[0].shape[1] // 256)
    soup8, params8 = cases["soup8"]
    args, kw = chip_smoke.first_call(T, "scheduled_trace", lambda: view_factor_matrix(
        soup8, params8, prepared=PreparedSolver(soup8)))
    (scene8, pack8, tables, geom, cp, surf, emit, mins, once, plane, schedule, sel) = args
    sb = kw["sched_block"]
    masks = T.combined_masks(scene8, surf, emit, mins, plane)
    o, d, _ = T.scheduled_rays(tables, geom, cp, once, schedule, sel, sched_block=sb)
    rays8 = T.ray_pack(o, d)
    emap = schedule[:, 0].repeat_interleave(sb // chip_smoke.RAY_SUB)
    best("soup8 round, matrix", lambda: tc.sweep_rays_scheduled(
        rays8, pack8, masks, emap, tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False))
    del args, scene8, pack8, tables, masks, rays8
    city, vf_params = cases["city"]
    plates, plates_params = cases["city_plates"]
    call = chip_smoke.first_call(T, "chunk_body", lambda: view_factor(
        city[0], city[1], vf_params, prepared=PreparedSolver(city)))
    r, pack, mask, accel, tile, _ = chip_smoke.city_chunk_inputs(call)
    with chip_smoke.forced_launch(gate=tc._gate_for(accel, r, pack.shape[1], tile,
                                                    PALLAS_TRI_TILE, dev)):
        best("1M gated chunk", lambda: tc.sweep_rays(
            r, pack, mask, tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False,
            masks_baked=True, accel=accel))
    call = chip_smoke.first_call(T, "scheduled_trace", lambda: view_factor_matrix(
        plates, plates_params, prepared=PreparedSolver(plates)))
    r, pack, masks, emap, accel, tile, _ = chip_smoke.city_round_inputs(call)
    with chip_smoke.forced_launch(gate=tc._gate_for(accel, r, pack.shape[1], tile,
                                                    PALLAS_TRI_TILE, dev)):
        best("city_plates round", lambda: tc.sweep_rays_scheduled(
            r, pack, masks, emap, tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False,
            accel=accel))
    from examples_torch import ex06_city_block as ex06
    from examples.ex06_city_block import build_city
    from raystrack_tpu_torch import MatrixParams
    from raystrack_tpu_torch.parallel.distribute import view_factor_matrix_partition

    ex_meshes = build_city()
    target = ex06.target_name()
    part = [name for name, _, _ in ex_meshes].index(target)
    calls = []
    real = T.sweep_rays
    T.sweep_rays = lambda *a, **k: calls.append((a, k)) or real(*a, **k)
    try:
        view_factor_matrix_partition(ex_meshes, MatrixParams(**ex06.SETTINGS, reciprocity=False),
                                     n_parts=len(ex_meshes), part=part)
    finally:
        T.sweep_rays = real
    a, k = calls[0]
    best("ex06 row, a kernel #1 launch (50 back to back)", lambda: [
        tc.sweep_rays(*a, **k) for _ in range(50)][-1])
    out["ex06 row, a kernel #1 launch (50 back to back)"] /= 50
    big = chip_smoke.city_meshes(chip_smoke.BIG_CITY_TRIS)
    call = chip_smoke.first_call(T, "chunk_body", lambda: view_factor(
        big[0], big[1], vf_params, prepared=PreparedSolver(big)))
    r, pack, mask, accel, tile, _ = chip_smoke.city_chunk_inputs(call)
    gate = tc._gate_for(accel, r, pack.shape[1], tile, PALLAS_TRI_TILE, dev)
    with chip_smoke.forced_launch(gate=gate):
        best("10M gated chunk", lambda: tc.sweep_rays(
            r, pack, mask, tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False,
            masks_baked=True, accel=accel))
    if range_tris:
        range_launches(range_tris, dev, best)
    print(json.dumps({"launches": out, "tree": str(Path(tc.__file__).parents[2]), "card": card}))


def range_launches(n_tri: int, dev, best) -> None:
    """Kernel #1 in code mode on the gated full chunk of city_100m_torch.py's
    city of ``n_tri`` triangles (slim, the two-level gate), gated on tables
    built once (best of 3) and ungated (best of 2), each at the geometry the
    tree's wrapper picks: ``best(label, fn, reps)`` times and records them."""
    import city_100m_torch as big
    from raystrack_tpu_torch import PreparedSolver
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.ops import trace_cuda as tc

    import chip_smoke

    ps = PreparedSolver(big.city_meshes(n_tri))
    pack, _ = big.prepare(ps, dev, big.DeviceMemory(dev))
    em = ps.get_emitter_pack(0, samples=1, rays=1, flip_faces=False, device=dev)
    tri_pack, mask, bounds = big.operands(pack, dev)
    rays = big.chunk_rays(pack, em, dev)
    tile = tc.sweep_tile_width(tri_pack.shape[1], PALLAS_TRI_TILE)
    kw = dict(tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False, code_bounds=bounds)
    with chip_smoke.forced_launch(gate=tc._gate_for(pack.accel, rays, tri_pack.shape[1], tile,
                                                    PALLAS_TRI_TILE, dev)):
        best(f"{n_tri:.0e} gated chunk", lambda: tc.sweep_rays(
            rays, tri_pack, mask, accel=pack.accel, **kw), reps=3)
    best(f"{n_tri:.0e} ungated chunk", lambda: tc.sweep_rays(rays, tri_pack, mask, **kw), reps=2)


def profile_sass(card: str, loops=()) -> None:
    """Each kernel instantiation's registers, shared memory and spills
    (``ptxas -v``) and, for the sweeps and the crossing kernel, the FP32
    SASS instructions a pair and all instructions a pair of the pair loop
    (``chip_smoke.sass_pair_ops``), for the library of this tree (or of
    ``--tree``), built anew into a temporary directory."""
    import os
    import tempfile

    import chip_smoke
    from raystrack_tpu_torch.ops import build

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["XDG_CACHE_HOME"] = tmp
        build.SOURCE_BUILD_DIR = Path(tmp) / "build"
        b = build.build()
        ptxas = chip_smoke.ptxas_lines(b.log)
        funcs = chip_smoke.sass_functions(b.path)
        ops = chip_smoke.sass_pair_ops(funcs)
    for line in ptxas:
        print(f"[sass] {line}")
    for name, (fp32, counts, total, local) in ops.items():
        print(f"[sass] {name}: {fp32:g} FP32 instructions a pair ({counts}), {total:g} in all, "
              f"{local} local loads and stores in the pair loop")
    for name in loops:  # the pair loop's SASS, instruction by instruction
        _, lo, hi = min(chip_smoke.sass_loops(funcs[name], "LDS.128"))
        for addr, op in funcs[name]:
            if lo <= addr <= hi:
                print(f"[loop] {name} {addr:05x} {op}")
    print(json.dumps({"sass": {k: dict(fp32=v[0], all=v[2], local=v[3], fp32_by_opcode=v[1])
                               for k, v in ops.items()}, "ptxas": ptxas,
                      "tree": str(Path(build.__file__).parents[2]), "card": card}))


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
    rows = {}
    for wm, wa in ((True, False), (False, True), (True, True)):
        name = "matrix+any" if wm and wa else "matrix" if wm else "any"
        flags = "".join(str(int(f)) for f in (wm, wa))
        prim = m_any if wa else m_mat
        pack = trace_cuda.build_tri_pack(scene, m_any, m_mat, bake=prim)
        sym1 = chip_smoke.sweep_name(f"sweep_kernel<{','.join(flags)},1,0>",
                                     trace_cuda._launch_geometry(rays.shape[1], False, dev))
        sym2 = chip_smoke.sweep_name(f"sweep_sched_kernel<{','.join(flags)},0>",
                                     trace_cuda._launch_geometry(rays8.shape[1], False, dev))
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


def dump_solves(names, cases, path: str, card: str, traced: bool = False) -> None:
    """Solve each case once with ``view_factor_matrix`` (a fresh
    ``PreparedSolver``) and write the dicts to ``path`` as JSON (keys
    sorted, floats as Python prints them, so two trees' files are equal
    exactly when every entry is): the check that a kernel change left every
    solve's result bitwise as it was. ``traced`` runs each solve under
    ``torch.profiler`` (host and card), which turns the program's tracing
    on: equal files then mean tracing changes no result."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from raystrack_tpu_torch import PreparedSolver, view_factor_matrix

    out = {}
    for name in names:
        meshes, params = cases[name]
        prepared = PreparedSolver(meshes)
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()):
            out[name] = view_factor_matrix(meshes, params, prepared=prepared)
        print(f"[dump] {name}: {len(out[name])} rows{' (traced)' if traced else ''}",
              flush=True)
    Path(path).write_text(json.dumps({"solves": out, "card": card}, sort_keys=True))


def profile_halton(card: str) -> None:
    """Set-up (first solve minus warm solve, fresh ``PreparedSolver``) of
    ex02's matrix at its own settings and of ``city_plates`` at one sample
    per m² and one ray (the boxes' 26.6M cells), each with the Halton
    tables built on the card and on the host (``RAYSTRACK_TPU_DEVICE_HALTON=0``),
    device path first: the walls, the Halton builds' share, peak device
    memory. One JSON line a solve."""
    import chip_smoke
    from raystrack_tpu_torch import MatrixParams, config

    ex02, ex02_params = chip_smoke.ex02_case()
    cases = [("ex02", ex02, ex02_params),
             ("city_plates, samples=1 rays=1", chip_smoke.city_plates_meshes(), MatrixParams(
                 samples=1, rays=1, min_iters=2, max_iters=2, reciprocity=True,
                 device="gpu"))]
    for label, meshes, params in cases:
        for on in (True, False):
            path = "device" if on else "host"
            stats, _ = chip_smoke.setup_and_warm(meshes, params, on)
            builds = stats.pop("halton_builds")
            big = [b for b in builds if b[0] >= config.DEVICE_MIN_LENGTH]
            stats.update(solve=label, path=path, card=card, big_tables=len(big),
                         big_tables_s=sum(b[3] for b in big),
                         big_where=sorted({b[2] for b in big}))
            print(f"[halton] {label}, {path} path: first solve {stats['first_s']:.2f} s, warm "
                  f"{stats['warm_s']:.2f} s, set-up {stats['setup_s']:.2f} s, of it Halton "
                  f"builds {stats['halton_s']:.3f} s ({len(big)} tables and grids of "
                  f"{config.DEVICE_MIN_LENGTH:,} entries or more: {stats['big_tables_s']:.3f} "
                  f"s, {stats['big_where']}); peak {stats['peak_bytes'] / 2**20:.1f} MiB")
            print(json.dumps(stats))


def profile_masks(card: str, seed: int = 2200000020) -> None:
    """The mask rows kernel (``csrc/masks.cu``) on the round of the most
    rows of one solve of the benchmark's ``canyon_matrix`` and
    ``city_buildings`` (``vfbench``'s scene and traffic from ``seed``): its
    device ms a launch (``chip_smoke.launch_times``: 200 launches behind the
    spin kernel) beside its bytes bound (``chip_smoke.mask_bytes`` at
    ``chip_smoke.PEAK_BYTES``), the wrapper's host ms a call, the
    plain version's device ms (best of 5 by CUDA events) and host ms a
    call, the device memory each allocates over the call's start (the rows
    and the plain version's temporaries), and whether the rows are equal."""
    import chip_smoke
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.ops.build import load_library
    from vfbench import harness

    lib = load_library()
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name in ("canyon_matrix", "city_buildings"):
        cell = harness.Cell.load(name)
        solve = harness.program_solver(cell.traffic, cell.meshes(seed), "gpu")
        rounds = []
        real = T.combined_masks
        T.combined_masks = lambda *a: rounds.append(a) or real(*a)  # noqa: B023
        try:
            solve(harness.solve_seed(seed, 1))
        finally:
            T.combined_masks = real
        args = max(rounds, key=lambda a: a[1].shape[0])  # the round of the most rows
        scene, ext, emit, mins, plane = args
        n_bytes = chip_smoke.mask_bytes(scene, ext, plane)
        n_emit, n_tri = ext.shape[0], scene[7].shape[0]
        out = torch.empty((n_emit, n_tri), dtype=torch.float32, device=dev)
        ptrs = (scene[0].data_ptr(), scene[1].data_ptr(), scene[2].data_ptr(),
                scene[7].data_ptr(), ext.data_ptr(), ext.shape[1], emit.data_ptr(),
                mins.data_ptr(), plane.data_ptr(), n_emit, n_tri, out.data_ptr(), stream)
        times = chip_smoke.launch_times(lambda: lib.raystrack_mask_rows(*ptrs),  # noqa: B023
                                        lambda: T.combined_masks(*args))  # noqa: B023
        plain_ms, want = chip_smoke.cuda_ms(lambda: T.combined_masks_reference(*args), 5)  # noqa
        calls = 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            T.combined_masks_reference(*args)
        plain_host_ms = (time.perf_counter() - t0) / calls * 1e3
        torch.cuda.synchronize()
        peaks = {}
        for label, fn in (("kernel", T.combined_masks), ("plain", T.combined_masks_reference)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn(*args)
            torch.cuda.synchronize()
            peaks[label] = (torch.cuda.max_memory_allocated() - base) / 2**30
        bound_ms = chip_smoke.bound(n_bytes)[0]
        row = dict(cell=name, rows=n_emit, triangles=n_tri, bytes=n_bytes,
                   bound_ms=bound_ms, ms=times["device_ms"],
                   share=bound_ms / times["device_ms"], floor_ms=times["floor_ms"],
                   call_device_ms=times["call_device_ms"], enqueue_ms=times["enqueue_ms"],
                   plain_ms=plain_ms, plain_host_ms=plain_host_ms,
                   call_gib=peaks["kernel"], plain_call_gib=peaks["plain"],
                   equal=bool(torch.equal(T.combined_masks(*args), want)), card=card)
        print(f"[masks] {name} ({n_emit}, {n_tri}): {row['ms']:.4f} ms a launch against a "
              f"bound of {bound_ms:.4f} ms ({row['share']:.1%}); plain {plain_ms:.4f} ms; "
              f"host {row['enqueue_ms']:.4f} / {plain_host_ms:.4f} ms a call; "
              f"{peaks['kernel']:.3f} / {peaks['plain']:.3f} GiB a call; equal {row['equal']}",
              flush=True)
        print(json.dumps(row), flush=True)
        del solve, args, scene, ext, emit, mins, plane, out, want
        torch.cuda.empty_cache()


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
    parser.add_argument("--halton", action="store_true")
    parser.add_argument("--masks", action="store_true")
    parser.add_argument("--force-split", default=None,
                        help="N (a whole block at N threads a ray) or a geometry's name "
                             "(256x2r4, 256x8r4s2): every ungated sweep at it")
    parser.add_argument("--launches", action="store_true")
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--dump", default=None,
                        help="solve the named cases once and write their dicts to this file")
    parser.add_argument("--dump-traced", action="store_true",
                        help="with --dump, solve under torch.profiler (tracing on)")
    parser.add_argument("--loop", action="append", default=[],
                        help="with --sass, print this instantiation's pair loop")
    parser.add_argument("--tree", default=None,
                        help="import the package and chip_smoke.py from this tree")
    parser.add_argument("--range", type=int, default=0,
                        help="with --splits, --timeline or --launches, also the chunk of "
                             "city_100m_torch.py's city of this many triangles")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--traced", type=int, default=3)
    args = parser.parse_args()
    if args.reps < 1 or args.traced < 1:
        parser.error("--reps and --traced must be at least 1")
    if not torch.cuda.is_available():
        print("chip_profile.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    import chip_smoke
    import raystrack_tpu_torch.solver as solver_mod
    from raystrack_tpu_torch import config

    config.SCHEDULER = args.route
    if args.slim:
        config.SLIM_PACK_MIN_TRIS = 1
    solver_mod._log = lambda line: None  # progress lines would flood the output
    if args.force_split is not None:
        import re

        from raystrack_tpu_torch.ops import trace_cuda

        m = re.fullmatch(r"(\d+)x(\d+)(?:r(\d+))?(?:s(\d+))?", args.force_split)
        forced = (trace_cuda.SweepGeometry(int(m[1]), int(m[2]), int(m[4] or 1), int(m[3] or 1))
                  if m else int(args.force_split))
        rule = trace_cuda.sweep_split
        trace_cuda.sweep_split = lambda n_blocks, gated, n_sms: (
            rule(n_blocks, gated, n_sms) if gated else forced)
    card = chip_smoke.card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    if args.timeline:
        profile_timelines(card, args.range)
        return 0
    if args.splits:
        profile_splits(card, args.range)
        return 0
    if args.variants:
        profile_variants(card)
        return 0
    if args.launches:
        profile_launches(card, args.range)
        return 0
    if args.sass:
        profile_sass(card, args.loop)
        return 0
    if args.halton:
        profile_halton(card)
        return 0
    if args.masks:
        profile_masks(card)
        return 0
    cases = chip_smoke.solve_cases()
    if "city10m" in args.solves:  # built only on request: 10M triangles on the host
        cases["city10m"] = (chip_smoke.city_meshes(chip_smoke.BIG_CITY_TRIS), cases["city"][1])
    if args.dump:
        dump_solves(args.solves, cases, args.dump, card, args.dump_traced)
        return 0
    for name in args.solves:
        meshes, params = cases[name]
        if args.bvh:
            params = dataclasses.replace(params, bvh=args.bvh)
        profile_case(name, meshes, params, args.reps, args.traced, card, args.route,
                     args.count, args.slim)
    return 0


if __name__ == "__main__":
    sys.exit(main())
