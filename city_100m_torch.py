#!/usr/bin/env python3
"""The 100M-triangle occluded city on one NVIDIA card: the PyTorch / CUDA
port's counterpart of ``benchmarks/city_100m.py`` and
``docs/measurements/city_100m_r05.py``.

It runs the port's production path for huge scenes at 10^8 triangles:

- scene: the occluded-city family (``city_meshes``, the JAX package's
  ``bench._city``, copied): a 200 x 200 ground under 8,333,333 random boxes,
  99,999,998 triangles;
- prep: ``PreparedSolver`` with the default config, which packs a scene of
  ``SLIM_PACK_MIN_TRIS`` padded triangles or more slim (pack-resident): one
  (24, Tpad) operand pack, the surface ids and the boxes on the card.
  100,001,792 padded triangles are 48,829 sweep tiles of 2,048, past
  ``GATE_MAX_TILES``: the gate takes its two-level form, one box for each
  group of 6 tiles, 8,139 boxes, the last group 1 real tile and 5 phantoms,
  and no early-exit window;
- sweep: ``ops.trace.chunk_body`` on the resident pack (kernel #1 in its
  ``code_bounds`` mode), gated, on the ground's 49,152 rays of one
  iteration (``accel``), and on its first 24 blocks of 256 rays gated and
  ungated (``accel_sub``, ``brute_sub``), the cases of the r05 script; and,
  which the TPU could not afford, ungated over the whole ray set
  (``brute``). Gated and ungated front-hit counts must be equal;
- kernel #1's two launches at this size timed by CUDA events, with the pairs
  they test (from each block's visit count) and their bound;
- a bounded ``view_factor_matrix`` (3 iterations) through the per-emitter
  driver, gated, on the resident pack only, ``==`` the same solve with
  ``bvh="off"``, F(ground -> city) against the TPU's committed value;
- ``--full``: steps 4 and 5 again with the pack forced to full mode (through
  ``SLIM_PACK_MIN_TRIS``, as ``chip_smoke.py`` forces it); counts and dicts
  ``==`` slim's, and full mode's device peak.

It logs each step's seconds, the host's peak RSS and the card's resident and
peak bytes, and prints as its last line one JSON object with the r05
script's keys and the port's own. It needs a CUDA card and raises without
one; it imports nothing of JAX. Host prep at 10^8 takes minutes and some
40 GB of host memory.

Usage: python3 city_100m_torch.py [--n 100000000] [--full]
       (``--n 30000000`` is the rehearsal: 14,649 tiles, groups of 2)
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import resource
import subprocess
import sys
import time
import numpy as np
import torch

CITY_TRIS = 100_000_000
SUB_BLOCKS = 24  # the r05 script's ungated subset: 24 blocks of 256 rays
RAY_SUB = 256  # rays a sweep block (trace_cuda.RAY_SUBBLOCK)
# The sizes this script states: triangles, padded triangles, tiles a gate
# box, gate boxes.
EXPECTED = {
    100_000_000: (99_999_998, 100_001_792, 6, 8_139),
    30_000_000: (29_999_990, 30_001_152, 2, 7_325),
}
# docs/measurements/city_100m_r05.txt: the JAX package's run on one TPU v5e
# (front hits of the gated full ray set and of the 24-block subset, and the
# bounded solve's F(ground -> city)); reference values, not the port's.
TPU_V5E = {"hits_full_accel": 211, "hits_equal_subset": 37, "solve_ground_to_city": 0.999992}
# FP32 instructions a ray-triangle pair in every sweep instantiation's SASS
# (chip_smoke.py counts them), and the H100 SXM's rates: one FP32
# instruction per lane per clock (the data sheet's 67 TFLOP/s counts an FFMA
# as 2) and HBM3 bytes/s.
FP32_PER_PAIR = 51
PEAK_FP32_INSTR = 67e12 / 2
PEAK_BYTES = 3.35e12
SOLVE = dict(samples=1, rays=1, seed=5, min_iters=2, max_iters=3)


def city_meshes(n_tri: int = 1_000_000, extent: float = 100.0, seed: int = 0):
    """Ground emitter + dense random boxes, near geometry occluding far: the
    JAX package's bench.py ``_city`` (occluded_city), copied. At 1M
    triangles: a 200 x 200 ground and 83,333 boxes, 999,998 triangles."""
    V = np.array([[-extent, -extent, 0], [extent, -extent, 0],
                  [extent, extent, 0], [-extent, extent, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n_boxes = max(1, (n_tri - 2) // 12)
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-extent, extent, (n_boxes, 2))
    w = rng.uniform(1.0, 4.0, (n_boxes, 2))
    h = rng.uniform(2.0, 25.0, n_boxes)
    box_f = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6],
                      [0, 4, 5], [0, 5, 1], [1, 5, 6], [1, 6, 2],
                      [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]], np.int32)
    x0, y0 = (cx - w).T.astype(np.float32)
    x1, y1 = (cx + w).T.astype(np.float32)
    h32 = h.astype(np.float32)
    vs = np.empty((n_boxes, 8, 3), np.float32)
    vs[:, (0, 3, 4, 7), 0] = x0[:, None]
    vs[:, (1, 2, 5, 6), 0] = x1[:, None]
    vs[:, (0, 1, 4, 5), 1] = y0[:, None]
    vs[:, (2, 3, 6, 7), 1] = y1[:, None]
    vs[:, :4, 2] = np.float32(0.05)
    vs[:, 4:, 2] = h32[:, None]
    faces = (box_f[None, :, :]
             + 8 * np.arange(n_boxes, dtype=np.int32)[:, None, None])
    return [("ground", V, F),
            ("city", vs.reshape(-1, 3), faces.reshape(-1, 3))]


@contextlib.contextmanager
def slim_threshold(config, n_tris: int):
    """The port's slim threshold set to ``n_tris`` for the block, then restored."""
    default = config.SLIM_PACK_MIN_TRIS
    config.SLIM_PACK_MIN_TRIS = n_tris
    try:
        yield
    finally:
        config.SLIM_PACK_MIN_TRIS = default


@contextlib.contextmanager
def timed_calls(mod, names):
    """Inside the block each ``mod.<name>`` adds its seconds to the dict
    yielded (a call reached through the module's global, as ``pack_scene``
    reaches its helpers)."""
    spent = {name: 0.0 for name in names}
    real = {name: getattr(mod, name) for name in names}

    def timer(name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    for name in names:
        setattr(mod, name, timer(name))
    try:
        yield spent
    finally:
        for name in names:
            setattr(mod, name, real[name])


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def host_peak_rss() -> int:
    """The process's peak resident set, bytes (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def host_memory() -> str:
    """MemTotal and MemAvailable of /proc/meminfo, GiB."""
    fields = {}
    with open("/proc/meminfo", encoding="ascii") as f:
        for line in f:
            key, value = line.split(":", 1)
            fields[key] = int(value.split()[0]) * 1024
    return (f"host memory {fields['MemTotal'] / 2**30:.1f} GiB, "
            f"{fields['MemAvailable'] / 2**30:.1f} GiB available")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class DeviceMemory:
    """Bytes tensors hold on a card over what they held at :meth:`reset`:
    resident now, and the peak since. None on the CPU."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.base = 0

    def reset(self) -> None:
        if self.dev.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
            self.base = torch.cuda.memory_allocated(self.dev)

    def resident(self):
        if self.dev.type != "cuda":
            return None
        return torch.cuda.memory_allocated(self.dev) - self.base

    def peak(self):
        if self.dev.type != "cuda":
            return None
        return torch.cuda.max_memory_allocated(self.dev) - self.base


def per_tri(n_bytes, n_tri_pad: int):
    return None if n_bytes is None else n_bytes / n_tri_pad


def gate_shape(n_tri_pad: int) -> dict:
    """The sweep's tiles and the gate's boxes at ``n_tri_pad`` padded
    triangles, as the wrappers decide them."""
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.ops.trace_cuda import (
        _resolve_gate_window, gate_group_size, sweep_tile_width,
    )

    tile = sweep_tile_width(n_tri_pad, T.PALLAS_TRI_TILE)
    n_tiles = n_tri_pad // tile
    group = gate_group_size(n_tiles)
    n_boxes = -(-n_tiles // group)
    return dict(tile=tile, n_tiles=n_tiles, group=group, n_boxes=n_boxes,
                phantoms=n_boxes * group - n_tiles, window=_resolve_gate_window(group))


def prepare(ps, dev: torch.device, mem: DeviceMemory) -> tuple:
    """The scene pack of ``ps`` with the boxes, as the solve builds it,
    with its set-up seconds split into flattening, Morton order, tile
    bounds, the slim pack's build and the rest (padding, sid, uploads)."""
    from raystrack_tpu_torch import prepared

    mem.reset()
    t0 = time.perf_counter()
    ps.get_scene(use_accel=True)
    t_flat = time.perf_counter() - t0
    t0 = time.perf_counter()
    with timed_calls(prepared, ("morton_order", "_tile_bounds", "_build_pack_resident")) as s:
        pack = ps.get_scene_pack(use_accel=True, device=dev)
        sync(dev)
    t_pack = time.perf_counter() - t0
    setup = dict(flatten_s=t_flat, morton_s=s["morton_order"], tile_bounds_s=s["_tile_bounds"],
                 pack_build_s=s["_build_pack_resident"],
                 padding_and_uploads_s=t_pack - sum(s.values()), pack_scene_s=t_pack,
                 total_s=t_flat + t_pack)
    out = dict(setup_s=setup, slim=pack.slim, n_tri=pack.n_tri, n_tri_pad=pack.n_tri_pad,
               resident_bytes=mem.resident(), peak_bytes=mem.peak(),
               host_peak_rss_bytes=host_peak_rss())
    out["resident_bytes_per_tri"] = per_tri(out["resident_bytes"], pack.n_tri_pad)
    out["peak_bytes_per_tri"] = per_tri(out["peak_bytes"], pack.n_tri_pad)
    log(f"scene pack: slim={pack.slim} n_tri={pack.n_tri:,} n_tri_pad={pack.n_tri_pad:,}; "
        f"set-up {setup['total_s']:.1f} s (flatten {t_flat:.1f}, Morton order "
        f"{setup['morton_s']:.1f}, tile bounds {setup['tile_bounds_s']:.1f}, pack build "
        f"{setup['pack_build_s']:.1f}, padding and uploads {setup['padding_and_uploads_s']:.1f}); "
        f"host peak RSS {out['host_peak_rss_bytes'] / 2**30:.2f} GiB; " + (
            f"device resident {out['resident_bytes'] / 2**30:.3f} GiB = "
            f"{out['resident_bytes_per_tri']:.1f} B per padded triangle, peak "
            f"{out['peak_bytes'] / 2**30:.3f} GiB = {out['peak_bytes_per_tri']:.1f} B"
            if dev.type == "cuda" else "device memory not measured (CPU)"))
    return pack, out


def operands(pack, dev: torch.device):
    """The sweep operands of the r05 cases: the ground (sid 0) emits, every
    other surface receives, no half-matrix cut and no plane cull. A slim
    pack: its resident pack, the mask from the surface ids and the two
    codes; a full one: the baked pack, as ``emitter_operands`` builds it."""
    from raystrack_tpu_torch.ops import trace as T

    ext = torch.zeros(pack.n_surf + 1, dtype=torch.int32, device=dev)
    ext[1:-1] = 1
    if pack.slim:
        mask, bounds = T.slim_operands(pack.sid, ext, 0, 0)
        return pack.tri_pack, mask, bounds
    scene = (pack.v0, pack.e1, pack.e2, pack.cross_e, pack.w_u, pack.w_v, pack.d0, pack.sid)
    tri_pack, mask = T.emitter_operands(scene, ext, 0, 0)
    return tri_pack, mask, None


def chunk(ops, pack, em, n_rays: int, n_once: int, seed: int, gated: bool, dev):
    """One iteration of ``chunk_body`` on the first ``n_rays`` rays of the
    ground's tables: its outputs, left on the device."""
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.solver import _cp_rows, _emission_geometry, _ray_tables

    tri_pack, mask, bounds = ops
    tables = tuple(t[:n_rays] for t in _ray_tables(em))
    cp = torch.from_numpy(_cp_rows(seed, 0, 0, 1)).to(dev)
    return T.chunk_body(tri_pack, mask, tables, _emission_geometry(em), cp, pack.n_surf,
                        n_once, accel=pack.accel if gated else None, code_bounds=bounds)


def sweep_cases(ops, pack, em, dev, reps: int = 3) -> dict:
    """The r05 cases and the ungated full ray set: front hits (seed 0) and
    the best of ``reps`` timed runs (seeds 1..reps; the full ungated case
    times its one run). Gated == ungated front and back counts on the
    subset and on the full set."""
    n_full, once = em.n_rays_pad, em.n_rays_once
    n_sub = min(n_full, SUB_BLOCKS * RAY_SUB)
    cases = (("accel", True, n_full, once, reps), ("accel_sub", True, n_sub, min(once, n_sub), 1),
             ("brute_sub", False, n_sub, min(once, n_sub), 1), ("brute", False, n_full, once, 0))
    counts, hits, best, times = {}, {}, {}, {}
    for label, gated, n_rays, n_once, n_reps in cases:
        t0 = time.perf_counter()
        out = chunk(ops, pack, em, n_rays, n_once, 0, gated, dev)
        counts[label] = (out["counts_f"].cpu(), out["counts_b"].cpu())
        first = time.perf_counter() - t0
        hits[label] = int(counts[label][0].sum())
        runs = []
        for rep in range(n_reps):
            t0 = time.perf_counter()
            out = chunk(ops, pack, em, n_rays, n_once, rep + 1, gated, dev)
            int(out["counts_f"].sum())  # waits for the chunk
            runs.append(time.perf_counter() - t0)
        times[label] = runs or [first]
        best[label] = min(times[label])
        log(f"{label}: {n_rays:,} rays ({n_once:,} real), {'gated' if gated else 'ungated'}: "
            f"front hits {hits[label]}, back hits {int(counts[label][1].sum())}; first run "
            f"{first:.3f} s, timed {[round(t, 4) for t in times[label]]} -> "
            f"{n_rays / best[label]:,.0f} rays/s")
    for a, b, which in (("accel_sub", "brute_sub", "the 24-block subset"),
                        ("accel", "brute", "the full ray set")):
        same = all(torch.equal(x, y) for x, y in zip(counts[a], counts[b]))
        log(f"gated == ungated on {which} (front and back counts per surface): {same}")
        if not same:
            raise SystemExit(f"FAILED: the gate changed the counts: {a} {counts[a]} != "
                             f"{b} {counts[b]}")
    return dict(n_full=n_full, n_sub=n_sub, hits=hits, best_s=best, times_s=times,
                counts={k: [v[0].tolist(), v[1].tolist()] for k, v in counts.items()})


def chunk_rays(pack, em, dev) -> torch.Tensor:
    """The (9, N) rays of the gated full chunk (seed 0), coherence-sorted as
    ``chunk_body`` sorts them."""
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.solver import _cp_rows, _emission_geometry, _ray_tables

    cp = torch.from_numpy(_cp_rows(0, 0, 0, 1)).to(dev)
    o, d = T.generate_rays(_ray_tables(em), _emission_geometry(em), cp)
    valid = (torch.arange(em.n_rays_pad, device=dev) < em.n_rays_once)[None]
    o, d, _ = T._sorted_for_gate(o, d, valid, pack.accel)
    return T.ray_pack(o, d)


@contextlib.contextmanager
def forced_launch(split=None, gate=None):
    """Inside the block the sweep wrappers launch at ``split`` (a
    ``SweepGeometry``, or a bare int: a whole 256-ray block a CTA at that
    many threads a ray; else the rule's geometry) and, with ``gate``, on
    these prebuilt tables (else they build their own)."""
    from raystrack_tpu_torch.ops import trace_cuda

    real = trace_cuda.sweep_split, trace_cuda._gate_for
    if split is not None:
        trace_cuda.sweep_split = lambda n_blocks, gated, n_sms: split
    if gate is not None:
        trace_cuda._gate_for = lambda *args: gate
    try:
        yield
    finally:
        trace_cuda.sweep_split, trace_cuda._gate_for = real


def kernel_launches(ops, pack, em, dev, reps: int = 3) -> list:
    """Kernel #1 alone on the gated full chunk's rays (coherence-sorted as
    ``chunk_body`` sorts them), gated (tables prebuilt; best of ``reps``) and
    ungated (one run), by CUDA events, each at the geometry the wrapper's
    rule picks and at a whole 256-ray block a CTA (the geometry before CTAs
    served part of a block: ``trace_cuda._whole_block``): ms, the (block,
    tile) visits of the 256-ray walk (the tiles any CTA of a block swept:
    the same at every geometry) and its pairs, the launch's own pair tests
    (each CTA's swept tiles x its rays x the tile) and the bound, the
    larger of the bytes the launch must move over the card's memory rate
    and ``FP32_PER_PAIR`` FP32 instructions a pair of the walk over its
    issue rate. Gated == ungated over the whole chunk at every geometry,
    and the gated launch's first ``SUB_BLOCKS`` blocks == its plain gated
    version on them at the rule's geometry (codes, flags and each CTA's
    visits; the tables' rows of those blocks)."""
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.ops import trace_cuda

    tri_pack, mask, bounds = ops
    rays = chunk_rays(pack, em, dev)
    n_tri_pad, n = tri_pack.shape[1], rays.shape[1]
    n_blocks = -(-n // RAY_SUB)
    shape = gate_shape(n_tri_pad)
    tile = shape["tile"]
    tiles_on = mask.reshape(-1, tile).any(dim=1).to(torch.int32)
    kw = dict(tri_tile=T.PALLAS_TRI_TILE, want_matrix=True, want_any=False,
              masks_baked=bounds is None, code_bounds=bounds)

    def timed(fn, n_reps):
        best, out = None, None
        for _ in range(n_reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize(dev)
            t = start.elapsed_time(end)
            best = t if best is None else min(best, t)
        return best, out

    table_ms, gate = timed(lambda: trace_cuda._gate_for(
        pack.accel, rays, n_tri_pad, tile, T.PALLAS_TRI_TILE, dev), reps)
    runs, ref = [], None
    for gated in (True, False):
        rule = trace_cuda._launch_geometry(n, gated, dev)
        for geo in (rule, trace_cuda._whole_block(n_blocks, gated, trace_cuda._sm_count(dev))):
            accel = pack.accel if gated else None
            block = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
            cta = torch.zeros(geo.units(n), dtype=torch.int32, device=dev)
            with forced_launch(geo, gate if gated else None):
                ms, out = timed(lambda: trace_cuda.sweep_rays(  # noqa: B023
                    rays, tri_pack, mask, accel=accel, visits=block, **kw),  # noqa: B023
                    reps if gated else 1)
                if geo.per_block > 1:
                    trace_cuda.sweep_rays(rays, tri_pack, mask, accel=accel, visits=cta, **kw)
                else:
                    cta.copy_(block)
            ref = ref or out
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise SystemExit(f"FAILED: kernel #1 (gated={gated}) at {geo} != the gated "
                                 f"launch at the rule's geometry on the full chunk")
            runs.append((gated, geo, ms, block, cta))
    visits, cta_visits = runs[0][3], runs[0][4]
    if not torch.equal(runs[1][3], visits):
        raise SystemExit("FAILED: the whole-block walk's visits != the rule's launch's")
    rule = runs[0][1]
    k = min(SUB_BLOCKS, n_blocks)
    lead = slice(0, k * RAY_SUB)
    plain_visits = torch.zeros(rule.units(k * RAY_SUB), dtype=torch.int32, device=dev)
    plain_ms, plain = timed(lambda: trace_cuda.sweep_rays_reference(
        rays[:, lead].contiguous(), tri_pack, trace_cuda._gated_tiles_on(tiles_on, gate), tile,
        want_matrix=True, want_any=False, masks_baked=bounds is None, code_bounds=bounds,
        gate=gate.blocks(torch.arange(k, device=dev)), visits=plain_visits, split=rule), 1)
    same_plain = (torch.equal(plain[0], ref[0][lead]) and torch.equal(plain[1], ref[1][lead])
                  and torch.equal(plain_visits, cta_visits[: plain_visits.shape[0]]))
    log(f"kernel: the gated launch's first {k} blocks == its plain gated version at "
        f"{rule.name} (codes, flags, each CTA's visits): "
        f"{same_plain}; plain {plain_ms:.1f} ms")
    if not same_plain:
        raise SystemExit(f"FAILED: gated kernel #1 != its plain gated version on {k} blocks")
    n_bytes = (rays.numel() + tri_pack.numel() + tiles_on.numel()) * 4 + 8 * n
    gate_bytes = sum(t.numel() * t.element_size()
                     for t in (*pack.accel, gate.order, gate.counts))
    rows = []
    for gated, geo, ms, block, cta in runs:
        pairs = int(block.sum()) * RAY_SUB * tile
        t_ops = pairs * FP32_PER_PAIR / PEAK_FP32_INSTR * 1e3
        extra = gate_bytes if gated else 0
        t_bytes = (n_bytes + extra) / PEAK_BYTES * 1e3
        bound_ms, bound_by = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
        mode = "code mode" if bounds is not None else "baked"
        rows.append(dict(launch=f"kernel #1 {mode}, {'gated' if gated else 'ungated'}, "
                                f"{geo.name} (rays a CTA x threads a ray, segments)",
                         gated=gated, rays_a_cta=geo.rays, split=geo.split,
                         segments=geo.segments, per_thread=geo.per_thread, ms=ms,
                         visits=int(block.sum()), pairs=pairs,
                         own_pairs=int(cta.sum()) * geo.rays * tile, bytes=n_bytes + extra,
                         bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms))
        log(f"kernel: {rows[-1]['launch']} on {n:,} rays x {n_tri_pad:,} padded triangles "
            f"({shape['n_tiles']:,} tiles, {shape['n_boxes']:,} gate boxes of {shape['group']} "
            f"tiles): {ms:.3f} ms, {int(block.sum()):,} (block, tile) visits of the 256-ray "
            f"walk = {pairs:.4g} pair tests, the launch's own {rows[-1]['own_pairs']:.4g}; "
            f"bound {bound_ms:.3f} ms ({bound_by}), {bound_ms / ms:.1%} of it")
    rows[0].update(gate_tables_ms=table_ms, plain_ms=plain_ms, plain_blocks=k,
                   max_abs_err=max(int((plain[0] - ref[0][lead]).abs().max()),
                                   int((plain[1] - ref[1][lead]).abs().max())))
    rows[0]["visit_share"] = int(visits.sum()) / max(int(runs[2][3].sum()), 1)
    log(f"kernel: gate tables {table_ms:.3f} ms; the gate leaves {rows[0]['visit_share']:.4%} "
        f"of the ungated visits; gated == ungated codes and flags at every geometry: True")
    return rows


class SolveSpy:
    """Inside the block: the chunks the per-emitter route dispatched (the
    operand pack each swept), the scheduled rounds, and the launches of
    kernels #1, #2, the crossing and the count."""

    def __enter__(self):
        from raystrack_tpu_torch.ops import trace as T
        from raystrack_tpu_torch.ops.count_cuda import count_bins
        from raystrack_tpu_torch.ops.trace_cuda import gate_cross, sweep_rays, sweep_rays_scheduled

        self.T, self.packs, self.rounds = T, [], 0
        self.real = T.chunk_body, T.scheduled_trace
        self.counters = (sweep_rays, sweep_rays_scheduled, gate_cross, count_bins)
        self.before = self._counts()

        def chunk_body(*args, **kwargs):
            self.packs.append(args[0])
            return self.real[0](*args, **kwargs)

        def scheduled_trace(*args, **kwargs):
            self.rounds += 1
            return self.real[1](*args, **kwargs)

        T.chunk_body, T.scheduled_trace = chunk_body, scheduled_trace
        return self

    def _counts(self) -> dict:
        sweep_rays, sweep_rays_scheduled, gate_cross, count_bins = self.counters
        return dict(k1=sweep_rays.launches, k1_gated=sweep_rays.gated_launches,
                    k1_code=sweep_rays.code_launches, k2=sweep_rays_scheduled.launches,
                    cross=gate_cross.launches, count=count_bins.launches)

    def __exit__(self, *exc):
        self.T.chunk_body, self.T.scheduled_trace = self.real
        self.launches = {k: v - self.before[k] for k, v in self._counts().items()}
        return False


def bounded_solve(meshes, ps, dev, *, bvh: str) -> dict:
    """The r05 script's bounded ``view_factor_matrix`` (3 iterations of the
    ground), with its route: per-emitter chunks only, each on the scene's
    resident pack when it is slim, and on a card one launch of kernel #1
    (gated where ``bvh`` is on, in code mode on a slim pack), of the
    crossing (gated) and of the count a chunk."""
    from raystrack_tpu_torch import MatrixParams, view_factor_matrix

    params = MatrixParams(bvh=bvh, device="gpu" if dev.type == "cuda" else "cpu", **SOLVE)
    t0 = time.perf_counter()
    with SolveSpy() as spy:
        vf = view_factor_matrix(meshes, params, prepared=ps)
    seconds = time.perf_counter() - t0
    pack = ps.get_scene_pack(use_accel=bvh != "off", device=dev)
    n_chunks, on_card = len(spy.packs), dev.type == "cuda"
    gated = bvh != "off"
    want = dict(k1=n_chunks, k1_gated=n_chunks if gated else 0,
                k1_code=n_chunks if pack.slim else 0, k2=0,
                cross=n_chunks if gated else 0, count=n_chunks)
    if not on_card:  # CPU tensors run the plain versions: no launch
        want = {k: 0 for k in want}
    resident = [p is pack.tri_pack for p in spy.packs] if pack.slim else []
    f_city = sum(v for k, v in vf["ground"].items() if k.startswith("city"))
    log(f"bounded solve, bvh={bvh}: {seconds:.2f} s, {n_chunks} per-emitter chunks, "
        f"{spy.rounds} scheduled rounds; chunks on the resident pack {sum(resident)} of "
        f"{len(resident)}; launches {spy.launches}; F(ground->city) = {f_city!r}")
    if n_chunks == 0 or spy.rounds or spy.launches != want or not all(resident):
        raise SystemExit(f"FAILED: bounded solve bvh={bvh} took another route: "
                         f"{n_chunks} chunks, {spy.rounds} rounds, launches {spy.launches} "
                         f"(wanted {want}), resident {resident}")
    return dict(vf=vf, seconds=seconds, chunks=n_chunks, launches=spy.launches,
                ground_to_city=f_city)


def mode_run(meshes, ps, dev, mem, *, reps: int) -> dict:
    """Steps 2-5 in the mode the config gives: the scene pack, the ground's
    emitter pack, the sweeps, the kernel's launches (on a card), the
    bounded solve gated, then (the gated pack freed) with ``bvh="off"``."""
    pack, out = prepare(ps, dev, mem)
    shape = gate_shape(pack.n_tri_pad)
    out["gate"] = shape
    log(f"gate: {shape['n_tiles']:,} tiles of {shape['tile']}, groups of {shape['group']} "
        f"tiles over {shape['n_boxes']:,} boxes ({shape['phantoms']} phantom tiles in the "
        f"last group), early-exit window {shape['window']}")
    t0 = time.perf_counter()
    em = ps.get_emitter_pack(0, samples=1, rays=1, flip_faces=False, device=dev)
    sync(dev)
    out["emitter_pack_s"] = time.perf_counter() - t0
    log(f"emitter pack: {em.n_rays_pad:,} rays an iteration ({em.n_rays_once:,} real) in "
        f"{out['emitter_pack_s']:.1f} s (every mesh's emission tables); host peak RSS "
        f"{host_peak_rss() / 2**30:.2f} GiB")
    ops = operands(pack, dev)
    out["sweeps"] = sweep_cases(ops, pack, em, dev, reps)
    out["kernels"] = kernel_launches(ops, pack, em, dev, reps) if dev.type == "cuda" else []
    del ops
    solve = bounded_solve(meshes, ps, dev, bvh="builtin")
    out["solve"] = solve
    out["peak_bytes"] = mem.peak()
    out["peak_bytes_per_tri"] = per_tri(out["peak_bytes"], pack.n_tri_pad)
    if dev.type == "cuda":
        log(f"device peak over the pack, sweeps and gated solve: {out['peak_bytes'] / 2**30:.3f} "
            f"GiB = {out['peak_bytes_per_tri']:.1f} B per padded triangle")
    del pack, em
    ps.clear_device_cache()
    mem.reset()
    off = bounded_solve(meshes, ps, dev, bvh="off")
    out["solve_off"] = off
    out["off_peak_bytes"] = mem.peak()
    same = off["vf"] == solve["vf"]
    log(f"bounded solve: bvh='builtin' dict == bvh='off' dict: {same}")
    if not same:
        raise SystemExit(f"FAILED: bvh='builtin' {solve['vf']} != bvh='off' {off['vf']}")
    ps.clear_device_cache()
    mem.reset()
    out["host_peak_rss_bytes"] = host_peak_rss()
    return out


def run(n_tri: int, dev: torch.device, *, full: bool = False, reps: int = 3,
        extent: float = 100.0) -> dict:
    """Steps 1-7 on ``dev`` for the city of ``n_tri`` triangles on a ground
    of half-width ``extent``; returns the result entry (the last line's
    object, without the card line). On the CPU (a test at a tiny size) the
    kernels' plain versions run and nothing is timed by CUDA events."""
    from raystrack_tpu_torch import PreparedSolver, config

    log(f"device {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}); "
        f"n={n_tri:,}; {host_memory()}")
    t0 = time.perf_counter()
    meshes = city_meshes(n_tri, extent)
    gen_s = time.perf_counter() - t0
    n_real = sum(F.shape[0] for _, _, F in meshes)
    log(f"scene generated: {n_real:,} triangles ({meshes[1][2].shape[0] // 12:,} boxes) in "
        f"{gen_s:.1f} s")
    mem = DeviceMemory(dev)
    ps = PreparedSolver(meshes)
    slim = mode_run(meshes, ps, dev, mem, reps=reps)
    shape = slim["gate"]
    checks = [(slim["slim"], "the default config packed the scene full")]
    if shape["group"] > 1:
        checks.append((shape["window"] == 0, "a two-level gate kept its early-exit window"))
    if n_tri in EXPECTED:
        want = EXPECTED[n_tri]
        got = (slim["n_tri"], slim["n_tri_pad"], shape["group"], shape["n_boxes"])
        checks.append((got == want, f"(triangles, padded, group, boxes) {got} != {want}"))
    for ok, msg in checks:
        if not ok:
            raise SystemExit(f"FAILED: {msg}")
    sw = slim["sweeps"]
    entry = {
        "n_tri": n_tri, "rays_per_dispatch": sw["n_full"], "brute_subset_rays": sw["n_sub"],
        "accel": round(sw["n_full"] / sw["best_s"]["accel"]),
        "brute": round(sw["n_sub"] / sw["best_s"]["brute_sub"]),
        "brute_full": round(sw["n_full"] / sw["best_s"]["brute"]),
    }
    entry["speedup"] = round(entry["accel"] / entry["brute"], 2)
    entry.update(hits_full_accel=sw["hits"]["accel"], hits_equal_subset=sw["hits"]["accel_sub"],
                 hits_full_brute=sw["hits"]["brute"],
                 solve_3iter_s=round(slim["solve"]["seconds"], 1),
                 solve_ground_to_city=round(slim["solve"]["ground_to_city"], 6))
    for key, tpu in TPU_V5E.items():
        log(f"{key}: port {entry[key]}, the JAX package on a TPU v5e {tpu} (reference)")
    if abs(entry["solve_ground_to_city"] - TPU_V5E["solve_ground_to_city"]) > 1e-4 and \
            n_tri == CITY_TRIS:
        raise SystemExit(f"FAILED: F(ground->city) {entry['solve_ground_to_city']} is not "
                         f"within 1e-4 of the TPU's {TPU_V5E['solve_ground_to_city']}")
    entry.update(
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        scene_generate_s=gen_s, n_tri_real=n_real, n_tri_pad=slim["n_tri_pad"], gate=shape,
        setup_s=slim["setup_s"], emitter_pack_s=slim["emitter_pack_s"],
        pack_resident_bytes=slim["resident_bytes"],
        pack_resident_bytes_per_tri=slim["resident_bytes_per_tri"],
        device_peak_bytes=slim["peak_bytes"], device_peak_bytes_per_tri=slim["peak_bytes_per_tri"],
        off_solve_s=slim["solve_off"]["seconds"], off_device_peak_bytes=slim["off_peak_bytes"],
        sweep_times_s=sw["times_s"], sweep_counts=sw["counts"], kernels=slim["kernels"],
        solve_chunks=slim["solve"]["chunks"], solve_launches=slim["solve"]["launches"])
    if full:
        with slim_threshold(config, 2**62):
            fm = mode_run(meshes, ps, dev, mem, reps=reps)
        checks = [(not fm["slim"], "--full packed the scene slim"),
                  (fm["sweeps"]["counts"] == sw["counts"], "full-mode counts != slim counts"),
                  (fm["solve"]["vf"] == slim["solve"]["vf"], "full-mode dict != slim dict")]
        for ok, msg in checks:
            if not ok:
                raise SystemExit(f"FAILED: {msg}")
        log("full mode: counts of every sweep case == slim's; bounded solve dicts == slim's")
        entry["full"] = dict(
            setup_s=fm["setup_s"], pack_resident_bytes=fm["resident_bytes"],
            pack_resident_bytes_per_tri=fm["resident_bytes_per_tri"],
            device_peak_bytes=fm["peak_bytes"], device_peak_bytes_per_tri=fm["peak_bytes_per_tri"],
            accel=round(sw["n_full"] / fm["sweeps"]["best_s"]["accel"]),
            brute_full=round(sw["n_full"] / fm["sweeps"]["best_s"]["brute"]),
            sweep_times_s=fm["sweeps"]["times_s"], kernels=fm["kernels"],
            solve_3iter_s=fm["solve"]["seconds"], off_solve_s=fm["solve_off"]["seconds"],
            counts_equal_slim=True, dicts_equal_slim=True)
    entry["host_peak_rss_bytes"] = host_peak_rss()
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=CITY_TRIS, help="triangles (default 10^8)")
    ap.add_argument("--full", action="store_true",
                    help="repeat the sweeps and the solve with the pack forced to full mode")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("city_100m_torch.py needs a CUDA card: torch.cuda.is_available() "
                           "is false")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    entry = run(args.n, torch.device("cuda", torch.cuda.current_device()), full=args.full)
    entry["card"] = card
    print(json.dumps(entry), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
