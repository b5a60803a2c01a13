#!/usr/bin/env python3
"""Card smoke test of the PyTorch / CUDA port (raystrack_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``raystrack_tpu_torch/csrc`` (nvcc, at first
use), checks each bitwise against its plain PyTorch version at the shapes
the main path gives it, then drives ``view_factor_matrix`` on the card
through five scenes and checks each against its analytic or plain
reference:

1. card       name, power limit, torch and CUDA versions
2. build      nvcc build time and register/spill report
3. kernel #1  single-emitter sweep vs its plain version on the soup (98,304
              triangles x 262,144 rays), 6 output/mask variants
4. kernel #2  multi-emitter sweep vs its plain version on the soup8 round
              (98,432 triangles x 262,144 rays of 8 emitters), 3 variants,
              and vs kernel #1 per emitter on the same rays; then the count
              kernel vs its plain version on the codes of phases 3 and 4
5. plates     two parallel unit squares vs 0.1998249 (|err| <= 3e-4), scheduled
6. canyon     11-surface street canyon vs the analytic matrix (max |dF| <= 1e-4),
              scheduled
7. district   97 emitters: >= 90 non-empty rows; scheduled dict == the
              per-emitter route's; rounds and warm solve times of both
8. soup       one emitter (per-emitter route); equals phase 3's counts
9. soup8      8 emitters: scheduled dict == per-emitter dict == phase 4's counts
10. launches  kernel #1 once per per-emitter chunk, kernel #2 once per
              scheduled round, the count kernel once per chunk or round, all
              on card tensors, during phases 5-9

Kernel times are CUDA events: the kernel's best of 3, the plain version's
one comparison run. The last three lines are the kernels' JSON summary, the
card line and the result line. Any failed check exits non-zero before them.
Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PLATES_EXACT = 0.1998249
PLATES_TPU = 0.1998818169
SOUP_TRIS = 98304
SOUP_CHUNK = 4
SOUP8_RAYS = 8 * 4 * 8192  # emitters x iterations x rays per iteration


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def soup_meshes():
    """Emitter plate plus a 98,302-triangle cloud above it (the JAX
    package's bench.py headline scene)."""
    h = 8.0
    V = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    rng = np.random.default_rng(0)
    n_cloud = SOUP_TRIS - 2
    centers = rng.uniform([-8, -8, 2], [8, 8, 30], size=(n_cloud, 3))
    spans = rng.normal(scale=0.4, size=(n_cloud, 2, 3))
    Vc = np.concatenate(
        [centers, centers + spans[:, 0], centers + spans[:, 1]], axis=1
    ).reshape(-1, 3).astype(np.float32)
    Fc = np.arange(n_cloud * 3, dtype=np.int32).reshape(-1, 3)
    return [("emitter", V, F), ("cloud", Vc, Fc)]


def soup8_meshes():
    """The soup's cloud above eight 4 x 8 two-triangle plates that tile its
    16 x 16 ground at z = 0. Coplanar plates cull each other, so the cloud
    is every plate's only receiver."""
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    plates = []
    for i, x0 in enumerate((-8.0, -4.0, 0.0, 4.0)):
        for j, y0 in enumerate((-8.0, 0.0)):
            V = np.array([[x0, y0, 0], [x0 + 4, y0, 0], [x0 + 4, y0 + 8, 0],
                          [x0, y0 + 8, 0]], np.float32)
            plates.append((f"plate_{i}{j}", V, F.copy()))
    return plates + [soup_meshes()[1]]


def district_meshes(n_buildings: int = 96, extent: float = 60.0, seed: int = 3):
    """Ground plus one 12-triangle mesh per building (bench.py district)."""
    rng = np.random.default_rng(seed)
    V = np.array([[-extent, -extent, 0], [extent, -extent, 0],
                  [extent, extent, 0], [-extent, extent, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    box_f = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6],
                      [0, 4, 5], [0, 5, 1], [1, 5, 6], [1, 6, 2],
                      [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]], np.int32)
    meshes = [("ground", V, F)]
    cx = rng.uniform(-extent * 0.9, extent * 0.9, (n_buildings, 2))
    w = rng.uniform(1.5, 5.0, (n_buildings, 2))
    h = rng.uniform(4.0, 30.0, n_buildings)
    for i in range(n_buildings):
        x0, y0 = cx[i] - w[i]
        x1, y1 = cx[i] + w[i]
        vs = np.array([[x0, y0, 0.05], [x1, y0, 0.05], [x1, y1, 0.05],
                       [x0, y1, 0.05], [x0, y0, h[i]], [x1, y0, h[i]],
                       [x1, y1, h[i]], [x0, y1, h[i]]], np.float32)
        meshes.append((f"bld_{i:03d}", vs, box_f.copy()))
    return meshes


def square(name: str, z: float, flip: bool):
    V = np.array([[-0.5, -0.5, z], [0.5, -0.5, z], [0.5, 0.5, z], [-0.5, 0.5, z]],
                 np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return name, V, (F[:, [0, 2, 1]].copy() if flip else F)


def solve_cases():
    """The solves of phases 5-9 (also timed by chip_profile.py): name ->
    (meshes, MatrixParams), all on the card."""
    from raystrack_tpu_torch import MatrixParams
    from examples.ex00_street_canyon_geometry import build_street_canyon

    return {
        "plates": ([square("bottom", 0.0, False), square("top", 1.0, True)], MatrixParams(
            samples=32, rays=1024, seed=11, tol=1e-4, tol_mode="stderr",
            min_iters=40, max_iters=500, reciprocity=False, device="gpu")),
        # validation/validate_06_canyon_analytic_compare.py and common.py settings
        "canyon": (build_street_canyon(), MatrixParams(
            samples=8, rays=512, seed=31, tol=1e-4, tol_mode="stderr", min_iters=40,
            max_iters=500, bvh="builtin", convergence_interval=1, reciprocity=False,
            enforce_reciprocity_rowsum=False, flip_faces=False, device="gpu")),
        "district": (district_meshes(), MatrixParams(
            samples=1, rays=32, seed=7, max_iters=8, min_iters=4, tol=1e-3,
            reciprocity=True, device="gpu")),
        "soup": (soup_meshes(), MatrixParams(
            bvh="off", samples=1, rays=256, min_iters=SOUP_CHUNK,
            max_iters=SOUP_CHUNK, reciprocity=True, device="gpu")),
        # 8 emitters x 4 iterations x 8,192 rays: one scheduled round
        "soup8": (soup8_meshes(), MatrixParams(
            bvh="off", samples=2, rays=128, min_iters=SOUP_CHUNK,
            max_iters=SOUP_CHUNK, reciprocity=True, device="gpu")),
    }


def base_matrix(vf):
    """Fold ``_front``/``_back`` keys into per-receiver totals (as
    validation/common.py base_matrix does)."""
    out = {}
    for sender, row in vf.items():
        totals = {}
        for key, value in row.items():
            base = key.rsplit("_", 1)[0] if key.endswith(("_front", "_back")) else key
            totals[base] = totals.get(base, 0.0) + float(value)
        out[sender] = totals
    return out


def cuda_ms(fn, reps: int = 3):
    """Best-of-``reps`` time of ``fn()`` in ms, by CUDA events, and the
    last call's result."""
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best, out


def wall_times(fn, reps: int) -> list:
    """Sorted wall-clock seconds of ``reps`` calls of ``fn()``, each from a
    drained card to a drained card."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)


def spread(times: list) -> str:
    """``median (min-max, n runs)`` of sorted seconds."""
    return (f"median {float(np.median(times)):.4f} s "
            f"(min {times[0]:.4f}, max {times[-1]:.4f}, {len(times)} runs)")


def ptxas_lines(log: str) -> list:
    """ptxas -v lines naming each kernel instantiation, sweep_kernel as
    <matrix,any,baked>, sweep_sched_kernel as <matrix,any> and
    count_codes_kernel, beside its registers, shared memory and spills."""
    out, name = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?"
                      r"(sweep_(?:sched_)?kernel|count_codes_kernel)((?:ILb\d)?(?:ELb\d)*)E",
                      line)
        if m:
            flags = re.findall(r"b(\d)", m.group(2))
            name = m.group(1) + (f"<{','.join(flags)}>" if flags else "")
        elif "registers" in line or "spill" in line:
            out.append(f"{name} {line.strip()}")
    return out


def timed_once(fn):
    """One call of ``fn()``: (ms by CUDA events, result)."""
    return cuda_ms(fn, reps=1)


def phase_kernel(dev, soup_ps, seed: int):
    """Kernel #1 vs its plain version at the soup shape in all 6 variants."""
    from raystrack_tpu_torch.ops.trace import compute_masks, generate_rays, ray_pack
    from raystrack_tpu_torch.ops.trace_cuda import (
        build_tri_pack, sweep_rays, sweep_rays_reference, sweep_tile_width,
    )
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.solver import _cp_rows

    sp = soup_ps.get_scene_pack(use_accel=False, device=dev)
    em = soup_ps.get_emitter_pack(0, samples=1, rays=256, flip_faces=False, device=dev)
    scene = (sp.v0, sp.e1, sp.e2, sp.cross_e, sp.w_u, sp.w_v, sp.d0, sp.sid)
    cp = torch.from_numpy(_cp_rows(seed, 0, 0, SOUP_CHUNK)).to(dev)
    o, d = generate_rays(
        (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2),
        (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v, em.tri_n,
         em.tri_eps),
        cp,
    )
    rays = ray_pack(o, d)
    ext = torch.tensor([0, 1, 0], dtype=torch.int32, device=dev)
    m_any, m_mat = compute_masks(scene, ext, 0, 1, em.plane_vec)
    n, tpad = rays.shape[1], sp.n_tri_pad
    check(n == SOUP_CHUNK * 65536 and tpad == SOUP_TRIS, f"soup shape {n} x {tpad}")
    tile = sweep_tile_width(tpad, PALLAS_TRI_TILE)
    print(f"[kernel1] soup: {tpad} triangles x {n} rays = {n * tpad:.4g} pair tests, "
          f"tile {tile}")
    max_err = 0
    rows = {}
    valid = torch.full((SOUP_CHUNK,), em.n_rays_once, dtype=torch.int32, device=dev)
    for baked in (True, False):
        for wm, wa in ((True, False), (False, True), (True, True)):
            prim = m_any if wa else m_mat
            pack = build_tri_pack(scene, m_any, m_mat, bake=prim if baked else None)
            tiles_on = prim.reshape(-1, tile).any(dim=1).to(torch.int32)
            kern = lambda: sweep_rays(rays, pack, prim, tri_tile=PALLAS_TRI_TILE,  # noqa: E731
                                      want_matrix=wm, want_any=wa, masks_baked=baked)
            plain = lambda: sweep_rays_reference(rays, pack, tiles_on, tile,  # noqa: E731
                                                 want_matrix=wm, want_any=wa,
                                                 masks_baked=baked)
            ms, (c, a) = cuda_ms(kern)
            plain_ms, (cr, ar) = timed_once(plain)
            same = torch.equal(c, cr) and torch.equal(a, ar)
            err = max(int((c - cr).abs().max()), int((a - ar).abs().max()))
            max_err = max(max_err, err)
            name = f"{'matrix+any' if wm and wa else 'matrix' if wm else 'any'}," \
                   f"{'baked' if baked else 'rows'}"
            rows[(wm, wa, baked)] = (ms, plain_ms)
            print(f"[kernel1] {name:17s} equal={same} hits={int((c >= 0).sum())} "
                  f"blocked={int(a.sum())} kernel {ms:.3f} ms "
                  f"({n * tpad / ms * 1e3:.4g} tests/s) plain {plain_ms:.3f} ms "
                  f"({n * tpad / plain_ms * 1e3:.4g} tests/s)")
            check(same, f"kernel #1 != plain version in variant {name}")
    codes = sweep_rays(rays, build_tri_pack(scene, m_any, m_mat, bake=m_mat), m_mat,
                       tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False,
                       masks_baked=True)[0]
    front = int((codes == 3).sum())
    ms, plain_ms = rows[(True, False, True)]  # the solve's own variant
    return max_err, ms, plain_ms, front / n, (codes.view(SOUP_CHUNK, -1), valid, 2)


def phase_sched_kernel(round_args, round_kwargs, kernel1_ms: float):
    """Kernel #2 vs its plain version on one scheduled round, as the driver
    dispatched it, in all 3 variants; then vs kernel #1 per emitter."""
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.ops.trace_cuda import (
        RAY_SUBBLOCK, build_tri_pack, scheduled_tiles_on, sweep_rays,
        sweep_rays_scheduled, sweep_rays_scheduled_reference, sweep_tile_width,
    )

    (scene, tri_pack, tables, geom, cp, surf, emit, mins, once, plane,
     schedule, sel) = round_args
    sb, tri_tile = round_kwargs["sched_block"], T.PALLAS_TRI_TILE
    masks = T.combined_masks(scene, surf, emit, mins, plane)
    o, d, valid = T.scheduled_rays(tables, geom, cp, once, schedule, sel, sched_block=sb)
    rays = T.ray_pack(o, d)
    emap = schedule[:, 0].repeat_interleave(sb // RAY_SUBBLOCK)
    n, tpad, n_emit = rays.shape[1], tri_pack.shape[1], masks.shape[0]
    check(n == SOUP8_RAYS and n_emit == 8, f"soup8 round: {n} rays, {n_emit} emitters")
    tile = sweep_tile_width(tpad, tri_tile)
    print(f"[kernel2] soup8 round: {tpad} triangles x {n} rays of {n_emit} emitters "
          f"= {n * tpad:.4g} pair tests, tile {tile}, {schedule.shape[0]} schedule rows")
    max_err = 0
    times = {}
    outs = {}
    for wm, wa in ((True, False), (False, True), (True, True)):
        tiles_on = scheduled_tiles_on(masks, tile, want_matrix=wm, want_any=wa)
        kern = lambda: sweep_rays_scheduled(rays, tri_pack, masks, emap,  # noqa: E731
                                            tri_tile=tri_tile, want_matrix=wm,
                                            want_any=wa)
        plain = lambda: sweep_rays_scheduled_reference(  # noqa: E731
            rays, tri_pack, masks, emap, tiles_on, tile, want_matrix=wm, want_any=wa)
        ms, (c, a) = cuda_ms(kern)
        plain_ms, (cr, ar) = timed_once(plain)
        same = torch.equal(c, cr) and torch.equal(a, ar)
        max_err = max(max_err, int((c - cr).abs().max()), int((a - ar).abs().max()))
        name = "matrix+any" if wm and wa else "matrix" if wm else "any"
        times[(wm, wa)] = (ms, plain_ms)
        outs[(wm, wa)] = (c, a)
        print(f"[kernel2] {name:10s} equal={same} hits={int((c >= 0).sum())} "
              f"blocked={int(a.sum())} kernel {ms:.3f} ms "
              f"({n * tpad / ms * 1e3:.4g} tests/s; kernel #1 at the soup shape "
              f"{SOUP_CHUNK * 65536 * SOUP_TRIS / kernel1_ms * 1e3:.4g}) "
              f"plain {plain_ms:.3f} ms ({n * tpad / plain_ms * 1e3:.4g} tests/s)")
        check(same, f"kernel #2 != plain version in variant {name}")

    # the same rays through kernel #1, emitter by emitter, with row masks
    codes, any_hit = outs[(True, True)]
    ray_row = emap.repeat_interleave(RAY_SUBBLOCK)
    for e in range(n_emit):
        idx = torch.nonzero(ray_row == e).squeeze(1)
        m_any, m_mat = masks[e] > 0, masks[e] > 1
        c1, a1 = sweep_rays(rays.index_select(1, idx).contiguous(),
                            build_tri_pack(scene, m_any, m_mat), m_any,
                            tri_tile=tri_tile, want_matrix=True, want_any=True)
        check(torch.equal(codes[idx], c1) and torch.equal(any_hit[idx], a1),
              f"kernel #2 != kernel #1 for emitter row {e}")
    print(f"[kernel2] equal to kernel #1 (row masks) for each of the {n_emit} emitters")
    # the round's per-emitter front counts, for phase 9
    ray_ok = torch.arange(sb, device=valid.device)[None, :] < valid[:, None]
    c = torch.where(ray_ok.reshape(-1), outs[(True, False)][0], -1)
    fronts = {int(sel[e]): int((c[ray_row == e] == 2 * 8 + 1).sum()) for e in range(n_emit)}
    ms, plain_ms = times[(True, False)]  # the solve's own variant
    codes_rows = outs[(True, False)][0].view(schedule.shape[0], sb)
    return max_err, ms, plain_ms, fronts, (codes_rows, valid, surf.shape[1] - 1)


def phase_count(cases):
    """The count kernel vs its plain version on the codes the main path
    gives it: name -> (codes (rows, L), n_valid (rows,), n_surf)."""
    from raystrack_tpu_torch.ops.count_cuda import count_codes, count_codes_reference

    max_err, times = 0, {}
    for name, (codes, n_valid, n_surf) in cases.items():
        args = (codes, n_valid, n_surf)
        ms, (cf, cb) = cuda_ms(lambda: count_codes(*args))  # noqa: B023
        plain_ms, counts = timed_once(lambda: count_codes_reference(*args))  # noqa: B023
        counts = counts.view(codes.shape[0], n_surf, 2)
        same = torch.equal(cf, counts[:, :, 1]) and torch.equal(cb, counts[:, :, 0])
        max_err = max(max_err, int((cf - counts[:, :, 1]).abs().max()),
                      int((cb - counts[:, :, 0]).abs().max()))
        times[name] = (ms, plain_ms)
        print(f"[count] {name}: {codes.shape[0]} rows x {codes.shape[1]} codes, "
              f"{n_surf} surfaces: equal={same} hits={int(cf.sum() + cb.sum())} "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
        check(same, f"count kernel != plain version on {name}")
    return max_err, times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "validation"))
    import raystrack_tpu_torch.solver as solver_mod
    from raystrack_tpu_torch import PreparedSolver, config, view_factor_matrix
    from raystrack_tpu_torch.ops import build
    from raystrack_tpu_torch.ops import trace as trace_mod
    from raystrack_tpu_torch.ops.count_cuda import count_codes
    from raystrack_tpu_torch.ops.trace_cuda import sweep_rays, sweep_rays_scheduled
    from raystrack_tpu_torch.prepared import EmitterPack
    from analytic import canyon_ground_truth

    # 1. card
    card = card_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(dev)}")

    # 2. build
    t0 = time.perf_counter()
    b = build.build()
    print(f"[build] {b.path.name}: nvcc {b.seconds:.2f} s, "
          f"build() {time.perf_counter() - t0:.2f} s")
    for line in ptxas_lines(b.log):
        print(f"[build] {line}")

    # 3. kernel #1 vs plain
    cases = solve_cases()
    soup, soup_params = cases["soup"]
    soup_ps = PreparedSolver(soup)
    max_err, ms, plain_ms, soup_front, soup_codes = phase_kernel(
        dev, soup_ps, soup_params.seed)

    # 4. kernel #2 vs plain, on the round the soup8 solve dispatches
    soup8, soup8_params = cases["soup8"]
    soup8_ps = PreparedSolver(soup8)
    real_round = trace_mod.scheduled_trace
    captured = []

    def capture(*args, **kwargs):
        captured.append((args, kwargs))
        return real_round(*args, **kwargs)

    trace_mod.scheduled_trace = capture
    view_factor_matrix(soup8, soup8_params, prepared=soup8_ps)
    trace_mod.scheduled_trace = real_round
    check(len(captured) == 1, f"soup8 took {len(captured)} scheduled rounds, not 1")
    max_err2, ms2, plain_ms2, soup8_fronts, soup8_codes = phase_sched_kernel(
        *captured[0], ms)
    del captured
    max_err3, count_times = phase_count({"soup chunk": soup_codes, "soup8 round": soup8_codes})
    del soup_codes, soup8_codes
    ms3, plain_ms3 = count_times["soup8 round"]

    # phases 5-9 run the main path: count its chunks, rounds and launches
    def on_card(x) -> bool:
        if isinstance(x, torch.Tensor):
            return x.is_cuda
        if isinstance(x, (tuple, list)):
            return all(on_card(v) for v in x)
        return True

    dispatches, rounds = [], []
    dispatch = solver_mod._EmitterRun.dispatch_chunk

    def counted(self, chunk):
        harvest = dispatch(self, chunk)
        dispatches.append(on_card(
            [self.tri_pack, self.sweep_mask]
            + [getattr(self.scene_pack, f.name) for f in dataclasses.fields(self.scene_pack)]
            + [getattr(self.em_pack, f.name) for f in dataclasses.fields(EmitterPack)]))
        return harvest

    def counted_round(*args, **kwargs):
        rounds.append(on_card(args))
        return real_round(*args, **kwargs)

    solver_mod._EmitterRun.dispatch_chunk = counted
    trace_mod.scheduled_trace = counted_round
    progress = []  # per-emitter progress lines: hundreds, summarised below
    solver_mod._log = progress.append
    sweep_rays.launches = 0
    sweep_rays_scheduled.launches = 0
    count_codes.launches = 0

    def route_solve(route, solve):
        """(result, rounds, chunks) of one solve through ``route``."""
        config.SCHEDULER = route
        r0, c0 = len(rounds), len(dispatches)
        out = solve()
        config.SCHEDULER = "auto"
        return out, len(rounds) - r0, len(dispatches) - c0

    # 5. plates
    plates, plates_params = cases["plates"]
    t0 = time.perf_counter()
    vf, n_rounds, n_chunks = route_solve("auto", lambda: view_factor_matrix(
        plates, plates_params))
    f = vf["bottom"]["top_front"]
    err = abs(f - PLATES_EXACT)
    print(f"[plates] F(bottom->top_front) = {f!r} |err| = {err:.3e} "
          f"({time.perf_counter() - t0:.2f} s, {n_rounds} scheduled rounds, "
          f"{n_chunks} per-emitter chunks); equals the TPU's {PLATES_TPU}: "
          f"{abs(f - PLATES_TPU) < 5e-11}")
    check(err <= 3e-4, f"plates |err| {err} > 3e-4")
    check(n_rounds > 0 and n_chunks == 0, "plates did not take the scheduled route")

    # 6. canyon
    canyon, canyon_params = cases["canyon"]
    names = [name for name, _, _ in canyon]
    t0 = time.perf_counter()
    vf, n_rounds, n_chunks = route_solve("auto", lambda: view_factor_matrix(
        canyon, canyon_params))
    got = base_matrix(vf)
    canyon_s = time.perf_counter() - t0
    truth = canyon_ground_truth()
    diff, pair = max(
        (abs(got[s].get(r, 0.0) - truth[s].get(r, 0.0)), (s, r))
        for s in names for r in names
    )
    print(f"[canyon] max |dF| = {diff:.3e} at {pair[0]} -> {pair[1]} "
          f"(solve {canyon_s:.3f} s, {n_rounds} scheduled rounds, "
          f"{n_chunks} per-emitter chunks)")
    check(diff <= 1e-4, f"canyon max |dF| {diff} > 1e-4")
    check(n_rounds > 0 and n_chunks == 0, "canyon did not take the scheduled route")

    # 7. district, through both routes
    district, district_params = cases["district"]
    district_ps = PreparedSolver(district)
    solve = lambda: view_factor_matrix(district, district_params,  # noqa: E731
                                       prepared=district_ps)
    t0 = time.perf_counter()
    vf, n_rounds, n_chunks = route_solve("auto", solve)
    cold_s = time.perf_counter() - t0
    n_rows = sum(1 for row in vf.values() if row)
    k2 = sweep_rays_scheduled.launches
    warm, _, _ = route_solve("auto", lambda: wall_times(solve, 5))
    print(f"[district] {len(district)} emitters, {n_rows} non-empty rows; scheduled: "
          f"{n_rounds} rounds, {n_chunks} per-emitter chunks, first solve {cold_s:.3f} s, "
          f"warm solve {spread(warm)}")
    check(n_rows >= 90, f"district: {n_rows} non-empty rows < 90")
    check(n_rounds > 0 and n_chunks == 0, "district did not take the scheduled route")
    k2 = sweep_rays_scheduled.launches - k2
    vf_pe, _, pe_chunks = route_solve("grouped", solve)
    warm_pe, _, _ = route_solve("grouped", lambda: wall_times(solve, 5))
    print(f"[district] per-emitter route: {pe_chunks} chunks, warm solve {spread(warm_pe)}; "
          f"kernel #2 launches in the 5 warm scheduled solves: {k2} "
          f"({k2 / 5:.1f} rounds per solve); dicts identical: {vf_pe == vf}")
    check(vf_pe == vf, "district: scheduled dict != per-emitter dict")

    # 8. soup through the entry point (one emitter: the per-emitter route)
    solve = lambda: view_factor_matrix(soup, soup_params, prepared=soup_ps)  # noqa: E731
    vf, n_rounds, n_chunks = route_solve("auto", solve)
    soup_times = wall_times(solve, 3)
    tests = SOUP_CHUNK * 65536 * SOUP_TRIS
    f = vf["emitter"].get("cloud_front", 0.0)
    print(f"[soup] F(emitter->cloud_front) = {f!r}; {n_chunks} chunks, {n_rounds} rounds; "
          f"warm solve {spread(soup_times)} "
          f"= {tests / float(np.median(soup_times)):.4g} tests/s at the median")
    check(f == soup_front, f"soup solve F {f} != kernel phase counts {soup_front}")
    check(n_rounds == 0 and n_chunks == 1, "soup did not take the per-emitter route")

    # 9. soup8 through both routes
    solve = lambda: view_factor_matrix(soup8, soup8_params, prepared=soup8_ps)  # noqa: E731
    vf, n_rounds, _ = route_solve("auto", solve)
    warm, _, _ = route_solve("auto", lambda: wall_times(solve, 5))
    vf_pe, _, pe_chunks = route_solve("grouped", solve)
    warm_pe, _, _ = route_solve("grouped", lambda: wall_times(solve, 5))
    print(f"[soup8] scheduled: {n_rounds} round(s), warm solve {spread(warm)} = "
          f"{SOUP8_RAYS * 98432 / float(np.median(warm)):.4g} tests/s at the median; "
          f"per-emitter: {pe_chunks} chunks, warm solve {spread(warm_pe)}; "
          f"dicts identical: {vf_pe == vf}")
    check(vf_pe == vf, "soup8: scheduled dict != per-emitter dict")
    for e, front in soup8_fronts.items():
        name = soup8[e][0]
        check(vf[name].get("cloud_front", 0.0) == front / (SOUP8_RAYS // 8),
              f"soup8 {name}: solve F != kernel #2 phase counts")
    print(f"[soup8] F(plate -> cloud_front) of all 8 plates equal phase 4's counts")

    # 10. launches
    launches, launches2 = sweep_rays.launches, sweep_rays_scheduled.launches
    launches3 = count_codes.launches
    solver_mod._EmitterRun.dispatch_chunk = dispatch
    trace_mod.scheduled_trace = real_round
    parsed = [re.search(r"\[(.+?)\] (\d+) iter", line) for line in progress]
    print(f"[launches] {len(progress)} progress lines, e.g. {progress[0]!r}")
    check(all(parsed), "a progress line lost its '[name] K iter' format")
    print(f"[launches] kernel #1: {launches} launches for {len(dispatches)} per-emitter "
          f"chunks; kernel #2: {launches2} launches for {len(rounds)} scheduled rounds; "
          f"on cuda in every chunk and round: {all(dispatches) and all(rounds)}")
    check(launches > 0 and launches == len(dispatches),
          f"{launches} kernel #1 launches != {len(dispatches)} chunks")
    check(launches2 > 0 and launches2 == len(rounds),
          f"{launches2} kernel #2 launches != {len(rounds)} rounds")
    print(f"[launches] count kernel: {launches3} launches for "
          f"{len(dispatches) + len(rounds)} chunks and rounds")
    check(launches3 == len(dispatches) + len(rounds),
          f"{launches3} count kernel launches != {len(dispatches) + len(rounds)} "
          f"chunks and rounds")
    check(all(dispatches) and all(rounds), "a chunk or round ran with a tensor off the card")

    print(json.dumps({"kernels": [{
        "name": "sweep_rays",
        "route": "cuda",
        "source": "raystrack_tpu_torch/csrc/sweep.cu",
        "replaces": "raystrack_tpu/ops/trace_pallas.py:1453",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "sweep_rays_scheduled",
        "route": "cuda",
        "source": "raystrack_tpu_torch/csrc/sweep.cu",
        "replaces": "raystrack_tpu/ops/trace_pallas.py:1267",
        "launches": launches2,
        "max_abs_err": max_err2,
        "ms": ms2,
        "plain_ms": plain_ms2,
    }, {
        "name": "count_codes",
        "route": "cuda",
        "source": "raystrack_tpu_torch/csrc/count.cu",
        # not a Pallas kernel: the XLA compare-and-sum it stands in for
        "replaces": "raystrack_tpu/ops/trace.py:865",
        "launches": launches3,
        "max_abs_err": max_err3,
        "ms": ms3,
        "plain_ms": plain_ms3,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
