#!/usr/bin/env python3
"""Card smoke test of the PyTorch / CUDA port (raystrack_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the CUDA kernel from ``raystrack_tpu_torch/csrc`` (nvcc, at first
use), checks it bitwise against its plain PyTorch version at the benchmark
soup shape (98,304 triangles x 262,144 rays, all 6 output/mask variants),
then drives ``view_factor_matrix`` on the card through four scenes and
checks each against its analytic or plain reference:

1. card       name, power limit, torch and CUDA versions
2. build      nvcc build time and register/spill report
3. kernel     kernel vs plain version on the soup; times (CUDA events, best of 3)
4. plates     two parallel unit squares vs 0.1998249 (|err| <= 3e-4)
5. canyon     11-surface street canyon vs the analytic matrix (max |dF| <= 1e-4)
6. district   97 emitters: >= 90 non-empty rows, warm solve wall time
7. soup       the soup through view_factor_matrix; equals phase 3's counts
8. launches   every chunk of phases 4-7 launched the kernel on card tensors

The last two lines are the kernels' JSON summary and the result line. Any
failed check exits non-zero before them. Imports nothing of JAX.
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
    """The solves of phases 4-7 (also timed by chip_profile.py): name ->
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


def cuda_ms(fn, reps: int = 3) -> float:
    """Best-of-``reps`` time of ``fn()`` in ms, by CUDA events."""
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


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
    """ptxas -v lines naming each kernel instantiation as <matrix,any,baked>
    beside its registers, shared memory and spills."""
    out, name = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?sweep_kernel"
                      r"ILb(\d)ELb(\d)ELb(\d)E", line)
        if m:
            name = "<{},{},{}>".format(*m.groups())
        elif "registers" in line or "spill" in line:
            out.append(f"sweep_kernel{name} {line.strip()}")
    return out


def phase_kernel(dev, soup_ps, seed: int):
    """Kernel vs plain version at the soup shape in all 6 variants."""
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
    print(f"[kernel] soup: {tpad} triangles x {n} rays = {n * tpad:.4g} pair tests, "
          f"tile {tile}")
    max_err = 0
    rows = {}
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
            c, a = kern()
            cr, ar = plain()
            torch.cuda.synchronize()
            same = torch.equal(c, cr) and torch.equal(a, ar)
            err = max(int((c - cr).abs().max()), int((a - ar).abs().max()))
            max_err = max(max_err, err)
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
            name = f"{'matrix+any' if wm and wa else 'matrix' if wm else 'any'}," \
                   f"{'baked' if baked else 'rows'}"
            rows[(wm, wa, baked)] = (ms, plain_ms)
            print(f"[kernel] {name:17s} equal={same} hits={int((c >= 0).sum())} "
                  f"blocked={int(a.sum())} kernel {ms:.3f} ms "
                  f"({n * tpad / ms * 1e3:.4g} tests/s) plain {plain_ms:.3f} ms "
                  f"({n * tpad / plain_ms * 1e3:.4g} tests/s)")
            check(same, f"kernel != plain version in variant {name}")
    codes = sweep_rays(rays, build_tri_pack(scene, m_any, m_mat, bake=m_mat), m_mat,
                       tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False,
                       masks_baked=True)[0]
    front = int((codes == 3).sum())
    ms, plain_ms = rows[(True, False, True)]  # the solve's own variant
    return max_err, ms, plain_ms, front / n


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "validation"))
    import raystrack_tpu_torch.solver as solver_mod
    from raystrack_tpu_torch import PreparedSolver, view_factor_matrix
    from raystrack_tpu_torch.ops import build
    from raystrack_tpu_torch.ops.trace_cuda import sweep_rays
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

    # 3. kernel vs plain
    cases = solve_cases()
    soup, soup_params = cases["soup"]
    soup_ps = PreparedSolver(soup)
    max_err, ms, plain_ms, soup_front = phase_kernel(dev, soup_ps, soup_params.seed)

    # phases 4-7 run the main path; count its chunks and kernel launches
    dispatches = []
    dispatch = solver_mod._EmitterRun.dispatch_chunk

    def counted(self, chunk):
        tensors = [self.tri_pack, self.sweep_mask] + [
            getattr(p, f.name) for p in (self.scene_pack, self.em_pack)
            for f in dataclasses.fields(p)
        ]
        dispatches.append(all(t.is_cuda for t in tensors if isinstance(t, torch.Tensor)))
        return dispatch(self, chunk)

    solver_mod._EmitterRun.dispatch_chunk = counted
    progress = []  # per-emitter progress lines: hundreds, summarised below
    solver_mod._log = progress.append
    sweep_rays.launches = 0

    # 4. plates
    plates, plates_params = cases["plates"]
    t0 = time.perf_counter()
    vf = view_factor_matrix(plates, plates_params)
    f = vf["bottom"]["top_front"]
    err = abs(f - PLATES_EXACT)
    print(f"[plates] F(bottom->top_front) = {f!r} |err| = {err:.3e} "
          f"({time.perf_counter() - t0:.2f} s); equals the TPU's {PLATES_TPU}: "
          f"{abs(f - PLATES_TPU) < 5e-11}")
    check(err <= 3e-4, f"plates |err| {err} > 3e-4")

    # 5. canyon
    canyon, canyon_params = cases["canyon"]
    names = [name for name, _, _ in canyon]
    t0 = time.perf_counter()
    got = base_matrix(view_factor_matrix(canyon, canyon_params))
    canyon_s = time.perf_counter() - t0
    truth = canyon_ground_truth()
    diff, pair = max(
        (abs(got[s].get(r, 0.0) - truth[s].get(r, 0.0)), (s, r))
        for s in names for r in names
    )
    print(f"[canyon] max |dF| = {diff:.3e} at {pair[0]} -> {pair[1]} "
          f"(solve {canyon_s:.3f} s)")
    check(diff <= 1e-4, f"canyon max |dF| {diff} > 1e-4")

    # 6. district
    district, district_params = cases["district"]
    district_ps = PreparedSolver(district)
    solve = lambda: view_factor_matrix(district, district_params,  # noqa: E731
                                       prepared=district_ps)
    t0 = time.perf_counter()
    vf = solve()
    cold_s = time.perf_counter() - t0
    n_rows = sum(1 for row in vf.values() if row)
    print(f"[district] {len(district)} emitters, {n_rows} non-empty rows; "
          f"first solve {cold_s:.3f} s, warm solve {spread(wall_times(solve, 5))}")
    check(n_rows >= 90, f"district: {n_rows} non-empty rows < 90")

    # 7. soup through the entry point
    solve = lambda: view_factor_matrix(soup, soup_params, prepared=soup_ps)  # noqa: E731
    vf = solve()
    soup_times = wall_times(solve, 3)
    tests = SOUP_CHUNK * 65536 * SOUP_TRIS
    f = vf["emitter"].get("cloud_front", 0.0)
    print(f"[soup] F(emitter->cloud_front) = {f!r}; warm solve {spread(soup_times)} "
          f"= {tests / float(np.median(soup_times)):.4g} tests/s at the median")
    check(f == soup_front, f"soup solve F {f} != kernel phase counts {soup_front}")

    # 8. launches
    launches = sweep_rays.launches
    solver_mod._EmitterRun.dispatch_chunk = dispatch
    parsed = [re.search(r"\[(.+?)\] (\d+) iter", line) for line in progress]
    print(f"[launches] {len(progress)} progress lines, e.g. {progress[0]!r}")
    check(all(parsed), "a progress line lost its '[name] K iter' format")
    print(f"[launches] {launches} kernel launches for {len(dispatches)} chunks; "
          f"packs on cuda in every chunk: {all(dispatches)}")
    check(launches > 0 and launches == len(dispatches),
          f"{launches} launches != {len(dispatches)} chunks")
    check(all(dispatches), "a chunk ran with a pack tensor off the card")

    print(json.dumps({"kernels": [{
        "name": "sweep_rays",
        "route": "cuda",
        "source": "raystrack_tpu_torch/csrc/sweep.cu",
        "replaces": "raystrack_tpu/ops/trace_pallas.py:1453",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
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
