#!/usr/bin/env python3
"""Card smoke test of the PyTorch / CUDA port (raystrack_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``raystrack_tpu_torch/csrc`` (nvcc, at first
use), checks each bitwise against its plain PyTorch version at the shapes
the main path gives it, then drives ``view_factor_matrix`` / ``view_factor``
on the card through seven scenes, and ``view_factor_to_tregenza_sky``,
``view_factor_matrix_and_sky`` and ``view_factor_outside_workflow`` through
the canyon and the 1M-triangle city, then the ray mesh and the
multi-process solve (``raystrack_tpu_torch.parallel``) on the city and the
district, the Halton tables built on the card for ex02's 89M-ray ground,
and the validation suite, and checks each against its analytic or plain
reference:

1. card       name, power limit, torch and CUDA versions
2. build      where the library was built, nvcc build time, register/spill
              report, FP32 instructions (and all instructions) per
              ray-triangle pair counted from each sweep kernel's SASS (at 1
              and 4 threads a ray) and per ray-box pair of the gate's
              crossing kernel (at 1, 2 and 4 boxes a thread)
3. kernel #1  single-emitter sweep vs its plain version on the soup (98,304
              triangles x 262,144 rays), 6 output/mask variants; the solve's
              variant also at 4 threads a ray (== 1, timed)
4. kernel #2  multi-emitter sweep vs its plain version on the soup8 round
              (100,352 padded triangles x 262,144 rays of 8 emitters), 3
              variants, and vs kernel #1 per emitter on the same rays; the
              sky's any-only and the workflow's matrix + any variants of
              both kernels (on the m_any-baked pack their solves build) beside
              their bounds, the FP32 SASS instructions a pair of the
              instantiation that launched; then the count kernel vs its plain
              version and torch.bincount on the codes of phases 3-4 and on
              a sky round's ids (the soup8 round's missed rays: 145 patch
              bins and 1 upward bin), measured as a kernel: device time a
              launch (200 launches enqueued behind a spin kernel, by CUDA
              events), the wrapper's host enqueue a call, the launch floor
              (the library's empty kernel, the same way) beside the bound
5. gate       on the 1M-triangle occluded city (bench.py's ``_city``), each
              kernel gated by the scene's AABBs, on the coherence-sorted
              rays of the first chunk (kernel #1, ground -> city) and round
              (kernel #2, the matrix of the city with its ground split into
              ten plates: 245,760 rays, all real) the solves
              dispatch: gated == ungated
              over all of them, gated == its plain gated version on the
              leading blocks, run at the kernel's 4 threads a ray
              (``split=4``) and unsplit: codes, flags, visits; times beside
              the bound, the share
              of (block, tile) visits the gate leaves, the gate-table build
              time; the gate's crossing kernel == its plain version on both
              inputs, with one box per tile and through the two-level gate,
              measured as the count kernel is, beside two bounds (its FP32
              instructions and all its instructions a pair), and the tables
              built through it == those built through the plain crossing,
              field by field; the count kernel on the gated chunk's codes
              and valid flags; then kernel #1 in its
              code_bounds mode (the slim pack-resident scene's) on the same
              chunk: == the baked kernel over the whole chunk and == its
              plain version on the leading blocks, gated and ungated, with
              times beside the baked kernel's and its SASS count per pair;
              and 32 blocks alone (a slim chunk that under-fills the card)
              ungated at 1 and at 4 threads a ray, equal and timed
6. plates     two parallel unit squares vs 0.1998249 (|err| <= 3e-4), scheduled
7. canyon     11-surface street canyon vs the analytic matrix (max |dF| <= 1e-4),
              scheduled
8. district   97 emitters: >= 90 non-empty rows; scheduled dict == the
              per-emitter route's; rounds and warm solve times of both
9. soup       one emitter (per-emitter route); equals phase 3's counts
10. soup8     8 emitters: scheduled dict == per-emitter dict == phase 4's counts
11. launches  kernel #1 once per per-emitter chunk, kernel #2 once per
              scheduled round, the count kernel once per chunk or round, all
              on card tensors, none of them gated, during phases 6-10
12. city      ``view_factor`` ground -> city (per-emitter route, kernel #1)
              and ``view_factor_matrix`` of both meshes and of the ten
              plates and the boxes (scheduled route, kernel #2), each with
              bvh="auto" (gated) == bvh="off" (dicts
              ``==``); warm walls, rays/s, peak device memory; one gated
              launch, and one launch of the gate's crossing kernel, per
              chunk or round of the gated solves, one ungated launch per
              chunk or round of the others
13. slim 1M   the same ground -> city solve and the ten-plate matrix with the
              scene pack slim (forced through config.SLIM_PACK_MIN_TRIS,
              restored after): dicts ``==`` phase 12's; per-emitter chunks
              only, one gated code-mode launch each, on the resident pack,
              no per-emitter pack built; peak device memory of both modes
14. slim 10M  ``view_factor`` ground -> city of the 10M-triangle city
              (10,000,384 padded, 4,883 tiles), bvh="auto", full mode then
              slim mode, each from a fresh PreparedSolver with the other's
              packs freed: dicts ``==``, set-up seconds, warm walls, peak
              device memory; then the full-mode scheduled matrix of ten
              and of two ground plates over each city's boxes, the same
              way; from the two sizes, the bytes per padded triangle of
              each mode and per emitter row of a round, and the sizes at
              which full mode's peaks would pass half the card's memory
              (the reckoning behind the default of SLIM_PACK_MIN_TRIS); the
              crossing kernel on the 10M chunk's rays and 4,883 boxes
15. kernel #3 the FP32 FMA-peak probe (1.374e11 dependent-chain FFMAs): best
              of 5 by CUDA events, FFMA/s and its share of the data sheet's
              33.5e12, the SM clock while it runs, every repeat against the
              plain version; the sweeps' share restated against it
16. canyon sky validation 07's settings, merged and discrete: the road's Sky
              within 1e-4 of 1 - sum(analytic F(road -> panels)), its 145
              patches within 1e-4 of the merged value, the scheduled dict
              == the per-emitter dict; warm walls of 5 on each route
17. workflow  the canyon's outside workflow, shareable parameters: scene +
              sky + Rest == 1 within 1e-9 per emitter; the shared-ray dicts
              == the separate matrix and sky solves', and == its per-emitter
              route's; warm walls of 3
18. city sky  ``city_plates`` (ten plates and the 1M city's boxes, all
              emitting), 6 iterations: merged and discrete sky gated ==
              ``bvh="off"`` == the per-emitter route == slim (threshold
              forced to 1, restored after); the shared-ray workflow gated ==
              off == per-emitter; per solve one launch of kernel #2 a round
              and of kernel #1 a chunk in the variant the dispatch asked for
              (any-only, matrix + any), gated exactly when bvh is on, one
              crossing-kernel launch a gated dispatch, one count launch an
              output, all on card tensors; warm walls, rays/s, peak device
              memory
19. resume    checkpoints, streaming, scene files and the CLI: ``city_plates``
              written with ``save_meshes_obj`` (file size, load time); a child
              ``python -m raystrack_tpu_torch matrix <file> --device gpu
              --checkpoint-dir --stream-out`` of 4 scheduled rounds SIGKILLed
              at its first progress snapshots (it fails the phase if it ends
              on its own); the same command again, in this process through
              the CLI's ``main``: it resumes from iteration 64, takes 3
              rounds, each one gated launch of kernel #2, and its streamed
              file == an uninterrupted ``view_factor_matrix`` of the file's
              meshes; a third solve on the same directory restores all 11
              emitters and launches nothing; the same kill for ground ->
              city (``view_factor``'s solve, the per-emitter route: 2
              chunks, then 1 on resume, gated kernel #1); the children load
              the library as built; the canyon's
              discrete sky and outside workflow crashed in ``_entry_done``
              and resumed, both routes, == uninterrupted; a
              ``RAYSTRACK_TPU_PROFILE`` trace naming kernel #2, one event a
              launch; warm walls of 5 of a 3-round ``city_plates`` matrix
              without ``checkpoint_dir``, with it, and with a snapshot after
              every round, beside the card's name and power limit
20. parallel  the ray mesh and the multi-process solve: ground -> city
              (per-emitter, gated kernel #1) and ``city_plates`` (one
              scheduled round, gated kernel #2) through
              ``view_factor_matrix(mesh=)`` on no mesh, ``ray_mesh()`` and
              logical meshes of 2 and 4 shards on this card, phase 12's
              ``PreparedSolver``s reused: dicts == unsharded == phase 12's,
              launches of #1, #2, the count and the crossing == shards x
              chunks or rounds, warm walls of 5, peak device bytes of a warm
              solve (4 shards within 5% of none: no replica multiplies);
              the district by two ``view_factor_matrix_multihost`` children
              (this script run as ``chip_smoke.py --multihost-child``) on
              gloo over localhost sharing the card, against one process:
              both merged dicts == ``view_factor_matrix``'s; on a node of
              several cards ``ray_mesh()`` spans them all
21. halton    the Halton device builder: 4,194,304 entries of each base, and
              the (u, v) grid of 2048 x 2048 cells, built on the card == the
              host build bitwise; the 89,458,688-entry
              tables of ex02's ground (examples/ex02_compare_sky_vf.py: the
              canyon and a ground plane, samples=16, rays=128) built on the
              card, timed, and == the exact radical inverse at >= 10,000
              indices (the first and last, every chunk seam, base**j - 1 and
              base**j, random ones); ex02's matrix at its own settings (the
              per-emitter route) from a fresh PreparedSolver: set-up (first
              - warm solve), the Halton builds' share, warm wall, peak device
              memory, and no host table of the ground's length built; at
              samples=1 (5,591,168 ground rays, the scheduled route) the
              dict with the device builder == with RAYSTRACK_TPU_DEVICE_HALTON=0
22. validation the nine cases of validation/ through the port
              (validate_torch.py) at their full settings, each within its
              own tolerance, beside the committed TPU values

Kernel times are CUDA events: the kernel's best of 3, the plain version's
one comparison run; the count and crossing kernels' ``ms`` is their device
time a launch, their wrapper's one call beside it. Each kernel's bound is
the larger of its bytes over
3.35 TB/s and its FP32 instructions (the SASS count per pair times the pair
tests it runs) over 33.5e12 per second, one per lane per clock: half the
H100 SXM data sheet's 67 TFLOP/s, which counts an FFMA as 2. The last three lines
are the kernels' JSON summary, the card line and the result line. Any failed
check exits non-zero before them. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
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
CITY_TRIS = 1_000_000
BIG_CITY_TRIS = 10_000_000  # bench.py's largest gated city: 4,883 tiles of 2048
CITY_PLAIN_BLOCKS = 64  # leading 256-ray blocks the plain gated versions run
RAY_SUB = 256  # rays per kernel block (trace_cuda.RAY_SUBBLOCK)
# H100 SXM data sheet: HBM3 bytes/s, and FP32 instructions/s: the sheet's
# 67 TFLOP/s counts an FFMA as 2 flops, so one FP32 instruction per lane
# per clock (132 SMs x 128 lanes x 1.98 GHz) is half of it
PEAK_BYTES = 3.35e12
PEAK_FP32_INSTR = 67e12 / 2


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


def city_meshes(n_tri: int = CITY_TRIS, extent: float = 100.0, seed: int = 0):
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


def city_plates_meshes(boxes=None, nx: int = 5):
    """The city with its 200 x 200 ground split into ``2 * nx`` plates of
    ``200 / nx`` x 100 (ten 40 x 100 plates by default, as soup8 splits the
    soup's ground) over ``boxes``, the 1M city's unless given. With
    reciprocity the boxes, listed last, receive from every plate and trace
    nothing themselves, so a round of the matrix holds only plate rows, each
    sweeping the boxes. At 1M the 999,996 box triangles and 20 plate
    triangles pad as the city's do."""
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    w = 200.0 / nx
    plates = []
    for i in range(nx):
        x0 = -100.0 + i * w
        for j, y0 in enumerate((-100.0, 0.0)):
            V = np.array([[x0, y0, 0], [x0 + w, y0, 0], [x0 + w, y0 + 100, 0],
                          [x0, y0 + 100, 0]], np.float32)
            plates.append((f"ground_{i}{j}", V, F.copy()))
    return plates + [city_meshes()[1] if boxes is None else boxes]


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
        # ground -> city, what view_factor(ground, city) solves: with
        # reciprocity the city has no receiver, so one emitter (per-emitter
        # route); 240,000 rays per iteration pad to chunks of 262,144
        "city": (city_meshes(), MatrixParams(
            samples=1, rays=6, min_iters=2, max_iters=2, reciprocity=True,
            device="gpu")),
        # both emitters (scheduled route): the city's 26.6M m2 at 0.005
        # samples per m2 is 133,225 rays per iteration, one round of
        # 4 iterations
        "city_matrix": (city_meshes(), MatrixParams(
            samples=0.005, rays=1, min_iters=4, max_iters=4, reciprocity=False,
            device="gpu")),
        # ten plates x 6 iterations x 4,096 rays: one scheduled round of
        # 245,760 rays, all real (2 blocks of 2,048 per plate and
        # iteration). samples=0 floors every emitter's grid at 4 x 4 cells,
        # 256 rays each: at 1 sample per m2 the boxes' 26.6M m2 would add
        # 26.6M cells of host Halton tables (40 s of set-up on the card's
        # host), though they trace nothing
        "city_plates": (city_plates_meshes(), MatrixParams(
            samples=0, rays=256, min_iters=6, max_iters=6, reciprocity=True,
            device="gpu")),
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


LAUNCHES = 200  # launches a kernel's device time and its wrapper's enqueue are averaged over
SPIN_NS = 50_000_000  # how long the spin kernel holds the card while they are enqueued


def launch_times(raw, wrapper) -> dict:
    """A small kernel measured as a kernel: ``raw()`` launches it through
    its C entry on outputs allocated beforehand, ``wrapper()`` is one call
    of its Python wrapper. Returns ms:

    - ``device_ms``: CUDA events around LAUNCHES back-to-back raw launches,
      over LAUNCHES; the launches are enqueued behind the library's spin
      kernel, so they run back to back on the card whatever the host's rate;
    - ``floor_ms``: the same loop over the library's empty kernel, the
      launch floor on this card;
    - ``call_device_ms``: the same loop over LAUNCHES wrapper calls: the
      card's time a call, a zero-fill before the kernel included;
    - ``enqueue_ms``: host ``perf_counter`` around LAUNCHES wrapper calls
      with no synchronise inside, over LAUNCHES;
    - ``raw_enqueue_ms``: the same for the raw launches, which must stay
      well inside the spin for ``device_ms`` to hold no host time.
    """
    from raystrack_tpu_torch.ops.build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    empty = lambda: lib.raystrack_empty(stream)  # noqa: E731
    out = {}
    def call() -> int:
        wrapper()
        return 0

    for key, fn in (("device_ms", raw), ("floor_ms", empty), ("call_device_ms", call)):
        check(fn() == 0, f"a launch was refused while timing {key}")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        check(lib.raystrack_spin(SPIN_NS, stream) == 0, "the spin kernel was refused")
        start.record()
        t0 = time.perf_counter()
        errs = sum(fn() != 0 for _ in range(LAUNCHES))
        enqueued = time.perf_counter() - t0
        end.record()
        end.synchronize()
        check(errs == 0, f"{errs} launches refused while timing {key}")
        out[key] = start.elapsed_time(end) / LAUNCHES
        if key == "device_ms":
            out["raw_enqueue_ms"] = enqueued / LAUNCHES * 1e3
        check(enqueued * 1e9 < 0.5 * SPIN_NS, f"the launches took longer to enqueue than "
              f"half the spin: {key} would hold host time")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LAUNCHES):
        wrapper()
    out["enqueue_ms"] = (time.perf_counter() - t0) / LAUNCHES * 1e3
    torch.cuda.synchronize()
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


KERNEL_SYMBOL = (r"(sweep_(?:sched_|code_)?kernel|count_codes_kernel|fma_peak_kernel|"
                 r"gate_cross_kernel)((?:IL[bi]\d+)?(?:EL[bi]\d+)*)E")


def kernel_name(match) -> str:
    """A kernel instantiation's name from its mangled symbol (a match of
    KERNEL_SYMBOL): sweep_kernel as ``sweep_kernel<matrix,any,baked,gate>``,
    sweep_code_kernel and sweep_sched_kernel as ``<matrix,any,gate>``, with
    ``x2`` or ``x4`` after it for 2 or 4 threads a ray (kSplit);
    gate_cross_kernel as ``gate_cross_kernel<K>``, K boxes a thread;
    count_codes_kernel as ``<shared>``."""
    flags = re.findall(r"Lb(\d)", match.group(2))
    split = re.findall(r"Li(\d+)", match.group(2))
    if match.group(1) == "gate_cross_kernel":
        return f"gate_cross_kernel<{split[0]}>"
    if match.group(1) == "count_codes_kernel":
        return f"count_codes_kernel<{','.join(split + flags)}>"
    return (match.group(1) + (f"<{','.join(flags)}>" if flags else "")
            + (f"x{split[0]}" if split and split[0] != "1" else ""))


def ptxas_lines(log: str) -> list:
    """ptxas -v lines naming each kernel instantiation (:func:`kernel_name`)
    beside its registers, shared memory and spills. The sources compile in
    parallel processes whose outputs follow one another in the log."""
    out, name = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?" + KERNEL_SYMBOL, line)
        if m:
            name = kernel_name(m)
        elif "registers" in line or "spill" in line:
            out.append(f"{name} {line.strip()}")
    return out


FP32_OPCODES = ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX")


def sass_functions(lib_path) -> dict:
    """The library's SASS (``cuobjdump -sass``) by kernel
    (:func:`kernel_name`, as ``"sweep_kernel<1,0,1,0>"``,
    ``"sweep_kernel<1,0,1,1>x2"``, ``"gate_cross_kernel"``) -> [(address,
    instruction)]."""
    from raystrack_tpu_torch.ops.build import find_nvcc

    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    funcs, ins = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = re.search(KERNEL_SYMBOL, line)
            ins = funcs.setdefault(kernel_name(m), []) if m else None
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and ins is not None:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def sass_loops(ins, holds: str) -> list:
    """(length, first, last address) of the loops (a backward BRA and its
    target) that hold an instruction starting with ``holds`` and no barrier."""
    loops = []
    for addr, op in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", op)
        if m and int(m.group(1), 16) < addr:
            lo, hi = int(m.group(1), 16), addr
            body = [o.split(None, 1)[1] if o.startswith("@") else o
                    for a, o in ins if lo <= a <= hi]
            if any(o.startswith(holds) for o in body) and not any("BAR" in o for o in body):
                loops.append((hi - lo, lo, hi))
    return loops


def sass_pair_ops(funcs: dict) -> dict:
    """FP32 instructions per ray-triangle pair of each sweep instantiation,
    and per ray-box pair of the gate's crossing kernel, counted from its
    SASS: the FADD, FMUL, FFMA, FSETP, FSEL and FMNMX instructions of the
    innermost loop (the one holding the shared-memory loads), outside the
    branches that only pairs passing the barycentric test take, divided by
    the pairs one pass of that loop tests (5 LDS.128 a triangle; one a ray
    of the crossing kernel, which tests it against its K boxes). Each takes
    one slot per lane, an FFMA too; so does every other instruction, and the
    third count is all of them.
    ``"sweep_kernel<1,0,1,0>"`` -> (FP32 instructions per pair, {opcode:
    count per pair}, instructions per pair)."""
    out = {}
    for name, ins in funcs.items():
        if not name.startswith(("sweep_", "gate_cross")):
            continue
        # pairs per LDS.128: K for the crossing kernel, 1/5 for the sweeps
        per_load = int(name[-2]) if name.startswith("gate_cross") else 0.2
        _, lo, hi = min(sass_loops(ins, "LDS.128"))
        skips = []
        for a, o in ins:
            m = re.search(r"@!?P\d BRA (0x[0-9a-f]+)", o)
            if m and lo <= a < int(m.group(1), 16) <= hi:
                skips.append((a, int(m.group(1), 16)))
        counts, loads, total = {}, 0, 0
        for a, o in ins:
            if not lo <= a <= hi or any(s < a < e for s, e in skips):
                continue
            total += 1
            o = o.split(None, 1)[1] if o.startswith("@") else o
            opc = o.split()[0].split(".")[0]
            if opc in FP32_OPCODES:
                counts[opc] = counts.get(opc, 0) + 1
            loads += o.startswith("LDS.128")
        pairs = round(loads * per_load)
        ops = sum(counts.values()) / pairs
        out[name] = (ops, {k: v / pairs for k, v in sorted(counts.items())}, total / pairs)
    return out


def sass_ffma_share(ins) -> tuple:
    """(FFMAs, instructions) of the probe's chain loop: the largest loop
    holding an FFMA."""
    _, lo, hi = max(sass_loops(ins, "FFMA"))
    body = [o.split(None, 1)[1] if o.startswith("@") else o for a, o in ins if lo <= a <= hi]
    return sum(o.startswith("FFMA") for o in body), len(body)


def bound(n_bytes: float, pairs: float = 0.0, ops_per_pair: float = 0.0):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the FP32 instructions over its issue rate."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = pairs * ops_per_pair / PEAK_FP32_INSTR * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def sweep_bytes(rays, pack, *others) -> int:
    """Bytes a sweep must move: every input once (rays, pack, tables) and
    its two (N,) int32 outputs once."""
    return (rays.numel() + pack.numel()) * 4 + sum(t.numel() * t.element_size()
                                                  for t in others) + 8 * rays.shape[1]


def timed_once(fn):
    """One call of ``fn()``: (ms by CUDA events, result)."""
    return cuda_ms(fn, reps=1)


def soup_inputs(dev, soup_ps, seed: int):
    """The operands of the soup solve's one chunk: (scene fields, rays
    (9, 262144), m_any, m_mat, padded triangles, the emitter's real rays per
    iteration)."""
    from raystrack_tpu_torch.ops.trace import compute_masks, generate_rays, ray_pack
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
    ext = torch.tensor([0, 1, 0], dtype=torch.int32, device=dev)
    m_any, m_mat = compute_masks(scene, ext, 0, 1, em.plane_vec)
    return scene, ray_pack(o, d), m_any, m_mat, sp.n_tri_pad, em.n_rays_once


def phase_kernel(dev, soup_ps, seed: int):
    """Kernel #1 vs its plain version at the soup shape in all 6 variants."""
    from raystrack_tpu_torch.ops.trace_cuda import (
        build_tri_pack, sweep_rays, sweep_rays_reference, sweep_tile_width,
    )
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE

    scene, rays, m_any, m_mat, tpad, n_once = soup_inputs(dev, soup_ps, seed)
    n = rays.shape[1]
    check(n == SOUP_CHUNK * 65536 and tpad == SOUP_TRIS, f"soup shape {n} x {tpad}")
    tile = sweep_tile_width(tpad, PALLAS_TRI_TILE)
    print(f"[kernel1] soup: {tpad} triangles x {n} rays = {n * tpad:.4g} pair tests, "
          f"tile {tile}")
    max_err = 0
    rows = {}
    valid = torch.full((SOUP_CHUNK,), n_once, dtype=torch.int32, device=dev)
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
            rows[(wm, wa, baked)] = (ms, plain_ms, n * int(tiles_on.sum()) * tile,
                                     sweep_bytes(rays, pack, tiles_on))
            print(f"[kernel1] {name:17s} equal={same} hits={int((c >= 0).sum())} "
                  f"blocked={int(a.sum())} kernel {ms:.3f} ms "
                  f"({n * tpad / ms * 1e3:.4g} tests/s) plain {plain_ms:.3f} ms "
                  f"({n * tpad / plain_ms * 1e3:.4g} tests/s)")
            check(same, f"kernel #1 != plain version in variant {name}")
    pack = build_tri_pack(scene, m_any, m_mat, bake=m_mat)
    codes = sweep_rays(rays, pack, m_mat, tri_tile=PALLAS_TRI_TILE, want_matrix=True,
                       want_any=False, masks_baked=True)[0]
    front = int((codes == 3).sum())
    ms, plain_ms = rows[(True, False, True)][:2]  # the matrix solve's own variant
    with forced_launch(split=4):  # the same launch at the under-filled launches' split
        ms4, (c4, _) = cuda_ms(lambda: sweep_rays(
            rays, pack, m_mat, tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False,
            masks_baked=True))
    check(torch.equal(c4, codes), "kernel #1 at 4 threads a ray != at 1 on the soup")
    print(f"[kernel1] matrix,baked at 4 threads a ray: equal=True, {ms4:.3f} ms "
          f"(the wrapper's 1 thread a ray: {ms:.3f} ms)")
    tiles_on = m_mat.reshape(-1, tile).any(dim=1)
    pairs = -(-n // 256) * 256 * int(tiles_on.sum()) * tile
    nbytes = sweep_bytes(rays, pack, tiles_on.to(torch.int32))
    # the sky's and the workflow's variants: the m_any-baked pack they sweep
    sky = {name: rows[key] for name, key in (("any", (False, True, True)),
                                             ("matrix+any", (True, True, True)))}
    return (max_err, ms, plain_ms, front / n, (codes.view(SOUP_CHUNK, -1), valid, 4, None),
            pairs, nbytes, sky)


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
    print(f"[kernel2] soup8 round: {tpad} padded triangles x {n} rays of {n_emit} "
          f"emitters = {n * tpad:.4g} pair tests, tile {tile}, {schedule.shape[0]} "
          f"schedule rows")
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
        times[(wm, wa)] = (ms, plain_ms, int(tiles_on[emap.long()].sum()) * RAY_SUBBLOCK * tile,
                           sweep_bytes(rays, tri_pack, masks, emap, tiles_on))
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
    ms, plain_ms, pairs, nbytes = times[(True, False)]  # the matrix solve's own variant
    codes_rows = outs[(True, False)][0].view(schedule.shape[0], sb)
    # the ids a sky round of these rays counts: a missed ray's Tregenza
    # patch (145 bins) or its upward flag (1 bin)
    miss = (outs[(False, True)][1] == 0).view(schedule.shape[0], sb)
    patch = T.tregenza_patch_id(d[..., 0], d[..., 1], d[..., 2])
    sky_ids = {
        "sky_bins": torch.where(miss, patch, -1).contiguous(),
        "upward": torch.where(miss & (d[..., 2] > 0.0), 0, -1).to(torch.int32).contiguous(),
    }
    sky = {name: times[key] for name, key in (("any", (False, True)),
                                              ("matrix+any", (True, True)))}
    return (max_err, ms, plain_ms, fronts, (codes_rows, valid, 2 * (surf.shape[1] - 1), None),
            pairs, nbytes, sky, (sky_ids, valid))


def phase_count(cases):
    """The count kernel vs its plain version and ``torch.bincount`` on the
    ids the main path gives it: name -> (ids (rows, L), n_valid (rows,) or
    None, n_bins, valid (rows, L) or None): hit codes in 2 * n_surf bins,
    a sky round's patch ids in 145, its upward flags in 1. The wrapper's
    one-call time (``ms``) and the kernel measured as a kernel
    (:func:`launch_times`: device time per launch, host enqueue per call,
    the launch floor) beside the bytes bound."""
    from raystrack_tpu_torch.ops.build import load_library
    from raystrack_tpu_torch.ops.count_cuda import _work, count_bins, count_bins_reference

    lib = load_library()
    max_err, times = 0, {}
    for name, (ids, n_valid, n_bins, valid) in cases.items():
        args = (ids, n_bins, n_valid)
        rows, length = ids.shape
        ms, got = cuda_ms(lambda: count_bins(*args, valid=valid))  # noqa: B023
        out = torch.full((rows, n_bins), -7, dtype=torch.int32, device=ids.device)
        stream = torch.cuda.current_stream().cuda_stream
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        work = (_work(ids.device, stream, rows * (n_bins + 1))
                if length > lib.raystrack_count_per_cta() else None)
        launch = launch_times(
            lambda: lib.raystrack_count_codes(  # noqa: B023
                ids.data_ptr(), ptr(n_valid), ptr(valid), rows, length,  # noqa: B023
                n_bins, out.data_ptr(), ptr(work), stream),  # noqa: B023
            lambda: count_bins(*args, valid=valid))  # noqa: B023
        check(work is None or not bool(work.any()), f"count: the work buffer is not zero "
                                                    f"after the launches on {name}")
        plain_ms, counts = timed_once(lambda: count_bins_reference(*args, valid))  # noqa: B023
        # one launch writes every count: the raw launches' outputs, which
        # started as -7, are the counts
        same = torch.equal(out, counts) and torch.equal(got, counts)
        max_err = max(max_err, int((got - counts).abs().max()))
        # the library yardstick: one torch.bincount over (row, id) keys,
        # every entry that counts nowhere sent to one extra bin
        pos = torch.arange(length, device=ids.device)
        ok = (ids >= 0) & (ids < n_bins)
        if n_valid is not None:
            ok &= pos[None, :] < n_valid[:, None]
        if valid is not None:
            ok &= valid
        keys = torch.where(ok, torch.arange(rows, device=ids.device)[:, None] * n_bins
                           + ids, rows * n_bins).reshape(-1)
        lib_ms, hist = cuda_ms(lambda: torch.bincount(keys, minlength=rows * n_bins + 1))  # noqa: B023
        same = same and torch.equal(hist[:-1].view(rows, n_bins).to(torch.int32), counts)
        nbytes = (ids.numel() + counts.numel()) * 4 + sum(
            t.numel() * t.element_size() for t in (n_valid, valid) if t is not None)
        times[name] = (ms, plain_ms, lib_ms, bound(nbytes), launch)
        print(f"[count] {name}: {rows} rows x {length} ids, {n_bins} bins: "
              f"equal={same} counted={int(counts.sum())} wrapper (one call) {ms:.4f} ms, "
              f"kernel {launch['device_ms']:.4f} ms a launch on the card "
              f"({launch['call_device_ms']:.4f} ms a wrapper call), host enqueue "
              f"{launch['enqueue_ms']:.4f} ms a call ({launch['raw_enqueue_ms']:.4f} ms a raw "
              f"launch), launch floor {launch['floor_ms']:.4f} ms; plain {plain_ms:.3f} ms "
              f"torch.bincount {lib_ms:.3f} ms bound {times[name][3][0]:.4f} ms "
              f"({times[name][3][1]})")
        check(same, f"count kernel != plain version or bincount on {name}")
    return max_err, times


@contextlib.contextmanager
def recording(mod, name: str, calls: list, keep=lambda args, kwargs, out: (args, kwargs, out)):
    """Inside the block ``mod.<name>`` appends ``keep(args, kwargs, result)``
    of its first call to ``calls``. Wrap no function whose body reads its
    own attributes (the wrappers' ``launches``): that body would find the
    recorder under its name."""
    real = getattr(mod, name)

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        if not calls:
            calls.append(keep(args, kwargs, out))
        return out

    setattr(mod, name, record)
    try:
        yield
    finally:
        setattr(mod, name, real)


def first_call(mod, name: str, fn):
    """Run ``fn()`` with ``mod.<name>`` wrapped, and return the (args,
    kwargs) of its first call."""
    calls = []
    with recording(mod, name, calls):
        fn()
    check(bool(calls), f"the solve never called {name}")
    return calls[0][:2]


@contextlib.contextmanager
def forced_launch(split=None, gate=None):
    """Inside the block the sweep wrappers launch at ``split`` threads a ray
    (else their own choice) and, with ``gate``, on these prebuilt tables
    (else they build their own)."""
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


def gate_phase(label, rays, kernel, plain, tables, n_blocks, tiles_total, tile, ops, nbytes):
    """Gated kernel vs ungated kernel (whole input) and vs its plain gated
    version on the leading CITY_PLAIN_BLOCKS blocks, with times, the visit
    share and the gate-table build time. ``kernel(rays, gated, visits)``
    and ``plain(rays, gate, tiles_on, visits, split)`` run the two versions;
    ``tables()`` builds the gate's tables and padded tile flags for ``rays``;
    ``tiles_total`` is the (block, tile) visits of the ungated sweep.

    The wrapper builds the gate's tables at every call; the kernel's own
    time is taken with the tables built once beforehand. The gated kernels
    are built at one triangle split (``trace_cuda.GATED_SPLIT``); the plain
    version runs at that split and unsplit, and both must give the kernel's
    codes, flags and visits."""
    from raystrack_tpu_torch.ops import trace_cuda

    dev = rays.device
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    visits = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
    full = torch.zeros_like(visits)
    table_ms, (gate, tiles_on) = cuda_ms(lambda: tables(rays))
    wrapper_ms, (c, a) = cuda_ms(lambda: kernel(rays, True, visits))
    chosen = trace_cuda.sweep_split(n_blocks, True, n_sms)
    check(chosen == trace_cuda.GATED_SPLIT, f"{label}: the rule picks {chosen} for a gated launch")
    v = torch.full_like(visits, -1)
    with forced_launch(gate=gate):
        ms, (cs, as_) = cuda_ms(lambda: kernel(rays, True, v))
    check(torch.equal(cs, c) and torch.equal(as_, a) and torch.equal(v, visits),
          f"{label}: the kernel on prebuilt tables != the wrapper's launch")
    ms_u, (cu, au) = cuda_ms(lambda: kernel(rays, False, full))
    check(torch.equal(c, cu) and torch.equal(a, au), f"{label}: gated kernel != ungated kernel")
    k = min(CITY_PLAIN_BLOCKS, n_blocks)
    sub = rays[:, : k * RAY_SUB].contiguous()
    sub_visits = torch.zeros(k, dtype=torch.int32, device=dev)
    sub_ms, (cs, as_) = cuda_ms(lambda: kernel(sub, True, sub_visits))
    lead = slice(0, k * RAY_SUB)
    err, plain_ms = 0, {}
    for split in (chosen, 1):
        plain_visits = torch.zeros_like(sub_visits)
        plain_ms[split], (cp, ap) = timed_once(lambda: plain(  # noqa: B023
            sub, gate.blocks(torch.arange(k, device=dev)), tiles_on, plain_visits, split))  # noqa: B023
        same = (torch.equal(cp, c[lead]) and torch.equal(ap, a[lead])
                and torch.equal(plain_visits, visits[:k]))
        err = max(err, int((cp - c[lead]).abs().max()), int((ap - a[lead]).abs().max()))
        check(same, f"{label}: gated kernel != its plain gated version (split={split}) on "
                    f"{k} blocks")
    # the leading blocks alone (timed against the plain version) build their
    # own tables; a block's mean origin may round apart, reordering ties only
    sub_same = torch.equal(cs, cp) and torch.equal(as_, ap)
    swept, total = int(visits.sum()), int(full.sum())
    check(total == tiles_total, f"{label}: ungated visits {total} != {tiles_total}")
    pairs, pairs_full = swept * RAY_SUB * tile, total * RAY_SUB * tile
    out = dict(
        gated_ms=ms, gated_split=chosen, gated_wrapper_ms=wrapper_ms, ungated_ms=ms_u,
        ungated_split=trace_cuda.sweep_split(n_blocks, False, n_sms),
        gated_plain_ms=plain_ms[chosen], gated_plain_blocks=k,
        gated_kernel_ms_on_plain_blocks=sub_ms, gate_tables_ms=table_ms,
        visit_share=swept / total, gated_pairs=pairs, ungated_pairs=pairs_full,
        max_abs_err=err)
    out["gated_bound_ms"], out["gated_bound_by"] = bound(nbytes, pairs, ops[0])
    out["ungated_bound_ms"], out["ungated_bound_by"] = bound(nbytes, pairs_full, ops[1])
    print(f"[gate] {label}: {n_blocks} blocks, {total} (block, tile) visits of {tile} "
          f"triangles ungated; the gate "
          f"leaves {swept} of {total} (block, tile) visits = {swept / total:.4%} "
          f"({pairs:.4g} of {pairs_full:.4g} pair tests); gated == ungated and == the "
          f"plain gated version at split={chosen} and split=1 on {k} blocks (codes, flags, "
          f"visits): True; "
          f"the kernel on those blocks alone: codes equal {sub_same}, visits equal "
          f"{torch.equal(sub_visits, plain_visits)}")
    print(f"[gate] {label}: at most {int(visits.max())} tiles in one block (ungated "
          f"{int(full.max())}); per block, the median {float(visits.float().median()):g}")
    print(f"[gate] {label}: gated kernel, {chosen} threads a ray, {ms:.3f} ms (bound "
          f"{out['gated_bound_ms']:.3f} ms, {out['gated_bound_by']}: "
          f"{out['gated_bound_ms'] / ms:.1%} of it), ungated kernel, "
          f"{out['ungated_split']} thread(s) a ray, {ms_u:.3f} ms (bound "
          f"{out['ungated_bound_ms']:.3f} ms, {out['ungated_bound_by']}), gate tables "
          f"{table_ms:.3f} ms, the gated wrapper (tables and kernel) {wrapper_ms:.3f} ms; "
          f"on the leading {k} blocks (tables included): gated kernel {sub_ms:.3f} ms, "
          f"plain gated version " + ", ".join(f"{t:.3f} ms (split={sp})"
                                              for sp, t in plain_ms.items()))
    return out


def city_chunk_inputs(chunk_call):
    """The operands of a captured ``chunk_body`` call with the rays it
    sweeps, generated and coherence-sorted as chunk_body does: (rays, pack,
    sweep_mask, accel, tile, tiles_on)."""
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.ops.trace_cuda import sweep_tile_width

    (pack, sweep_mask, tables, geom, cp, _, n_once), kw = chunk_call
    accel = kw["accel"]
    chunk, n_local = cp.shape[0], tables[0].shape[0]
    o, d = T.generate_rays(tables, geom, cp)
    valid = (torch.arange(n_local, device=cp.device) < n_once).expand(chunk, n_local)
    o, d, _ = T._sorted_for_gate(o, d, valid, accel)
    rays = T.ray_pack(o, d)
    tile = sweep_tile_width(pack.shape[1], PALLAS_TRI_TILE)
    tiles_on = sweep_mask.reshape(-1, tile).any(dim=1).to(torch.int32)
    print(f"[gate] city chunk: {rays.shape[1]} rays ({chunk} x {n_local}, {n_once} real per "
          f"iteration) x {pack.shape[1]} padded triangles ({pack.shape[1] // tile} tiles of "
          f"{tile}) = {rays.shape[1] * pack.shape[1]:.4g} pair tests ungated")
    return rays, pack, sweep_mask, accel, tile, tiles_on


def city_round_inputs(round_call):
    """The operands of a captured ``scheduled_trace`` call with the rays it
    sweeps, generated and coherence-sorted as scheduled_trace does: (rays,
    pack, masks, emap, accel, tile, tiles_on (E, n_tiles))."""
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.ops.trace_cuda import scheduled_tiles_on, sweep_tile_width

    (scene, pack, tables, geom, cp, surf, emit, mins, once, plane, schedule, sel), kw = \
        round_call
    sb, accel = kw["sched_block"], kw["accel"]
    masks = T.combined_masks(scene, surf, emit, mins, plane)
    o, d, n_valid = T.scheduled_rays(tables, geom, cp, once, schedule, sel, sched_block=sb)
    ray = torch.arange(sb, dtype=n_valid.dtype, device=cp.device)
    o, d, _ = T._sorted_for_gate(o, d, ray[None, :] < n_valid[:, None], accel)
    rays = T.ray_pack(o, d)
    emap = schedule[:, 0].repeat_interleave(sb // RAY_SUB)
    tpad = pack.shape[1]
    tile = sweep_tile_width(tpad, PALLAS_TRI_TILE)
    t_on = scheduled_tiles_on(masks, tile, want_matrix=True, want_any=False)
    n, n_real = rays.shape[1], int(n_valid.sum())
    print(f"[gate] city_plates round: {schedule.shape[0]} rows of {sb} rays ({n} rays, {n_real} "
          f"real) of {masks.shape[0]} emitters x {tpad} padded triangles; active tiles "
          f"per emitter row {t_on.sum(dim=1).tolist()} of {tpad // tile}")
    check(masks.shape[0] == 10 and n == n_real == 245760,
          f"city_plates round: {masks.shape[0]} emitters, {n} rays, {n_real} real")
    return rays, pack, masks, emap, accel, tile, t_on


def phase_city_kernels(chunk_call, round_call, pair_ops):
    """Kernels #1 and #2 gated on the city: the first chunk of the
    ground -> city solve and the first round of the ten-plate matrix
    solve, with the rays those dispatches sweep."""
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.ops.trace_cuda import (
        _gate_for, _gated_tiles_on, sweep_rays, sweep_rays_reference,
        sweep_rays_scheduled, sweep_rays_scheduled_reference,
    )

    rays, pack, sweep_mask, accel, tile, tiles_on = city_chunk_inputs(chunk_call)
    dev, rays1 = rays.device, rays
    n, tpad = rays.shape[1], pack.shape[1]
    check(tpad % 2048 == 0 and tile == 2048, f"city pack {tpad}, tile {tile}")
    sweep_kw = dict(tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False,
                    masks_baked=True)

    def tables1(r):
        gate = _gate_for(accel, r, tpad, tile, PALLAS_TRI_TILE, dev)
        return gate, _gated_tiles_on(tiles_on, gate)

    k1 = gate_phase(
        "kernel #1, city chunk", rays,
        lambda r, gated, v: sweep_rays(r, pack, sweep_mask, accel=accel if gated else None,
                                       visits=v, **sweep_kw),
        lambda r, gate, t_on, v, split: sweep_rays_reference(
            r, pack, t_on, tile, want_matrix=True, want_any=False, masks_baked=True,
            gate=gate, visits=v, split=split),
        tables1, n // RAY_SUB, n // RAY_SUB * int(tiles_on.sum()), tile,
        (pair_ops["sweep_kernel<1,0,1,1>x4"][0], pair_ops["sweep_kernel<1,0,1,0>"][0]),
        sweep_bytes(rays, pack, tiles_on, *accel))

    rays, pack2, masks, emap, accel, tile, t_on = city_round_inputs(round_call)
    n = rays.shape[1]

    def tables2(r):
        gate = _gate_for(accel, r, tpad, tile, PALLAS_TRI_TILE, dev)
        return gate, _gated_tiles_on(t_on, gate)

    def plain2(r, gate, t_pad, v, split):
        return sweep_rays_scheduled_reference(
            r, pack2, masks, emap[: r.shape[1] // RAY_SUB], t_pad, tile, want_matrix=True,
            want_any=False, gate=gate, visits=v, split=split)

    def kernel2(r, gated, v):
        return sweep_rays_scheduled(
            r, pack2, masks, emap[: r.shape[1] // RAY_SUB].contiguous(),
            tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False,
            accel=accel if gated else None, visits=v)

    k2 = gate_phase(
        "kernel #2, city_plates round", rays, kernel2, plain2, tables2, n // RAY_SUB,
        int(t_on[emap.long()].sum()), tile,
        (pair_ops["sweep_sched_kernel<1,0,1>x4"][0], pair_ops["sweep_sched_kernel<1,0,0>"][0]),
        sweep_bytes(rays, pack2, masks, emap, t_on, *accel))
    cross = phase_gate_cross({"city chunk": rays1, "city_plates round": rays}, accel, tile,
                             tpad // tile, pair_ops)
    return k1, k2, cross


def phase_gate_cross(cases, accel, tile, n_tiles, pair_ops):
    """The gate's crossing kernel vs its plain version on the rays of the
    city chunk and the ``city_plates`` round (``cases``: label -> rays), with
    one box per tile and, with ``GATE_MAX_TILES`` lowered to 64 for the call,
    through the two-level gate: ``crossed`` and ``minnear`` equal, and every
    field of the GateTables built through the kernel equal to those built
    through the plain crossing; the kernel's times (:func:`cross_case`)
    beside the plain loop's and its two bounds, and the whole table build
    both ways."""
    from raystrack_tpu_torch import config
    from raystrack_tpu_torch.ops import trace_cuda
    from raystrack_tpu_torch.ops.trace_cuda import (
        _gate_tables, _resolve_gate_window, gate_cross, gate_cross_reference, gate_group_size,
    )

    default, out = config.GATE_MAX_TILES, None
    try:
        for label, rays in cases.items():
            for max_tiles in (default, 64):
                config.GATE_MAX_TILES = max_tiles
                group = gate_group_size(n_tiles)
                build = lambda: _gate_tables(  # noqa: E731
                    accel, rays, n_tiles, tile, window=_resolve_gate_window(group))  # noqa: B023
                tables_ms, tables = cuda_ms(build)
                boxes = tables.boxes
                n_boxes = boxes.shape[0]
                check(n_boxes == -(-n_tiles // group) and (group > 1) == (max_tiles == 64),
                      f"gate_cross {label}: {n_boxes} boxes in groups of {group}")
                got = cross_case(f"{label}, {n_boxes} boxes (groups of {group})", rays, boxes,
                                 pair_ops)
                err = got["max_abs_err"]
                trace_cuda.gate_cross = gate_cross_reference
                try:
                    plain_tables_ms, plain_tables = cuda_ms(build)
                finally:
                    trace_cuda.gate_cross = gate_cross
                fields = ("boxes", "order", "counts", "suffmin")
                tables_same = all(torch.equal(getattr(tables, f), getattr(plain_tables, f))
                                  for f in fields)
                print(f"[cross] {label}, {n_boxes} boxes: tables through the kernel == "
                      f"through the plain crossing ({', '.join(fields)}): {tables_same}; the "
                      f"whole table build {tables_ms:.3f} ms, with the plain crossing "
                      f"{plain_tables_ms:.3f} ms")
                check(tables_same, f"gate tables through the kernel != through the plain "
                                   f"crossing on {label}, {n_boxes} boxes")
                got.update(tables_ms=tables_ms, tables_plain_crossing_ms=plain_tables_ms)
                if out is None:  # the city chunk, one box per tile: the entry's shape
                    out = dict(got, times={})
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["times"][f"{label}, {n_boxes} boxes"] = {
                    k: v for k, v in got.items() if k != "max_abs_err"}
    finally:
        config.GATE_MAX_TILES = default
    return out


def cross_boxes_a_thread(n_boxes: int) -> int:
    """K, the boxes a thread of the crossing kernel takes at ``n_boxes``
    (csrc/gate.cu raystrack_gate_cross): the instantiation it launches."""
    return 1 if n_boxes <= 256 else 2 if n_boxes <= 512 else 4


def cross_case(label, rays, boxes, pair_ops) -> dict:
    """The crossing kernel on one input: == its plain version (crossed,
    minnear), the wrapper's one-call time (``ms``), :func:`launch_times`
    of the raw entry, the plain loop's time and two bounds: the FP32
    instructions per pair over the card's FP32 peak (``bound_ms``) and
    every instruction of the pair loop (``bound_all_ms``), each over the
    issue rate of one instruction per lane per clock."""
    from raystrack_tpu_torch.ops.build import load_library
    from raystrack_tpu_torch.ops.trace_cuda import gate_cross, gate_cross_reference

    fp32, _, every = pair_ops[f"gate_cross_kernel<{cross_boxes_a_thread(boxes.shape[0])}>"]
    n, n_boxes = rays.shape[1], boxes.shape[0]
    ms, (crossed, minnear) = cuda_ms(lambda: gate_cross(rays, boxes))
    plain_ms, (cr, mr) = timed_once(lambda: gate_cross_reference(rays, boxes))
    same = torch.equal(crossed, cr) and torch.equal(minnear, mr)
    err = float((minnear - mr).abs().max())
    lib = load_library()
    c_out, m_out = torch.empty_like(crossed), torch.empty_like(minnear)
    stream = torch.cuda.current_stream().cuda_stream
    launch = launch_times(
        lambda: lib.raystrack_gate_cross(rays.data_ptr(), n, boxes.data_ptr(), n_boxes, RAY_SUB,
                                         c_out.data_ptr(), m_out.data_ptr(), stream),
        lambda: gate_cross(rays, boxes))
    check(torch.equal(c_out, crossed) and torch.equal(m_out, minnear),
          f"gate_cross: the raw launches' tables != the wrapper's on {label}")
    nbytes = 6 * 4 * n + boxes.numel() * 4 + crossed.numel() + minnear.numel() * 4
    bnd = bound(nbytes, float(n) * n_boxes, fp32)
    bnd_all = bound(nbytes, float(n) * n_boxes, every)
    dev_ms = launch["device_ms"]
    nearer = "FP32" if abs(dev_ms - bnd[0]) < abs(dev_ms - bnd_all[0]) else "every-instruction"
    print(f"[cross] {label}: {n} rays = {n * n_boxes:.4g} (ray, box) pairs; kernel == plain "
          f"(crossed, minnear): {same}; {int(crossed.sum())} of {crossed.numel()} (block, box) "
          f"crossed; wrapper (one call) {ms:.4f} ms, kernel {dev_ms:.4f} ms a launch on the "
          f"card ({launch['call_device_ms']:.4f} ms a wrapper call), host enqueue "
          f"{launch['enqueue_ms']:.4f} ms a call, launch floor {launch['floor_ms']:.4f} ms; "
          f"bounds: FP32 {bnd[0]:.4f} ms ({fp32:g} a pair, {bnd[0] / dev_ms:.1%} of it reached), "
          f"every instruction {bnd_all[0]:.4f} ms "
          f"({every:g} a pair, {bnd_all[0] / dev_ms:.1%}); nearer the {nearer} bound; plain "
          f"loop {plain_ms:.3f} ms")
    check(same, f"gate_cross != its plain version on {label}")
    return dict(ms=dev_ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                bound_all_ms=bnd_all[0], max_abs_err=err, wrapper_ms=ms,
                enqueue_ms=launch["enqueue_ms"], floor_ms=launch["floor_ms"],
                call_device_ms=launch["call_device_ms"])


def phase_code_kernel(chunk_call, code_call, pair_ops, baked):
    """Kernel #1 in its code_bounds mode on the city's first ground -> city
    chunk, with the operands the slim solve dispatched (``code_call``: the
    resident pack, the sweep mask from the surface ids, the two codes) and
    the rays of the full-mode chunk (``chunk_call``; both solves generate
    the same): == the baked kernel over the whole chunk, gated and ungated,
    == its plain version on the leading blocks, visits included; times
    beside the baked kernel's (``baked``, from :func:`phase_city_kernels`)."""
    from raystrack_tpu_torch.config import PALLAS_TRI_TILE
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.ops.trace_cuda import (
        UNGATED_SPLITS, _gate_for, _gated_tiles_on, sweep_rays, sweep_rays_reference,
        sweep_split, sweep_tile_width,
    )

    (baked_pack, baked_mask, tables, geom, cp, _, n_once), kw = chunk_call
    (pack, mask, tables_s, _, cp_s, _, n_once_s), kw_s = code_call
    accel, bounds = kw["accel"], kw_s["code_bounds"]
    dev = cp.device
    check(bounds == (0.0, 2.0), f"ground -> city code_bounds {bounds}")
    check(torch.equal(cp, cp_s) and n_once == n_once_s
          and all(torch.equal(a, b) for a, b in zip(tables, tables_s)),
          "the slim solve's first chunk is not the full-mode solve's")
    check(torch.equal(mask, baked_mask), "ground -> city: slim sweep mask != full-mode mask")
    check(not bool(pack[17:].any()), "the resident pack's mask rows are not zero")
    chunk, n_local = cp.shape[0], tables[0].shape[0]
    o, d = T.generate_rays(tables, geom, cp)
    valid = (torch.arange(n_local, device=dev) < n_once).expand(chunk, n_local)
    o, d, _ = T._sorted_for_gate(o, d, valid, accel)
    rays = T.ray_pack(o, d)
    n, tpad = rays.shape[1], pack.shape[1]
    tile = sweep_tile_width(tpad, PALLAS_TRI_TILE)
    tiles_on = mask.reshape(-1, tile).any(dim=1).to(torch.int32)
    out_kw = dict(tri_tile=PALLAS_TRI_TILE, want_matrix=True, want_any=False)

    def kernel(r, gated, v):
        return sweep_rays(r, pack, mask, accel=accel if gated else None, visits=v,
                          code_bounds=bounds, **out_kw)

    def plain(r, gate, t_on, v, split):
        return sweep_rays_reference(r, pack, t_on, tile, want_matrix=True, want_any=False,
                                    code_bounds=bounds, gate=gate, visits=v, split=split)

    def tables1(r):
        gate = _gate_for(accel, r, tpad, tile, PALLAS_TRI_TILE, dev)
        return gate, _gated_tiles_on(tiles_on, gate)

    k = gate_phase(
        "kernel #1 code mode, city chunk", rays, kernel, plain, tables1, n // RAY_SUB,
        n // RAY_SUB * int(tiles_on.sum()), tile,
        (pair_ops["sweep_code_kernel<1,0,1>x4"][0], pair_ops["sweep_code_kernel<1,0,0>"][0]),
        sweep_bytes(rays, pack, tiles_on, *accel))
    # against the baked kernel over the whole chunk, and the ungated plain
    # version on the leading blocks
    for gated in (True, False):
        a = accel if gated else None
        code = sweep_rays(rays, pack, mask, accel=a, code_bounds=bounds, **out_kw)
        full = sweep_rays(rays, baked_pack, baked_mask, accel=a, masks_baked=True, **out_kw)
        check(torch.equal(code[0], full[0]) and torch.equal(code[1], full[1]),
              f"code-mode kernel != baked kernel (gated={gated})")
    lead = min(CITY_PLAIN_BLOCKS, n // RAY_SUB)
    sub = rays[:, : lead * RAY_SUB].contiguous()
    v_k = torch.zeros(lead, dtype=torch.int32, device=dev)
    v_p = torch.zeros_like(v_k)
    ms_sub, (ck, ak) = cuda_ms(lambda: kernel(sub, False, v_k))
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plain_ms, (cr, ar) = timed_once(lambda: plain(
        sub, None, tiles_on, v_p, sweep_split(lead, False, n_sms)))
    same = torch.equal(ck, cr) and torch.equal(ak, ar) and torch.equal(v_k, v_p)
    k["max_abs_err"] = max(k["max_abs_err"], int((ck - cr).abs().max()),
                           int((ak - ar).abs().max()))
    check(same, "code-mode kernel != its plain version, ungated, on the leading blocks")
    # a slim chunk of the ten-plate city is 8,192 rays: 32 blocks on 132 SMs
    small = rays[:, : 32 * RAY_SUB].contiguous()
    k["small_chunk_ms"] = {}
    ref = None
    for split in UNGATED_SPLITS:
        v = torch.zeros(32, dtype=torch.int32, device=dev)
        with forced_launch(split):
            t, (cs, as_) = cuda_ms(lambda: kernel(small, False, v))  # noqa: B023
        ref = ref or (cs, as_, v)
        check(torch.equal(cs, ref[0]) and torch.equal(as_, ref[1]) and torch.equal(v, ref[2]),
              f"code-mode kernel on 32 blocks, ungated: {split} threads a ray != 1")
        k["small_chunk_ms"][f"ungated, {split}"] = t
    t, (cs, as_) = cuda_ms(lambda: kernel(small, True, v))
    check(torch.equal(cs, ref[0]) and torch.equal(as_, ref[1]),
          "code-mode kernel on 32 blocks: gated != ungated")
    k["small_chunk_ms"][f"gated, {sweep_split(32, True, n_sms)}"] = t
    print(f"[code] 32 leading blocks alone (a slim ten-plate chunk's size), threads a ray "
          f"(codes, flags and ungated visits equal; the gated time includes the tables): "
          + "; ".join(f"{key} {t:.3f} ms" for key, t in k["small_chunk_ms"].items())
          + f"; the wrapper launches {sweep_split(32, False, n_sms)} ungated and "
            f"{sweep_split(32, True, n_sms)} gated")
    ops_code, ops_baked = pair_ops["sweep_code_kernel<1,0,0>"], pair_ops["sweep_kernel<1,0,1,0>"]
    print(f"[code] == the baked kernel over the whole chunk (codes and flags), gated and "
          f"ungated: True; ungated == its plain version on {lead} blocks (codes, flags, "
          f"visits): {same} (kernel {ms_sub:.3f} ms, plain {plain_ms:.3f} ms)")
    print(f"[code] code mode vs baked: gated {k['gated_ms']:.3f} vs {baked['gated_ms']:.3f} ms "
          f"({k['gated_ms'] / baked['gated_ms'] - 1:+.2%}), ungated {k['ungated_ms']:.3f} vs "
          f"{baked['ungated_ms']:.3f} ms ({k['ungated_ms'] / baked['ungated_ms'] - 1:+.2%}); "
          f"FP32 instructions per pair in the SASS {ops_code[0]:g} vs {ops_baked[0]:g} "
          f"(the two code compares sit in the branch only pairs that hit take); the code "
          f"kernel stages 17 pack rows, the baked one 19")
    k["ungated_plain_ms"], k["ungated_kernel_ms_on_plain_blocks"] = plain_ms, ms_sub
    return k


@contextlib.contextmanager
def slim_threshold(config, n_tris: int):
    """The port's slim threshold set to ``n_tris`` for the block, then restored."""
    default = config.SLIM_PACK_MIN_TRIS
    config.SLIM_PACK_MIN_TRIS = n_tris
    try:
        yield
    finally:
        config.SLIM_PACK_MIN_TRIS = default


def mode_footprint(label, meshes, solve_with, slim: bool, dev, repeats: int = 3):
    """``solve_with(prepared)`` on ``meshes`` from a fresh PreparedSolver in
    full or slim mode: the dict, set-up (first solve) seconds, warm walls,
    and device bytes over what was allocated before: the peak of the first
    solve (pack build included), of the warm solves, and what stays
    resident. Frees its packs before it returns."""
    from raystrack_tpu_torch import PreparedSolver, config

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with slim_threshold(config, 1 if slim else 2**62):
        ps = PreparedSolver(meshes)
        t0 = time.perf_counter()
        result = solve_with(ps)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        pack = ps.get_scene_pack(use_accel=True, device=dev)
        check(pack.slim == slim, f"{label}: scene pack slim={pack.slim}, wanted {slim}")
        first_peak = torch.cuda.max_memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        warm = wall_times(lambda: solve_with(ps), repeats)
        warm_peak = torch.cuda.max_memory_allocated(dev) - base
        resident = torch.cuda.memory_allocated(dev) - base
        n_tri_pad = pack.n_tri_pad
    del ps, pack
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[slim] {label}, {'slim' if slim else 'full'} mode: {n_tri_pad} padded triangles; "
          f"first solve with set-up {setup_s:.2f} s; warm solve {spread(warm)}; device "
          f"memory over the {base / 2**20:.1f} MiB held before: peak of the first solve "
          f"{first_peak / 2**20:.1f} MiB = {first_peak / n_tri_pad:.1f} B per padded triangle, "
          f"of the warm solves {warm_peak / 2**20:.1f} MiB = {warm_peak / n_tri_pad:.1f} B, "
          f"resident after {resident / 2**20:.1f} MiB = {resident / n_tri_pad:.1f} B")
    return dict(result=result, setup_s=setup_s, warm=warm, first_peak=first_peak,
                warm_peak=warm_peak, resident=resident, n_tri_pad=n_tri_pad)


def phase_fma_peak(dev, sass, sweep_rates):
    """Kernel #3, the FP32 FMA-peak probe: every repeat against its plain
    version, best of 5 by CUDA events, the SM clock during a burst, and the
    sweeps' FP32 instruction rates (``sweep_rates``: label -> instructions
    per second) as shares of the measured rate."""
    from raystrack_tpu_torch.ops.peak_cuda import (
        REPEATS, fma_count, fma_peak, fma_peak_reference, fma_peak_tolerance,
    )

    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((32, 128)).astype(np.float32)).to(dev)
    c, d = 0.999999881, 0.25  # the JAX package's probe's scalars
    out = fma_peak(x, c, d)  # first launch: also the warm-up
    plain_ms, plain = timed_once(lambda: fma_peak_reference(x, c, d))
    torch.cuda.synchronize()
    tol = fma_peak_tolerance(x, c, d)
    err = float((out - plain).abs().max())
    err64 = float((out.double() - fma_peak_reference(x.double(), c, d)).abs().max())
    repeats_same = bool((out == out[0]).all())
    print(f"[peak] {REPEATS} repeats of (32, 128) x 16 chains x 1024 FFMAs = {fma_count():.4g} "
          f"FFMAs; max |kernel - plain| over every repeat {err:.3e} (allowed {2 * tol:.3e}: "
          f"twice the bound of either f32 version against the float64 recurrence), "
          f"|kernel - float64| {err64:.3e} (allowed {tol:.3e}); all repeats bitwise the "
          f"same: {repeats_same}; values up to {float(out.abs().max()):.1f}")
    check(err <= 2 * tol and err64 <= tol and repeats_same,
          "the FMA-peak kernel disagrees with its plain version")
    n_ffma, n_ins = sass_ffma_share(sass["fma_peak_kernel"])
    print(f"[peak] chain loop in the SASS: {n_ffma} FFMA of {n_ins} instructions "
          f"({n_ffma / n_ins:.2%})")
    check(n_ffma >= 16 * 16, "the probe's loop holds fewer FFMAs than 16 chains x 16 steps")
    fma_peak.launches = 0
    ms, _ = cuda_ms(lambda: fma_peak(x, c, d), reps=5)
    for _ in range(150):  # ~0.7 s of queued probes
        fma_peak(x, c, d)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    launches = fma_peak.launches
    rate = fma_count() / (ms * 1e-3)
    bnd = fma_count() / PEAK_FP32_INSTR * 1e3
    print(f"[peak] best of 5: {ms:.4f} ms = {rate:.4g} FFMA/s = {rate / PEAK_FP32_INSTR:.2%} "
          f"of the data sheet's {PEAK_FP32_INSTR:.4g} (bound {bnd:.3f} ms); SM clock, its "
          f"maximum and the power draw during a burst of 150 probes: {clocks}; plain "
          f"version (one repeat, 2,048 tensor ops) {plain_ms:.3f} ms")
    for label, r in sweep_rates.items():
        print(f"[peak] {label}: {r:.4g} FP32 instructions/s = {r / PEAK_FP32_INSTR:.1%} of "
              f"the data sheet's rate, {r / rate:.1%} of the measured FFMA rate")
    return {"name": "fma_peak", "route": "cuda", "source": "raystrack_tpu_torch/csrc/peak.cu",
            "replaces": "docs/measurements/vpu_roofline_r05.py:62", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": "operations",
            # one torch.addcmul chain reads and writes memory at every step:
            # not the same function
            "library_ms": None, "ffma_per_s": rate, "share_of_data_sheet": rate / PEAK_FP32_INSTR,
            "tolerance": 2 * tol, "clocks": clocks}


def sky_variants(sky1, sky2, pair_ops) -> dict:
    """The any-only and matrix + any variants of kernels #1 (the soup chunk,
    on the m_any-baked pack the sky's and the workflow's operands bake) and
    #2 (the soup8 round), as phases 3-4 timed them at the split the
    wrappers pick for those shapes, beside their bounds: the FP32 SASS
    instructions a pair of the instantiation that launched times the pairs
    it tests, over 33.5e12/s (or the bytes, if larger)."""
    from raystrack_tpu_torch.ops.trace_cuda import sweep_split

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, rows, sym in (("kernel #1, soup chunk", sky1, "sweep_kernel<{},1,0>"),
                             ("kernel #2, soup8 round", sky2, "sweep_sched_kernel<{},0>")):
        split = sweep_split(SOUP_CHUNK * 65536 // RAY_SUB, False, n_sms)
        for name, (ms_, plain, pairs, nbytes) in rows.items():
            inst = sym.format("0,1" if name == "any" else "1,1") + (
                f"x{split}" if split > 1 else "")
            ops = pair_ops[inst][0]
            bnd = bound(nbytes, pairs, ops)
            out[f"{label}, {name}"] = dict(ms=ms_, plain_ms=plain, bound_ms=bnd[0],
                                           bound_by=bnd[1], pairs=pairs, fp32_per_pair=ops,
                                           instantiation=inst)
            print(f"[sky] {label}, {name} ({inst}, {split} thread(s) a ray): {ms_:.3f} ms, "
                  f"bitwise equal to its plain version ({plain:.3f} ms); {pairs:.4g} pair "
                  f"tests x {ops:g} FP32 instructions = bound {bnd[0]:.3f} ms ({bnd[1]}): "
                  f"{bnd[0] / ms_:.1%} of it reached")
    return out


def sky_base(**kw) -> dict:
    """validation/validate_07_canyon_sky.py's settings, on the card."""
    return dict(samples=8, rays=512, seed=17, bvh="builtin", device="gpu", tol=1e-4,
                tol_mode="stderr", min_iters=40, max_iters=500, **kw)


def phase_canyon_sky(route_solve) -> dict:
    """16. The canyon's sky at validation 07's settings, merged and discrete,
    on both routes: the road's merged Sky within 1e-4 of 1 - sum(analytic
    F(road -> panels)), its 145 patches within 1e-4 of the merged value, the
    scheduled dict == the per-emitter dict (``config.SCHEDULER`` forced to
    ``grouped``, restored after); warm walls of 5."""
    from analytic import canyon_ground_truth
    from examples.ex00_street_canyon_geometry import build_street_canyon
    from raystrack_tpu_torch import SkyParams, view_factor_to_tregenza_sky

    canyon = build_street_canyon()
    analytic = 1.0 - sum(canyon_ground_truth()["road"].values())
    out = {}
    for discrete in (False, True):
        params = SkyParams(**sky_base(discrete=discrete))
        solve = lambda: view_factor_to_tregenza_sky(canyon, params)  # noqa: E731, B023
        sched, n_r, n_c = route_solve("auto", solve)
        check(n_r > 0 and n_c == 0, f"canyon sky: {n_r} rounds, {n_c} chunks, not scheduled")
        per_emitter, n_r2, n_c2 = route_solve("grouped", solve)
        check(n_c2 > 0 and n_r2 == 0, f"canyon sky: {n_r2} rounds, {n_c2} chunks per emitter")
        same = per_emitter == sched
        warm, _, _ = route_solve("auto", lambda: wall_times(solve, 5))  # noqa: B023
        warm_pe, _, _ = route_solve("grouped", lambda: wall_times(solve, 5))  # noqa: B023
        kind = "discrete" if discrete else "merged"
        print(f"[canyon sky] {kind}: scheduled {n_r} rounds, warm solve {spread(warm)}; "
              f"per-emitter {n_c2} chunks, warm solve {spread(warm_pe)}; dicts identical: {same}")
        check(same, f"canyon sky ({kind}): scheduled dict != per-emitter dict")
        out[kind] = dict(result=sched, warm=warm, warm_per_emitter=warm_pe, rounds=n_r,
                         chunks=n_c2)
    merged = out["merged"]["result"]["road"]["Sky"]
    patches = sum(out["discrete"]["result"]["road"].values())
    diff, patch_diff = abs(merged - analytic), abs(patches - merged)
    print(f"[canyon sky] road: merged Sky {merged!r} vs analytic {analytic!r}: |diff| "
          f"{diff:.3e}; the 145 patches sum to {patches!r}: |diff| {patch_diff:.3e} "
          f"(both within 1e-4: {diff <= 1e-4 and patch_diff <= 1e-4})")
    check(diff <= 1e-4, f"canyon road Sky {merged} is {diff} from the analytic {analytic}")
    check(patch_diff <= 1e-4, f"canyon road patches sum {patches}, {patch_diff} from merged")
    out.update(road_sky=merged, analytic=analytic, diff=diff, patch_diff=patch_diff)
    return out


def phase_canyon_workflow(route_solve) -> dict:
    """17. The canyon's outside workflow with shareable parameters
    (validation 07's settings on both sides, the matrix with reciprocity):
    scene + sky + Rest == 1 within 1e-9 per emitter; the shared-ray solve's
    dicts == the separate ``view_factor_matrix`` and
    ``view_factor_to_tregenza_sky`` solves, and == its per-emitter route;
    warm walls of 3."""
    from examples.ex00_street_canyon_geometry import build_street_canyon
    from raystrack_tpu_torch import (
        MatrixParams, SkyParams, outside_workflow_shareable, view_factor_matrix,
        view_factor_matrix_and_sky, view_factor_outside_workflow, view_factor_to_tregenza_sky,
    )

    canyon = build_street_canyon()
    mp, sp = MatrixParams(**sky_base()), SkyParams(**sky_base())
    check(outside_workflow_shareable(mp, sp), "canyon workflow parameters are not shareable")
    (scene, sky, rest), n_r, n_c = route_solve("auto", lambda: view_factor_outside_workflow(
        canyon, matrix_params=mp, sky_params=sp))
    worst = max(abs(sum(scene[n].values()) + sum(sky[n].values()) + rest[n]["Rest"] - 1.0)
                for n, _, _ in canyon)
    solve = lambda: view_factor_matrix_and_sky(canyon, matrix_params=mp, sky_params=sp)  # noqa: E731
    shared, _, _ = route_solve("auto", solve)
    separate = (route_solve("auto", lambda: view_factor_matrix(canyon, mp))[0],
                route_solve("auto", lambda: view_factor_to_tregenza_sky(canyon, sp))[0])
    per_emitter, n_r2, n_c2 = route_solve("grouped", solve)
    warm, _, _ = route_solve("auto", lambda: wall_times(solve, 3))
    print(f"[canyon workflow] outside workflow: {n_r} scheduled rounds, {n_c} chunks; worst "
          f"|scene + sky + rest - 1| {worst:.3e}; shared-ray dicts == the separate solves': "
          f"{shared == separate}; == the per-emitter route's ({n_c2} chunks): "
          f"{per_emitter == shared}; warm shared-ray solve {spread(warm)}; road: scene "
          f"{sum(scene['road'].values())!r}, sky {sky['road']['Sky']!r}, rest "
          f"{rest['road']['Rest']!r}")
    check(n_r > 0 and n_c == 0 and n_c2 > 0 and n_r2 == 0, "canyon workflow: wrong routes")
    check(worst <= 1e-9, f"canyon workflow: a row's scene + sky + rest is {worst} from 1")
    check(shared == separate, "canyon workflow: shared-ray dicts != the separate solves'")
    check(per_emitter == shared, "canyon workflow: scheduled dicts != per-emitter dicts")
    return dict(worst_row_error=worst, warm=warm, rounds=n_r)


def phase_city_sky(route_solve, trace_log, dev, config) -> dict:
    """18. The 1M-triangle city's sky and workflow: ``city_plates`` (ten
    ground plates and the 999,996 box triangles, 1,001,472 padded = 489
    tiles), samples=0, rays=256, 6 iterations, every mesh emitting, the
    boxes included. Merged and discrete sky, gated (bvh="auto") == "off",
    the scheduled route == the per-emitter route, slim == full; the
    shared-ray workflow gated == off, scheduled == per-emitter. Per solve:
    one launch of kernel #2 a round and of kernel #1 a chunk, in the
    variant the dispatch asked for, gated exactly when bvh is on, one
    crossing-kernel launch a gated dispatch, one count launch an output a
    dispatch, all on card tensors; warm walls, rays/s and peak device
    memory."""
    from raystrack_tpu_torch import (
        MatrixParams, PreparedSolver, SkyParams, view_factor_matrix_and_sky,
        view_factor_to_tregenza_sky,
    )
    from raystrack_tpu_torch.ops import trace as trace_mod
    from raystrack_tpu_torch.ops.count_cuda import count_bins
    from raystrack_tpu_torch.ops.trace_cuda import gate_cross, sweep_rays, sweep_rays_scheduled

    meshes = city_plates_meshes()
    ps = PreparedSolver(meshes)
    base = dict(samples=0, rays=256, min_iters=6, max_iters=6, device="gpu")
    sweeps = []  # (kernel, want_matrix, want_any, gated, on the card) of each sweep call
    real = trace_mod.sweep_rays, trace_mod.sweep_rays_scheduled

    def spy(kernel, fn):
        def call(rays, *args, **kwargs):
            sweeps.append((kernel, kwargs["want_matrix"], kwargs["want_any"],
                           kwargs.get("accel") is not None, rays.is_cuda))
            return fn(rays, *args, **kwargs)
        return call

    trace_mod.sweep_rays, trace_mod.sweep_rays_scheduled = spy(1, real[0]), spy(2, real[1])
    totals = dict(launches1=0, launches2=0, gated1=0, gated2=0, any_only=0, matrix_any=0)

    def solve_once(label, route, fn, gated, slim=False):
        """One solve through ``route`` with its launches checked."""
        n0 = {k: len(v) for k, v in trace_log.items()}
        s0 = len(sweeps)
        c0 = (sweep_rays.launches, sweep_rays.gated_launches, sweep_rays_scheduled.launches,
              sweep_rays_scheduled.gated_launches, gate_cross.launches, count_bins.launches)
        torch.cuda.reset_peak_memory_stats(dev)
        result, n_r, n_c = route_solve(route, fn)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        c1 = (sweep_rays.launches, sweep_rays.gated_launches, sweep_rays_scheduled.launches,
              sweep_rays_scheduled.gated_launches, gate_cross.launches, count_bins.launches)
        d = [b - a for a, b in zip(c0, c1)]
        kinds = trace_log["round_kinds"][n0["round_kinds"]:] + \
            trace_log["chunk_kinds"][n0["chunk_kinds"]:]
        calls = sweeps[s0:]
        rays = sum(trace_log["round_rays"][n0["round_rays"]:]) + \
            sum(trace_log["chunk_rays"][n0["chunk_rays"]:])
        on_card = all(trace_log["rounds"][n0["rounds"]:]) and \
            all(trace_log["dispatches"][n0["dispatches"]:]) and all(c[4] for c in calls)
        check(d[2] == n_r and d[0] == n_c and len(calls) == n_r + n_c,
              f"city {label}: kernel launches {d[2]} + {d[0]} for {n_r} rounds and {n_c} chunks")
        check(d[3] == (n_r if gated else 0) and d[1] == (n_c if gated else 0)
              and d[4] == (n_r + n_c if gated else 0),
              f"city {label}: gated launches {d[3]} + {d[1]}, crossing {d[4]}, gated={gated}")
        check([(c[1], c[2]) for c in calls] == kinds and all(c[3] == gated for c in calls),
              f"city {label}: a sweep launched another variant than its dispatch asked for")
        check(d[5] == sum(int(m) + int(a) for m, a in kinds),
              f"city {label}: {d[5]} count launches for {len(kinds)} dispatches")
        check(on_card, f"city {label}: a dispatch ran with a tensor off the card")
        check(not slim or (n_r == 0 and n_c > 0), f"city {label}: a slim solve took a round")
        totals["launches1"] += d[0]
        totals["launches2"] += d[2]
        totals["gated1"] += d[1]
        totals["gated2"] += d[3]
        totals["any_only"] += sum(1 for m, a in kinds if a and not m)
        totals["matrix_any"] += sum(1 for m, a in kinds if a and m)
        return result, dict(rounds=n_r, chunks=n_c, rays=rays, peak=peak, kinds=kinds)

    out = {}
    try:
        t0 = time.perf_counter()
        for discrete in (False, True):
            kind = "discrete" if discrete else "merged"
            sp = SkyParams(**base, discrete=discrete)
            results = {}
            for label, route, bvh in (("auto", "auto", "auto"), ("off", "auto", "off"),
                                      ("per-emitter", "grouped", "auto")):
                p = dataclasses.replace(sp, bvh=bvh)
                fn = lambda: view_factor_to_tregenza_sky(meshes, p, prepared=ps)  # noqa: E731, B023
                results[label], info = solve_once(f"sky {kind} {label}", route, fn,
                                                  gated=bvh == "auto")
                info["warm"], _, _ = route_solve(route, lambda: wall_times(fn, 3))  # noqa: B023
                out[f"sky {kind}, {label}"] = info
                if label == "auto" and discrete is False:
                    print(f"[city sky] first solve with set-up {time.perf_counter() - t0:.2f} s")
            with slim_threshold(config, 1):
                slim_ps = PreparedSolver(meshes)
                fn = lambda: view_factor_to_tregenza_sky(meshes, sp, prepared=slim_ps)  # noqa: E731, B023
                results["slim"], info = solve_once(f"sky {kind} slim", "auto", fn, gated=True,
                                                   slim=True)
                info["warm"], _, _ = route_solve("auto", lambda: wall_times(fn, 3))  # noqa: B023
                check(slim_ps.get_scene_pack(use_accel=True, device=dev).slim,
                      "the city's slim sky solve packed full")
                out[f"sky {kind}, slim"] = info
                del slim_ps
            same = {k: v == results["auto"] for k, v in results.items()}
            # the boxes cover the ground about 50 times over: no ground ray
            # reaches the sky, the roofs see it
            print(f"[city sky] {kind}: == the gated scheduled dict: {same}; ground_00 sky "
                  f"{sum(results['auto']['ground_00'].values())!r}, the boxes' "
                  f"{sum(results['auto'][meshes[-1][0]].values())!r}")
            check(all(same.values()), f"city sky {kind}: dicts differ: {same}")
            check(sum(results["auto"][meshes[-1][0]].values()) > 0.0, "city sky: no sky seen")
        mp = MatrixParams(**base)
        sp = SkyParams(**base)
        results = {}
        for label, route, bvh in (("auto", "auto", "auto"), ("off", "auto", "off"),
                                  ("per-emitter", "grouped", "auto")):
            m, s = dataclasses.replace(mp, bvh=bvh), dataclasses.replace(sp, bvh=bvh)
            fn = lambda: view_factor_matrix_and_sky(  # noqa: E731
                meshes, matrix_params=m, sky_params=s, prepared=ps)  # noqa: B023
            results[label], info = solve_once(f"workflow {label}", route, fn,
                                              gated=bvh == "auto")
            info["warm"], _, _ = route_solve(route, lambda: wall_times(fn, 3))  # noqa: B023
            out[f"workflow, {label}"] = info
        same = {k: v == results["auto"] for k, v in results.items()}
        print(f"[city workflow] shared-ray matrix and sky == the gated scheduled dicts: {same}")
        check(all(same.values()), f"city workflow: dicts differ: {same}")
        check(sum(len(row) for row in results["auto"][0].values()) > 0, "city workflow: no hits")
    finally:
        trace_mod.sweep_rays, trace_mod.sweep_rays_scheduled = real
    for name, info in out.items():
        warm = info["warm"]
        rate = (f", warm solve {spread(warm)} = {info['rays'] / float(np.median(warm)):.4g} "
                f"rays/s at the median")
        kinds = sorted(set(info["kinds"]))
        print(f"[city] {name}: {info['rounds']} rounds, {info['chunks']} chunks, variants "
              f"(matrix, any) {kinds}, {info['rays']} rays traced{rate}; peak device memory "
              f"{info['peak'] / 2**20:.1f} MiB")
    print(f"[launches] city sky and workflow: kernel #1 {totals['launches1']} "
          f"({totals['gated1']} gated), kernel #2 {totals['launches2']} ({totals['gated2']} "
          f"gated); dispatches any-only {totals['any_only']}, matrix + any "
          f"{totals['matrix_any']}; every one on the card, in its dispatch's variant")
    check(totals["any_only"] > 0 and totals["matrix_any"] > 0, "city: a variant never launched")
    out["totals"] = totals
    return out


# phase 19's kill/resume runs: the (b) settings give the ten plates 194
# iterations each (min_iters == max_iters: no convergence check stops a
# plate early; with a tolerance alone, most plates' rows do not vary between
# iterations and converge at the first check), in four scheduled rounds of
# 64, 64, 64 and 2 (a round carries at most MAX_CHUNK = 64 iterations an
# emitter); the per-emitter run (f) two chunks of one iteration of
# 2,560,000 rays
RESUME_ARGS = ["--samples", "0", "--rays", "256", "--min-iters", "194", "--max-iters", "194"]
RESUME_ROUNDS = 4
RESUME_ARGS_1 = ["--samples", "1", "--rays", "64", "--min-iters", "2", "--max-iters", "2"]
# (h): the (b) settings cut to 130 iterations, three rounds (64, 64 and 2:
# with CHECKPOINT_PROGRESS_S=0 a second set of snapshots), so that fifteen
# solves fit the phase's budget
COST_ITERS = dict(min_iters=130, max_iters=130)
COST_ROUNDS = 3


def cli_params(args):
    """The MatrixParams the port's CLI builds from ``matrix <scene> args``."""
    from raystrack_tpu_torch.cli import _matrix_params, build_parser

    return _matrix_params(build_parser().parse_args(["matrix", "scene.obj", *args]))


def same_fingerprint(ckpt: Path, params, meshes) -> bool:
    """Whether the checkpoints in ``ckpt`` were written for ``params`` and
    ``meshes`` (the store's fingerprint of both)."""
    import tempfile

    from raystrack_tpu_torch.solver import _CheckpointStore

    with tempfile.TemporaryDirectory(dir=ckpt.parent) as tmp:
        want = _CheckpointStore(tmp, params.as_dict(), meshes).fingerprint
    found = {json.loads(p.read_text())["fingerprint"] for p in ckpt.glob("emitter_*.json")}
    return found == {want}


class SnapshotKiller:
    """Start the port's CLI in child processes and SIGKILL each once its
    first progress snapshots are in its checkpoint directory: the ``n``
    snapshots of its first round or chunk, which one consume writes one
    after the other (a kill between two of them would restart the rest from
    iteration 0). A thread polls every 2 ms, so this process works on
    meanwhile; ``join()`` waits for every child, fails if one exited before
    its kill, and returns per child the seconds from its start to the kill
    and the snapshots' names."""

    def __init__(self, env: dict):
        import threading

        self.env = env
        self.children = []  # (name, ckpt, n, log, Popen, t0)
        self.result = {}  # written by the thread, read after join()
        self.thread = threading.Thread(target=self._poll, daemon=True)

    def start(self, name: str, cmd, ckpt: Path, n: int, log: Path) -> None:
        out = open(log, "w")
        child = subprocess.Popen(cmd, cwd=str(ckpt.parent), env=self.env, stdout=out,
                                 stderr=subprocess.STDOUT)
        out.close()
        self.children.append((name, ckpt, n, log, child, time.perf_counter()))

    def _poll(self) -> None:
        pending = list(self.children)
        while pending:
            for item in list(pending):
                name, ckpt, n, log, child, t0 = item
                snaps = sorted(p.name for p in ckpt.glob("*.progress.json"))
                if len(snaps) >= n:
                    child.kill()
                    self.result[name] = (time.perf_counter() - t0, snaps)
                    pending.remove(item)
                elif child.poll() is not None or time.perf_counter() - t0 > 300:
                    child.kill()
                    self.result[name] = None
                    pending.remove(item)
            time.sleep(0.002)

    def join(self) -> dict:
        self.thread.join()
        for name, ckpt, n, log, child, t0 in self.children:
            rc = child.wait()
            if self.result.get(name) is None:
                raise SystemExit(f"FAILED: the CLI solve {name} ended ({rc}) before its first "
                                 f"progress snapshots landed:\n{log.read_text()[-4000:]}")
            check(rc == -9, f"the CLI solve {name} ended with {rc}, not SIGKILL")
        return self.result

    def stop(self) -> None:
        """Kill and reap every child still running (on any failure)."""
        for *_, child, _t0 in self.children:
            if child.poll() is None:
                child.kill()
            child.wait()


def run_cli(argv) -> tuple:
    """``raystrack_tpu_torch.cli.main(argv)`` in this process (the console
    script's entry), with the solver's progress lines and the CLI's output
    captured: (rc, lines, stdout)."""
    import io as io_mod

    from raystrack_tpu_torch import cli

    buf = io_mod.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, lines = logged(lambda: cli.main(argv))
    return rc, lines, buf.getvalue()


def crash_and_resume(solve, dirs: Path):
    """``solve(checkpoint_dir)`` stopped by a crash in ``_entry_done`` at the
    first emitter that finishes, with a snapshot after every chunk or round,
    then resumed in the same directory (tests/test_checkpoint.py's kill).
    Returns the resumed result and whether a line said it resumed."""
    import raystrack_tpu_torch.solver as solver_mod
    from raystrack_tpu_torch import config

    real_done = solver_mod._entry_done
    snap = config.CHECKPOINT_PROGRESS_S

    def crash(entry):
        raise RuntimeError("killed mid-solve")

    config.CHECKPOINT_PROGRESS_S = 0.0
    solver_mod._entry_done = crash
    try:
        solve(str(dirs))
        raise SystemExit("FAILED: the crash in _entry_done did not stop the solve")
    except RuntimeError:
        pass
    finally:
        solver_mod._entry_done = real_done
        config.CHECKPOINT_PROGRESS_S = snap
    check(bool(list(dirs.rglob("*.progress.json"))), f"no progress snapshot in {dirs}")
    out, lines = logged(lambda: solve(str(dirs)))
    return out, any("resuming from iteration" in line for line in lines)


def stop_after_emitter_0(fn) -> list:
    """``fn()`` stopped by a crash in ``_entry_done`` at the first emitter to
    finish after emitter 0, with a snapshot after every round: emitter 0's
    row is checkpointed and streamed into a stream not yet published.
    Returns the emitters that finished, in order."""
    import raystrack_tpu_torch.solver as solver_mod
    from raystrack_tpu_torch import config

    real_done, snap, finished = solver_mod._entry_done, config.CHECKPOINT_PROGRESS_S, []

    def done_then_stop(entry):
        if 0 in finished:
            raise RuntimeError("killed mid-solve")
        real_done(entry)
        finished.append(entry["idx"])

    config.CHECKPOINT_PROGRESS_S = 0.0
    solver_mod._entry_done = done_then_stop
    try:
        fn()
        raise SystemExit("FAILED: no emitter finished after emitter 0")
    except RuntimeError:
        pass
    finally:
        solver_mod._entry_done = real_done
        config.CHECKPOINT_PROGRESS_S = snap
    return finished


def logged(fn):
    """``fn()`` with the solver's progress lines captured: (result, lines)."""
    import raystrack_tpu_torch.solver as solver_mod

    lines, quiet = [], solver_mod._log
    solver_mod._log = lines.append
    try:
        return fn(), lines
    finally:
        solver_mod._log = quiet


def trace_kernels(trace_dir: Path) -> dict:
    """{kernel name: launches} of the CUDA kernels in the Chrome traces
    ``RAYSTRACK_TPU_PROFILE`` wrote into ``trace_dir``."""
    counts = {}
    for path in trace_dir.glob("matrix_solve.*.json"):
        for ev in json.loads(path.read_text())["traceEvents"]:
            if ev.get("cat") == "kernel":
                counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    return counts


def phase_resume(route_solve, trace_log, dev, config, lib_path: Path, city_plates,
                 city) -> dict:
    """19. Checkpoints, streaming, scene files and the CLI on the card: the
    1M-triangle ``city_plates`` written as an OBJ file, a CLI solve of it
    SIGKILLed at its first progress snapshots and resumed (the streamed
    file == the uninterrupted solve, fewer rounds, every one gated kernel
    #2), a third solve that restores everything and launches nothing; the
    same kill for ground -> city on the per-emitter route; the canyon's sky
    and workflow crashed and resumed on both routes; a profile trace; the
    checkpoints' cost in warm walls. The two CLI children run while this
    process solves the references (the timed walls of (h) come after
    both are gone)."""
    import os
    import shutil
    import tempfile

    from examples.ex00_street_canyon_geometry import build_street_canyon
    from raystrack_tpu_torch import (
        MatrixParams, SkyParams, VFMatrixStreamWriter, cli, clear_prepared_cache,
        load_vf_matrix_json, save_meshes_obj, view_factor, view_factor_matrix,
        view_factor_outside_workflow, view_factor_to_tregenza_sky,
    )
    from raystrack_tpu_torch.ops.count_cuda import count_bins
    from raystrack_tpu_torch.ops.trace_cuda import gate_cross, sweep_rays, sweep_rays_scheduled

    def counts():
        return dict(k1=sweep_rays.launches, k1_gated=sweep_rays.gated_launches,
                    k2=sweep_rays_scheduled.launches,
                    k2_gated=sweep_rays_scheduled.gated_launches,
                    count=count_bins.launches, cross=gate_cross.launches,
                    rounds=len(trace_log["rounds"]), chunks=len(trace_log["dispatches"]))

    def since(c0):
        return {k: v - c0[k] for k, v in counts().items()}

    out = {}
    c_start = counts()
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="smoke_resume_", dir=root))
    env = dict(os.environ, PYTHONPATH=str(ROOT), RAYSTRACK_TPU_CHECKPOINT_PROGRESS_S="0")
    lib_stamp = (lib_path.stat().st_mtime_ns, sorted(p.name for p in lib_path.parent.iterdir()))
    killer = SnapshotKiller(env)
    t_phase = time.perf_counter()
    try:
        # (a) the scene files
        t0 = time.perf_counter()
        scene = Path(save_meshes_obj(city_plates, str(work / "city_plates.obj")))
        pair = Path(save_meshes_obj(city, str(work / "ground_city.obj")))
        write_s = time.perf_counter() - t0
        print(f"[resume] (a) {scene.name}: {len(city_plates)} meshes, "
              f"{sum(F.shape[0] for _, _, F in city_plates)} triangles, "
              f"{scene.stat().st_size} bytes ({pair.name}, ground and city: "
              f"{pair.stat().st_size}); both written by save_meshes_obj in {write_s:.2f} s")

        # (b), (f): the CLI solves, each killed at its first progress snapshots
        torch.cuda.empty_cache()
        ckpt, stream = work / "ckpt", work / "vf_stream.json"
        argv = ["matrix", str(scene), "--device", "gpu", "--checkpoint-dir", str(ckpt),
                "--stream-out", "--out", str(stream), *RESUME_ARGS]
        ckpt1 = work / "ckpt1"
        argv1 = ["matrix", str(pair), "--device", "gpu", "--checkpoint-dir", str(ckpt1),
                 "--stream-out", "--out", str(work / "vf1_killed.json"), *RESUME_ARGS_1]
        killer.start("b", [sys.executable, "-m", "raystrack_tpu_torch", *argv], ckpt, 10,
                     work / "child_b.log")
        killer.start("f", [sys.executable, "-m", "raystrack_tpu_torch", *argv1], ckpt1, 1,
                     work / "child_f.log")
        killer.thread.start()

        # meanwhile: the uninterrupted solves of the same meshes with the
        # parameters the CLI builds (the children's checkpoints' fingerprint
        # shows both below)
        params, params1 = cli_params(RESUME_ARGS), cli_params(RESUME_ARGS_1)
        c0 = counts()
        t0 = time.perf_counter()
        (plain, lines), n_r, n_c = route_solve("auto", lambda: logged(
            lambda: view_factor_matrix(city_plates, params)))
        first_s = time.perf_counter() - t0
        d = since(c0)
        # the drivers' time: an emitter's line gives the seconds from the
        # start of the rounds to its completion (the set-up before excluded)
        rounds_s = max(float(m.group(1)) for m in (
            re.search(r"-> (\d+\.\d+)s", line) for line in lines) if m)
        check(n_r == RESUME_ROUNDS and n_c == 0 and d["k2_gated"] == d["k2"] == n_r,
              f"the uninterrupted solve: {n_r} rounds, {n_c} chunks, launches {d}")
        check(rounds_s >= 2.0, f"the uninterrupted solve's rounds took {rounds_s:.2f} s, "
              f"under 2 s")
        print(f"[resume] uninterrupted view_factor_matrix of city_plates with the (b) "
              f"settings: {n_r} scheduled rounds, each one gated kernel #2 launch; "
              f"{first_s:.2f} s with set-up, {rounds_s:.3f} s from the first round to the "
              f"last emitter's end (the two children sharing the card)")
        c0 = counts()
        vf1, n_r1, n_c1 = route_solve("auto", lambda: view_factor(city[0], city[1], params1))
        d_plain = since(c0)
        check(n_c1 == 2 and n_r1 == 0 and d_plain["k1_gated"] == 2,
              f"the uninterrupted ground -> city: {n_r1} rounds, {n_c1} chunks, {d_plain}")

        # (e) the canyon's sky and workflow, crashed and resumed, both routes
        canyon = build_street_canyon()
        sp = SkyParams(**sky_base(discrete=True))
        mp, sp2 = MatrixParams(**sky_base()), SkyParams(**sky_base())
        for route in ("auto", "grouped"):
            want_sky, _, _ = route_solve(route, lambda: view_factor_to_tregenza_sky(canyon, sp))
            (got_sky, said), n_r2, n_c2 = route_solve(route, lambda: crash_and_resume(
                lambda ck: view_factor_to_tregenza_sky(canyon, sp, checkpoint_dir=ck),
                work / f"sky_{route}"))
            want_wf, _, _ = route_solve(route, lambda: view_factor_outside_workflow(
                canyon, matrix_params=mp, sky_params=sp2))
            (got_wf, said2), _, _ = route_solve(route, lambda: crash_and_resume(
                lambda ck: view_factor_outside_workflow(canyon, matrix_params=mp,
                                                        sky_params=sp2, checkpoint_dir=ck),
                work / f"wf_{route}"))
            check(said and said2, f"canyon ({route}): a resume did not resume mid-emitter")
            check(got_sky == want_sky and got_wf == want_wf,
                  f"canyon ({route}): a resumed sky or workflow != the uninterrupted one")
            print(f"[resume] (e) canyon, {'scheduled' if route == 'auto' else 'per-emitter'}: "
                  f"discrete sky and outside workflow crashed at the first emitter to finish "
                  f"and resumed from their snapshots ({n_r2} rounds, {n_c2} chunks in the "
                  f"sky's two runs): == the uninterrupted results")

        # (g) the profile hook
        trace_dir = work / "profile"
        os.environ["RAYSTRACK_TPU_PROFILE"] = str(trace_dir)
        try:
            c0 = counts()
            _, n_r3, _ = route_solve("auto", lambda: view_factor_matrix(
                city_plates, dataclasses.replace(params, min_iters=6, max_iters=6)))
            d = since(c0)
        finally:
            del os.environ["RAYSTRACK_TPU_PROFILE"]
        kernels = trace_kernels(trace_dir)
        named = {k: v for k, v in kernels.items() if "sweep_sched_kernel" in k}
        check(bool(named) and sum(named.values()) == d["k2"] == n_r3,
              f"the profile trace holds {named} for {d['k2']} kernel #2 launches")
        print(f"[resume] (g) RAYSTRACK_TPU_PROFILE: {len(list(trace_dir.glob('*.json')))} "
              f"trace file(s), {sum(kernels.values())} kernel events; the sweep: {named}")

        # the children, killed
        killed = killer.join()
        (kill_s, snaps), (kill1_s, snaps1) = killed["b"], killed["f"]
        check(not stream.exists(), "the killed solve published its streamed file")
        # a copy of (b)'s directory for (c2), before (c) resumes it
        ckpt2 = work / "ckpt2"
        shutil.copytree(ckpt, ckpt2)
        check(same_fingerprint(ckpt, params, city_plates)
              and same_fingerprint(ckpt1, params1, city),
              "the CLI's checkpoints were written for other parameters or meshes")
        child_log = (work / "child_b.log").read_text()
        print(f"[resume] (b) python -m raystrack_tpu_torch {' '.join(argv[:1] + argv[2:])}: "
              f"SIGKILLed {kill_s:.2f} s after its start, with {len(snaps)} progress snapshots "
              f"and {len(list(ckpt.glob('emitter_?????.json')))} finished checkpoint(s) on "
              f"disk (the boxes', which trace nothing); its last line: "
              f"{child_log.strip().splitlines()[-1]!r}")
        new_stamp = (lib_path.stat().st_mtime_ns,
                     sorted(p.name for p in lib_path.parent.iterdir()))
        check(new_stamp == lib_stamp, "a child process rebuilt the kernels' library")
        print(f"[resume] both children loaded {lib_path.name} as built: no nvcc run "
              f"(the library's mtime and the build directory unchanged)")

        # (c) the same command again, to completion
        loads = []
        real_load = cli._load_meshes

        def timed_load(path):
            t0 = time.perf_counter()
            meshes = real_load(path)
            loads.append((time.perf_counter() - t0, meshes))
            return meshes

        cli._load_meshes = timed_load
        try:
            c0 = counts()
            rc, lines, text = run_cli(argv)
            d = since(c0)
        finally:
            cli._load_meshes = real_load
        load_s, loaded = loads[0]
        check([m[0] for m in loaded] == [m[0] for m in city_plates]
              and all(np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
                      for a, b in zip(loaded, city_plates)),
              "the OBJ file did not load back the city's arrays")
        del loads, loaded
        resumed = [line for line in lines if "resuming from iteration" in line]
        streamed = load_vf_matrix_json(str(stream))
        check(rc == 0 and len(resumed) == 10, f"the resumed CLI solve: rc {rc}, "
              f"{len(resumed)} 'resuming from iteration' lines of 10")
        check(streamed == plain, "the resumed solve's streamed file != the uninterrupted dict")
        check(d["k2"] == d["k2_gated"] == d["rounds"] < n_r and d["k1"] == 0
              and d["cross"] == d["rounds"] and d["count"] == d["rounds"],
              f"the resumed solve's launches {d} against {n_r} uninterrupted rounds")
        check(not list(ckpt.glob("*.progress.json")), "snapshots left after the resume")
        print(f"[resume] (c) the same command again (the CLI's main in this process): "
              f"load_meshes_obj {load_s:.2f} s, the arrays == the generated ones; "
              f"{resumed[0]!r} (and 9 more); {d['rounds']} rounds against {n_r} "
              f"uninterrupted, kernel #2 {d['k2']} launches, all gated, crossing "
              f"{d['cross']}, count {d['count']}, kernel #1 {d['k1']}; the streamed file "
              f"(load_vf_matrix_json) == the uninterrupted dict: True ({len(streamed)} rows)")
        out.update(obj_bytes=scene.stat().st_size, obj_write_s=write_s, obj_load_s=load_s,
                   rounds_uninterrupted=n_r, rounds_resumed=d["rounds"],
                   uninterrupted_rounds_s=rounds_s, kill_s=kill_s, resumed_launches=d)

        # (d) a third solve restores every emitter and launches nothing
        c0 = counts()
        third, lines = logged(lambda: view_factor_matrix(city_plates, params,
                                                         checkpoint_dir=str(ckpt)))
        d = since(c0)
        check(any(line.startswith("11/11 emitters restored") for line in lines),
              f"the third run: {lines[-1:]!r}")
        check(all(v == 0 for v in d.values()), f"the third run launched {d}")
        check(third == plain, "the third run's dict != the uninterrupted dict")
        print(f"[resume] (d) a third solve (view_factor_matrix, the same checkpoint_dir): "
              f"{lines[-1]!r}; no launch ({d}); its dict == the uninterrupted dict")

        # (c2) the copy of (b)'s directory resumed by the same command, stopped
        # once emitter 0 has finished in the last round (its row streamed,
        # the stream unpublished), then the same command again: the
        # restored rows stream again, and the file == the uninterrupted dict
        stream2 = work / "vf_stream2.json"
        argv2 = ["matrix", str(scene), "--device", "gpu", "--checkpoint-dir", str(ckpt2),
                 "--stream-out", "--out", str(stream2), *RESUME_ARGS]
        c0 = counts()
        finished = stop_after_emitter_0(lambda: run_cli(argv2))
        d_stop = since(c0)
        check(finished[-1:] == [0] and (ckpt2 / "emitter_00000.json").exists()
              and not stream2.exists(), f"the stopped run: finished {finished}")
        c0 = counts()
        rc, lines, _ = run_cli(argv2)
        d = since(c0)
        restored = [line for line in lines if "] restored from checkpoint (" in line]
        check(rc == 0 and restored[:1] and restored[0].startswith("(1/"),
              f"the run resumed after emitter 0 finished: rc {rc}, restored {restored}")
        check(load_vf_matrix_json(str(stream2)) == plain,
              "the run resumed after emitter 0 finished: its streamed file != the "
              "uninterrupted dict")
        print(f"[resume] (c2) the same command on a copy of (b)'s directory, stopped in "
              f"round {d_stop['rounds']} of its resume once emitter 0 had finished "
              f"({len(finished)} emitter(s) finished, the stream unpublished), then run "
              f"again: {len(restored)} emitters restored ({restored[0]!r}), {d['rounds']} "
              f"round(s); the streamed file == the uninterrupted dict: True")
        out.update(stop_rounds=d_stop["rounds"], stop_restored=len(restored),
                   stop_resumed_rounds=d["rounds"])

        # (f) the per-emitter route: ground -> city
        stream1 = work / "vf1.json"
        c0 = counts()
        with VFMatrixStreamWriter(str(stream1)) as writer:
            got1, lines = logged(lambda: view_factor_matrix(
                city, params1, checkpoint_dir=str(ckpt1), row_sink=writer.write_row))
        d = since(c0)
        check(any("resuming from iteration 1" in line for line in lines),
              f"the per-emitter resume: {lines!r}")
        check(got1["ground"] == vf1["ground"] and load_vf_matrix_json(str(stream1)) == got1,
              "the per-emitter resume's row or streamed file != the uninterrupted solve's")
        check(d["chunks"] == d["k1"] == d["k1_gated"] == 1 and d["k2"] == 0,
              f"the per-emitter resume's launches {d}")
        print(f"[resume] (f) ground -> city, the per-emitter route: the child "
              f"(python -m raystrack_tpu_torch {' '.join(argv1[:1] + argv1[2:])}) SIGKILLed "
              f"{kill1_s:.2f} s after its start with {snaps1}; resumed by "
              f"view_factor_matrix(checkpoint_dir=, row_sink=VFMatrixStreamWriter): "
              f"{d['chunks']} chunk, kernel #1 {d['k1']} launch, gated, against "
              f"{n_c1} chunks of an uninterrupted view_factor(ground, city); its ground row == "
              f"view_factor's, and the streamed file == the resumed dict: True")
        out.update(chunks_uninterrupted=n_c1, chunks_resumed=d["chunks"], kill1_s=kill1_s)

        # (h) what checkpoints cost: warm walls of the city_plates matrix
        cost_params = dataclasses.replace(params, **COST_ITERS)
        walls = {}
        snap = config.CHECKPOINT_PROGRESS_S
        for label, ck, every in (("no checkpoint_dir", False, snap),
                                 (f"checkpoint_dir, CHECKPOINT_PROGRESS_S={snap:g}", True,
                                  snap),
                                 ("checkpoint_dir, CHECKPOINT_PROGRESS_S=0", True, 0.0)):
            config.CHECKPOINT_PROGRESS_S = every
            times = []
            try:
                for rep in range(5):
                    d_ck = str(work / f"cost_{len(walls)}_{rep}") if ck else None
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, n_r4, _ = route_solve("auto", lambda: view_factor_matrix(
                        city_plates, cost_params, checkpoint_dir=d_ck))  # noqa: B023
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    check(n_r4 == COST_ROUNDS, f"the cost solve took {n_r4} rounds")
            finally:
                config.CHECKPOINT_PROGRESS_S = snap
            walls[label] = sorted(times)
        # what the store's set-up costs on the host: the fingerprint hashes
        # the meshes' bytes, as the prepared cache's key does
        from raystrack_tpu_torch.solver import _CheckpointStore, hash_meshes

        store_s, hash_s = [], []
        for rep in range(5):
            t0 = time.perf_counter()
            _CheckpointStore(str(work / f"store_{rep}"), cost_params.as_dict(), city_plates)
            store_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            hash_meshes(hashlib.sha256(), city_plates)
            hash_s.append(time.perf_counter() - t0)
        n_bytes = sum(V.nbytes + F.nbytes for _, V, F in city_plates)
        card = card_line()
        print(f"[resume] (h) _CheckpointStore(...) of city_plates on the host: "
              f"{spread(sorted(store_s))}; of it hash_meshes over the {n_bytes} bytes of "
              f"geometry: {spread(sorted(hash_s))}")
        out.update(store_s=sorted(store_s), hash_s=sorted(hash_s))
        for label, times in walls.items():
            print(f"[resume] (h) city_plates matrix, {COST_ROUNDS} rounds "
                  f"({cost_params.max_iters} iterations), {label}: warm solve "
                  f"{spread(times)} [{card}]")
        out["cost_walls"] = walls
        out["launches"] = since(c_start)
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"[resume] phase 19 took {out['phase_s']:.1f} s")
    finally:
        killer.stop()
        shutil.rmtree(work, ignore_errors=True)
        clear_prepared_cache()
    return out


MULTIHOST_CHILD = "--multihost-child"  # phase 20's child processes: chip_smoke.py <this> ...
MESH_SHARDS = (None, "card", 2, 4)  # phase 20's meshes: none, ray_mesh(), logical 2 and 4


def multihost_child(coordinator: str, n_procs: str, rank: str, go: str, out: str) -> int:
    """Phase 20's child: process ``rank`` of ``n_procs`` on gloo. Once the
    parent creates ``go`` it solves the district with
    ``view_factor_matrix_multihost`` four times (the first with set-up) and
    writes the merged dict, the walls and its kernel launches to ``out``."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    import raystrack_tpu_torch.solver as solver_mod
    from raystrack_tpu_torch.ops.count_cuda import count_bins
    from raystrack_tpu_torch.ops.trace_cuda import sweep_rays, sweep_rays_scheduled
    from raystrack_tpu_torch import PreparedSolver
    from raystrack_tpu_torch.parallel import initialize, view_factor_matrix_multihost

    solver_mod._log = lambda line: None
    joined = initialize(coordinator, int(n_procs), int(rank))
    district, params = solve_cases()["district"]
    prepared = PreparedSolver(district)
    t0 = time.perf_counter()
    while not Path(go).exists():
        if time.perf_counter() - t0 > 600:
            raise SystemExit("the parent never started the solves")
        time.sleep(0.02)
    walls = []
    try:
        for _ in range(4):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            merged = view_factor_matrix_multihost(district, params, prepared=prepared)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps({
        "process": list(joined), "device": torch.cuda.current_device(), "walls": walls,
        "launches": [sweep_rays.launches, sweep_rays_scheduled.launches, count_bins.launches],
        "matrix": merged}))
    return 0


def phase_parallel(dev, city_ps, city_plates_ps, city, city_plates, cases, city_dicts):
    """20. The parallel layer on the card: the 1M city's ground -> city
    (per-emitter route, gated kernel #1) and ``city_plates`` (one scheduled
    round, gated kernel #2) on four meshes (none, ``ray_mesh()``, a logical
    mesh of 2 and of 4 shards on this card), through ``view_factor_matrix``:
    every dict == the unsharded one (and == phase 12's), the kernels'
    launches == shards x chunks or rounds, warm walls of 5, peak device
    bytes of a warm solve; then the district solved by two
    ``view_factor_matrix_multihost`` processes on gloo sharing this card
    (started at the phase's start, solving once this process is idle)
    against one process, dicts == ``view_factor_matrix``."""
    import os
    import tempfile

    import raystrack_tpu_torch.parallel.sharding as sharding_mod
    import raystrack_tpu_torch.solver as solver_mod
    from raystrack_tpu_torch import PreparedSolver, view_factor_matrix
    from raystrack_tpu_torch.ops.count_cuda import count_bins
    from raystrack_tpu_torch.ops.trace_cuda import gate_cross, sweep_rays, sweep_rays_scheduled
    from raystrack_tpu_torch.parallel import ray_mesh, view_factor_matrix_multihost

    t_phase = time.perf_counter()
    quiet = solver_mod._log
    solver_mod._log = lambda line: None
    district, district_params = cases["district"]
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_parallel_", dir=ROOT / "build"))
    go = tmp / "go"
    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(key, None)
    children = []
    for rank in range(2):
        with open(tmp / f"proc{rank}.log", "w") as log:
            children.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), MULTIHOST_CHILD, coordinator,
                 "2", str(rank), str(go), str(tmp / f"proc{rank}.json")],
                cwd=str(tmp), env=env, stdout=log, stderr=subprocess.STDOUT))
    out = {"solves": {}}
    try:
        chunks, rounds = [], []
        dispatch = solver_mod._EmitterRun.dispatch_chunk
        real_sharded = sharding_mod.scheduled_trace_sharded

        def counted_chunk(self, chunk, **kwargs):
            chunks.append(chunk)
            return dispatch(self, chunk, **kwargs)

        def counted_sharded(*args, **kwargs):
            rounds.append(1)
            return real_sharded(*args, **kwargs)

        solver_mod._EmitterRun.dispatch_chunk = counted_chunk
        sharding_mod.scheduled_trace_sharded = counted_sharded

        def counts():
            return dict(k1=sweep_rays.launches, k1_gated=sweep_rays.gated_launches,
                        k2=sweep_rays_scheduled.launches,
                        k2_gated=sweep_rays_scheduled.gated_launches,
                        count=count_bins.launches, cross=gate_cross.launches)

        # (meshes, params, prepared, phase 12's dict, the rows it holds): the
        # ground's row is what view_factor(ground, city) returns
        solves = {
            "ground -> city (per-emitter, gated #1)": (
                city, cases["city"][1], city_ps, city_dicts["view_factor ground -> city"],
                ["ground"]),
            "city_plates (scheduled, gated #2)": (
                city_plates, cases["city_plates"][1], city_plates_ps,
                city_dicts["view_factor_matrix, ten plates"], [n for n, _, _ in city_plates]),
        }
        for label, (meshes, params, ps, phase12, rows) in solves.items():
            base = None
            for shards in MESH_SHARDS:
                mesh = (None if shards is None else ray_mesh() if shards == "card"
                        else ray_mesh([dev] * shards))
                n_shards = 1 if mesh is None else mesh.size
                name = "none" if mesh is None else f"{shards} shards" if shards != "card" \
                    else f"ray_mesh() ({n_shards} card)"
                solve = lambda: view_factor_matrix(meshes, params, prepared=ps,  # noqa: E731
                                                   mesh=mesh)  # noqa: B023
                del chunks[:], rounds[:]
                c0 = counts()
                got = solve()
                torch.cuda.synchronize()
                d = {k: v - c0[k] for k, v in counts().items()}
                n_rounds, n_chunks = len(rounds), len(chunks)
                if base is None:
                    base = got
                check(got == base, f"parallel {label}, mesh {name}: dict != the unsharded dict")
                check({r: got[r] for r in rows} == phase12,
                      f"parallel {label}, mesh {name}: dict != phase 12's")
                per_emitter = n_rounds == 0
                check((n_chunks > 0) if per_emitter else (n_chunks == 0 and n_rounds > 0),
                      f"parallel {label}, mesh {name}: {n_chunks} chunks, {n_rounds} rounds")
                n_disp = n_chunks or n_rounds
                want = dict(k1=n_shards * n_chunks, k1_gated=n_shards * n_chunks,
                            k2=n_shards * n_rounds, k2_gated=n_shards * n_rounds,
                            count=n_shards * n_disp, cross=n_shards * n_disp)
                check(d == want, f"parallel {label}, mesh {name}: launches {d}, want {want} "
                      f"({n_shards} shards x {n_disp} dispatches)")
                walls = wall_times(solve, 5)
                gc.collect()
                torch.cuda.reset_peak_memory_stats(dev)
                resident = torch.cuda.memory_allocated(dev)
                solve()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated(dev)
                out["solves"][f"{label}, {name}"] = dict(
                    shards=n_shards, chunks=n_chunks, rounds=n_rounds, launches=d,
                    warm_s=walls, peak_bytes=peak, resident_bytes=resident)
                print(f"[parallel] {label}, mesh {name}: {n_chunks} chunks, {n_rounds} rounds; "
                      f"launches #1 {d['k1']} ({d['k1_gated']} gated), #2 {d['k2']} "
                      f"({d['k2_gated']} gated), count {d['count']}, crossing {d['cross']}; "
                      f"dict == unsharded == phase 12's; warm solve {spread(walls)}; peak "
                      f"device memory of a warm solve {peak / 2**20:.1f} MiB "
                      f"({resident / 2**20:.1f} MiB resident before it)")
            none = out["solves"][f"{label}, none"]["peak_bytes"]
            four = out["solves"][f"{label}, 4 shards"]["peak_bytes"]
            print(f"[parallel] {label}: peak device bytes, 4 shards / none = "
                  f"{four / none:.4f} ({four} / {none})")
            check(four <= 1.05 * none, f"parallel {label}: the 4-shard solve's peak "
                  f"{four} B is more than 5% over the unsharded {none} B: replicas multiply")
        n_cards = len(ray_mesh().distinct)
        check(len(city_ps._scene_pack_cache) == len(city_plates_ps._scene_pack_cache) == n_cards,
              f"not one scene pack a card ({n_cards}): a logical mesh built a second copy")
        solver_mod._EmitterRun.dispatch_chunk = dispatch
        sharding_mod.scheduled_trace_sharded = real_sharded

        # the district: one process, then the two children on gloo
        single = view_factor_matrix(district, district_params)
        district_ps = PreparedSolver(district)
        one_walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            alone = view_factor_matrix_multihost(district, district_params,
                                                 prepared=district_ps)
            torch.cuda.synchronize()
            one_walls.append(time.perf_counter() - t0)
        check(alone == single, "parallel district: one process's multihost dict != "
              "view_factor_matrix's")
        go.touch()
        t0 = time.perf_counter()
        for child in children:
            child.wait(timeout=300)
        two_s = time.perf_counter() - t0
        for rank, child in enumerate(children):
            check(child.returncode == 0, f"multihost child {rank} failed ({child.returncode}):"
                  f"\n{(tmp / f'proc{rank}.log').read_text()[-4000:]}")
        procs = [json.loads((tmp / f"proc{rank}.json").read_text()) for rank in range(2)]
        same = procs[0]["matrix"] == procs[1]["matrix"] == json.loads(json.dumps(single))
        print(f"[parallel] district ({len(district)} emitters), view_factor_matrix_multihost: "
              f"one process {spread(sorted(one_walls[1:]))} (set-up solve "
              f"{one_walls[0]:.3f} s); two processes on gloo: "
              + "; ".join(f"rank {p['process'][0]} of {p['process'][1]} on cuda:{p['device']}: "
                          f"warm {spread(sorted(p['walls'][1:]))}, set-up solve "
                          f"{p['walls'][0]:.3f} s, launches #1 {p['launches'][0]}"
                          for p in procs)
              + f"; both done {two_s:.2f} s after the start signal; the two merged dicts == "
              f"each other == view_factor_matrix's: {same}")
        check(same, "parallel district: the two processes' merged dicts differ from each "
              "other or from the single-process solve")
        out["district"] = dict(one_process_s=one_walls, two_process_s=[p["walls"] for p in procs],
                               two_process_wall_s=two_s,
                               child_launches=[p["launches"] for p in procs])
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
            child.wait()
        solver_mod._log = quiet
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[parallel] phase 20 took {out['phase_s']:.1f} s")
    return out


# Copied from examples/ex02_compare_sky_vf.py (GROUND_NAME, GROUND_MARGIN,
# ground_plane), which imports the JAX package at module level.
GROUND_NAME = "infinite_ground"
GROUND_MARGIN = 100.0  # extra extent beyond the scene bounds


def ground_plane(meshes):
    """A large ground quad sized from the scene bounds, slightly below the
    lowest z so it never lies coplanar with scene geometry."""
    all_v = np.concatenate([V for _, V, _ in meshes], axis=0)
    lo = all_v.min(axis=0)
    hi = all_v.max(axis=0)
    x0, x1 = float(lo[0] - GROUND_MARGIN), float(hi[0] + GROUND_MARGIN)
    y0, y1 = float(lo[1] - GROUND_MARGIN), float(hi[1] + GROUND_MARGIN)
    z = float(lo[2]) - 1e-3
    V = np.array([[x0, y0, z], [x1, y0, z], [x1, y1, z], [x0, y1, z]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return GROUND_NAME, V, F


EX02_GROUND_RAYS = 89_458_688  # 836 x 836 cells x 128 rays: past SCHED_MAX_FLAT_RAYS
HALTON_CHECK_LENGTH = 4_194_304  # phase 21's whole tables, against the host build
HALTON_GRID_SIDE = 2048  # and its (u, v) grid of as many cells
HALTON_SAMPLED = 10_000  # random indices of the ground's tables checked exactly


def ex02_case(samples=16):
    """ex02's matrix (examples/ex02_compare_sky_vf.py): the canyon and its
    ground plane at ex02's own MatrixParams, on the card."""
    from raystrack_tpu_torch import MatrixParams
    from examples.ex00_street_canyon_geometry import build_street_canyon

    canyon = build_street_canyon()
    return canyon + [ground_plane(canyon)], MatrixParams(
        samples=samples, rays=128, seed=20, bvh="auto", device="gpu", min_iters=1,
        tol=1e-4, tol_mode="stderr", max_iters=50, reciprocity=False)


@contextlib.contextmanager
def halton_builds(records: list):
    """Inside the block each Halton table build appends ``(length, base,
    where, seconds)`` to ``records`` (a (u, v) grid of g*g cells as
    ``(g*g, "grid", ...)``): ``where`` is "device", "host" or "disk", the
    seconds from a drained card to a drained card."""
    from raystrack_tpu_torch.ops import halton

    names = ("_halton_dim", "_halton_dim_device", "_halton_dim_host",
             "_halton_grid_device", "_halton_grid_host")
    real = {name: getattr(halton, name) for name in names}
    where = []

    def timed(build, key):
        def run(*args):
            torch.cuda.synchronize()
            where.clear()
            t0 = time.perf_counter()
            out = build(*args)
            torch.cuda.synchronize()
            records.append(key(*args) + (where[0] if where else "disk",
                                         time.perf_counter() - t0))
            return out
        return run

    def at(label, build):
        def run(*args):
            where.append(label)
            return build(*args)
        return run

    halton._halton_dim = timed(real["_halton_dim"], lambda length, base, dev=None: (length, base))
    halton._halton_dim_device = at("device", real["_halton_dim_device"])
    halton._halton_dim_host = at("host", real["_halton_dim_host"])
    halton._halton_grid_device = timed(at("device", real["_halton_grid_device"]),
                                       lambda g, dev: (g * g, "grid"))
    halton._halton_grid_host = timed(at("host", real["_halton_grid_host"]),
                                     lambda g: (g * g, "grid"))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(halton, name, fn)


@contextlib.contextmanager
def device_halton(on: bool):
    """``RAYSTRACK_TPU_DEVICE_HALTON`` at auto (``on``) or 0 inside the block,
    the dims and grid caches empty before and after."""
    import os

    from raystrack_tpu_torch import config
    from raystrack_tpu_torch.ops import halton

    previous = os.environ.pop(config.DEVICE_HALTON_ENV, None)
    if not on:
        os.environ[config.DEVICE_HALTON_ENV] = "0"
    halton.cached_halton_dims.cache_clear()
    halton.cached_halton.cache_clear()
    try:
        yield
    finally:
        os.environ.pop(config.DEVICE_HALTON_ENV, None)
        if previous is not None:
            os.environ[config.DEVICE_HALTON_ENV] = previous
        halton.cached_halton_dims.cache_clear()
        halton.cached_halton.cache_clear()


def setup_and_warm(meshes, params, on: bool) -> tuple:
    """A fresh PreparedSolver's first solve (its set-up included) and one
    warm solve, with the device builder on (auto) or off: ``(stats, dict)``.
    ``stats``: both walls, set-up = first - warm, the Halton builds of both
    solves and their seconds, the peak device bytes from the first solve on."""
    from raystrack_tpu_torch import PreparedSolver, view_factor_matrix

    gc.collect()
    torch.cuda.empty_cache()
    builds = []
    with device_halton(on), halton_builds(builds):
        ps = PreparedSolver(meshes)
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vf = view_factor_matrix(meshes, params, prepared=ps)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        del ps
    gc.collect()
    torch.cuda.empty_cache()
    return dict(first_s=walls[0], warm_s=walls[1], setup_s=walls[0] - walls[1],
                halton_s=sum(b[3] for b in builds), halton_builds=builds,
                peak_bytes=peak), vf


def check_ex02_rows(vf, meshes, label: str) -> None:
    """ex02's rows: every mesh emits, every value finite and in [0, 1], each
    row's sum at most 1 (the rest is sky), the ground sees the canyon."""
    check(set(vf) == {name for name, _, _ in meshes}, f"{label}: rows {sorted(vf)}")
    for name, row in vf.items():
        values = np.array(list(row.values()), dtype=np.float64)
        check(bool(np.all(np.isfinite(values)) and np.all(values >= 0.0)
                   and values.sum() <= 1.0 + 1e-6), f"{label}: row {name} out of range")
    check(sum(vf[GROUND_NAME].values()) > 0.0, f"{label}: the ground sees nothing")


def phase_halton(dev, launches) -> dict:
    """Phase 21: the device Halton builder bitwise against the host build,
    ex02's matrix at full settings without a host table of the ground's
    length, and the device path against the host path."""
    from raystrack_tpu_torch import PreparedSolver
    from raystrack_tpu_torch.ops import halton

    t_phase = time.perf_counter()
    out = {"bitwise_4m": {}}
    n4 = HALTON_CHECK_LENGTH
    for base in halton.BASES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = halton._halton_dim_device(n4, base, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = halton._halton_dim_host(n4, base)
        t2 = time.perf_counter()
        check(table.device == dev and torch.equal(table.cpu(), torch.from_numpy(host)),
              f"halton base {base}: the card's {n4} entries != the host build")
        out["bitwise_4m"][base] = dict(device_s=t1 - t0, host_s=t2 - t1)
    del table, host
    g = HALTON_GRID_SIDE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = halton._halton_grid_device(g, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host_grid = halton._halton_grid_host(g)
    t2 = time.perf_counter()
    check(all(torch.equal(a.cpu(), torch.from_numpy(b)) for a, b in zip(grid, host_grid)),
          f"halton grid: the card's {g} x {g} (u, v) grid != the host build")
    out["grid"] = dict(side=g, device_s=t1 - t0, host_s=t2 - t1)
    del grid, host_grid
    print(f"[halton] {n4:,} entries built on the card == the host build bitwise, bases "
          f"{halton.BASES}; device s " + ", ".join(
              f"{v['device_s']:.4f}" for v in out["bitwise_4m"].values())
          + "; host s " + ", ".join(f"{v['host_s']:.3f}" for v in out["bitwise_4m"].values())
          + f"; the {g} x {g} (u, v) grid too: device {t1 - t0:.4f} s, host {t2 - t1:.3f} s")

    meshes, params = ex02_case()
    ground = PreparedSolver(meshes).get_emitter(
        len(meshes) - 1, samples=params.samples, rays=params.rays, flip_faces=False)
    n = ground.n_cells * params.rays
    check(n == EX02_GROUND_RAYS, f"ex02's ground has {n} rays an iteration, "
          f"not {EX02_GROUND_RAYS}")
    rng = np.random.default_rng(21)
    boundaries = np.arange(halton.DEVICE_CHUNK, n, halton.DEVICE_CHUNK)
    device_s = []
    n_checked = 0
    for base in halton.BASES:
        powers = [base**j for j in range(1, 32) if base**j <= n]
        idx = np.unique(np.concatenate([
            rng.integers(1, n + 1, HALTON_SAMPLED), [1, n], boundaries, boundaries + 1,
            np.array(powers) - 1, powers]))
        idx = idx[(idx >= 1) & (idx <= n)].astype(np.int64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = halton._halton_dim_device(n, base, dev)
        torch.cuda.synchronize()
        device_s.append(time.perf_counter() - t0)
        got = table[torch.from_numpy(idx - 1).to(dev)].cpu().numpy()
        del table
        # idx holds n, so radical_inverse takes the table's own digit count
        want = halton.radical_inverse(idx, base).astype(np.float32)
        check(np.array_equal(got, want), f"halton base {base}: the card's {n}-entry table "
              f"differs from the exact radical inverse at {int((got != want).sum())} of "
              f"{idx.size} indices")
        n_checked += idx.size
    out["ground"] = dict(length=n, device_s=device_s, indices_checked=n_checked)
    print(f"[halton] ex02's ground: {n:,} entries a table built on the card in "
          + ", ".join(f"{s:.4f}" for s in device_s) + f" s (bases {halton.BASES}, "
          f"{sum(device_s):.4f} s in all), exact at {n_checked:,} indices (the first and "
          f"last, every chunk seam, base**j - 1 and base**j, {HALTON_SAMPLED:,} random)")

    # ex02's matrix at its own settings: the per-emitter route (the ground
    # alone passes SCHED_MAX_FLAT_RAYS), the ground's tables built on the card
    k0 = launches()
    full, vf = setup_and_warm(meshes, params, on=True)
    k1 = launches()
    check_ex02_rows(vf, meshes, "ex02")
    ground_builds = [b for b in full["halton_builds"] if b[0] == n]
    check(sorted(b[1] for b in ground_builds) == sorted(halton.BASES)
          and all(b[2] == "device" for b in ground_builds),
          f"ex02: the ground's tables were built as {ground_builds}, not once each on the "
          "card")
    check(not any(b[0] >= n and b[2] == "host" for b in full["halton_builds"]),
          "ex02: a host table of the ground's length was built")
    check(k1[0] > k0[0] and k1[2] == k0[2],
          f"ex02 did not take the per-emitter route: launches {k0} -> {k1}")
    out["ex02"] = dict({k: v for k, v in full.items() if k != "halton_builds"},
                       ground_halton_s=sum(b[3] for b in ground_builds),
                       k1_launches=k1[0] - k0[0])
    print(f"[halton] ex02 matrix (12 emitters, ground {n:,} rays an iteration, per-emitter "
          f"route, {k1[0] - k0[0]} launches of kernel #1): first solve {full['first_s']:.2f} s, "
          f"warm {full['warm_s']:.2f} s, set-up {full['setup_s']:.2f} s, of it the Halton "
          f"builds {full['halton_s']:.3f} s (the ground's {out['ex02']['ground_halton_s']:.3f} "
          f"s); peak {full['peak_bytes'] / 2**20:.1f} MiB; no host table of the ground's "
          f"length")
    del vf

    # the device path against the host path at samples=1: the ground's 5.6M
    # rays are one scheduled solve's flat tables, concatenated on the card
    meshes1, params1 = ex02_case(samples=1)
    n1 = PreparedSolver(meshes1).get_emitter(
        len(meshes1) - 1, samples=params1.samples, rays=params1.rays,
        flip_faces=False).n_cells * params1.rays
    k0 = launches()
    on, vf_on = setup_and_warm(meshes1, params1, on=True)
    k1 = launches()
    off, vf_off = setup_and_warm(meshes1, params1, on=False)
    k2 = launches()
    check(vf_on == vf_off, "ex02 at samples=1: device tables' dict != host tables' dict")
    check_ex02_rows(vf_on, meshes1, "ex02 at samples=1")
    check({b[2] for b in on["halton_builds"] if b[0] == n1} == {"device"}
          and {b[2] for b in off["halton_builds"] if b[0] == n1} == {"host"},
          "ex02 at samples=1: the ground's tables were not built on the card with the "
          "builder on and on the host with it off")
    check(k1[2] > k0[2] and k2[2] > k1[2],
          f"ex02 at samples=1 did not take the scheduled route: launches {k0}, {k1}, {k2}")
    out["samples1"] = {label: {k: v for k, v in s.items() if k != "halton_builds"}
                       for label, s in (("device", on), ("host", off))}
    out["samples1"]["ground_length"] = n1
    print(f"[halton] ex02 at samples=1 (ground {n1:,} rays, scheduled route): dicts == with "
          f"the builder on and off; set-up {on['setup_s']:.2f} s (Halton {on['halton_s']:.3f} "
          f"s) against {off['setup_s']:.2f} s (Halton {off['halton_s']:.3f} s); warm "
          f"{on['warm_s']:.3f} / {off['warm_s']:.3f} s")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[halton] phase 21 took {out['phase_s']:.1f} s")
    return out


def phase_validation() -> dict:
    """Phase 22: validation cases 01-09 through the port on the card, at
    their full settings (validate_torch.py), each within its own tolerance."""
    import validate_torch

    t0 = time.perf_counter()
    results = validate_torch.run_cases(list(validate_torch.CASES), "gpu",
                                       log=lambda line: print(f"[validation] {line}"))
    failed = [r.case for r in results if not r.passed]
    check(not failed, f"validation cases outside their tolerances: {failed}")
    out = {"phase_s": time.perf_counter() - t0, "cases": {
        r.case: dict(value=r.value, reference=r.reference, err=r.err, tol=r.tol,
                     iterations=r.iterations, seconds=r.extra["seconds"],
                     committed=validate_torch.read_committed(r.case)["value"],
                     value_as_committed=r.value_as_committed)
        for r in results}}
    print(f"[validation] phase 22: {len(results)} of {len(results)} cases within their own "
          f"tolerances in {out['phase_s']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "validation"))
    import raystrack_tpu_torch.solver as solver_mod
    from raystrack_tpu_torch import PreparedSolver, config, view_factor, view_factor_matrix
    from raystrack_tpu_torch.ops import build, trace_cuda
    from raystrack_tpu_torch.ops import trace as trace_mod
    from raystrack_tpu_torch.ops.count_cuda import count_bins
    from raystrack_tpu_torch.ops.trace_cuda import (
        gate_cross, sweep_rays, sweep_rays_scheduled,
    )
    from raystrack_tpu_torch.prepared import EmitterPack
    from analytic import canyon_ground_truth

    check(config.SLIM_PACK_MIN_TRIS > BIG_CITY_TRIS + 2048,
          "SLIM_PACK_MIN_TRIS is set below this script's scenes: unset "
          "RAYSTRACK_TPU_SLIM_PACK_MIN_TRIS")

    # 1. card
    card = card_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(dev)}")

    # 2. build
    t0 = time.perf_counter()
    b = build.build()
    print(f"[build] {b.path}: nvcc {b.seconds:.2f} s, "
          f"build() {time.perf_counter() - t0:.2f} s")
    for line in ptxas_lines(b.log):
        print(f"[build] {line}")
    sass = sass_functions(b.path)
    pair_ops = sass_pair_ops(sass)
    for name, (ops, counts, total) in pair_ops.items():
        print(f"[build] {name}: {ops:g} FP32 instructions per pair in the SASS ({counts}); "
              f"{total:g} instructions in all")

    # 3. kernel #1 vs plain
    cases = solve_cases()
    soup, soup_params = cases["soup"]
    soup_ps = PreparedSolver(soup)
    max_err, ms, plain_ms, soup_front, soup_codes, pairs1, bytes1, sky1 = phase_kernel(
        dev, soup_ps, soup_params.seed)
    bound1 = bound(bytes1, pairs1, pair_ops["sweep_kernel<1,0,1,0>"][0])
    print(f"[kernel1] matrix,baked: {pairs1:.4g} pair tests, bound {bound1[0]:.3f} ms "
          f"({bound1[1]}); the kernel at {bound1[0] / ms:.1%} of it")

    # 4. kernel #2 vs plain, on the round the soup8 solve dispatches
    soup8, soup8_params = cases["soup8"]
    soup8_ps = PreparedSolver(soup8)
    real_round = trace_mod.scheduled_trace
    captured = []

    def capture(*args, **kwargs):
        captured.append((args, kwargs))
        return real_round(*args, **kwargs)

    trace_mod.scheduled_trace = capture
    quiet = solver_mod._log
    solver_mod._log = lambda line: None
    view_factor_matrix(soup8, soup8_params, prepared=soup8_ps)
    solver_mod._log = quiet
    trace_mod.scheduled_trace = real_round
    check(len(captured) == 1, f"soup8 took {len(captured)} scheduled rounds, not 1")
    (max_err2, ms2, plain_ms2, soup8_fronts, soup8_codes, pairs2, bytes2, sky2,
     (sky_ids, sky_valid)) = phase_sched_kernel(*captured[0], ms)
    del captured
    bound2 = bound(bytes2, pairs2, pair_ops["sweep_sched_kernel<1,0,0>"][0])
    print(f"[kernel2] matrix: {pairs2:.4g} pair tests, bound {bound2[0]:.3f} ms "
          f"({bound2[1]}); the kernel at {bound2[0] / ms2:.1%} of it")
    # the sky variants as the sky and workflow solves launch them, at the
    # split the wrappers pick on these shapes, beside their bounds
    variant_rows = sky_variants(sky1, sky2, pair_ops)
    max_err3, count_times = phase_count({
        "soup chunk": soup_codes, "soup8 round": soup8_codes,
        "soup8 sky round, 145 patch bins": (sky_ids["sky_bins"], sky_valid, 145, None),
        "soup8 sky round, 1 upward bin": (sky_ids["upward"], sky_valid, 1, None)})
    del soup_codes, soup8_codes, sky_ids
    ms3, plain_ms3, lib_ms3, bound3, launch3 = count_times["soup8 round"]

    # 5. the gate on the 1M-triangle city: the first chunk of ground -> city
    # and the first round of the ten-plate matrix, captured from their
    # first (set-up) solves
    city, vf_params = cases["city"]
    mx_params = cases["city_matrix"][1]
    city_plates, city_plates_params = cases["city_plates"]
    city_ps, city_plates_ps = PreparedSolver(city), PreparedSolver(city_plates)
    solver_mod._log = lambda line: None
    t0 = time.perf_counter()
    count_calls = []  # the gated chunks' counts: rows of 262,144 codes and their valid flags
    with recording(trace_mod, "count_codes", count_calls):
        chunk_call = first_call(trace_mod, "chunk_body", lambda: view_factor(
            city[0], city[1], vf_params, prepared=city_ps))
    t1 = time.perf_counter()
    round_call = first_call(trace_mod, "scheduled_trace", lambda: view_factor_matrix(
        city_plates, city_plates_params, prepared=city_plates_ps))
    solver_mod._log = quiet
    print(f"[gate] city: {sum(F.shape[0] for _, _, F in city)} triangles; first solves "
          f"with set-up: ground -> city {t1 - t0:.2f} s, ten-plate matrix "
          f"{time.perf_counter() - t1:.2f} s")
    city_k1, city_k2, cross = phase_city_kernels(chunk_call, round_call, pair_ops)
    (codes, n_valid, n_surf), kw, _ = count_calls[0]
    check(n_valid is None and kw.get("valid") is not None,
          "the gated chunk's count did not take the valid flags")
    gated_err, gated_times = phase_count({"city chunk, gated": (codes, None, 2 * n_surf,
                                                                kw["valid"])})
    max_err3 = max(max_err3, gated_err)
    count_times.update(gated_times)
    del count_calls, codes, kw
    # kernel #1's code mode, with the operands of the same solve on a slim pack
    city_slim_ps = PreparedSolver(city)
    solver_mod._log = lambda line: None
    with slim_threshold(config, 1):
        code_call = first_call(trace_mod, "chunk_body", lambda: view_factor(
            city[0], city[1], vf_params, prepared=city_slim_ps))
    solver_mod._log = quiet
    city_code = phase_code_kernel(chunk_call, code_call, pair_ops, city_k1)
    del chunk_call, round_call, code_call

    # phases 6-10 run the main path: count its chunks, rounds and launches
    def on_card(x) -> bool:
        if isinstance(x, torch.Tensor):
            return x.is_cuda
        if isinstance(x, (tuple, list)):
            return all(on_card(v) for v in x)
        return True

    dispatches, rounds = [], []
    dispatch = solver_mod._EmitterRun.dispatch_chunk

    chunk_rays, round_rays = [], []
    chunk_kinds, round_kinds = [], []  # (want_matrix, want_any) of each chunk and round
    resident = []  # per chunk of a slim scene: it swept the scene's resident pack

    def counted(self, chunk, **kwargs):
        harvest = dispatch(self, chunk, **kwargs)
        chunk_rays.append(chunk * self.em_pack.n_rays_pad)
        chunk_kinds.append((kwargs["want_matrix"], kwargs["want_any"]))
        tri_pack, sweep_mask, _ = self.packs[kwargs["want_any"], self.device]
        if self.scene_pack.slim:
            resident.append(tri_pack is self.scene_pack.tri_pack)
        dispatches.append(on_card(
            [tri_pack, sweep_mask]
            + [getattr(self.scene_pack, f.name) for f in dataclasses.fields(self.scene_pack)]
            + [getattr(self.em_pack, f.name) for f in dataclasses.fields(EmitterPack)]))
        return harvest

    def counted_round(*args, **kwargs):
        rounds.append(on_card(args))
        round_kinds.append((kwargs.get("want_matrix", True), kwargs.get("want_any", False)))
        round_rays.append(int(args[10].shape[0]) * kwargs["sched_block"])
        return real_round(*args, **kwargs)

    solver_mod._EmitterRun.dispatch_chunk = counted
    trace_mod.scheduled_trace = counted_round
    progress = []  # per-emitter progress lines: hundreds, summarised below
    solver_mod._log = progress.append
    def reset_launches():
        sweep_rays.launches = sweep_rays.gated_launches = sweep_rays.code_launches = 0
        sweep_rays_scheduled.launches = sweep_rays_scheduled.gated_launches = 0
        count_bins.launches = gate_cross.launches = 0

    reset_launches()

    def route_solve(route, solve):
        """(result, rounds, chunks) of one solve through ``route``."""
        config.SCHEDULER = route
        r0, c0 = len(rounds), len(dispatches)
        out = solve()
        config.SCHEDULER = "auto"
        return out, len(rounds) - r0, len(dispatches) - c0

    # 6. plates
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

    # 7. canyon
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

    # 8. district, through both routes
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

    # 9. soup through the entry point (one emitter: the per-emitter route)
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

    # 10. soup8 through both routes
    soup8_tris = soup8_ps.get_scene_pack(device=dev).n_tri_pad
    solve = lambda: view_factor_matrix(soup8, soup8_params, prepared=soup8_ps)  # noqa: E731
    vf, n_rounds, _ = route_solve("auto", solve)
    warm, _, _ = route_solve("auto", lambda: wall_times(solve, 5))
    vf_pe, _, pe_chunks = route_solve("grouped", solve)
    warm_pe, _, _ = route_solve("grouped", lambda: wall_times(solve, 5))
    print(f"[soup8] scheduled: {n_rounds} round(s), warm solve {spread(warm)} = "
          f"{SOUP8_RAYS * soup8_tris / float(np.median(warm)):.4g} tests/s at the median; "
          f"per-emitter: {pe_chunks} chunks, warm solve {spread(warm_pe)}; "
          f"dicts identical: {vf_pe == vf}")
    check(vf_pe == vf, "soup8: scheduled dict != per-emitter dict")
    for e, front in soup8_fronts.items():
        name = soup8[e][0]
        check(vf[name].get("cloud_front", 0.0) == front / (SOUP8_RAYS // 8),
              f"soup8 {name}: solve F != kernel #2 phase counts")
    print(f"[soup8] F(plate -> cloud_front) of all 8 plates equal phase 4's counts")

    # 11. launches
    launches, launches2 = sweep_rays.launches, sweep_rays_scheduled.launches
    launches3 = count_bins.launches
    gated = sweep_rays.gated_launches + sweep_rays_scheduled.gated_launches
    parsed = [re.search(r"\[(.+?)\] (\d+) iter", line) for line in progress]
    print(f"[launches] {len(progress)} progress lines, e.g. {progress[0]!r}")
    check(all(parsed), "a progress line lost its '[name] K iter' format")
    print(f"[launches] kernel #1: {launches} launches for {len(dispatches)} per-emitter "
          f"chunks; kernel #2: {launches2} launches for {len(rounds)} scheduled rounds; "
          f"{gated} gated (none of these scenes has more than one sweep tile and "
          f"acceleration); on cuda in every chunk and round: {all(dispatches) and all(rounds)}")
    check(launches > 0 and launches == len(dispatches),
          f"{launches} kernel #1 launches != {len(dispatches)} chunks")
    check(launches2 > 0 and launches2 == len(rounds),
          f"{launches2} kernel #2 launches != {len(rounds)} rounds")
    check(gated == 0 and gate_cross.launches == 0,
          f"{gated} gated launches, {gate_cross.launches} of the crossing kernel, on scenes "
          f"the gate cannot prune")
    print(f"[launches] count kernel: {launches3} launches for "
          f"{len(dispatches) + len(rounds)} chunks and rounds")
    check(launches3 == len(dispatches) + len(rounds),
          f"{launches3} count kernel launches != {len(dispatches) + len(rounds)} "
          f"chunks and rounds")
    check(all(dispatches) and all(rounds), "a chunk or round ran with a tensor off the card")

    # 12. the city through both entry points, gated (bvh="auto") and not
    reset_launches()
    city_dicts = {}
    n_chunks = {True: 0, False: 0}
    n_rounds = {True: 0, False: 0}
    solves = {
        "view_factor ground -> city": (vf_params, lambda p: view_factor(
            city[0], city[1], p, prepared=city_ps)),
        "view_factor_matrix, two meshes": (mx_params, lambda p: view_factor_matrix(
            city, p, prepared=city_ps)),
        "view_factor_matrix, ten plates": (city_plates_params, lambda p: view_factor_matrix(
            city_plates, p, prepared=city_plates_ps)),
    }
    for name, (params, solve) in solves.items():
        results, walls, peak, rays = {}, {}, {}, {}
        for gate_on in (True, False):
            p = params if gate_on else dataclasses.replace(params, bvh="off")
            torch.cuda.reset_peak_memory_stats(dev)
            r0, c0 = len(round_rays), len(chunk_rays)
            results[gate_on], n_r, n_c = route_solve("auto", lambda: solve(p))  # noqa: B023
            check((n_r > 0 and n_c == 0) if name.startswith("view_factor_matrix")
                  else (n_c > 0 and n_r == 0), f"city {name}: {n_r} rounds and {n_c} chunks, "
                  f"not the route its phase holds")
            peak[gate_on] = torch.cuda.max_memory_allocated(dev)
            rays[gate_on] = sum(round_rays[r0:]) + sum(chunk_rays[c0:])
            walls[gate_on], n_r2, n_c2 = route_solve(
                "auto", lambda: wall_times(lambda: solve(p), 3))  # noqa: B023
            n_rounds[gate_on] += n_r + n_r2
            n_chunks[gate_on] += n_c + n_c2
            label = "auto (gated)" if gate_on else "off"
            print(f"[city] {name}, bvh={label}: {n_r} rounds, {n_c} per-emitter chunks, "
                  f"{rays[gate_on]} rays traced; warm solve {spread(walls[gate_on])} = "
                  f"{rays[gate_on] / float(np.median(walls[gate_on])):.4g} rays/s at the "
                  f"median; peak device memory {peak[gate_on] / 2**20:.1f} MiB")
        same = results[True] == results[False]
        print(f"[city] {name}: dicts identical: {same}; gated speed-up at the median "
              f"{float(np.median(walls[False])) / float(np.median(walls[True])):.2f}x; "
              f"{results[True]}")
        check(same, f"city {name}: bvh='auto' dict != bvh='off' dict")
        check(sum(len(row) for row in results[True].values()) > 0, f"city {name}: no hits")
        city_dicts[name] = results[True]
    launches_city = (sweep_rays.launches, sweep_rays.gated_launches,
                     sweep_rays_scheduled.launches, sweep_rays_scheduled.gated_launches)
    count_city, cross_city = count_bins.launches, gate_cross.launches
    check(sweep_rays.code_launches == 0 and not resident,
          "a full-mode solve launched kernel #1 in code mode")
    print(f"[launches] city: kernel #1 {launches_city[0]} launches ({launches_city[1]} gated) "
          f"for {n_chunks[True]} gated and {n_chunks[False]} ungated chunks; kernel #2 "
          f"{launches_city[2]} ({launches_city[3]} gated) for {n_rounds[True]} gated and "
          f"{n_rounds[False]} ungated rounds; count kernel {count_bins.launches}; the "
          f"gate's crossing kernel {cross_city}")
    check(cross_city == n_chunks[True] + n_rounds[True],
          "city: the crossing kernel did not launch once per gated chunk or round")
    check(launches_city[1] == n_chunks[True] > 0
          and launches_city[0] == n_chunks[True] + n_chunks[False],
          "city: kernel #1 launches != one gated launch per gated chunk")
    check(launches_city[3] == n_rounds[True] > 0
          and launches_city[2] == n_rounds[True] + n_rounds[False],
          "city: kernel #2 launches != one gated launch per gated round")
    check(count_city == sum(n_chunks.values()) + sum(n_rounds.values()),
          "city: count launches != chunks and rounds")

    # 13. the same solves with the scene pack slim: per-emitter chunks on the
    # resident pack, kernel #1 in code mode, the dicts of phase 12
    reset_launches()
    built = []
    real_build = trace_mod.build_tri_pack

    def counted_build(*args, **kwargs):
        built.append(1)
        return real_build(*args, **kwargs)

    trace_mod.build_tri_pack = solver_mod.build_tri_pack = counted_build
    city_plates_slim_ps = PreparedSolver(city_plates)
    slim_solves = {
        "view_factor ground -> city": (vf_params, lambda p: view_factor(
            city[0], city[1], p, prepared=city_slim_ps)),
        "view_factor_matrix, ten plates": (city_plates_params, lambda p: view_factor_matrix(
            city_plates, p, prepared=city_plates_slim_ps)),
    }
    n_slim_chunks = 0
    with slim_threshold(config, 1):
        for name, (params, solve) in slim_solves.items():
            torch.cuda.reset_peak_memory_stats(dev)
            c0 = len(chunk_rays)
            t0 = time.perf_counter()
            got, n_r, n_c = route_solve("auto", lambda: solve(params))  # noqa: B023
            first_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            rays = sum(chunk_rays[c0:])
            walls, n_r2, n_c2 = route_solve(
                "auto", lambda: wall_times(lambda: solve(params), 3))  # noqa: B023
            n_slim_chunks += n_c + n_c2
            same = got == city_dicts[name]
            print(f"[slim] {name}, slim, bvh=auto (gated): {n_r} rounds, {n_c} per-emitter "
                  f"chunks, {rays} rays traced; first solve {first_s:.2f} s, warm solve "
                  f"{spread(walls)} = {rays / float(np.median(walls)):.4g} rays/s at the "
                  f"median; peak device memory {peak / 2**20:.1f} MiB; dict == the "
                  f"full-mode dict of phase 12: {same}")
            check(same, f"slim {name}: dict != the full-mode dict")
            check(n_r == n_r2 == 0 and n_c > 0 and n_c2 == 3 * n_c,
                  f"slim {name}: {n_r} + {n_r2} rounds, {n_c} + {n_c2} chunks")
    trace_mod.build_tri_pack = solver_mod.build_tri_pack = real_build
    for ps in (city_slim_ps, city_plates_slim_ps):
        check(ps.get_scene_pack(use_accel=True, device=dev).slim, "a slim solve's pack is full")
    launches_slim = (sweep_rays.launches, sweep_rays.gated_launches, sweep_rays.code_launches)
    count_slim, cross_slim = count_bins.launches, gate_cross.launches
    print(f"[slim] kernel #1: {launches_slim[0]} launches ({launches_slim[1]} gated, "
          f"{launches_slim[2]} in code mode) for {n_slim_chunks} chunks; kernel #2 "
          f"{sweep_rays_scheduled.launches}; count kernel {count_slim}; per-emitter packs "
          f"built: {len(built)}; chunks that swept the scene's resident pack: "
          f"{sum(resident)} of {len(resident)}")
    check(launches_slim == (n_slim_chunks,) * 3 and sweep_rays_scheduled.launches == 0
          and count_slim == cross_slim == n_slim_chunks,
          "slim: not one gated code-mode launch per chunk and no round")
    check(not built, f"slim: {len(built)} per-emitter packs were built")
    check(len(resident) == n_slim_chunks and all(resident),
          "slim: a chunk did not sweep the scene's resident pack")
    del city_slim_ps, city_plates_slim_ps
    # phase 20 solves these again: their host prep stays, their packs go
    city_ps.clear_device_cache()
    city_plates_ps.clear_device_cache()

    # 14. slim where it matters: the 10M-triangle city in both modes, and the
    # 1M city measured the same way, for the bytes per triangle of each; then
    # the full-mode scheduled matrix, which holds the zero-mask scene pack and
    # a round's (E, Tpad) mask rows, with ten and with two plates
    reset_launches()
    del resident[:]
    big = city_meshes(BIG_CITY_TRIS)
    foot = {}
    cross_big_call = []  # the 10M chunk's (rays, boxes), for the crossing kernel's 10M case
    for size, meshes in (("1M", city), ("10M", big)):
        for slim in (False, True):
            # kept on the host: the footprint is measured around it
            with recording(trace_cuda, "_gate_tables",
                           cross_big_call if (size, slim) == ("10M", False) else [],
                           keep=lambda args, kwargs, out: (args[1].cpu(), out.boxes.cpu())):
                foot[size, slim] = mode_footprint(
                    f"city {size}, view_factor ground -> city", meshes,
                    lambda ps: view_factor(meshes[0], meshes[1], vf_params,  # noqa: B023
                                           prepared=ps), slim, dev)
        same = foot[size, True]["result"] == foot[size, False]["result"]
        print(f"[slim] city {size}: slim dict == full dict: {same}; {foot[size, True]['result']}")
        check(same, f"city {size}: slim dict != full dict")
    check(foot["1M", False]["result"] == city_dicts["view_factor ground -> city"],
          "city 1M: a fresh full-mode solve != phase 12's dict")
    check(foot["10M", True]["n_tri_pad"] == 10_000_384, "the 10M city's padded size")
    launches_big = (sweep_rays.launches, sweep_rays.gated_launches, sweep_rays.code_launches)
    check(launches_big[0] == launches_big[1] > launches_big[2] > 0
          and len(resident) == launches_big[2] and all(resident)
          and sweep_rays_scheduled.launches == 0,
          f"phase 14 launches {launches_big}: not all gated, or a slim chunk off the "
          f"resident pack")
    for size, boxes in (("1M", city[1]), ("10M", big[1])):
        for n_plates in (10, 2):
            meshes = city_plates_meshes(boxes, nx=n_plates // 2)
            foot[size, n_plates] = mode_footprint(
                f"city {size}, view_factor_matrix of {n_plates} plates (scheduled)", meshes,
                lambda ps: view_factor_matrix(meshes, city_plates_params,  # noqa: B023
                                              prepared=ps), False, dev,
                repeats=3 if size == "1M" else 1)
            check(sum(len(row) for row in foot[size, n_plates]["result"].values()) > 0,
                  f"city {size}, {n_plates} plates: no hits")
    check(foot["1M", 10]["result"] == city_dicts["view_factor_matrix, ten plates"],
          "city 1M: a fresh ten-plate solve != phase 12's dict")
    del big, boxes, meshes
    launches_big2 = (sweep_rays_scheduled.launches, sweep_rays_scheduled.gated_launches)
    count_big, cross_big = count_bins.launches, gate_cross.launches
    # the crossing kernel at the 10M city's shape: one chunk's rays over 4,883 boxes
    check(bool(cross_big_call), "the 10M city's solve built no gate tables")
    rays10, boxes10 = (t.to(dev) for t in cross_big_call[0])
    check(boxes10.shape[0] == 4883, f"the 10M chunk has {boxes10.shape[0]} gate boxes")
    cross10 = cross_case(f"city 10M chunk, {boxes10.shape[0]} boxes", rays10, boxes10, pair_ops)
    cross["max_abs_err"] = max(cross["max_abs_err"], cross10["max_abs_err"])
    cross["times"][f"city 10M chunk, {boxes10.shape[0]} boxes"] = {
        k: v for k, v in cross10.items() if k != "max_abs_err"}
    del cross_big_call, rays10, boxes10
    check(cross_big == launches_big[1] + launches_big2[1],
          f"phase 14: {cross_big} crossing-kernel launches for {launches_big[1]} gated chunks "
          f"and {launches_big2[1]} gated rounds")
    check(launches_big2[0] == launches_big2[1] > 0 and sweep_rays.launches == launches_big[0],
          f"phase 14: the plate solves launched kernel #2 {launches_big2} times, not all "
          f"gated, or took per-emitter chunks")
    d_tri = foot["10M", True]["n_tri_pad"] - foot["1M", True]["n_tri_pad"]
    per_tri = {key: {k: (foot["10M", key][k] - foot["1M", key][k]) / d_tri
                     for k in ("first_peak", "warm_peak", "resident")}
               for key in (False, True, 10, 2)}
    worst = {key: max(v["first_peak"], v["warm_peak"]) for key, v in per_tri.items()}
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"[slim] bytes per padded triangle, from the 1M and 10M cities (the slope), "
          f"view_factor ground -> city: full mode peak {worst[False]:.1f} (first solve "
          f"{per_tri[False]['first_peak']:.1f}, warm {per_tri[False]['warm_peak']:.1f}, "
          f"resident {per_tri[False]['resident']:.1f}); slim mode peak {worst[True]:.1f} "
          f"(first solve {per_tri[True]['first_peak']:.1f}, warm "
          f"{per_tri[True]['warm_peak']:.1f}, resident {per_tri[True]['resident']:.1f})")
    per_row = (worst[10] - worst[2]) / 8
    fixed = worst[2] - 2 * per_row
    print(f"[slim] full-mode scheduled matrix: peak {worst[10]:.1f} with ten plates (first "
          f"solve {per_tri[10]['first_peak']:.1f}, warm {per_tri[10]['warm_peak']:.1f}, "
          f"resident {per_tri[10]['resident']:.1f}), {worst[2]:.1f} with two (resident "
          f"{per_tri[2]['resident']:.1f}) = {fixed:.1f} + {per_row:.1f} per emitter row of "
          f"a round")
    print(f"[slim] the card holds {total} bytes: full mode's peak passes half of it at "
          f"{total / 2 / worst[False]:.4g} padded triangles for one emitter and at "
          f"{total / 2 / worst[10]:.4g} for a round of ten, and all of it at "
          f"{total / worst[False]:.4g} and {total / worst[10]:.4g}; slim mode's passes all "
          f"of it at {total / worst[True]:.4g}; "
          f"config.SLIM_PACK_MIN_TRIS = {config.SLIM_PACK_MIN_TRIS}")
    check(worst[True] < worst[False] < worst[10] and worst[2] < worst[10],
          "peaks per triangle out of order: slim < full single emitter < a round of ten")
    check(config.SLIM_PACK_MIN_TRIS * worst[10] < 0.75 * total,
          "a full-mode round of ten emitters would not fit the card just below "
          "SLIM_PACK_MIN_TRIS")

    # 15. kernel #3, the FMA-peak probe, and the sweeps against its rate
    peak_entry = phase_fma_peak(dev, sass, {
        "kernel #1, soup (matrix, baked)":
            pairs1 * pair_ops["sweep_kernel<1,0,1,0>"][0] / (ms * 1e-3),
        "kernel #2, soup8 round (matrix)":
            pairs2 * pair_ops["sweep_sched_kernel<1,0,0>"][0] / (ms2 * 1e-3),
        "kernel #1 code mode, city chunk ungated":
            city_code["ungated_pairs"] * pair_ops["sweep_code_kernel<1,0,0>"][0]
            / (city_code["ungated_ms"] * 1e-3),
    })

    # 16-18. the sky and the shared-ray workflow through their entry points:
    # the canyon against its analytic sky, then the 1M-triangle city gated
    reset_launches()
    canyon_sky = phase_canyon_sky(route_solve)
    canyon_workflow = phase_canyon_workflow(route_solve)
    city_sky = phase_city_sky(route_solve, dict(
        rounds=rounds, dispatches=dispatches, round_kinds=round_kinds, chunk_kinds=chunk_kinds,
        round_rays=round_rays, chunk_rays=chunk_rays), dev, config)
    launches_sky = (sweep_rays.launches, sweep_rays.gated_launches,
                    sweep_rays_scheduled.launches, sweep_rays_scheduled.gated_launches,
                    count_bins.launches, gate_cross.launches)
    sky_kinds = {"any": sum(1 for k in chunk_kinds + round_kinds if k == (False, True)),
                 "matrix+any": sum(1 for k in chunk_kinds + round_kinds if k == (True, True))}
    print(f"[launches] sky and workflow phases (16-18): kernel #1 {launches_sky[0]} "
          f"({launches_sky[1]} gated), kernel #2 {launches_sky[2]} ({launches_sky[3]} gated), "
          f"count {launches_sky[4]}, crossing {launches_sky[5]}; dispatches by variant "
          f"{sky_kinds} of {len(chunk_kinds) + len(round_kinds)} since phase 6")

    # 19. checkpoints, streaming, scene files and the CLI: the 1M city's
    # solve from an OBJ file, SIGKILLed mid-way and resumed
    reset_launches()
    resume = phase_resume(route_solve, dict(rounds=rounds, dispatches=dispatches), dev, config,
                          b.path, city_plates, city)
    launches_resume = resume["launches"]
    print(f"[launches] phase 19 (this process): kernel #1 {launches_resume['k1']} "
          f"({launches_resume['k1_gated']} gated), kernel #2 {launches_resume['k2']} "
          f"({launches_resume['k2_gated']} gated), count {launches_resume['count']}, crossing "
          f"{launches_resume['cross']}, for {launches_resume['chunks']} chunks and "
          f"{launches_resume['rounds']} rounds")
    check(launches_resume["k1"] == launches_resume["chunks"] > 0
          and launches_resume["k2"] == launches_resume["rounds"] > 0,
          "phase 19: launches != chunks and rounds")
    solver_mod._EmitterRun.dispatch_chunk = dispatch
    trace_mod.scheduled_trace = real_round

    # 20. the parallel layer: ray meshes on the city, multi-process district
    reset_launches()
    parallel = phase_parallel(dev, city_ps, city_plates_ps, city, city_plates, cases, city_dicts)
    launches_par = dict(k1=sweep_rays.launches, k1_gated=sweep_rays.gated_launches,
                        k2=sweep_rays_scheduled.launches,
                        k2_gated=sweep_rays_scheduled.gated_launches,
                        count=count_bins.launches, cross=gate_cross.launches)
    print(f"[launches] phase 20 (this process): kernel #1 {launches_par['k1']} "
          f"({launches_par['k1_gated']} gated), kernel #2 {launches_par['k2']} "
          f"({launches_par['k2_gated']} gated), count {launches_par['count']}, crossing "
          f"{launches_par['cross']}")
    check(launches_par["k1_gated"] > 0 and launches_par["k2_gated"] > 0
          and launches_par["cross"] > 0 and launches_par["count"] > 0,
          "phase 20 launched no gated kernel #1 or #2, crossing or count")
    del city_ps, city_plates_ps

    def launches_now():
        return (sweep_rays.launches, sweep_rays.gated_launches, sweep_rays_scheduled.launches,
                sweep_rays_scheduled.gated_launches, count_bins.launches, gate_cross.launches)

    # 21. the Halton device builder: bitwise on the card, ex02's matrix at
    # full settings with its ground's tables built there, device == host path
    reset_launches()
    halton_out = phase_halton(dev, launches_now)
    launches_halton = launches_now()
    print(f"[launches] phase 21: kernel #1 {launches_halton[0]} ({launches_halton[1]} gated), "
          f"kernel #2 {launches_halton[2]} ({launches_halton[3]} gated), count "
          f"{launches_halton[4]}, crossing {launches_halton[5]}")

    # 22. the validation suite through the port, at full settings
    reset_launches()
    validation = phase_validation()
    launches_val = launches_now()
    print(f"[launches] phase 22: kernel #1 {launches_val[0]} ({launches_val[1]} gated), "
          f"kernel #2 {launches_val[2]} ({launches_val[3]} gated), count {launches_val[4]}, "
          f"crossing {launches_val[5]}")
    check(launches_val[2] > 0 and launches_val[4] > 0,
          "phase 22 launched no kernel #2 or count")

    def kernel_entry(name, replaces, n_launches, gated_launches, err, ms_, plain, bnd, city_k):
        entry = {"name": name, "route": "cuda", "source": "raystrack_tpu_torch/csrc/sweep_kernels.cuh",
                 "replaces": replaces, "launches": n_launches,
                 "max_abs_err": max(err, city_k["max_abs_err"]), "ms": ms_,
                 "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
                 "library_ms": None, "gated_launches": gated_launches}
        entry.update({k: v for k, v in city_k.items() if k != "max_abs_err"})
        return entry

    sweep_entry = kernel_entry(
        "sweep_rays", "raystrack_tpu/ops/trace_pallas.py:1453",
        launches + launches_city[0] + launches_slim[0] + launches_big[0] + launches_sky[0]
        + launches_resume["k1"] + launches_par["k1"] + launches_halton[0] + launches_val[0],
        launches_city[1] + launches_slim[1] + launches_big[1] + launches_sky[1]
        + launches_resume["k1_gated"] + launches_par["k1_gated"] + launches_halton[1]
        + launches_val[1],
        max(max_err, city_code["max_abs_err"]), ms, plain_ms, bound1, city_k1)
    sweep_entry["code_launches"] = launches_slim[2] + launches_big[2]
    sweep_entry.update({f"code_{k}": v for k, v in city_code.items() if k != "max_abs_err"})
    sched_entry = kernel_entry(
        "sweep_rays_scheduled", "raystrack_tpu/ops/trace_pallas.py:1267",
        launches2 + launches_city[2] + launches_big2[0] + launches_sky[2]
        + launches_resume["k2"] + launches_par["k2"] + launches_halton[2] + launches_val[2],
        launches_city[3] + launches_big2[1] + launches_sky[3] + launches_resume["k2_gated"]
        + launches_par["k2_gated"] + launches_halton[3] + launches_val[3],
        max_err2, ms2, plain_ms2, bound2, city_k2)
    # the sky's and the workflow's variants (phases 3-4) and their launches
    # on the main path (phases 16-18)
    for entry, label in ((sweep_entry, "kernel #1, soup chunk"),
                         (sched_entry, "kernel #2, soup8 round")):
        entry["sky_variants"] = {name: variant_rows[f"{label}, {name}"]
                                 for name in ("any", "matrix+any")}
    sweep_entry["sky_launches"] = launches_sky[0]
    sched_entry["sky_launches"] = launches_sky[2]
    # phase 19's, in this process: the resumed solves' and their references'
    sweep_entry["resume_launches"] = launches_resume["k1"]
    sched_entry["resume_launches"] = launches_resume["k2"]
    # phase 20's: the ray meshes' shards and the one-process district
    sweep_entry["parallel_launches"] = launches_par["k1"]
    sched_entry["parallel_launches"] = launches_par["k2"]
    # phases 21 and 22: ex02's solves and the validation cases
    sweep_entry["halton_launches"] = launches_halton[0]
    sched_entry["halton_launches"] = launches_halton[2]
    sweep_entry["validation_launches"] = launches_val[0]
    sched_entry["validation_launches"] = launches_val[2]
    sky_summary = dict(
        canyon_road_sky=canyon_sky["road_sky"], canyon_road_sky_analytic=canyon_sky["analytic"],
        canyon_patch_sum_diff=canyon_sky["patch_diff"],
        canyon_sky_warm_s=canyon_sky["merged"]["warm"],
        canyon_workflow_row_error=canyon_workflow["worst_row_error"],
        canyon_workflow_warm_s=canyon_workflow["warm"],
        city={k: {kk: vv for kk, vv in v.items() if kk != "kinds"}
              for k, v in city_sky.items() if k != "totals"},
        dispatches_by_variant=sky_kinds)
    print(f"[sky] summary: {json.dumps(sky_summary)}")
    print(f"[resume] summary: {json.dumps({k: v for k, v in resume.items() if k != 'launches'})}")
    print(f"[parallel] summary: {json.dumps(parallel)}")
    print(f"[halton] summary: {json.dumps(halton_out)}")
    print(f"[validation] summary: {json.dumps(validation)}")
    print(json.dumps({"kernels": [
        sweep_entry,
        sched_entry,
        {
            "name": "count_codes",
            "route": "cuda",
            "source": "raystrack_tpu_torch/csrc/count.cu",
            # not a Pallas kernel: the XLA compare-and-sum it stands in for
            "replaces": "raystrack_tpu/ops/trace.py:865",
            "launches": launches3 + count_city + count_slim + count_big + launches_sky[4]
            + launches_resume["count"] + launches_par["count"] + launches_halton[4]
            + launches_val[4],
            "max_abs_err": max_err3,
            # the kernel's device time a launch; the wrapper's one call beside it
            "ms": launch3["device_ms"],
            "plain_ms": plain_ms3,
            "bound_ms": bound3[0],
            "bound_by": bound3[1],
            "library_ms": lib_ms3,
            "wrapper_ms": ms3,
            "enqueue_ms": launch3["enqueue_ms"],
            "floor_ms": launch3["floor_ms"],
            "times": {k: dict(wrapper_ms=v[0], plain_ms=v[1], library_ms=v[2], bound_ms=v[3][0],
                              **v[4]) for k, v in count_times.items()},
        }, peak_entry, {
            "name": "gate_cross",
            "route": "cuda",
            "source": "raystrack_tpu_torch/csrc/gate.cu",
            # not a Pallas kernel: the XLA slab-and-reduce of the gate's tables
            "replaces": "raystrack_tpu/ops/trace_pallas.py:790",
            "launches": cross_city + cross_slim + cross_big + launches_sky[5]
            + launches_resume["cross"] + launches_par["cross"] + launches_halton[5]
            + launches_val[5],
            # the kernel's device time a launch on the city chunk; the rest
            # of cross_case's numbers beside it
            **cross,
            # no one PyTorch call reduces a ray-box slab test over blocks of rays
            "library_ms": None,
        }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [MULTIHOST_CHILD]:
        sys.exit(multihost_child(*sys.argv[2:]))
    sys.exit(main())
