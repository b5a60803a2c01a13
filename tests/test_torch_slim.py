"""Port parity: the slim (pack-resident) scene mode, kernel #1's
``code_bounds`` mask mode, and the FMA-peak probe's plain version.

The JAX side runs as ``tests/test_slim_pack.py`` runs it on the CPU: slim
forced through ``pack_scene(slim=True)`` or the config threshold, the Pallas
sweep in interpret mode. The scene is that file's: an emitter plane, boxes
over it, a plate BEHIND the plane (the plane cull masks its triangles out
of a full-mode pack; a slim sweep keeps them live in the pair math, where
no ray can hit them) and a top. Inputs come from NumPy seeds and reach both
packages as the same arrays. Tolerances:

- the slim pack, ``sid`` and the boxes against the JAX slim pack and against
  the port's own full-mode ``build_tri_pack``; ``compute_masks_slim``; slim
  against full in the port (sweeps, chunks, solve dicts): bitwise / ``==``;
- the plain code-mode sweep against the Pallas sweep with ``code_bounds``
  (interpret), codes and any-flags, and one chunk's counts against
  ``trace_chunk(tri_pack=...)``: bitwise too. (XLA's CPU backend contracts
  a*b + c into FMAs, which on the random clouds of tests/test_torch_trace.py
  moves a few edge rays; on this scene of axis-aligned boxes and plates no
  ray sits that close to an edge.)
- the port's slim solve against the JAX slim solve: |dF| <= 1e-4;
- the probe's plain version against the JAX package's ``_fma_kernel`` body
  run eagerly on the same block: bitwise (eager XLA ops round a * c and
  + d apart, as the tensor ops do); against its float64 recurrence: within
  ``fma_peak_tolerance``, whose docstring reckons it.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raystrack_tpu
import raystrack_tpu.ops.trace as jtrace
import raystrack_tpu.ops.trace_pallas as jpallas
import raystrack_tpu.prepared as jprep
from raystrack_tpu import config as jconfig
from raystrack_tpu.solver import _build_emitter_surface_mask, _cp_rows

import raystrack_tpu_torch
import raystrack_tpu_torch.ops.trace as ttrace
import raystrack_tpu_torch.prepared as tprep
from raystrack_tpu_torch import config as tconfig
from raystrack_tpu_torch.interop import scene_pack_from_arrays
from raystrack_tpu_torch.ops import peak_cuda
from raystrack_tpu_torch.ops.peak_cuda import (
    fma_count, fma_peak, fma_peak_reference, fma_peak_tolerance,
)
from raystrack_tpu_torch.ops.trace_cuda import (
    TRI_ROWS, build_tri_pack, sweep_rays, sweep_rays_reference,
)

CPU = torch.device("cpu")
SAMPLING = dict(samples=4, rays=16, flip_faces=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def _square(name, size, z, normal=1):
    h = size / 2.0
    V = np.array([[-h, -h, z], [h, -h, z], [h, h, z], [-h, h, z]], dtype=np.float32)
    F = (np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32) if normal >= 0
         else np.array([[0, 2, 1], [0, 3, 2]], dtype=np.int32))
    return name, V, F


def _boxes(name, n_boxes, seed=0, extent=4.0):
    """Dense random boxes above z = 0 (12 triangles each)."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-extent, extent, (n_boxes, 2)).astype(np.float32)
    w = rng.uniform(0.2, 0.8, (n_boxes, 2)).astype(np.float32)
    h = rng.uniform(0.5, 2.0, n_boxes).astype(np.float32)
    box_f = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6],
                      [0, 4, 5], [0, 5, 1], [1, 5, 6], [1, 6, 2],
                      [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]], np.int32)
    verts, faces = [], []
    for i in range(n_boxes):
        x0, y0 = cx[i] - w[i]
        x1, y1 = cx[i] + w[i]
        verts.append(np.array([[x0, y0, 0.05], [x1, y0, 0.05], [x1, y1, 0.05],
                               [x0, y1, 0.05], [x0, y0, h[i]], [x1, y0, h[i]],
                               [x1, y1, h[i]], [x0, y1, h[i]]], np.float32))
        faces.append(box_f + 8 * i)
    return name, np.concatenate(verts), np.concatenate(faces)


def _scene():
    """tests/test_slim_pack.py's scene: 294 triangles, 384 padded (three
    sweep tiles of 128)."""
    return [
        _square("emitter", 8.0, 0.0, normal=+1),
        _boxes("city", 24, seed=3),
        _square("behind", 8.0, -1.0, normal=-1),
        _square("top", 10.0, 3.0, normal=-1),
    ]


def _scene_t(p):
    return (p.v0, p.e1, p.e2, p.cross_e, p.w_u, p.w_v, p.d0, p.sid)


def _arrays(pack):
    return {
        f.name: (getattr(pack, f.name) if isinstance(getattr(pack, f.name), int)
                 else None if getattr(pack, f.name) is None
                 else np.asarray(getattr(pack, f.name)))
        for f in dataclasses.fields(pack)
    }


def _jax_pack(meshes, *, use_accel, slim):
    scene = jprep.PreparedSolver(meshes).get_scene(use_accel=use_accel)
    return jprep.pack_scene(scene, len(meshes), slim=slim)


def _port_pack(meshes, *, use_accel, slim):
    scene = tprep.PreparedSolver(meshes).get_scene(use_accel=use_accel)
    return tprep.pack_scene(scene, len(meshes), device=CPU, slim=slim)


def _surf_ext(ps, idx_emit):
    """(n_surf + 1,) int32 active-surface vector of one emitter, as the
    solver builds it (the plate behind the emitter's plane is off)."""
    emitter = ps.get_emitter(idx_emit, **SAMPLING)
    ext = np.zeros(len(ps.meshes) + 1, dtype=np.int32)
    ext[:-1] = _build_emitter_surface_mask(idx_emit, emitter, *ps.get_mesh_bounds())
    return ext


def _up_rays(n, seed, lo, hi):
    """(9, n) f32 cosine-weighted rays from the emitter square, sorted for
    the gate by the port's coherence sort."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n), np.full(n, 1e-4)], 1)
    r1, r2 = rng.uniform(size=n), rng.uniform(size=n)
    s = np.sqrt(1 - r1)
    d = np.stack([s * np.cos(2 * np.pi * r2), s * np.sin(2 * np.pi * r2), np.sqrt(r1)], 1)
    o = torch.from_numpy(o.astype(np.float32))[None]
    d = torch.from_numpy(d.astype(np.float32))[None]
    o, d, _ = ttrace.sort_rays_for_coherence(
        o, d, torch.ones(o.shape[:2], dtype=torch.bool), scene_lo=torch.from_numpy(lo),
        scene_hi=torch.from_numpy(hi))
    o, d = o[0].numpy(), d[0].numpy()
    return np.concatenate([o, d, np.cross(o, d)], axis=1).astype(np.float32).T.copy()


# ---------------------------------------------------------------------------
# the pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 128], ids=["one_chunk", "three_chunks"])
@pytest.mark.parametrize("use_accel", [False, True], ids=["plain", "accel"])
def test_slim_pack_equals_jax_and_full_mode_rows(monkeypatch, use_accel, chunk):
    """The port's slim pack, built in one chunk or in three, equals the JAX
    slim pack bitwise (tri_pack, sid, boxes, scalars) and the port's own
    full-mode ``build_tri_pack`` with zero masks; the per-triangle fields
    are None in both."""
    if chunk:
        monkeypatch.setattr(tprep, "_PACK_BUILD_CHUNK", chunk)
    meshes = _scene()
    jp = _jax_pack(meshes, use_accel=use_accel, slim=True)
    tp = _port_pack(meshes, use_accel=use_accel, slim=True)
    full = _port_pack(meshes, use_accel=use_accel, slim=False)
    assert tp.slim and jp.slim and not full.slim and full.tri_pack is None
    assert tp.tri_pack.shape == (TRI_ROWS, 384) and tp.tri_pack.dtype == torch.float32
    for f in dataclasses.fields(tprep.ScenePack):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if a is None or isinstance(a, int):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f.name)
            assert np.asarray(a).dtype == b.numpy().dtype, f.name
    assert (tp.accel is None) == (not use_accel)
    zeros = torch.zeros(384, dtype=torch.bool)
    assert torch.equal(tp.tri_pack, build_tri_pack(_scene_t(full), zeros, zeros))
    assert not bool(tp.tri_pack[17:].any())
    assert torch.equal(tp.sid, full.sid)


def test_slim_threshold_and_one_pack_per_device(monkeypatch):
    """Below the threshold a scene packs full, at it slim; however the
    device is spelled, a PreparedSolver keeps one pack."""
    meshes = _scene()
    assert tconfig.SLIM_PACK_MIN_TRIS > 384
    assert not tprep.PreparedSolver(meshes).get_scene_pack(use_accel=True, device=CPU).slim
    monkeypatch.setattr(tconfig, "SLIM_PACK_MIN_TRIS", 384)
    ps = tprep.PreparedSolver(meshes)
    pack = ps.get_scene_pack(use_accel=True, device="cpu")
    assert pack.slim and pack is ps.get_scene_pack(use_accel=True, device=CPU)
    assert len(ps._scene_pack_cache) == 1
    monkeypatch.setattr(tconfig, "SLIM_PACK_MIN_TRIS", 385)
    assert not tprep.PreparedSolver(meshes).get_scene_pack(use_accel=True, device=CPU).slim


@pytest.mark.parametrize("reciprocity", [True, False], ids=["half", "whole"])
def test_compute_masks_slim_equals_jax(reciprocity):
    meshes = _scene()
    tp = _port_pack(meshes, use_accel=True, slim=True)
    ps = tprep.PreparedSolver(meshes)
    for idx_emit in range(len(meshes)):
        ext = _surf_ext(ps, idx_emit)
        min_sid = idx_emit + 1 if reciprocity else 0
        want = jtrace.compute_masks_slim(jnp.asarray(tp.sid.numpy()), jnp.asarray(ext),
                                         jnp.int32(idx_emit), jnp.int32(min_sid))
        got = ttrace.compute_masks_slim(tp.sid, torch.from_numpy(ext), idx_emit, min_sid)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert bool(got[0].any()) and got[0].dtype == torch.bool


# ---------------------------------------------------------------------------
# kernel #1's plain version in code mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_code_sweep_matches_pallas_interpret(want_matrix, want_any, gated):
    """The plain code-mode sweep on the slim pack against the Pallas sweep
    with ``code_bounds`` (bitwise), three tiles of 128; and bitwise against
    the port's baked sweep of the full-mode pack, whose
    masks hold the plane cull the code mode leaves out."""
    meshes = _scene()
    jp = _jax_pack(meshes, use_accel=True, slim=True)
    tp = _port_pack(meshes, use_accel=True, slim=True)
    full = _port_pack(meshes, use_accel=True, slim=False)
    ps = tprep.PreparedSolver(meshes)
    ext = _surf_ext(ps, 0)
    lo, hi = tp.tile_lo.numpy().min(axis=0), tp.tile_hi.numpy().max(axis=0)
    rays = _up_rays(4 * 256, 5, lo, hi)
    kw = dict(tri_tile=128, want_matrix=want_matrix, want_any=want_any)

    jm = jtrace.compute_masks_slim(jp.sid, jnp.asarray(ext), jnp.int32(0), jnp.int32(1))
    cj, aj = jpallas.sweep_rays(
        jnp.asarray(rays), jp.tri_pack, jm[0] if want_any else jm[1], ray_block=256,
        interpret=True, accel=jp.accel if gated else None,
        code_bounds=jnp.asarray([0.0, 2.0], jnp.float32), **kw)

    mask, bounds = ttrace.slim_operands(tp.sid, torch.from_numpy(ext), 0, 1, want_any=want_any)
    assert bounds == (0.0, 2.0)
    rays_t = torch.from_numpy(rays)
    visits = torch.zeros(4, dtype=torch.int32)
    ct, at = sweep_rays(rays_t, tp.tri_pack, mask, code_bounds=bounds, visits=visits,
                        accel=tp.accel if gated else None, **kw)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    if want_matrix:
        assert int((ct >= 0).sum()) > 300 and not bool((ct // 2 == 2).any())  # never `behind`
    if want_any:
        assert int(at.sum()) > 300

    em = ps.get_emitter_pack(0, device=CPU, **SAMPLING)
    m_any, m_mat = ttrace.compute_masks(_scene_t(full), torch.from_numpy(ext), 0, 1,
                                        em.plane_vec)
    prim = m_any if want_any else m_mat
    cb, ab = sweep_rays(rays_t, build_tri_pack(_scene_t(full), m_any, m_mat, bake=prim), prim,
                        masks_baked=True, accel=full.accel if gated else None, **kw)
    assert torch.equal(ct, cb) and torch.equal(at, ab)
    assert sweep_rays.launches == sweep_rays.code_launches == 0  # CPU: the plain version


def test_code_mode_excludes_the_emitter_and_the_half_matrix():
    """Per pair, code mode drops the emitter's own triangles from both
    outputs and codes below ``min_code`` from the matrix only, as the mask
    rows of the same pack do."""
    meshes = _scene()
    tp = _port_pack(meshes, use_accel=False, slim=True)
    full = _port_pack(meshes, use_accel=False, slim=False)
    rays_t = torch.from_numpy(_up_rays(512, 8, np.float32([-5, -5, -1]), np.float32([5, 5, 3])))
    on = torch.ones(384, dtype=torch.bool)
    kw = dict(tri_tile=128, want_matrix=True, want_any=True)
    for emit_sid, min_sid in ((1, 0), (1, 2), (3, 0), (0, 3)):
        m_any = (full.sid != emit_sid) & (full.sid < 4)
        m_mat = m_any & (full.sid >= min_sid)
        want = sweep_rays(rays_t, build_tri_pack(_scene_t(full), m_any, m_mat), on, **kw)
        got = sweep_rays(rays_t, tp.tri_pack, on, code_bounds=(2.0 * emit_sid, 2.0 * min_sid),
                         **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (emit_sid, min_sid)
    assert int((got[0] // 2 == 3).sum()) > 100  # emitter 0 off, matrix from sid 3: the top


def test_code_bounds_with_masks_baked_raises():
    tp = _port_pack(_scene(), use_accel=False, slim=True)
    rays_t = torch.zeros((9, 256))
    on = torch.ones(384, dtype=torch.bool)
    with pytest.raises(ValueError, match="mutually exclusive"):
        sweep_rays(rays_t, tp.tri_pack, on, tri_tile=128, want_matrix=True, want_any=False,
                   masks_baked=True, code_bounds=(0.0, 2.0))
    with pytest.raises(ValueError, match="mutually exclusive"):
        sweep_rays_reference(rays_t, tp.tri_pack, torch.ones(3, dtype=torch.int32), 128,
                             want_matrix=True, want_any=False, masks_baked=True,
                             code_bounds=(0.0, 2.0))


# ---------------------------------------------------------------------------
# one chunk
# ---------------------------------------------------------------------------


def _chunk(pack, ps, idx_emit, ext, *, min_sid, accel):
    """``chunk_body`` of two iterations of one emitter on a full or slim pack."""
    em = ps.get_emitter_pack(idx_emit, device=CPU, **SAMPLING)
    ext_t = torch.from_numpy(ext)
    if pack.slim:
        mask, bounds = ttrace.slim_operands(pack.sid, ext_t, idx_emit, min_sid)
        tri_pack = pack.tri_pack
    else:
        tri_pack, mask = ttrace.emitter_operands(_scene_t(pack), ext_t, idx_emit, min_sid,
                                                 em.plane_vec)
        bounds = None
    return ttrace.chunk_body(
        tri_pack, mask, (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2),
        (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v, em.tri_n, em.tri_eps),
        torch.from_numpy(_cp_rows(7, idx_emit, 0, 2)), pack.n_surf, em.n_rays_once,
        accel=pack.accel if accel else None, code_bounds=bounds)


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_chunk_body_slim_equals_full_and_matches_jax(monkeypatch, gated):
    """The port's slim chunk equals its full-mode chunk, and the JAX
    package's slim ``trace_chunk`` (Pallas, interpret), bitwise."""
    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 128)
    meshes = _scene()
    ps = tprep.PreparedSolver(meshes)
    ext = _surf_ext(ps, 0)
    slim = _port_pack(meshes, use_accel=True, slim=True)
    full = _port_pack(meshes, use_accel=True, slim=False)
    got = _chunk(slim, ps, 0, ext, min_sid=1, accel=gated)
    want = _chunk(full, ps, 0, ext, min_sid=1, accel=gated)
    for key in ("counts_f", "counts_b"):
        assert torch.equal(got[key], want[key]), key
    assert int(got["counts_f"].sum() + got["counts_b"].sum()) > 1000

    jps = jprep.PreparedSolver(meshes)
    jp = _jax_pack(meshes, use_accel=True, slim=True)
    em = jps.get_emitter_pack(0, **SAMPLING)
    out = jtrace.trace_chunk(
        (None,) * 7 + (jp.sid,),
        (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2),
        (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v, em.tri_n, em.tri_eps),
        jnp.asarray(_cp_rows(7, 0, 0, 2)), jnp.asarray(ext), jnp.int32(0), jnp.int32(1),
        jnp.int32(em.n_rays_once), em.plane_vec, jp.accel if gated else None, jp.tri_pack,
        ray_block=256, tri_tile=128, want_matrix=True, want_any=False, discrete=False,
        kernel="pallas", interpret=True)
    for key in ("counts_f", "counts_b"):
        np.testing.assert_array_equal(np.asarray(out[key]), got[key].numpy(), err_msg=key)


def test_interop_carries_a_jax_slim_pack_into_a_chunk():
    """A JAX slim pack carried across by ``scene_pack_from_arrays`` is a
    slim pack of the port, field for field its own, and one chunk on it
    equals the same chunk on the port's own slim pack."""
    meshes = _scene()
    carried = scene_pack_from_arrays(_arrays(_jax_pack(meshes, use_accel=True, slim=True)), CPU)
    own = _port_pack(meshes, use_accel=True, slim=True)
    assert carried.slim and carried.v0 is None and carried.d0 is None
    for f in dataclasses.fields(tprep.ScenePack):
        a, b = getattr(carried, f.name), getattr(own, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
    ps = tprep.PreparedSolver(meshes)
    ext = _surf_ext(ps, 1)
    a = _chunk(carried, ps, 1, ext, min_sid=0, accel=False)
    b = _chunk(own, ps, 1, ext, min_sid=0, accel=False)
    for key in ("counts_f", "counts_b"):
        assert torch.equal(a[key], b[key]), key
    assert int(a["counts_f"].sum()) > 100


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _solve(pkg, meshes, prepared=None, **kw):
    params = dict(samples=4, rays=16, seed=9, max_iters=4, min_iters=2, device="cpu",
                  bvh="builtin")
    params.update(kw)
    return pkg.view_factor_matrix(meshes, pkg.MatrixParams(**params), prepared=prepared)


@pytest.mark.parametrize("bvh", ["off", "builtin"])
@pytest.mark.parametrize("reciprocity", [True, False], ids=["reciprocity", "whole"])
def test_slim_solve_equals_full_solve(monkeypatch, reciprocity, bvh):
    """``view_factor_matrix`` on a slim scene pack returns the full-mode
    dict, with the gate (three sweep tiles of 128) and without; the slim
    solve builds no per-emitter pack."""
    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 128)
    meshes = _scene()
    want = _solve(raystrack_tpu_torch, meshes, reciprocity=reciprocity, bvh=bvh)
    monkeypatch.setattr(tconfig, "SLIM_PACK_MIN_TRIS", 1)
    built = []
    monkeypatch.setattr(ttrace, "build_tri_pack",
                        lambda *a, **k: built.append(1) or build_tri_pack(*a, **k))
    ps = tprep.PreparedSolver(meshes)
    got = _solve(raystrack_tpu_torch, meshes, prepared=ps, reciprocity=reciprocity, bvh=bvh)
    assert ps.get_scene_pack(use_accel=bvh == "builtin", device=CPU).slim
    assert got == want and not built
    assert sum(len(row) for row in got.values()) >= 6


def test_slim_multi_emitter_solve_takes_no_scheduled_round(monkeypatch):
    """A slim scene declines the scheduled driver even when it is forced:
    every emitter goes through per-emitter chunks on the resident pack."""
    meshes = _scene()
    monkeypatch.setattr(tconfig, "SCHEDULER", "scheduled")
    want = _solve(raystrack_tpu_torch, meshes, reciprocity=False)
    rounds, packs = [], []
    real_round, real_chunk = ttrace.scheduled_trace, ttrace.chunk_body
    monkeypatch.setattr(ttrace, "scheduled_trace",
                        lambda *a, **k: rounds.append(1) or real_round(*a, **k))
    monkeypatch.setattr(ttrace, "chunk_body",
                        lambda *a, **k: packs.append(a[0]) or real_chunk(*a, **k))
    assert _solve(raystrack_tpu_torch, meshes, reciprocity=False) == want
    assert rounds and not packs  # full mode, forced: scheduled rounds only
    del rounds[:]
    monkeypatch.setattr(tconfig, "SLIM_PACK_MIN_TRIS", 1)
    ps = tprep.PreparedSolver(meshes)
    assert _solve(raystrack_tpu_torch, meshes, prepared=ps, reciprocity=False) == want
    resident = ps.get_scene_pack(use_accel=True, device=CPU).tri_pack
    assert not rounds and len(packs) >= 3 and all(p is resident for p in packs)


def test_slim_solve_matches_jax(monkeypatch):
    """The port's slim solve against the JAX package's slim solve:
    same keys, |dF| <= 1e-4."""
    meshes = _scene()
    monkeypatch.setattr(tconfig, "SLIM_PACK_MIN_TRIS", 1)
    monkeypatch.setattr(jconfig, "SLIM_PACK_MIN_TRIS", 1)
    jps = jprep.PreparedSolver(meshes)
    want = _solve(raystrack_tpu, meshes, prepared=jps)
    assert jps.get_scene_pack(use_accel=True).slim
    got = _solve(raystrack_tpu_torch, meshes)
    assert set(got) == set(want)
    for sender, row in want.items():
        assert set(got[sender]) == set(row), sender
        for key, value in row.items():
            assert abs(got[sender][key] - value) <= 1e-4, (sender, key)
    assert sum(len(row) for row in want.values()) >= 6


# ---------------------------------------------------------------------------
# the FMA-peak probe's plain version
# ---------------------------------------------------------------------------


# the scalars of the JAX package's _fma_kernel
PROBE_C, PROBE_D = 0.999999881, 0.25


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX package's probe script, docs/measurements/vpu_roofline_r05.py,
    loaded as a module (importing it measures nothing)."""
    path = Path(__file__).resolve().parents[1] / "docs" / "measurements" / "vpu_roofline_r05.py"
    spec = importlib.util.spec_from_file_location("vpu_roofline_r05", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_fma_peak_reference_matches_jax_kernel_body(jax_probe):
    """The plain version against the body of TPU kernel #3, ``_fma_kernel``,
    run eagerly on ``measure_peak``'s own block (a jnp array stands for the
    input ref, a NumPy array for the output ref): bitwise, and the port's
    chains, depth, repeats and FMA count are that script's."""
    assert (peak_cuda.ROWS, peak_cuda.LANES) == (jax_probe.ROWS, jax_probe.LANES)
    assert (peak_cuda.CHAINS, peak_cuda.DEPTH, peak_cuda.REPEATS) == (
        jax_probe.CHAINS, jax_probe.DEPTH, jax_probe.GRID)
    assert fma_count() == (jax_probe.GRID * jax_probe.CHAINS * jax_probe.DEPTH
                           * jax_probe.ROWS * jax_probe.LANES)
    x = np.random.default_rng(0).standard_normal(
        (jax_probe.ROWS, jax_probe.LANES), np.float32)
    want = np.empty_like(x)
    jax_probe._fma_kernel(jnp.asarray(x), want)
    got = fma_peak_reference(torch.from_numpy(x), PROBE_C, PROBE_D, 2).numpy()
    assert got.shape == (2,) + want.shape and got.dtype == want.dtype
    assert np.array_equal(got[0], want) and np.array_equal(got[1], want)
    assert np.isfinite(want).all() and np.ptp(want) > 1.0


def test_fma_peak_reference_within_tolerance_of_float64():
    """The plain f32 recurrence stays within ``fma_peak_tolerance`` of the
    same recurrence in float64; on a CPU tensor the wrapper is the plain
    version and launches nothing."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((32, 128)).astype(np.float32))
    c, d = PROBE_C, PROBE_D
    got = fma_peak(x, c, d, repeats=3)
    assert got.shape == (3, 32, 128) and got.dtype == torch.float32
    assert torch.equal(got, fma_peak_reference(x, c, d, 3)) and fma_peak.launches == 0
    exact = fma_peak_reference(x.double(), c, d, 3)
    tol = fma_peak_tolerance(x, c, d)
    err = float((got.double() - exact).abs().max())
    assert 0.0 < err <= tol < 1e-3 * float(exact.abs().max())
    assert bool((got[0] == got[2]).all())
    assert fma_count() == 137438953472 and fma_count(3) * 2048 == 3 * fma_count()
    with pytest.raises(ValueError, match=r"\(32, 128\)"):
        fma_peak(x[:16], c, d)
