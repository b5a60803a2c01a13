"""Port parity of the scheduled route, and the repairs that came with it.

The scheduled route traces one convergence round of many emitters per
dispatch (``solver._drive_scheduled`` -> ``ops.trace.scheduled_trace``
-> sweep kernel #2). On the CPU the port runs the kernels' plain versions;
the JAX package runs as its own tests run it (the Pallas kernels in
interpret mode). Inputs come from NumPy seeds.

Held here:

- ``get_flat_tables`` bitwise equal to the JAX package's;
- the scheduled sweep against JAX ``sweep_rays_scheduled(interpret=True)``
  (at most 0.1% of rays may differ);
- ``scheduled_trace`` against JAX ``scheduled_trace_pallas(interpret=True)``
  (per row and surface |dcount| <= max(2, 0.001 rays));
- the scheduled solve exactly equal (``==``) to the per-emitter solve, and
  within |dF| <= 1e-4 of the JAX scheduled-Pallas solve;
- the repairs: exact per-row counts, emitter operands built only when a
  per-emitter dispatch needs them and dropped when the emitter finishes,
  the implicit PreparedSolver cache, one device key per device.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raystrack_tpu
import raystrack_tpu.ops.trace as jtrace
import raystrack_tpu.ops.trace_pallas as jpallas
import raystrack_tpu.prepared as jprep
from raystrack_tpu.config import RAY_BLOCK
from raystrack_tpu.solver import _build_emitter_surface_mask, _cp_rows, _matrix_skip

import raystrack_tpu_torch
import raystrack_tpu_torch.ops.count_cuda as count_cuda
import raystrack_tpu_torch.ops.trace as ttrace
import raystrack_tpu_torch.prepared as tprep
import raystrack_tpu_torch.solver as tsolver
from raystrack_tpu_torch import config as tconfig
from raystrack_tpu_torch.ops.trace_cuda import (
    build_tri_pack, sweep_rays, sweep_rays_scheduled,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from examples.ex00_street_canyon_geometry import build_street_canyon  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def _square(name, size, z, normal=1, center=(0.0, 0.0)):
    cx, cy = center
    h = size / 2.0
    V = np.array(
        [[cx - h, cy - h, z], [cx + h, cy - h, z], [cx + h, cy + h, z],
         [cx - h, cy + h, z]],
        dtype=np.float32,
    )
    F = np.array([[0, 1, 2], [0, 2, 3]] if normal >= 0 else [[0, 2, 1], [0, 3, 2]],
                 dtype=np.int32)
    return name, V, F


def _three_squares():
    return [
        _square("emitter", 1.0, 0.0),
        _square("mid", 1.5, 0.7, normal=-1, center=(0.3, -0.2)),
        _square("top", 3.0, 1.3, normal=+1, center=(-0.4, 0.1)),
    ]


def _cloud_scene(n_tri=600, seed=0):
    """Two facing plates sandwiching a random-triangle cloud (> 512 faces,
    so bvh="auto" Morton-orders it)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-4, -4, 0.5], [4, 4, 6], size=(n_tri, 3))
    spans = rng.normal(scale=0.5, size=(n_tri, 2, 3))
    Vc = np.concatenate(
        [centers, centers + spans[:, 0], centers + spans[:, 1]], axis=1
    ).reshape(-1, 3).astype(np.float32)
    Fc = np.arange(n_tri * 3, dtype=np.int32).reshape(-1, 3)
    return [_square("ground", 8.0, 0.0), _square("lid", 8.0, 7.0, normal=-1),
            ("cloud", Vc, Fc)]


def _scene_t(p):
    return (p.v0, p.e1, p.e2, p.cross_e, p.w_u, p.w_v, p.d0, p.sid)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# repair: exact per-row counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,length,n_surf,step_elems", [
    (5, 2048, 3, None), (3, 4096, 11, 2048 * 22), (1, 256, 1, None),
], ids=["rows5", "stepped", "one"])
def test_count_codes_equals_bincount(monkeypatch, rows, length, n_surf, step_elems):
    """Exact: equal to numpy.bincount per row over the valid rays' codes in
    0..2*n_surf-1. Misses (-1), codes outside that range and padded rays
    (past each row's n_valid) count nowhere; ``stepped`` forces the row
    steps that bound the plain version's memory."""
    if step_elems is not None:
        monkeypatch.setattr(count_cuda, "_COUNT_ELEMS", step_elems)
    rng = np.random.default_rng(rows * 7 + n_surf)
    codes = rng.integers(-3, 2 * n_surf + 3, size=(rows, length)).astype(np.int32)
    codes[:, ::7] = -1
    n_valid = rng.integers(length // 2, length + 1, size=rows).astype(np.int32)
    n_valid[0] = length - length // 5  # padded tail rays
    counts_f, counts_b = count_cuda.count_codes(
        torch.from_numpy(codes), torch.from_numpy(n_valid), n_surf
    )
    assert counts_f.dtype == counts_b.dtype == torch.int32
    assert counts_f.shape == counts_b.shape == (rows, n_surf)
    for r in range(rows):
        row = codes[r, : n_valid[r]]
        want = np.bincount(row[(row >= 0) & (row < 2 * n_surf)],
                           minlength=2 * n_surf).reshape(n_surf, 2)
        np.testing.assert_array_equal(counts_b[r].numpy(), want[:, 0])
        np.testing.assert_array_equal(counts_f[r].numpy(), want[:, 1])
    assert int(counts_f.sum() + counts_b.sum()) > 0
    assert count_cuda.count_bins.launches == 0


def test_count_codes_rejects():
    codes, n_valid = torch.zeros((2, 8), dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="codes"):
        count_cuda.count_codes(codes.long(), n_valid, 1)
    with pytest.raises(ValueError, match="n_valid"):
        count_cuda.count_codes(codes, torch.ones(3, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="contiguous"):
        count_cuda.count_codes(torch.zeros((8, 2), dtype=torch.int32).T, n_valid, 1)


# ---------------------------------------------------------------------------
# repair: emitter operands built at first dispatch, dropped when done
# ---------------------------------------------------------------------------


def _spy_operands(monkeypatch):
    built, runs = [], []
    real = ttrace.emitter_operands

    def spy(*a, **k):
        built.append(1)
        return real(*a, **k)

    class Run(tsolver._EmitterRun):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(ttrace, "emitter_operands", spy)
    monkeypatch.setattr(tsolver, "_EmitterRun", Run)
    return built, runs


@pytest.mark.parametrize("route", ["scheduled", "grouped"])
def test_emitter_operands_built_per_dispatch_and_dropped(monkeypatch, route):
    """A solve the scheduled driver finishes builds no emitter operands; a
    per-emitter solve builds one set per traced emitter; after either solve
    no run holds a pack."""
    built, runs = _spy_operands(monkeypatch)
    monkeypatch.setattr(tconfig, "SCHEDULER", route)
    params = raystrack_tpu_torch.MatrixParams(
        samples=8, rays=32, min_iters=2, max_iters=2, reciprocity=False, device="cpu")
    vf = raystrack_tpu_torch.view_factor_matrix(_three_squares(), params)
    assert len(runs) == 2 and vf["emitter"]  # top sees nothing above it
    assert len(built) == (0 if route == "scheduled" else len(runs))
    assert all(not r.packs for r in runs)


# ---------------------------------------------------------------------------
# repair: the implicit PreparedSolver cache
# ---------------------------------------------------------------------------


def test_implicit_prepared_cache_reuse_rebuild_and_clear(monkeypatch):
    made = []

    class Counted(tprep.PreparedSolver):
        def __init__(self, meshes):
            super().__init__(meshes)
            made.append(self)

    monkeypatch.setattr(tsolver, "PreparedSolver", Counted)
    monkeypatch.setattr(tsolver, "_PREPARED_LRU", {})
    params = raystrack_tpu_torch.MatrixParams(
        samples=4, rays=16, min_iters=1, max_iters=1, device="cpu")
    first = raystrack_tpu_torch.view_factor_matrix(_three_squares(), params)
    second = raystrack_tpu_torch.view_factor_matrix(_three_squares(), params)
    assert first == second and len(made) == 1  # equal meshes share one solver

    meshes = _three_squares()
    raystrack_tpu_torch.view_factor_matrix(meshes, params)
    assert len(made) == 1
    meshes[2][1][:, 2] += 0.25  # in-place edit of V
    raystrack_tpu_torch.view_factor_matrix(meshes, params)
    assert len(made) == 2
    # the cached solver owns copies: the edit did not reach the first one
    assert not np.array_equal(made[0].meshes[2][1], meshes[2][1])

    assert len(tsolver._PREPARED_LRU) == 2
    raystrack_tpu_torch.clear_prepared_cache()
    assert not tsolver._PREPARED_LRU
    raystrack_tpu_torch.view_factor_matrix(_three_squares(), params)
    assert len(made) == 3

    monkeypatch.setattr(tconfig, "PREPARED_CACHE", 0)
    raystrack_tpu_torch.view_factor_matrix(_three_squares(), params)
    assert len(made) == 4 and len(tsolver._PREPARED_LRU) == 1


# ---------------------------------------------------------------------------
# repair: canonical device keys
# ---------------------------------------------------------------------------


def test_device_key_is_canonical(monkeypatch):
    ps = tprep.PreparedSolver(_three_squares())
    kw = dict(samples=4, rays=16, flip_faces=False)
    assert ps.get_scene_pack(device="cpu") is ps.get_scene_pack(device=CPU)
    assert ps.get_emitter_pack(0, device="cpu", **kw) is ps.get_emitter_pack(
        0, device=CPU, **kw)
    assert ps.get_flat_tables(device="cpu", **kw) is ps.get_flat_tables(device=CPU, **kw)
    # an index-less CUDA device is the current card (no card needed to key)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tprep._device_key("cuda") == tprep._device_key("cuda:0") == "cuda:0"
    assert tprep._device_key(torch.device("cuda", 1)) == "cuda:1"


# ---------------------------------------------------------------------------
# flat tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene", ["canyon", "cloud"])
def test_flat_tables_bitwise(scene):
    meshes = build_street_canyon() if scene == "canyon" else _cloud_scene()
    kw = dict(samples=2, rays=16, flip_faces=scene == "cloud", align=RAY_BLOCK)
    jt, jg, joff, jpad = jprep.PreparedSolver(meshes).get_flat_tables(**kw)
    tt, tg, toff, tpad = tprep.PreparedSolver(meshes).get_flat_tables(device=CPU, **kw)
    np.testing.assert_array_equal(joff, toff)
    np.testing.assert_array_equal(jpad, tpad)
    assert len(jt) == len(tt) == 7 and len(jg) == len(tg) == 8
    for a, b in zip(jt + jg, tt + tg):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert b.dtype == torch.float32


# ---------------------------------------------------------------------------
# the scheduled sweep against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


def _sweep_scene():
    """Three surfaces of 128 small random triangles each (one sweep tile of
    128 per surface)."""
    meshes = []
    for sid, name in enumerate(("a", "b", "c")):
        rng = np.random.default_rng(30 + sid)
        centers = rng.uniform(-3, 3, (128, 1, 3))
        V = (centers + rng.normal(scale=0.6, size=(128, 3, 3))).reshape(-1, 3)
        meshes.append((name, V.astype(np.float32),
                       np.arange(384, dtype=np.int32).reshape(-1, 3)))
    return meshes


def _sched_masks(sid):
    """(4, Tpad) combined rows: emitter a with matrix hits from sid 2 (its
    tile off, b any-only); emitter b with no reciprocity; emitter c seeing
    only a; an all-zero row. Tiles are active for some emitters only."""
    rows = [
        np.where(sid == 0, 0, np.where(sid == 1, 1, 2)),
        np.where(sid == 1, 0, 2),
        np.where(sid == 0, 2, 0),
        np.zeros_like(sid),
    ]
    return np.stack(rows).astype(np.float32)


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([o, d, np.cross(o, d)], axis=1).astype(np.float32).T.copy()


@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_scheduled_sweep_matches_pallas_interpret(want_matrix, want_any):
    """Codes and any-hit flags equal the Pallas kernel's up to 0.1% of rays
    (XLA's CPU backend contracts a*b + c into FMAs; kernel #1 measured 0),
    with ragged per-emitter tile activity and an all-zero emitter row."""
    jsc = jprep.PreparedSolver(_sweep_scene()).get_scene_pack()
    zeros = jnp.zeros(jsc.sid.shape, bool)
    pack = np.asarray(jpallas.build_tri_pack(_scene_t(jsc), zeros, zeros))
    masks = _sched_masks(np.asarray(jsc.sid))
    n_blocks = 12
    emap = np.random.default_rng(3).permutation(np.arange(n_blocks) % 4).astype(np.int32)
    rays = _random_rays(n_blocks * 256, 9)
    kw = dict(tri_tile=128, want_matrix=want_matrix, want_any=want_any)
    cj, aj = jpallas.sweep_rays_scheduled(
        jnp.asarray(rays), jnp.asarray(pack), jnp.asarray(masks), jnp.asarray(emap),
        ray_block=256, interpret=True, **kw)
    ct, at = sweep_rays_scheduled(
        torch.from_numpy(rays), torch.from_numpy(pack), torch.from_numpy(masks),
        torch.from_numpy(emap), **kw)
    cj, aj = np.asarray(cj), np.asarray(aj)
    n = rays.shape[1]
    assert (ct.numpy() != cj).sum() <= n // 1000
    assert (at.numpy() != aj).sum() <= n // 1000
    dummy = np.repeat(emap == 3, 256)
    assert (ct.numpy()[dummy] == -1).all() and (at.numpy()[dummy] == 0).all()
    if want_matrix:
        hit_sid = cj[cj >= 0] // 2
        assert len(hit_sid) > 500 and set(np.unique(hit_sid)) == {0, 2}
    if want_any:
        assert aj.sum() > 500


def test_scheduled_sweep_equals_single_emitter_sweep():
    """Per emitter row, the scheduled plain sweep gives the rays of that
    row's blocks the codes of the single-emitter sweep with row masks."""
    tsc = tprep.PreparedSolver(_sweep_scene()).get_scene_pack(device=CPU)
    scene = _scene_t(tsc)
    zeros = torch.zeros_like(tsc.sid, dtype=torch.bool)
    masks = torch.from_numpy(_sched_masks(tsc.sid.numpy()))
    emap = torch.tensor([2, 0, 1, 0, 2, 1, 3, 1], dtype=torch.int32)
    rays = torch.from_numpy(_random_rays(8 * 256, 4))
    codes, any_hit = sweep_rays_scheduled(
        rays, build_tri_pack(scene, zeros, zeros), masks, emap, tri_tile=128,
        want_matrix=True, want_any=True)
    block_of = emap.repeat_interleave(256)
    for e in range(3):
        sel = block_of == e
        m_any, m_mat = masks[e] > 0, masks[e] > 1
        c1, a1 = sweep_rays(rays[:, sel].contiguous(), build_tri_pack(scene, m_any, m_mat),
                            m_any, tri_tile=128, want_matrix=True, want_any=True)
        assert torch.equal(codes[sel], c1) and torch.equal(any_hit[sel], a1), e


def test_scheduled_sweep_wrapper_rejects():
    rays = torch.zeros((9, 512))
    pack = torch.zeros((24, 256))
    masks = torch.zeros((2, 256))
    emap = torch.zeros(2, dtype=torch.int32)
    kw = dict(tri_tile=2048, want_matrix=True, want_any=False)
    sweep_rays_scheduled(rays, pack, masks, emap, **kw)  # the valid call
    with pytest.raises(ValueError, match="multiple of 256"):
        sweep_rays_scheduled(torch.zeros((9, 300)), pack, masks, emap, **kw)
    with pytest.raises(ValueError, match="emap"):
        sweep_rays_scheduled(rays, pack, masks, torch.zeros(3, dtype=torch.int32), **kw)
    with pytest.raises(TypeError, match="masks"):
        sweep_rays_scheduled(rays, pack, masks.to(torch.uint8), emap, **kw)
    with pytest.raises(ValueError, match="masks"):
        sweep_rays_scheduled(rays, pack, torch.zeros((2, 128)), emap, **kw)
    with pytest.raises(ValueError, match="want_matrix or want_any"):
        sweep_rays_scheduled(rays, pack, masks, emap, tri_tile=2048,
                             want_matrix=False, want_any=False)
    assert sweep_rays_scheduled.launches == 0


# ---------------------------------------------------------------------------
# scheduled_trace against scheduled_trace_pallas
# ---------------------------------------------------------------------------


def _schedule(ps, emitter_ids, *, samples, rays, iters, seed, reciprocity):
    """A multi-emitter block schedule and per-round emitter stacks, built
    as the JAX package's scheduled driver builds them (its tests' helper):
    local emitter rows, one CP row per iteration, padding rows repeating row
    0 up to a power of two."""
    kw = dict(samples=samples, rays=rays, flip_faces=False)
    on = {"device": CPU} if isinstance(ps, tprep.PreparedSolver) else {}
    _, _, offsets, n_pad = ps.get_flat_tables(align=RAY_BLOCK, **kw, **on)
    emitters = ps.get_emitters(**kw)
    bounds = ps.get_mesh_bounds()
    n_surf = len(ps.meshes)
    rows, cps, stacks = [], [], {k: [] for k in ("surf", "emit", "min", "once", "plane")}
    for local_e, e in enumerate(emitter_ids):
        ext = np.zeros(n_surf + 1, np.int32)
        ext[:-1] = _build_emitter_surface_mask(e, emitters[e], *bounds)
        es, ms = _matrix_skip(e, reciprocity)
        pe = emitters[e]
        stacks["surf"].append(ext)
        stacks["emit"].append(es)
        stacks["min"].append(ms)
        stacks["once"].append(pe.n_cells * rays)
        stacks["plane"].append(tprep.emitter_plane_vec(pe))
        for c in range(iters):
            cps.append(_cp_rows(seed, e, c, 1)[0])
            for b in range(int(n_pad[e]) // RAY_BLOCK):
                rows.append([local_e, len(cps) - 1, int(offsets[e]) + b * RAY_BLOCK,
                             b * RAY_BLOCK])
    nb = 1 << (len(rows) - 1).bit_length()
    schedule = np.array(rows + [rows[0]] * (nb - len(rows)), np.int32)
    stacks = [np.asarray(stacks[k], np.float32 if k == "plane" else np.int32)
              for k in ("surf", "emit", "min", "once", "plane")]
    return np.stack(cps).astype(np.float32), stacks, schedule


@pytest.mark.parametrize("reciprocity", [True, False], ids=["reciprocity", "full"])
def test_scheduled_trace_matches_pallas_interpret(reciprocity):
    """Per schedule row and surface |dcount| <= max(2, 0.001 * rays): rays
    agree to ulps, so only rays within an ulp of an edge may land apart.
    The JAX side runs its AABB gate; the port's sweep is ungated, and the
    gate changes no count."""
    meshes = _cloud_scene(700, seed=2)
    jps, tps = jprep.PreparedSolver(meshes), tprep.PreparedSolver(meshes)
    kw = dict(samples=2, rays=32, iters=2, seed=7, reciprocity=reciprocity)
    cp, stacks, schedule = _schedule(jps, [0, 1], **kw)
    jsc = jps.get_scene_pack(use_accel=True)
    jt, jg, _, _ = jps.get_flat_tables(samples=2, rays=32, flip_faces=False,
                                       align=RAY_BLOCK)
    want = jtrace.scheduled_trace_pallas(
        _scene_t(jsc), jt, jg, jnp.asarray(cp), *(jnp.asarray(s) for s in stacks),
        jnp.asarray(schedule), jsc.accel, sched_block=RAY_BLOCK, ray_block=256,
        tri_tile=512, want_matrix=True, want_any=False, discrete=False,
        interpret=True,
    )
    tsc = tps.get_scene_pack(use_accel=True, device=CPU)
    tt, tg, _, _ = tps.get_flat_tables(samples=2, rays=32, flip_faces=False,
                                       align=RAY_BLOCK, device=CPU)
    zeros = torch.zeros_like(tsc.sid, dtype=torch.bool)
    flat = ttrace.scheduled_trace(
        _scene_t(tsc), build_tri_pack(_scene_t(tsc), zeros, zeros), tt, tg,
        torch.from_numpy(cp), *(torch.from_numpy(s) for s in stacks),
        torch.from_numpy(schedule), torch.tensor([0, 1], dtype=torch.int32),
        sched_block=RAY_BLOCK, tri_tile=512,
    )
    got = ttrace.unpack_outputs(flat.numpy(), schedule.shape[0], len(meshes))
    tol = max(2, int(0.001 * RAY_BLOCK))
    for key in ("counts_f", "counts_b"):
        a, b = np.asarray(want[key]).astype(np.int64), got[key]
        assert a.shape == b.shape == (schedule.shape[0], len(meshes))
        assert np.abs(a - b).max() <= tol, key
    assert np.asarray(want["counts_f"]).sum() > 1000


@pytest.mark.parametrize("narrow", [False, True], ids=["whole_cdf", "round_faces_cdf"])
def test_scheduled_rays_equal_generate_rays(narrow):
    """The batched raygen gives every schedule row the rays, bitwise, that
    generate_rays gives its emitter's iteration: the ground of the equality
    of the two routes' dicts. The same with the stack's CDF cut to the
    columns the schedule's emitters fill, as the scheduled driver passes it:
    the two plates' 2 faces of the cloud's 300."""
    ps = tprep.PreparedSolver(_cloud_scene(300, seed=6))
    cp, stacks, schedule = _schedule(ps, [1, 0], samples=2, rays=32, iters=3,
                                     seed=3, reciprocity=False)
    tt, tg, offsets, _ = ps.get_flat_tables(samples=2, rays=32, flip_faces=False,
                                            align=RAY_BLOCK, device=CPU)
    sel = torch.tensor([1, 0], dtype=torch.int32)
    if narrow:
        faces = max(ps.get_emitters(samples=2, rays=32, flip_faces=False)[int(e)].cdf.shape[0]
                    for e in sel)
        assert faces < tg[0].shape[1]
        tg = (tg[0][:, :faces],) + tuple(tg[1:])
    o, d, n_valid = ttrace.scheduled_rays(
        tt, tg, torch.from_numpy(cp), torch.from_numpy(stacks[3]),
        torch.from_numpy(schedule), sel, sched_block=RAY_BLOCK)
    for r, (local_e, cp_row, off, base) in enumerate(schedule):
        em = ps.get_emitter_pack(int(sel[local_e]), samples=2, rays=32,
                                 flip_faces=False, device=CPU)
        o1, d1 = ttrace.generate_rays(
            (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2),
            (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v, em.tri_n,
             em.tri_eps),
            torch.from_numpy(cp[cp_row : cp_row + 1]))
        span = slice(base, base + RAY_BLOCK)
        assert torch.equal(o[r], o1[0, span]) and torch.equal(d[r], d1[0, span]), r
        assert int(n_valid[r]) == min(max(em.n_rays_once - base, 0), RAY_BLOCK)


# ---------------------------------------------------------------------------
# the scheduled solve
# ---------------------------------------------------------------------------


def _port_solve(meshes, params, route, monkeypatch, pipeline=1):
    monkeypatch.setattr(tconfig, "SCHEDULER", route)
    monkeypatch.setattr(tconfig, "SCHED_PIPELINE", pipeline)
    return raystrack_tpu_torch.view_factor_matrix(meshes, params, return_stats=True)


@pytest.mark.parametrize("scene", ["canyon", "cloud"])
@pytest.mark.parametrize("reciprocity", [True, False], ids=["reciprocity", "full"])
def test_scheduled_solve_equals_per_emitter_solve(monkeypatch, scene, reciprocity):
    """Exactly equal dicts and stats (==). Both routes lay rays out in rows
    of RAY_BLOCK = 2048 rays and generate them with the same ops, and the
    two sweeps share their pair math, so every count agrees. A stderr
    tolerance the scenes cannot meet makes several convergence rounds, the
    pipelined driver's overshoot and the dropped in-flight round."""
    meshes = build_street_canyon() if scene == "canyon" else _cloud_scene(300, seed=4)
    params = raystrack_tpu_torch.MatrixParams(
        samples=1 if scene == "canyon" else 2, rays=64 if scene == "canyon" else 24,
        seed=4, min_iters=2, max_iters=8, tol=2e-3, tol_mode="stderr",
        reciprocity=reciprocity, device="cpu")
    rounds = []
    real = ttrace.scheduled_trace
    monkeypatch.setattr(ttrace, "scheduled_trace",
                        lambda *a, **k: rounds.append(1) or real(*a, **k))
    want = _port_solve(meshes, params, "grouped", monkeypatch)
    assert not rounds
    got = _port_solve(meshes, params, "scheduled", monkeypatch)
    assert len(rounds) >= 2
    assert got == want
    assert sum(len(row) for row in got[0].values()) >= 5
    monkeypatch.setattr(tconfig, "SCHED_FUSE_ROUNDS", 2)
    assert _port_solve(meshes, params, "scheduled", monkeypatch, pipeline=0) == want


def test_oversized_emitter_goes_to_the_per_emitter_driver(monkeypatch):
    """An emitter whose single iteration exceeds the round budget is left
    to the per-emitter driver; the dict does not change."""
    meshes = [_square("top_a", 2.0, 4.0, normal=-1), _square("top_b", 2.0, 8.0, normal=-1),
              _square("big", 32.0, 0.0)]
    params = raystrack_tpu_torch.MatrixParams(
        samples=2, rays=8, seed=3, min_iters=2, max_iters=3, tol=1e-3,
        reciprocity=False, device="cpu")
    want = _port_solve(meshes, params, "grouped", monkeypatch)
    monkeypatch.setattr(tconfig, "SCHEDULER", "scheduled")
    monkeypatch.setattr(tconfig, "SCHED_MIN_BLOCKS", 2)
    monkeypatch.setattr(tconfig, "TARGET_CHUNK_RAYS", 2 * RAY_BLOCK)
    ps = tprep.PreparedSolver(meshes)
    _, _, offsets, n_pad = ps.get_flat_tables(samples=2, rays=8, flip_faces=False,
                                              align=RAY_BLOCK, device=CPU)
    assert n_pad[2] > 2 * RAY_BLOCK >= n_pad[0]  # big is oversized, the rest fit
    chunks = []
    real_round, real_chunk = ttrace.scheduled_trace, ttrace.chunk_body
    big = (int(offsets[2]), int(offsets[2] + n_pad[2]))

    def spy_round(*a, **k):
        offs = a[10][:, 2].numpy()
        assert not ((offs >= big[0]) & (offs < big[1])).any()
        return real_round(*a, **k)

    rounds = []
    monkeypatch.setattr(ttrace, "scheduled_trace",
                        lambda *a, **k: rounds.append(1) or spy_round(*a, **k))
    monkeypatch.setattr(ttrace, "chunk_body",
                        lambda *a, **k: chunks.append(a[-1]) or real_chunk(*a, **k))
    got = raystrack_tpu_torch.view_factor_matrix(
        meshes, params, prepared=ps, return_stats=True)
    assert got == want
    assert rounds and chunks and set(chunks) == {ps.get_emitters(
        samples=2, rays=8, flip_faces=False)[2].n_cells * 8}


def test_flat_table_budget_declines_scheduler(monkeypatch):
    monkeypatch.setattr(tconfig, "SCHED_MAX_FLAT_RAYS", 1)
    rounds = []
    real = ttrace.scheduled_trace
    monkeypatch.setattr(ttrace, "scheduled_trace",
                        lambda *a, **k: rounds.append(1) or real(*a, **k))
    params = raystrack_tpu_torch.MatrixParams(
        samples=4, rays=16, min_iters=2, max_iters=2, device="cpu")
    want = _port_solve(_three_squares(), params, "grouped", monkeypatch)
    assert _port_solve(_three_squares(), params, "scheduled", monkeypatch) == want
    assert not rounds


def test_scheduled_solve_matches_jax_scheduled_pallas(monkeypatch):
    """Same keys and |dF| <= 1e-4 per entry against the JAX package's
    scheduled driver with its Pallas kernel (interpret mode on the CPU),
    forced as the JAX package's own tests force it."""
    from raystrack_tpu import config as jconfig

    monkeypatch.setattr(jconfig, "SCHEDULER", "scheduled")
    monkeypatch.setattr(jconfig, "KERNEL", "pallas")
    monkeypatch.setattr(tconfig, "SCHEDULER", "scheduled")
    meshes = _three_squares()
    kw = dict(samples=32, rays=256, seed=5, min_iters=3, max_iters=3,
              reciprocity=False, device="cpu")
    want = raystrack_tpu.view_factor_matrix(meshes, raystrack_tpu.MatrixParams(**kw))
    rounds = []
    real = ttrace.scheduled_trace
    monkeypatch.setattr(ttrace, "scheduled_trace",
                        lambda *a, **k: rounds.append(1) or real(*a, **k))
    got = raystrack_tpu_torch.view_factor_matrix(
        meshes, raystrack_tpu_torch.MatrixParams(**kw))
    assert rounds
    assert set(got) == set(want)
    for sender in want:
        assert set(got[sender]) == set(want[sender]), sender
        for key, value in want[sender].items():
            assert abs(got[sender][key] - value) <= 1e-4, (sender, key)
    assert sum(len(row) for row in got.values()) >= 3
