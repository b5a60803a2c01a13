"""Port parity of the sky: the Tregenza classifier, the sky monitor, the
count's bin uses, the any-hit outputs of a chunk and of a scheduled round,
the operands an emitter run keeps per kind of dispatch, and
``view_factor_to_tregenza_sky`` end to end.

The JAX side runs on its CPU backend as its own tests run it (the chunk
through its XLA sweep, the solves through its CPU route); the port runs the
kernels' plain versions. Inputs come from NumPy seeds.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raystrack_tpu
import raystrack_tpu.convergence as jconv
import raystrack_tpu.ops.trace as jtrace
import raystrack_tpu.prepared as jprep
from raystrack_tpu.config import RAY_BLOCK
from raystrack_tpu.ops.tregenza import tregenza_patch_id as jax_patch_id
from raystrack_tpu.solver import _build_emitter_surface_mask, _cp_rows, _matrix_skip

import raystrack_tpu_torch
import raystrack_tpu_torch.ops.trace as ttrace
import raystrack_tpu_torch.prepared as tprep
import raystrack_tpu_torch.solver as tsolver
from raystrack_tpu_torch import config as tconfig
from raystrack_tpu_torch.convergence import SkyMonitor
from raystrack_tpu_torch.interop import emitter_pack_from_arrays, scene_pack_from_arrays
from raystrack_tpu_torch.parallel import ray_mesh
from raystrack_tpu_torch.ops.count_cuda import (
    count_bins, count_bins_reference, count_codes, count_codes_reference,
)
from raystrack_tpu_torch.ops.trace_cuda import build_tri_pack, sweep_rays
from raystrack_tpu_torch.ops.tregenza import RING_HI_SIN, RING_N, tregenza_patch_id

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
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


def _plate_and_cloud():
    """A 4 x 4 plate emitter under a 700-triangle cloud (Morton-ordered)."""
    _, V, F = _square("plate", 4.0, 0.0)
    rng = np.random.default_rng(5)
    Vc = rng.uniform(0.2, 3.0, (2100, 3)).astype(np.float32)
    Vc[:, :2] -= 1.6
    return [("plate", V, F), ("cloud", Vc, np.arange(2100, dtype=np.int32).reshape(-1, 3))]


def _roofed():
    """A floor (sid 1) under a lid (sid 2) and a wide roof above both (sid
    0, a lower sid than the floor): with reciprocity the floor's matrix
    counts only the lid, but its sky is blocked by the roof as well."""
    return [
        _square("roof", 3.0, 1.0, normal=-1),
        _square("floor", 1.0, 0.0),
        _square("lid", 0.5, 0.5, normal=-1, center=(0.1, 0.0)),
    ]


def _scene_t(p):
    return (p.v0, p.e1, p.e2, p.cross_e, p.w_u, p.w_v, p.d0, p.sid)


def _tables_t(e):
    return (e.u_cell, e.v_cell, e.h_tri, e.h_u, e.h_v, e.h_r1, e.h_r2)


def _geom_t(e):
    return (e.cdf, e.tri_a, e.tri_e1, e.tri_e2, e.tri_u, e.tri_v, e.tri_n, e.tri_eps)


def _arrays(pack):
    import dataclasses

    return {
        f.name: (getattr(pack, f.name) if isinstance(getattr(pack, f.name), int)
                 else None if getattr(pack, f.name) is None
                 else np.asarray(getattr(pack, f.name)))
        for f in dataclasses.fields(pack)
    }


# ---------------------------------------------------------------------------
# the Tregenza classifier
# ---------------------------------------------------------------------------


def _directions(n, seed, upper):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) if upper else -np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d.astype(np.float32)


def _far_from_edges(d, margin=1e-4):
    """Directions farther than ``margin`` from every ring threshold (in dz)
    and from every azimuth edge of their ring (in degrees, as the
    classifier measures azimuth)."""
    d64 = d.astype(np.float64)
    dz = d64[:, 2]
    far = np.all(np.abs(dz[:, None] - RING_HI_SIN[None, :7].astype(np.float64)) > margin,
                 axis=1)
    ridx = (dz[:, None] >= RING_HI_SIN[None, :7]).sum(axis=1)
    n_az = RING_N[ridx].astype(np.float64)
    az = np.degrees(np.arctan2(d64[:, 1], d64[:, 0])) % 360.0
    off = np.where(ridx % 2 == 1, 180.0 / n_az, 0.0)
    width = 360.0 / n_az
    rel = (az - off) % width
    return far & (np.minimum(rel, width - rel) > margin)


@pytest.mark.parametrize("upper", [True, False], ids=["upper", "lower"])
def test_patch_ids_match_jax(upper):
    """10^5 seeded unit directions: ids equal the JAX classifier's wherever
    the direction is farther than 1e-4 from a ring threshold or an azimuth
    edge (only atan2 may round apart), and -1 exactly where dz <= 0."""
    d = _directions(100_000, 11 if upper else 12, upper)
    got = tregenza_patch_id(*(torch.from_numpy(d[:, k].copy()) for k in range(3))).numpy()
    want = np.asarray(jax_patch_id(*(jnp.asarray(d[:, k]) for k in range(3))))
    assert got.dtype == np.int32 and got.shape == (100_000,)
    far = _far_from_edges(d)
    assert far.mean() > 0.95
    np.testing.assert_array_equal(got[far], want[far])
    np.testing.assert_array_equal(got == -1, d[:, 2] <= 0.0)
    if upper:
        assert set(np.unique(got)) == set(range(145))  # every patch reachable


def test_patch_ids_zenith_horizon_and_shapes():
    t = lambda *v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    assert tregenza_patch_id(t(0.0), t(0.0), t(1.0)).tolist() == [144]
    assert tregenza_patch_id(t(1.0), t(0.0), t(0.0)).tolist() == [-1]
    assert tregenza_patch_id(t(0.0), t(0.0), t(-1.0)).tolist() == [-1]
    assert tregenza_patch_id(t(1.0), t(0.0), t(1e-4)).tolist() == [0]  # just above the horizon
    d = torch.from_numpy(_directions(24, 3, True)).view(2, 3, 4, 3)
    ids = tregenza_patch_id(d[..., 0], d[..., 1], d[..., 2])
    assert ids.shape == (2, 3, 4) and ids.dtype == torch.int32


# ---------------------------------------------------------------------------
# the sky monitor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tol_mode", ["stderr", "delta"])
@pytest.mark.parametrize("discrete", [False, True], ids=["merged", "discrete"])
def test_sky_monitor_matches_jax(discrete, tol_mode):
    """Fed the same seeded per-iteration counts, the port's SkyMonitor and
    the JAX package's stop at the same iteration with identical totals,
    stderr and projections."""
    rng = np.random.default_rng(17)
    n_once = 4096
    kw = dict(discrete=discrete, n_rays_once=n_once, tol=2e-3 if tol_mode == "stderr" else 5e-4,
              tol_mode=tol_mode, min_iters=3, interval=2, max_iters=60)
    mons = (SkyMonitor(**kw), jconv.SkyMonitor(**kw))
    p = rng.dirichlet(np.ones(146))  # 145 patches and "not sky"
    for _ in range(60):
        value = rng.multinomial(n_once, p)[:145] if discrete else int(rng.binomial(n_once, 0.4))
        for mon in mons:
            mon.consume_iteration(value)
        assert mons[0].done == mons[1].done
        assert mons[0].projected_total() == mons[1].projected_total()
        if mons[0].done:
            break
    port, jax_ = mons
    assert port.iters_done == jax_.iters_done and port.total_rays == jax_.total_rays
    assert port.upward_total == jax_.upward_total
    np.testing.assert_array_equal(port.sky_w.stderr(), jax_.sky_w.stderr())
    if discrete:
        np.testing.assert_array_equal(port.counts_total, jax_.counts_total)
        np.testing.assert_array_equal(port.bins_w.stderr(), jax_.bins_w.stderr())
    assert port.iters_done >= 3


# ---------------------------------------------------------------------------
# the count's bin uses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bins", [145, 1, 22])
@pytest.mark.parametrize("mode", ["all", "n_valid", "valid", "both"])
def test_count_bins_equals_bincount(n_bins, mode):
    """count_bins (the plain version on the CPU) == numpy.bincount per row,
    exactly: out-of-range ids and entries that do not count count nowhere.
    The 22-bin case is count_codes' use (11 surfaces), whose front/back
    views must be unchanged."""
    rng = np.random.default_rng(n_bins)
    rows, length = 6, 3000
    ids = rng.integers(-2, n_bins + 2, size=(rows, length)).astype(np.int32)
    n_valid = rng.integers(0, length + 1, size=rows).astype(np.int32)
    valid = rng.uniform(size=(rows, length)) < 0.6
    keep = np.ones((rows, length), bool)
    nv_t = v_t = None
    if mode in ("n_valid", "both"):
        keep &= np.arange(length)[None, :] < n_valid[:, None]
        nv_t = torch.from_numpy(n_valid)
    if mode in ("valid", "both"):
        keep &= valid
        v_t = torch.from_numpy(valid)
    got = count_bins(torch.from_numpy(ids), n_bins, nv_t, valid=v_t)
    assert got.dtype == torch.int32 and got.shape == (rows, n_bins)
    for r in range(rows):
        sel = ids[r][keep[r] & (ids[r] >= 0) & (ids[r] < n_bins)]
        np.testing.assert_array_equal(got[r].numpy(), np.bincount(sel, minlength=n_bins))
    assert torch.equal(got, count_bins_reference(torch.from_numpy(ids), n_bins, nv_t, v_t))
    if n_bins == 22:
        f, b = count_codes(torch.from_numpy(ids), nv_t, 11, valid=v_t)
        ref = count_codes_reference(torch.from_numpy(ids), nv_t, 11, v_t).view(rows, 11, 2)
        assert torch.equal(f, ref[:, :, 1]) and torch.equal(b, ref[:, :, 0])
        assert torch.equal(f, got[:, 1::2]) and torch.equal(b, got[:, 0::2])
    assert count_bins.launches == 0


def test_count_bins_rejects():
    ids = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="ids"):
        count_bins(ids.long(), 145)
    with pytest.raises(ValueError, match="n_bins"):
        count_bins(ids, -1)
    with pytest.raises(ValueError, match="valid"):
        count_bins(ids, 145, valid=torch.ones((2, 7), dtype=torch.bool))


# ---------------------------------------------------------------------------
# one chunk against the JAX package's chunk step
# ---------------------------------------------------------------------------

OUTPUTS = {
    "any": (False, True, False),
    "any_discrete": (False, True, True),
    "both": (True, True, False),
    "both_discrete": (True, True, True),
}


@pytest.mark.parametrize(
    "scene,idx,accel",
    [("squares", 0, False), ("squares", 1, False), ("plate", 0, True)],
)
@pytest.mark.parametrize("outputs", sorted(OUTPUTS))
def test_chunk_sky_counts_match_trace_chunk(scene, idx, accel, outputs):
    """Per bin and iteration |dcount| <= max(2, 0.001 * n_rays): rays agree
    to ulps (tests/test_torch_trace.py), so only rays within an ulp of a
    triangle edge or a patch edge may land apart. Emitter and minimum sid
    as the workflow sets them (reciprocity); the sky solve's min_sid = 0 is
    the any-only case's only difference and moves no any-hit."""
    want_matrix, want_any, discrete = OUTPUTS[outputs]
    meshes = _three_squares() if scene == "squares" else _plate_and_cloud()
    jps = jprep.PreparedSolver(meshes)
    jsc = jps.get_scene_pack(use_accel=accel)
    jem = jps.get_emitter_pack(idx, samples=8, rays=32, flip_faces=False)
    emitter = jps.get_emitter(idx, samples=8, rays=32, flip_faces=False)
    ext = np.zeros(len(meshes) + 1, np.int32)
    ext[:-1] = _build_emitter_surface_mask(idx, emitter, *jps.get_mesh_bounds())
    emit_sid, min_sid = _matrix_skip(idx, True)
    cp = _cp_rows(11, idx, 0, 4)
    flags = dict(want_matrix=want_matrix, want_any=want_any, discrete=discrete)

    want = jtrace.trace_chunk(
        _scene_t(jsc), _tables_t(jem), _geom_t(jem), jnp.asarray(cp), jnp.asarray(ext),
        jnp.int32(emit_sid), jnp.int32(min_sid), jnp.int32(jem.n_rays_once),
        jem.plane_vec, jsc.accel, jsc.tri_pack,
        ray_block=RAY_BLOCK, tri_tile=jsc.tri_tile, kernel="xla", **flags,
    )
    tsc = scene_pack_from_arrays(_arrays(jsc), CPU)
    tem = emitter_pack_from_arrays(_arrays(jem), CPU)
    operands = ttrace.emitter_operands(
        _scene_t(tsc), torch.from_numpy(ext), emit_sid, min_sid, tem.plane_vec,
        want_any=want_any)
    got = ttrace.chunk_body(*operands, _tables_t(tem), _geom_t(tem), torch.from_numpy(cp),
                            tsc.n_surf, tem.n_rays_once, accel=tsc.accel, **flags)
    keys = (["counts_b", "counts_f"] if want_matrix else []) + [
        "sky_bins" if discrete else "upward"]
    assert sorted(got) == sorted(keys) == sorted(want)
    tol = max(2, int(0.001 * jem.n_rays_once))
    for key in keys:
        a, b = np.asarray(want[key]).astype(np.int64), got[key].numpy()
        assert a.shape == b.shape and b.dtype == np.int32, key
        assert np.abs(a - b).max() <= tol, key
    sky = np.asarray(want["sky_bins" if discrete else "upward"]).sum()
    if idx == 0:  # an upward emitter: some rays reach the sky, some are blocked
        assert 0 < sky < 4 * jem.n_rays_once
    else:  # "mid" emits downward: no ray reaches the sky
        assert sky == 0


# ---------------------------------------------------------------------------
# one scheduled round against the port's own chunks
# ---------------------------------------------------------------------------


def _cloud_scene(n_tri=600, seed=0):
    rng = np.random.default_rng(seed)
    meshes = [_square("ground", 6.0, 0.0), _square("wall", 2.0, 1.5, normal=-1)]
    centers = rng.uniform([-3, -3, 0.3], [3, 3, 3.0], size=(n_tri, 1, 3))
    V = (centers + rng.normal(scale=0.25, size=(n_tri, 3, 3))).reshape(-1, 3)
    meshes.append(("cloud", V.astype(np.float32),
                   np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)))
    return meshes


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("outputs", ["any", "any_discrete", "both_discrete"])
def test_scheduled_trace_sky_equals_chunk_body(monkeypatch, outputs, gated):
    """Each emitter's per-iteration sums over its schedule rows equal
    ``chunk_body`` of that emitter and iteration, bitwise: the two routes
    trace the same rays (tests/test_torch_scheduled.py) and every count is
    exact. Gated: 128-triangle tiles, so both sort their rays and gate."""
    if gated:
        monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 128)
    want_matrix, want_any, discrete = OUTPUTS[outputs]
    flags = dict(want_matrix=want_matrix, want_any=want_any, discrete=discrete)
    meshes = _cloud_scene(500, seed=3)
    ps = tprep.PreparedSolver(meshes)
    kw = dict(samples=2, rays=32, flip_faces=False)
    sc = ps.get_scene_pack(use_accel=True, device=CPU)
    assert ttrace._gate_accel(sc.accel, sc.n_tri_pad, ttrace.PALLAS_TRI_TILE) is not None or \
        not gated
    tables, geom, offsets, n_pad = ps.get_flat_tables(align=RAY_BLOCK, device=CPU, **kw)
    emitters = ps.get_emitters(**kw)
    bounds = ps.get_mesh_bounds()
    iters = 2
    rows, cps, surf, emit, mins, once, plane = [], [], [], [], [], [], []
    for local_e, e in enumerate((0, 1)):
        ext = np.zeros(len(meshes) + 1, np.int32)
        ext[:-1] = _build_emitter_surface_mask(e, emitters[e], *bounds)
        es, ms = _matrix_skip(e, True) if want_matrix else (e, 0)
        surf.append(ext)
        emit.append(es)
        mins.append(ms)
        once.append(emitters[e].n_cells * 32)
        plane.append(tprep.emitter_plane_vec(emitters[e]))
        for c in range(iters):
            cps.append(_cp_rows(5, e, c, 1)[0])
            for b in range(int(n_pad[e]) // RAY_BLOCK):
                rows.append([local_e, len(cps) - 1, int(offsets[e]) + b * RAY_BLOCK,
                             b * RAY_BLOCK])
    schedule = torch.tensor(rows, dtype=torch.int32)
    zeros = torch.zeros_like(sc.sid, dtype=torch.bool)
    flat = ttrace.scheduled_trace(
        _scene_t(sc), build_tri_pack(_scene_t(sc), zeros, zeros), tables, geom,
        torch.from_numpy(np.stack(cps)), torch.from_numpy(np.stack(surf)),
        torch.tensor(emit, dtype=torch.int32), torch.tensor(mins, dtype=torch.int32),
        torch.tensor(once, dtype=torch.int32), torch.from_numpy(np.stack(plane)),
        schedule, torch.tensor([0, 1], dtype=torch.int32), sched_block=RAY_BLOCK,
        accel=sc.accel, **flags)
    host = ttrace.unpack_outputs(flat.numpy(), len(rows), len(meshes), **flags)
    row0 = 0
    for local_e, e in enumerate((0, 1)):
        em = ps.get_emitter_pack(e, device=CPU, **kw)
        ops = ttrace.emitter_operands(_scene_t(sc), torch.from_numpy(surf[local_e]),
                                      emit[local_e], mins[local_e], em.plane_vec,
                                      want_any=want_any)
        chunk = ttrace.chunk_body(*ops, _tables_t(em), _geom_t(em),
                                  torch.from_numpy(_cp_rows(5, e, 0, iters)), len(meshes),
                                  em.n_rays_once, accel=sc.accel, **flags)
        bpi = int(n_pad[e]) // RAY_BLOCK
        for c in range(iters):
            r = slice(row0 + c * bpi, row0 + (c + 1) * bpi)
            for key, value in chunk.items():
                np.testing.assert_array_equal(host[key][r].sum(axis=0), value[c].numpy(),
                                              err_msg=f"{key} emitter {e} iteration {c}")
        row0 += iters * bpi
    sky = host["sky_bins" if discrete else "upward"]
    assert 0 < int(sky.sum()) < sum(once) * iters


def test_unpack_outputs_inverts_pack_outputs():
    rng = np.random.default_rng(2)
    for flags in OUTPUTS.values():
        want_matrix, want_any, discrete = flags
        out = {}
        if want_matrix:
            out["counts_f"] = torch.from_numpy(rng.integers(0, 9, (5, 3)).astype(np.int32))
            out["counts_b"] = torch.from_numpy(rng.integers(0, 9, (5, 3)).astype(np.int32))
        key, shape = ("sky_bins", (5, 145)) if discrete else ("upward", (5,))
        out[key] = torch.from_numpy(rng.integers(0, 9, shape).astype(np.int32))
        host = ttrace.unpack_outputs(ttrace.pack_outputs(out).numpy(), 5, 3,
                                     want_matrix=want_matrix, want_any=want_any,
                                     discrete=discrete)
        assert sorted(host) == sorted(out)
        for k in out:
            np.testing.assert_array_equal(host[k], out[k].numpy())
    with pytest.raises(ValueError, match="size mismatch"):
        ttrace.unpack_outputs(np.zeros(7, np.int32), 5, 3, want_matrix=False, want_any=True,
                              discrete=False)


# ---------------------------------------------------------------------------
# the operands follow the dispatch kind
# ---------------------------------------------------------------------------

KINDS = {"any": (False, True), "matrix+any": (True, True), "matrix": (True, False)}


def _run(scene_pack, ps, idx, reciprocity):
    emitter = ps.get_emitter(idx, samples=8, rays=32, flip_faces=False)
    em = ps.get_emitter_pack(idx, samples=8, rays=32, flip_faces=False, device=CPU)
    surf = _build_emitter_surface_mask(idx, emitter, *ps.get_mesh_bounds())
    emit_sid, min_sid = _matrix_skip(idx, reciprocity)
    return tsolver._EmitterRun(scene_pack, em, surf, emit_sid, min_sid, 9, idx, CPU,
                               mesh=ray_mesh([CPU]))


@pytest.mark.parametrize("discrete", [False, True], ids=["merged", "discrete"])
def test_emitter_run_operands_follow_the_dispatch_kind(discrete):
    """One run traces an any-only chunk, then a matrix + any chunk, then a
    matrix-only chunk (the workflow's state machine). Each chunk equals a
    fresh run of the same kind at the same iteration, on the full pack and
    on the slim pack (whose code-mode eligibility never depended on a baked
    mask), bitwise. The floor's sky is blocked by the roof, a surface its
    matrix never counts: a pack baked with m_mat for every kind would let
    those rays through."""
    meshes = _roofed()
    ps = tprep.PreparedSolver(meshes)
    scene = ps.get_scene(use_accel=False)
    full = tprep.pack_scene(scene, len(meshes), device=CPU, slim=False)
    slim = tprep.pack_scene(scene, len(meshes), device=CPU, slim=True)
    run = _run(full, ps, 1, True)
    assert (run.emit_sid, run.min_sid) == (1, 2)
    skies = []
    for name, (want_matrix, want_any) in KINDS.items():
        itr = run.itr_next
        flags = dict(want_matrix=want_matrix, want_any=want_any, discrete=discrete)
        got = run.dispatch_chunk(2, **flags)()
        for pack in (full, slim):
            fresh = _run(pack, ps, 1, True)
            fresh.itr_next = itr
            want = fresh.dispatch_chunk(2, **flags)()
            assert sorted(got) == sorted(want), name
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
        assert len(run.packs) == (2 if name == "matrix" else 1)  # one pack a kind
        if want_any:
            skies.append(got["sky_bins" if discrete else "upward"])
    run.release()
    assert not run.packs
    # the roof blocks most upward rays: far fewer reach the sky than go up
    n_once = run.em_pack.n_rays_once
    assert all(0 < s.sum() < 0.5 * 2 * n_once for s in skies)


# ---------------------------------------------------------------------------
# view_factor_to_tregenza_sky end to end
# ---------------------------------------------------------------------------

SCENES = {
    "squares": (_three_squares, dict(samples=64, rays=256)),
    "canyon": (build_street_canyon, dict(samples=1, rays=256)),
}


def _sky(pkg, meshes, **kw):
    params = pkg.SkyParams(seed=5, min_iters=4, max_iters=4, device="cpu", **kw)
    return pkg.view_factor_to_tregenza_sky(meshes, params=params, return_stats=True)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("discrete", [False, True], ids=["merged", "discrete"])
def test_sky_matches_jax(scene, discrete):
    """Same key sets and |dF| <= 1e-4 per key, stats key sets equal."""
    build, sampling = SCENES[scene]
    meshes = build()
    want, want_se = _sky(raystrack_tpu, meshes, discrete=discrete, **sampling)
    got, got_se = _sky(raystrack_tpu_torch, meshes, discrete=discrete, **sampling)
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for key, value in want[name].items():
            assert abs(got[name][key] - value) <= 1e-4, (name, key)
        assert len(got[name]) == (145 if discrete else 1)
    assert set(got_se) == set(want_se)
    for name in want_se:
        assert set(got_se[name]) == set(want_se[name])
    assert sum(sum(row.values()) for row in got.values()) > 0.5


@pytest.mark.parametrize("discrete", [False, True], ids=["merged", "discrete"])
def test_sky_scheduled_equals_per_emitter(monkeypatch, discrete):
    """config.SCHEDULER forced: the scheduled route's dict and stats == the
    per-emitter route's, on the CPU (tests/test_solver.py's model)."""
    meshes = [
        _square("ground", 2.0, 0.0, normal=+1),
        _square("mid", 1.5, 0.6, normal=-1, center=(0.4, 0.1)),
        _square("top", 3.0, 1.2, normal=-1),
    ]
    params = raystrack_tpu_torch.SkyParams(samples=8, rays=64, seed=6, device="cpu",
                                           bvh="off", max_iters=7, min_iters=3, tol=1e-3,
                                           discrete=discrete)
    outs = {}
    for route in ("grouped", "scheduled"):
        monkeypatch.setattr(tconfig, "SCHEDULER", route)
        outs[route] = raystrack_tpu_torch.view_factor_to_tregenza_sky(
            meshes, params=params, return_stats=True)
    assert outs["scheduled"] == outs["grouped"]
    assert sum(outs["grouped"][0]["ground"].values()) > 0.1


def test_sky_single_mesh_all_zero_and_logs_nothing(monkeypatch):
    lines = []
    monkeypatch.setattr(tsolver, "_log", lines.append)
    params = raystrack_tpu_torch.SkyParams(device="cpu")
    merged = raystrack_tpu_torch.view_factor_to_tregenza_sky([_square("only", 1.0, 0.0)], params)
    assert merged == {"only": {"Sky": 0.0}} and not lines
    discrete = raystrack_tpu_torch.view_factor_to_tregenza_sky(
        [_square("only", 1.0, 0.0)], raystrack_tpu_torch.SkyParams(device="cpu", discrete=True),
        return_stats=True)
    assert discrete[0]["only"] == {f"Sky_Patch_{i}": 0.0 for i in range(1, 146)}
    assert discrete[1] == {}


@pytest.mark.parametrize(
    "call,error",
    [
        (lambda f: f([], raystrack_tpu_torch.SkyParams(device="cpu")), ValueError),
        (lambda f: f(_three_squares(), raystrack_tpu_torch.MatrixParams(device="cpu")),
         TypeError),
        (lambda f: f(_three_squares(), raystrack_tpu.SkyParams()), TypeError),
        (lambda f: f(_three_squares(), raystrack_tpu_torch.SkyParams(device="cpu"),
                     mesh=object()), TypeError),
    ],
    ids=["empty", "matrix_params", "jax_params", "mesh"],
)
def test_sky_rejects(call, error):
    with pytest.raises(error):
        call(raystrack_tpu_torch.view_factor_to_tregenza_sky)


def test_sky_checkpoint_dir_works(tmp_path):
    """``checkpoint_dir=`` no longer raises: the sky with it equals the sky
    without, and a second solve restores every emitter
    (tests/test_torch_checkpoint.py holds the resume cases)."""
    params = raystrack_tpu_torch.SkyParams(samples=4, rays=16, min_iters=2, max_iters=2,
                                           device="cpu")
    plain = raystrack_tpu_torch.view_factor_to_tregenza_sky(_three_squares(), params)
    for _ in range(2):
        got = raystrack_tpu_torch.view_factor_to_tregenza_sky(
            _three_squares(), params, checkpoint_dir=str(tmp_path / "ckpt"))
        assert got == plain
    assert len(list((tmp_path / "ckpt").glob("emitter_*.json"))) == 3


def test_sky_params_round_trip_and_refuse_tpu():
    p = raystrack_tpu_torch.SkyParams(samples=3, discrete=True, device="cpu")
    assert raystrack_tpu_torch.SkyParams.from_dict(p.as_dict()) == p
    assert p.as_dict() == raystrack_tpu.SkyParams(samples=3, discrete=True,
                                                  device="cpu").as_dict()
    with pytest.raises(ValueError, match="device"):
        raystrack_tpu_torch.SkyParams(device="tpu")


def test_sky_solve_launches_no_kernel_on_cpu():
    before = (sweep_rays.launches, count_bins.launches)
    raystrack_tpu_torch.view_factor_to_tregenza_sky(
        _three_squares(), raystrack_tpu_torch.SkyParams(samples=4, rays=16, min_iters=2,
                                                        max_iters=2, device="cpu"))
    assert (sweep_rays.launches, count_bins.launches) == before == (0, 0)
