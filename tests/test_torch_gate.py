"""Port parity: the AABB distance gate and the scene padding it needs.

The JAX side runs as its own tests run it on the CPU (the Pallas sweeps in
interpret mode). Inputs come from NumPy seeds and reach both packages as
the same arrays. Tolerances:

- packs past PALLAS_MAX_TRIS, acceleration boxes, interop, the coherence
  sort, the gate's boxes, counts and early-exit bounds: bitwise;
- the gate's visit order: equal wherever the blocks' distance keys are
  distinct (the two packages may round a block's mean origin an ulp apart);
- the plain gated sweeps against the Pallas kernels with ``accel=``: at
  most 0.1% of rays differ (XLA's CPU backend contracts a*b + c into FMAs);
- gated against ungated, in the plain versions and through the solves:
  bitwise (``torch.equal``, ``==`` dicts); the port's solve against the
  JAX package's: |dF| <= 1e-4.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raystrack_tpu
import raystrack_tpu.ops.trace as jtrace
import raystrack_tpu.ops.trace_pallas as jpallas
import raystrack_tpu.prepared as jprep
from raystrack_tpu import config as jconfig
from raystrack_tpu.solver import _build_emitter_surface_mask, _cp_rows, _matrix_skip

import raystrack_tpu_torch
import raystrack_tpu_torch.ops.trace as ttrace
import raystrack_tpu_torch.ops.trace_cuda as tcuda
import raystrack_tpu_torch.prepared as tprep
from raystrack_tpu_torch import config as tconfig
from raystrack_tpu_torch.interop import scene_pack_from_arrays
from raystrack_tpu_torch.ops.trace_cuda import (
    build_tri_pack, scheduled_tiles_on, sweep_rays, sweep_rays_reference,
    sweep_rays_scheduled, sweep_rays_scheduled_reference,
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def _cluttered_scene(n_tri=1100, seed=0, hx=32.0, hy=1.0, top=1.6):
    """test_accel_gate.py's cluttered scene turned into a street: a 64 m
    long, 2 m wide canyon closed by walls and a roof of 1 m quads and
    filled with random triangles, with a 64 x 0.2 m emitter strip on its
    floor. Near geometry occludes far, and both the Morton-ordered tiles
    and the coherence-sorted ray blocks lie along the street, so most tiles
    are out of reach of any one block."""
    V = np.array([[-hx, 0.1, 0], [hx, 0.1, 0], [hx, 0.3, 0], [-hx, 0.3, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-hx, -hy, 0.2], [hx, hy, top - 0.1], size=(n_tri, 3))
    spans = rng.normal(scale=0.3, size=(n_tri, 2, 3))
    tris = [np.concatenate([centers, centers + spans[:, 0], centers + spans[:, 1]], axis=1)]
    for x in np.arange(-hx, hx):
        for a, b, c, d in (  # the roof, then the two walls
            ([x, -hy, top], [x, hy, top], [x + 1, hy, top], [x + 1, -hy, top]),
            ([x, -hy, 0], [x + 1, -hy, 0], [x + 1, -hy, top], [x, -hy, top]),
            ([x, hy, 0], [x, hy, top], [x + 1, hy, top], [x + 1, hy, 0]),
        ):
            tris += [np.array([a + b + c]), np.array([a + c + d])]
    Vc = np.concatenate(tris).reshape(-1, 3).astype(np.float32)
    Fc = np.arange(Vc.shape[0], dtype=np.int32).reshape(-1, 3)
    return [("emitter", V, F), ("cloud", Vc, Fc)]


def _arrays(pack):
    return {
        f.name: (getattr(pack, f.name) if isinstance(getattr(pack, f.name), int)
                 else None if getattr(pack, f.name) is None
                 else np.asarray(getattr(pack, f.name)))
        for f in dataclasses.fields(pack)
    }


def _scene_t(p):
    return (p.v0, p.e1, p.e2, p.cross_e, p.w_u, p.w_v, p.d0, p.sid)


def _assert_packs_equal(jp, tp):
    for f in dataclasses.fields(tprep.ScenePack):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if a is None or isinstance(a, int):
            assert a == b, f.name
        else:
            b = b.cpu().numpy()
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f.name)
            assert np.asarray(a).dtype == b.dtype, f.name


def _plate_rays(n, seed, hx=32.0):
    """(9, n) f32 rays from the emitter strip, cosine-weighted upward."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-hx, hx, n), rng.uniform(0.1, 0.3, n), np.full(n, 1e-4)], 1)
    r1, r2 = rng.uniform(size=n), rng.uniform(size=n)
    s = np.sqrt(1 - r1)
    d = np.stack([s * np.cos(2 * np.pi * r2), s * np.sin(2 * np.pi * r2), np.sqrt(r1)], 1)
    o, d = o.astype(np.float32), d.astype(np.float32)
    return np.concatenate([o, d, np.cross(o, d)], axis=1).astype(np.float32).T.copy()


def _coherent(rays, lo, hi):
    """The rays sorted for the gate by the port's coherence sort (one row)."""
    o = torch.from_numpy(rays[0:3].T.copy())[None]
    d = torch.from_numpy(rays[3:6].T.copy())[None]
    valid = torch.ones(o.shape[:2], dtype=torch.bool)
    o, d, _ = ttrace.sort_rays_for_coherence(o, d, valid, scene_lo=torch.from_numpy(lo),
                                             scene_hi=torch.from_numpy(hi))
    o, d = o[0].numpy(), d[0].numpy()
    return np.concatenate([o, d, np.cross(o, d)], axis=1).astype(np.float32).T.copy()


@pytest.fixture(scope="module")
def cluttered():
    """The cluttered scene's JAX accel pack, the port's and coherent rays."""
    meshes = _cluttered_scene()
    jsc = jprep.PreparedSolver(meshes).get_scene_pack(use_accel=True)
    tsc = tprep.PreparedSolver(meshes).get_scene_pack(use_accel=True, device=CPU)
    lo = np.asarray(jsc.tile_lo).min(axis=0)
    hi = np.asarray(jsc.tile_hi).max(axis=0)
    return meshes, jsc, tsc, _coherent(_plate_rays(6 * 256, 3), lo, hi)


# ---------------------------------------------------------------------------
# repairs: padding past PALLAS_MAX_TRIS, interop of the gate's fields
# ---------------------------------------------------------------------------


def _soup(n_tri, seed):
    rng = np.random.default_rng(seed)
    V = rng.uniform(-5, 5, (n_tri * 3, 3)).astype(np.float32)
    return [("soup", V, np.arange(n_tri * 3, dtype=np.int32).reshape(-1, 3))]


@pytest.mark.parametrize("use_accel", [False, True], ids=["plain", "accel"])
def test_pack_past_pallas_max_tris_equals_jax(use_accel):
    """40,000 triangles pad to 40,960 (20 tiles of 2048) in both packages:
    every array, n_tri_pad, tri_tile and the boxes bitwise equal."""
    meshes = _soup(40_000, 1)
    jp = jprep.PreparedSolver(meshes).get_scene_pack(use_accel=use_accel)
    tp = tprep.PreparedSolver(meshes).get_scene_pack(use_accel=use_accel, device=CPU)
    assert tp.n_tri_pad == jp.n_tri_pad == 40_960
    assert tp.tri_tile == jp.tri_tile
    assert tcuda.sweep_tile_width(tp.n_tri_pad, tconfig.PALLAS_TRI_TILE) == 2048
    assert (tp.accel is None) == (not use_accel)
    _assert_packs_equal(jp, tp)


def test_interop_carries_the_accel_boxes():
    """A JAX accel pack past PALLAS_MAX_TRIS carried across equals the
    port's own, its tri_tile and boxes included."""
    meshes = _soup(40_000, 2)
    jp = jprep.PreparedSolver(meshes).get_scene_pack(use_accel=True)
    carried = scene_pack_from_arrays(_arrays(jp), CPU)
    own = tprep.PreparedSolver(meshes).get_scene_pack(use_accel=True, device=CPU)
    for f in dataclasses.fields(tprep.ScenePack):
        a, b = getattr(carried, f.name), getattr(own, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
    assert carried.accel is not None and carried.tile_lo.shape == (40_960 // 128, 3)


def test_tile_boxes_equal_jax_and_cover_their_triangles(cluttered):
    """The cluttered scene's boxes equal the JAX package's bitwise, and each
    covers its ACCEL_GRAIN triangles (test_accel_gate.py's cover test)."""
    _, jsc, tsc, _ = cluttered
    _assert_packs_equal(jsc, tsc)
    lo, hi = tsc.tile_lo.numpy(), tsc.tile_hi.numpy()
    pts = torch.stack([tsc.v0, tsc.v0 + tsc.e1, tsc.v0 + tsc.e2], dim=1).numpy()
    grain = tconfig.ACCEL_GRAIN
    for t in range(tsc.n_tri_pad // grain):
        first, last = t * grain, min((t + 1) * grain, tsc.n_tri)
        if first >= tsc.n_tri:
            assert np.all(lo[t] > hi[t])  # padded grain: the empty box
            continue
        grain_pts = pts[first:last].reshape(-1, 3)
        assert np.all(lo[t] <= grain_pts.min(axis=0)) and np.all(hi[t] >= grain_pts.max(axis=0))


# ---------------------------------------------------------------------------
# the coherence sort and the gate's tables
# ---------------------------------------------------------------------------


def test_sort_rays_for_coherence_equals_jax():
    rng = np.random.default_rng(0)
    o = rng.uniform(-5, 5, (3, 1024, 3)).astype(np.float32)
    d = rng.normal(size=(3, 1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[:, ::7] = o[:, :1]  # repeated keys: the sorts must both be stable
    valid = rng.uniform(size=(3, 1024)) < 0.8
    lo, hi = np.float32([-5, -4, -5]), np.float32([5, 5, 4])
    want = jtrace.sort_rays_for_coherence(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid),
        scene_lo=jnp.asarray(lo), scene_hi=jnp.asarray(hi))
    got = ttrace.sort_rays_for_coherence(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(valid),
        scene_lo=torch.from_numpy(lo), scene_hi=torch.from_numpy(hi))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("tri_tile,max_tiles", [(128, 8192), (256, 8192), (128, 4)],
                         ids=["tile128", "tile256", "two_level"])
def test_gate_tables_equal_jax(cluttered, monkeypatch, tri_tile, max_tiles):
    _, jsc, tsc, rays = cluttered
    monkeypatch.setattr(jconfig, "GATE_MAX_TILES", max_tiles)
    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", max_tiles)
    n_tiles = tsc.n_tri_pad // tri_tile
    group = tcuda.gate_group_size(n_tiles)
    window = tcuda._resolve_gate_window(group)
    n_blocks = rays.shape[1] // 256
    aabb, wtab, order_j, counts_j, group_j = jpallas._gate_tables(
        jsc.accel, jnp.asarray(rays), n_blocks, 256, n_tiles, tri_tile, window=window)
    gate = tcuda._gate_tables(tsc.accel, torch.from_numpy(rays), n_tiles, tri_tile,
                              window=window)
    assert gate.group == group_j == group and gate.window == window
    n_boxes = gate.boxes.shape[0]
    np.testing.assert_array_equal(np.asarray(aabb)[:6].T, gate.boxes.numpy())
    counts = np.asarray(counts_j)[:n_blocks, 0]
    np.testing.assert_array_equal(counts, gate.counts.numpy())
    if n_boxes == 12:
        assert counts.min() < n_boxes  # blocks that cross only some boxes
    if window:
        n_w = -(-n_boxes // window)
        np.testing.assert_array_equal(np.asarray(wtab)[:n_blocks, :n_w, 6 * window],
                                      gate.suffmin.numpy())
    else:
        assert gate.suffmin.shape == (n_blocks, 0)
    # the visit order, wherever the JAX keys leave no room for an ulp
    lo, hi = gate.boxes[:, :3].numpy(), gate.boxes[:, 3:].numpy()
    order_j = np.asarray(order_j)[:n_blocks]
    for b in range(n_blocks):
        cent = rays[:3, b * 256 : (b + 1) * 256].mean(axis=1)
        gap = np.maximum(np.maximum(lo - cent, cent - hi), 0.0)
        key = (gap * gap).sum(axis=1)[order_j[b, : counts[b]]]
        distinct = np.ones(counts[b], bool)
        close = np.diff(key) <= 1e-5 * np.maximum(key[1:], 1e-12)
        distinct[1:] &= ~close
        distinct[:-1] &= ~close
        got = gate.order[b, : counts[b]].numpy()
        np.testing.assert_array_equal(got[distinct], order_j[b, : counts[b]][distinct])
        assert set(got) == set(order_j[b, : counts[b]])


def test_gate_tables_compaction_counts_and_order():
    """test_accel_gate.py's synthetic case: four unit boxes at x = 0, 10,
    20, 30 and three blocks of 8 rays crossing 4, 2 and 0 of them."""
    lo = np.array([[0, 0, 0], [10, 0, 0], [20, 0, 0], [30, 0, 0]], np.float32)
    accel = (torch.from_numpy(lo), torch.from_numpy(lo + 1.0))
    blocks = [([-1.0, 0.5, 0.5], [1.0, 0, 0]), ([15.0, 0.5, 0.5], [1.0, 0, 0]),
              ([-1.0, 0.5, 0.5], [-1.0, 0, 0])]
    o = np.concatenate([np.tile([b[0]], (8, 1)) for b in blocks])
    d = np.concatenate([np.tile([b[1]], (8, 1)) for b in blocks])
    rays = torch.from_numpy(np.concatenate([o, d, np.cross(o, d)], 1).T.astype(np.float32))
    gate = tcuda._gate_tables(accel, rays.contiguous(), 4, 128, ray_block=8)
    assert gate.group == 1
    np.testing.assert_array_equal(gate.counts.numpy(), [4, 2, 0])
    np.testing.assert_array_equal(gate.order[0].numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(gate.order[1, :2].numpy(), [2, 3])


def test_gate_tables_of_a_ragged_last_block(cluttered):
    """Rays past N in the last block cross nothing and leave its mean alone:
    its rows equal the tables of those rays alone."""
    _, _, tsc, rays = cluttered
    rays_t = torch.from_numpy(rays[:, : 5 * 256 + 37].copy())
    gate = tcuda._gate_tables(tsc.accel, rays_t, 12, 128, window=16)
    last = tcuda._gate_tables(tsc.accel, rays_t[:, 5 * 256 :].contiguous(), 12, 128,
                              window=16, ray_block=37)
    assert gate.counts.shape == (6,)
    assert torch.equal(gate.counts[5:], last.counts)
    assert torch.equal(gate.order[5:], last.order)
    assert torch.equal(gate.suffmin[5:], last.suffmin)


# ---------------------------------------------------------------------------
# the plain gated sweeps against the Pallas kernels and the ungated sweeps
# ---------------------------------------------------------------------------


def _jmasks(sc):
    """(m_any, m_mat) of emitter 0 (the plate, excluded), JAX side."""
    ext = jnp.asarray(np.array([0, 1, 0], np.int32))
    return jtrace.compute_masks(_scene_t(sc), ext, jnp.int32(0), jnp.int32(1))


def _masks(sc):
    """(m_any, m_mat) of emitter 0 (the plate, excluded), port side."""
    return ttrace.compute_masks(_scene_t(sc), torch.tensor([0, 1, 0], dtype=torch.int32),
                                0, 1)


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_gated_sweep_matches_pallas_interpret(cluttered, want_matrix, want_any, stream):
    """Kernel #1's plain gated version against the Pallas sweep with the
    same accel boxes (<= 0.1% of rays), and bitwise against the plain
    ungated version, which sweeps more tiles."""
    _, jsc, tsc, rays = cluttered
    jm, tm = _jmasks(jsc), _masks(tsc)
    prim = 1 if want_matrix and not want_any else 0
    kw = dict(tri_tile=128, want_matrix=want_matrix, want_any=want_any)
    cj, aj = jpallas.sweep_rays(
        jnp.asarray(rays), jpallas.build_tri_pack(_scene_t(jsc), *jm), jm[prim],
        ray_block=256, interpret=True, stream_from_hbm=stream, accel=jsc.accel, **kw)
    cj, aj = np.asarray(cj), np.asarray(aj)
    pack = build_tri_pack(_scene_t(tsc), *tm)
    rays_t = torch.from_numpy(rays)
    n_blocks = rays.shape[1] // 256
    visits = torch.zeros(n_blocks, dtype=torch.int32)
    ct, at = sweep_rays(rays_t, pack, tm[prim], accel=tsc.accel, visits=visits, **kw)
    n = rays.shape[1]
    assert (ct.numpy() != cj).sum() <= n // 1000
    assert (at.numpy() != aj).sum() <= n // 1000
    full = torch.zeros(n_blocks, dtype=torch.int32)
    cu, au = sweep_rays(rays_t, pack, tm[prim], visits=full, **kw)
    assert torch.equal(ct, cu) and torch.equal(at, au)
    assert int(visits.sum()) < int(full.sum())  # the gate skipped tiles
    if want_matrix:
        assert (cj >= 0).sum() > 300
    if want_any:
        assert aj.sum() > 300


def _sched_inputs(sc, n_blocks, seed, rays):
    """Three combined emitter rows (the last all zero), a random emap over
    them and the rays of its blocks."""
    sid = sc.sid.numpy() if isinstance(sc.sid, torch.Tensor) else np.asarray(sc.sid)
    masks = np.stack([
        np.where(sid == 1, 2, 0),
        np.where(sid == 0, 1, np.where(sid == 1, 2, 0)),
        np.zeros_like(sid),
    ]).astype(np.float32)
    emap = np.random.default_rng(seed).permutation(np.arange(n_blocks) % 3).astype(np.int32)
    return masks, emap, rays[:, : n_blocks * 256].copy()


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_gated_scheduled_sweep_matches_pallas_interpret(cluttered, want_matrix, want_any,
                                                        stream):
    """Kernel #2's plain gated version against the scheduled Pallas sweep
    with accel (<= 0.1% of rays), and bitwise against its ungated version."""
    _, jsc, tsc, all_rays = cluttered
    masks, emap, rays = _sched_inputs(tsc, 6, 4, all_rays)
    zeros = np.zeros(masks.shape[1], bool)
    kw = dict(tri_tile=128, want_matrix=want_matrix, want_any=want_any)
    cj, aj = jpallas.sweep_rays_scheduled(
        jnp.asarray(rays), jpallas.build_tri_pack(_scene_t(jsc), zeros, zeros),
        jnp.asarray(masks), jnp.asarray(emap), ray_block=256, interpret=True,
        stream_from_hbm=stream, accel=jsc.accel, **kw)
    cj, aj = np.asarray(cj), np.asarray(aj)
    zeros_t = torch.zeros(masks.shape[1], dtype=torch.bool)
    args = (torch.from_numpy(rays), build_tri_pack(_scene_t(tsc), zeros_t, zeros_t),
            torch.from_numpy(masks), torch.from_numpy(emap))
    visits = torch.zeros(6, dtype=torch.int32)
    ct, at = sweep_rays_scheduled(*args, accel=tsc.accel, visits=visits, **kw)
    n = rays.shape[1]
    assert (ct.numpy() != cj).sum() <= n // 1000
    assert (at.numpy() != aj).sum() <= n // 1000
    full = torch.zeros(6, dtype=torch.int32)
    cu, au = sweep_rays_scheduled(*args, visits=full, **kw)
    assert torch.equal(ct, cu) and torch.equal(at, au)
    assert int(visits.sum()) < int(full.sum())
    idle = torch.from_numpy(emap == 2)  # the all-zero row: no visit
    assert not bool(visits[idle].any()) and not bool(full[idle].any())
    assert bool((ct.view(6, 256)[idle] == -1).all())


@pytest.mark.parametrize("window", [16, 8, 0], ids=["window16", "window8", "no_exit"])
def test_gated_plain_equals_ungated_with_early_exit(cluttered, monkeypatch, window):
    """Every early-exit setting gives the ungated codes bitwise; the exit
    only ever removes visits."""
    _, _, tsc, rays = cluttered
    monkeypatch.setattr(tconfig, "GATE_WINDOW", window)
    _, m_mat = _masks(tsc)
    pack = build_tri_pack(_scene_t(tsc), m_mat, m_mat, bake=m_mat)
    rays_t = torch.from_numpy(rays)
    kw = dict(tri_tile=128, want_matrix=True, want_any=False, masks_baked=True)
    visits = torch.zeros(6, dtype=torch.int32)
    codes, _ = sweep_rays(rays_t, pack, m_mat, accel=tsc.accel, visits=visits, **kw)
    assert torch.equal(codes, sweep_rays(rays_t, pack, m_mat, **kw)[0])
    monkeypatch.setattr(tconfig, "GATE_WINDOW", 0)
    late = torch.zeros(6, dtype=torch.int32)
    sweep_rays(rays_t, pack, m_mat, accel=tsc.accel, visits=late, **kw)
    assert bool((visits <= late).all())


@pytest.mark.parametrize("kernel", ["single", "scheduled"])
def test_two_level_gate_equals_ungated(cluttered, monkeypatch, kernel):
    """GATE_MAX_TILES = 2 over 3 tiles of 512: two boxes of two tiles and
    one phantom padding tile. Gated == ungated bitwise on both kernels'
    plain versions, and the phantom tile is never swept."""
    _, _, tsc, rays = cluttered
    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", 2)
    n_tiles = tsc.n_tri_pad // 512
    assert n_tiles == 3 and tcuda.gate_group_size(n_tiles) == 2
    m_any, m_mat = _masks(tsc)
    rays_t = torch.from_numpy(rays)
    kw = dict(tri_tile=512, want_matrix=True, want_any=True)
    if kernel == "single":
        pack = build_tri_pack(_scene_t(tsc), m_any, m_mat)
        call = lambda **a: sweep_rays(rays_t, pack, m_any, **kw, **a)  # noqa: E731
    else:
        masks, emap, _ = _sched_inputs(tsc, 6, 9, rays)
        zeros = torch.zeros_like(m_any)
        pack = build_tri_pack(_scene_t(tsc), zeros, zeros)
        call = lambda **a: sweep_rays_scheduled(  # noqa: E731
            rays_t, pack, torch.from_numpy(masks), torch.from_numpy(emap), **kw, **a)
    visits = torch.zeros(6, dtype=torch.int32)
    c, a = call(accel=tsc.accel, visits=visits)
    cu, au = call()
    assert torch.equal(c, cu) and torch.equal(a, au)
    assert int(visits.max()) <= 4 and int((c >= 0).sum()) > 300


def test_gate_needs_more_than_one_tile(cluttered):
    """A scene of one sweep tile (or no boxes) runs ungated: nothing to skip."""
    _, _, tsc, _ = cluttered
    assert tcuda.gate_prunes(tsc.accel, tsc.n_tri_pad, 128)
    assert not tcuda.gate_prunes(tsc.accel, tsc.n_tri_pad, tconfig.PALLAS_TRI_TILE)
    assert not tcuda.gate_prunes(None, tsc.n_tri_pad, 128)


def test_gated_wrappers_check_accel_and_count_no_launch(cluttered):
    _, _, tsc, rays = cluttered
    m_any, _ = _masks(tsc)
    pack = build_tri_pack(_scene_t(tsc), m_any, m_any)
    kw = dict(tri_tile=128, want_matrix=True, want_any=False)
    rays_t = torch.from_numpy(rays)
    with pytest.raises(ValueError, match="tile_lo"):
        sweep_rays(rays_t, pack, m_any, accel=(tsc.tile_lo[:-1], tsc.tile_hi), **kw)
    with pytest.raises(TypeError, match="tile_hi"):
        sweep_rays(rays_t, pack, m_any, accel=(tsc.tile_lo, tsc.tile_hi.double()), **kw)
    with pytest.raises(ValueError, match="visits"):
        sweep_rays(rays_t, pack, m_any, accel=tsc.accel,
                   visits=torch.zeros(5, dtype=torch.int32), **kw)
    sweep_rays(rays_t, pack, m_any, accel=tsc.accel, **kw)
    assert sweep_rays.launches == sweep_rays.gated_launches == 0
    assert sweep_rays_scheduled.launches == sweep_rays_scheduled.gated_launches == 0


# ---------------------------------------------------------------------------
# the slice: chunks, rounds and solves
# ---------------------------------------------------------------------------


def _chunk_operands(meshes, *, samples=2, rays=24):
    """The port's accel scene pack, an emitter pack whose rows end in padded
    rays, and emitter 0's operands."""
    ps = tprep.PreparedSolver(meshes)
    sc = ps.get_scene_pack(use_accel=True, device=CPU)
    em = ps.get_emitter_pack(0, samples=samples, rays=rays, flip_faces=False, device=CPU)
    ext = torch.tensor([0, 1, 0], dtype=torch.int32)
    return sc, em, ttrace.emitter_operands(_scene_t(sc), ext, 0, 1, em.plane_vec)


def test_chunk_counts_with_padded_rays_mid_row(monkeypatch):
    """After the coherence sort the padded rays sit inside each row; the
    gated chunk's counts equal the ungated, unsorted chunk's exactly."""
    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 128)
    sc, em, operands = _chunk_operands(_cluttered_scene(seed=2))
    assert em.n_rays_once % 256 and em.n_rays_once < em.n_rays_pad
    tables = (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2)
    geom = (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v, em.tri_n, em.tri_eps)
    cp = torch.from_numpy(_cp_rows(5, 0, 0, 2))
    o, d = ttrace.generate_rays(tables, geom, cp)
    valid = (torch.arange(em.n_rays_pad) < em.n_rays_once).expand(2, -1)
    _, _, moved = ttrace._sorted_for_gate(o, d, valid, sc.accel)
    assert not bool(moved[:, : em.n_rays_once].all())  # padded rays moved up
    args = (*operands, tables, geom, cp, sc.n_surf, em.n_rays_once)
    gated = ttrace.chunk_body(*args, accel=sc.accel)
    plain = ttrace.chunk_body(*args)
    for key in ("counts_f", "counts_b"):
        assert torch.equal(gated[key], plain[key]), key
    assert int(plain["counts_f"].sum() + plain["counts_b"].sum()) > 100


def test_scheduled_round_counts_gated_equal_ungated():
    """One scheduled round over both emitters, rows sorted and gated, gives
    the ungated round's counts exactly (rows end in padded rays)."""
    meshes = _cluttered_scene(seed=4)
    ps = tprep.PreparedSolver(meshes)
    sc = ps.get_scene_pack(use_accel=True, device=CPU)
    tt, tg, offsets, n_pad = ps.get_flat_tables(samples=2, rays=24, flip_faces=False,
                                                device=CPU)
    emitters = ps.get_emitters(samples=2, rays=24, flip_faces=False)
    block = tconfig.RAY_BLOCK
    rows = [[e, e, int(offsets[e]) + b * block, b * block]
            for e in range(2) for b in range(int(n_pad[e]) // block)]
    ext = np.zeros((2, 3), np.int32)
    for e in range(2):
        ext[e, :2] = _build_emitter_surface_mask(e, emitters[e], *ps.get_mesh_bounds())
    stacks = (torch.from_numpy(ext), torch.tensor([0, 1], dtype=torch.int32),
              torch.tensor([0, 0], dtype=torch.int32),
              torch.tensor([em.n_cells * 24 for em in emitters], dtype=torch.int32),
              torch.from_numpy(np.stack([tprep.emitter_plane_vec(em) for em in emitters])))
    zeros = torch.zeros_like(sc.sid, dtype=torch.bool)
    pack = build_tri_pack(_scene_t(sc), zeros, zeros)
    cp = torch.from_numpy(np.concatenate([_cp_rows(3, e, 0, 1) for e in range(2)]))
    outs = [ttrace.scheduled_trace(
        _scene_t(sc), pack, tt, tg, cp, *stacks, torch.tensor(rows, dtype=torch.int32),
        torch.tensor([0, 1], dtype=torch.int32), sched_block=block, tri_tile=128,
        accel=accel) for accel in (sc.accel, None)]
    assert torch.equal(outs[0], outs[1])
    assert int(outs[1].sum()) > 100


def _matrix(pkg, meshes, **kw):
    params = dict(samples=2, rays=8, seed=4, device="cpu", max_iters=3, min_iters=2,
                  tol=1e-3, reciprocity=False)
    params.update(kw)
    return pkg.view_factor_matrix(meshes, pkg.MatrixParams(**params))


@pytest.mark.parametrize("route", ["grouped", "scheduled"])
@pytest.mark.parametrize("max_tiles", [8192, 2], ids=["per_tile", "two_level"])
def test_solve_builtin_equals_off(monkeypatch, route, max_tiles):
    """The port's solves on a 2,302-triangle scene (9 sweep tiles of 256,
    so the gate runs): bvh="builtin" == bvh="off" on both routes, with the
    per-tile and the two-level gate."""
    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 512)
    monkeypatch.setattr(tconfig, "SCHEDULER", route)
    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", max_tiles)
    meshes = _cluttered_scene(n_tri=2300, seed=8)
    calls = []
    real = tcuda._gate_tables
    monkeypatch.setattr(tcuda, "_gate_tables", lambda *a, **k: calls.append(1) or real(*a, **k))
    off = _matrix(raystrack_tpu_torch, meshes, bvh="off")
    assert not calls
    on = _matrix(raystrack_tpu_torch, meshes, bvh="builtin")
    assert calls  # the gate ran
    assert on == off
    assert sum(len(row) for row in on.values()) >= 2


def test_solve_builtin_matches_jax():
    """The port's gated solve against the JAX package's gated solve on a
    scene of more than one 2048-triangle sweep tile: |dF| <= 1e-4."""
    meshes = _cluttered_scene(n_tri=4500, seed=9)
    got = _matrix(raystrack_tpu_torch, meshes, bvh="builtin", max_iters=2)
    want = _matrix(raystrack_tpu, meshes, bvh="builtin", max_iters=2)
    assert set(got) == set(want)
    for sender, row in want.items():
        assert set(got[sender]) == set(row), sender
        for key, value in row.items():
            assert abs(got[sender][key] - value) <= 1e-4, (sender, key)
    assert sum(len(row) for row in want.values()) >= 2


def test_reference_visits_count_every_active_tile_ungated(cluttered):
    """Ungated, every block of the plain version sweeps every active tile."""
    _, _, tsc, rays = cluttered
    m_any, _ = _masks(tsc)
    tiles_on = m_any.reshape(-1, 128).any(dim=1).to(torch.int32)
    visits = torch.zeros(6, dtype=torch.int32)
    sweep_rays_reference(torch.from_numpy(rays), build_tri_pack(_scene_t(tsc), m_any, m_any),
                         tiles_on, 128, want_matrix=True, want_any=False, visits=visits)
    assert bool((visits == int(tiles_on.sum())).all())
    masks = torch.stack([m_any.float() * 2, torch.zeros_like(m_any, dtype=torch.float32)])
    emap = torch.tensor([0, 1, 0, 0, 1, 0], dtype=torch.int32)
    sweep_rays_scheduled_reference(
        torch.from_numpy(rays), build_tri_pack(_scene_t(tsc), m_any, m_any), masks, emap,
        scheduled_tiles_on(masks, 128, want_matrix=True, want_any=False), 128,
        want_matrix=True, want_any=False, visits=visits)
    np.testing.assert_array_equal(visits.numpy(), np.where(emap.numpy() == 0,
                                                           int(tiles_on.sum()), 0))
