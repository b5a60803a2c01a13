"""Port parity: the crossing pass of the gate's tables, the triangle split's
rule, and the split plain versions of the sweeps.

The JAX side runs as its own tests run it on the CPU (the Pallas sweeps in
interpret mode, ``_gate_tables`` in XLA). Inputs come from NumPy seeds and
reach both packages as the same arrays. Tolerances:

- ``gate_cross_reference`` against a NumPy float32 evaluation of
  ``trace_pallas.py`` ``block_union``, and the tables built from it against
  the JAX package's ``_gate_tables`` (counts, early-exit bounds, the set of
  crossed boxes): bitwise, since only differences, products, compares,
  minimum and OR are involved; the visit order wherever the distance keys
  are distinct (the packages may round a block's mean origin an ulp apart);
- ``split=2`` and ``split=4`` against ``split=1``: bitwise (``torch.equal``),
  because the merge is a minimum in the order (t, code);
- the split plain versions against the Pallas kernels in interpret mode: at
  most 0.1% of rays differ (XLA's CPU backend contracts a*b + c into FMAs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raystrack_tpu.ops.trace_pallas as jpallas
from raystrack_tpu import config as jconfig

import raystrack_tpu_torch.ops.trace_cuda as tcuda
from raystrack_tpu_torch import config as tconfig
from raystrack_tpu_torch.ops.trace_cuda import (
    INF, GateTables, build_tri_pack, gate_cross, gate_cross_reference,
    scheduled_tiles_on, sweep_rays, sweep_rays_reference, sweep_rays_scheduled,
    sweep_rays_scheduled_reference, sweep_split,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


# ---------------------------------------------------------------------------
# the crossing pass
# ---------------------------------------------------------------------------

N_TILES = 21  # boxes, one per 128-triangle tile


def _boxes(seed=0):
    """(lo, hi) (N_TILES, 3) f32: random boxes along a street, some thin."""
    rng = np.random.default_rng(seed)
    lo = np.stack([rng.uniform(-30, 28, N_TILES), rng.uniform(-2, 1, N_TILES),
                   rng.uniform(0, 3, N_TILES)], 1)
    hi = lo + rng.uniform(0.01, 6.0, (N_TILES, 3))
    return lo.astype(np.float32), hi.astype(np.float32)


def _hard_rays(n, lo, hi, seed=1):
    """(9, n) f32 rays with what the slab test branches on: direction
    components that are exactly zero (of both signs), origins inside boxes,
    on box faces and outside, rays pointing away from everything."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-32, 32, n), rng.uniform(-3, 3, n), rng.uniform(-1, 4, n)], 1)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    box = rng.integers(0, N_TILES, n)
    inside = rng.uniform(size=n) < 0.2  # origins at box centres
    o[inside] = ((lo[box] + hi[box]) * np.float32(0.5))[inside]
    face = rng.uniform(size=n) < 0.1  # origins on a box's lower x face
    o[face, 0] = lo[box, 0][face]
    for c in range(3):  # axis-parallel components: +0.0 and -0.0
        d[c::11, c] = 0.0
        d[c + 5::23, c] = -0.0
    d[7::29] = np.float32([0.0, 0.0, 1.0])  # two zero components
    d[9::31] = np.float32([0.0, 0.0, -1.0])
    o = o[np.argsort(o[:, 0], kind="stable")]  # coherent blocks along the street
    return np.concatenate([o, d, np.cross(o, d)], axis=1).astype(np.float32).T.copy()


def _block_union_numpy(rays, lo, hi, ray_block):
    """``trace_pallas.py`` ``block_union`` (lines 796-817) in NumPy float32,
    block by block; rays past N belong to no block."""
    f = np.float32
    n = rays.shape[1]
    n_blocks = -(-n // ray_block)
    crossed = np.zeros((n_blocks, lo.shape[0]), bool)
    minnear = np.full((n_blocks, lo.shape[0]), f(INF), np.float32)
    for b in range(n_blocks):
        ob = rays[0:3, b * ray_block:(b + 1) * ray_block].T
        db = rays[3:6, b * ray_block:(b + 1) * ray_block].T
        dz = (np.abs(db) <= f(1e-30))[:, None, :]
        iv = (f(1.0) / np.where(dz[:, 0], f(1.0), db))[:, None, :]
        dp = (db >= f(0.0))[:, None, :]
        ob = ob[:, None, :]
        lo_s, hi_s = lo[None], hi[None]
        t_n = (np.where(dp, lo_s, hi_s) - ob) * iv
        t_f = (np.where(dp, hi_s, lo_s) - ob) * iv
        inside = (ob >= lo_s) & (ob <= hi_s)
        t_n = np.where(dz, np.where(inside, f(-INF), f(INF)), t_n)
        t_f = np.where(dz, np.where(inside, f(INF), f(-INF)), t_f)
        near, far = t_n.max(axis=2), t_f.min(axis=2)
        near_c = near - (np.abs(near) * f(1e-4) + f(1e-6))
        far_c = far + (np.abs(far) * f(1e-4) + f(1e-6))
        assert near_c.dtype == np.float32
        hit = (far_c >= near_c) & (far_c > f(1e-6))
        crossed[b] = hit.any(axis=0)
        minnear[b] = np.where(hit, near_c, f(INF)).min(axis=0)
    return crossed, minnear


def _gate_boxes(lo, hi, monkeypatch, max_tiles):
    """The (n_boxes, 6) boxes ``_gate_tables`` hands the crossing pass: one
    per tile, or groups past ``max_tiles`` tiles."""
    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", max_tiles)
    monkeypatch.setattr(jconfig, "GATE_MAX_TILES", max_tiles)
    probe = torch.from_numpy(_hard_rays(256, lo, hi))
    return tcuda._gate_tables((torch.from_numpy(lo), torch.from_numpy(hi)), probe,
                              N_TILES, 128).boxes


@pytest.mark.parametrize("ray_block", [256, 100], ids=["block256", "block100"])
@pytest.mark.parametrize("max_tiles", [8192, 6], ids=["per_tile", "two_level"])
def test_gate_cross_reference_equals_block_union(monkeypatch, max_tiles, ray_block):
    """Per (block, box), ``crossed`` and ``minnear`` equal the NumPy
    evaluation of the JAX package's ``block_union`` bitwise, with a ragged
    last block and, in ``two_level``, boxes that cover groups of tiles
    (one of them padded with the empty box)."""
    lo, hi = _boxes()
    boxes = _gate_boxes(lo, hi, monkeypatch, max_tiles)
    assert boxes.shape[0] == (N_TILES if max_tiles == 8192 else 6)  # groups of 4: 5 + 1 tile
    n = 5 * 256 + 37
    rays = _hard_rays(n, lo, hi)
    crossed, minnear = gate_cross_reference(torch.from_numpy(rays), boxes, ray_block)
    want_c, want_m = _block_union_numpy(rays, boxes[:, :3].numpy(), boxes[:, 3:].numpy(),
                                        ray_block)
    np.testing.assert_array_equal(crossed.numpy(), want_c)
    np.testing.assert_array_equal(minnear.numpy(), want_m)
    assert crossed.dtype == torch.bool and minnear.dtype == torch.float32
    assert 0 < int(crossed.sum()) < crossed.numel()  # some boxes crossed, some not
    assert bool((minnear[~crossed] == INF).all()) and bool((minnear[crossed] < INF).all())
    assert bool((minnear[crossed] < 0).any())  # an origin inside a box: a negative near bound
    # the wrapper on CPU tensors is the plain version, and counts no launch
    got = gate_cross(torch.from_numpy(rays), boxes, ray_block)
    assert torch.equal(got[0], crossed) and torch.equal(got[1], minnear)
    assert gate_cross.launches == 0


def _octant_cross_numpy(rays, lo, hi, ray_block):
    """The crossing kernel's own evaluation order (csrc/gate.cu) in NumPy
    float32: per block, the rays grouped by octant (the signs d >= 0) and a
    group of rays with a component |d| <= 1e-30; per octant the boxes' near
    and far planes picked once, then the bare (plane - o) * inv chain with
    NaN-propagating max and min and the margins; the zero group through the
    general slab test."""
    f = np.float32
    n = rays.shape[1]
    n_blocks = -(-n // ray_block)
    crossed = np.zeros((n_blocks, lo.shape[0]), bool)
    minnear = np.full((n_blocks, lo.shape[0]), f(INF), np.float32)
    for b in range(n_blocks):
        ob = rays[0:3, b * ray_block:(b + 1) * ray_block].T
        db = rays[3:6, b * ray_block:(b + 1) * ray_block].T
        zero = (np.abs(db) <= f(1e-30)).any(axis=1)
        octant = ((db >= f(0.0)) * np.array([1, 2, 4])).sum(axis=1)
        for g in range(9):
            sel = zero if g == 8 else ~zero & (octant == g)
            if not sel.any():
                continue
            if g == 8:
                c, m = _block_union_numpy(rays[:, b * ray_block:(b + 1) * ray_block][:, sel],
                                          lo, hi, int(sel.sum()))
                hit_any, near_min = c[0], m[0]
            else:
                inv = (f(1.0) / db[sel])[:, None, :]
                pos = np.array([(g >> c) & 1 for c in range(3)], bool)
                np_ = np.where(pos, lo, hi)[None]  # (1, boxes, 3) near planes
                fp_ = np.where(pos, hi, lo)[None]
                o = ob[sel][:, None, :]
                t_n, t_f = (np_ - o) * inv, (fp_ - o) * inv
                near = np.maximum(np.maximum(t_n[..., 0], t_n[..., 1]), t_n[..., 2])
                far = np.minimum(np.minimum(t_f[..., 0], t_f[..., 1]), t_f[..., 2])
                near_c = near - (np.abs(near) * f(1e-4) + f(1e-6))
                far_c = far + (np.abs(far) * f(1e-4) + f(1e-6))
                hit = (far_c >= near_c) & (far_c > f(1e-6))
                hit_any = hit.any(axis=0)
                near_min = np.where(hit, near_c, f(INF)).min(axis=0)
            crossed[b] |= hit_any
            minnear[b] = np.minimum(minnear[b], near_min)
    return crossed, minnear


def _octant_rays(n, lo, hi, seed, special=False):
    """(9, n) rays of all eight octants (direction signs drawn per ray),
    every ninth with a zero component; with ``special`` some origins are NaN,
    +inf or -inf in one or all components, some directions inf or huge."""
    rays = _hard_rays(n, lo, hi, seed=seed)
    rng = np.random.default_rng(seed + 100)
    d = np.abs(rays[3:6]) + np.float32(0.05)
    d *= np.where(rng.uniform(size=(3, n)) < 0.5, np.float32(-1.0), np.float32(1.0))
    d[rng.integers(0, 3, n // 9), np.arange(0, n, 9)[: n // 9]] = 0.0
    rays[3:6] = d
    if special:
        f = np.float32
        for k, value in enumerate((np.nan, np.inf, -np.inf)):
            rays[k % 3, k::13] = f(value)  # one origin component
            rays[0:3, k + 6::41] = f(value)  # all three
        rays[3, 4::37] = f(np.inf)
        rays[5, 5::43] = f(3e38)
    with np.errstate(invalid="ignore", over="ignore"):
        rays[6:9] = np.cross(rays[0:3].T, rays[3:6].T).T
    return rays


@pytest.mark.parametrize("special", [False, True], ids=["octants", "nan_inf"])
@pytest.mark.parametrize("ray_block", [256, 100], ids=["block256", "block100"])
def test_gate_cross_reference_equals_the_kernels_octant_order(special, ray_block):
    """On rays of all eight octants mixed with zero-component rays (and, in
    ``nan_inf``, NaN and infinite origins and infinite or huge directions),
    ``gate_cross_reference`` equals bitwise both the NumPy ``block_union``
    and the crossing kernel's evaluation order: octant groups, planes
    picked once per octant, NaN-propagating max/min."""
    lo, hi = _boxes(seed=3)
    n = 4 * 256 + 61
    rays = _octant_rays(n, lo, hi, seed=7, special=special)
    lo[2, 0], hi[4, 1] = -np.inf, np.inf  # boxes unbounded along one axis
    d = rays[3:6].T
    zero = (np.abs(d) <= 1e-30).any(axis=1)
    octants = ((d >= 0) * np.array([1, 2, 4])).sum(axis=1)[~zero]
    assert set(octants) == set(range(8)) and 0 < zero.sum() < n
    boxes = torch.from_numpy(np.concatenate([lo, hi], axis=1))
    with np.errstate(invalid="ignore", over="ignore"):
        want_c, want_m = _block_union_numpy(rays, lo, hi, ray_block)
        oct_c, oct_m = _octant_cross_numpy(rays, lo, hi, ray_block)
    crossed, minnear = gate_cross_reference(torch.from_numpy(rays), boxes, ray_block)
    np.testing.assert_array_equal(crossed.numpy(), want_c)
    np.testing.assert_array_equal(minnear.numpy(), want_m)
    np.testing.assert_array_equal(oct_c, want_c)
    np.testing.assert_array_equal(oct_m, want_m)
    assert 0 < int(crossed.sum()) < crossed.numel()
    assert not np.isnan(minnear.numpy()).any()


@pytest.mark.parametrize("max_tiles", [8192, 6], ids=["per_tile", "two_level"])
def test_gate_tables_from_the_crossing_equal_jax(monkeypatch, max_tiles):
    """``gate_cross_reference`` put through the rest of ``_gate_tables``
    gives the JAX package's tables on the hard rays: counts, the window
    bounds and the set of crossed boxes bitwise, the visit order wherever
    the keys are distinct; the ragged last block equals its own rays'
    tables, the full blocks before it the JAX rows."""
    lo, hi = _boxes()
    boxes = _gate_boxes(lo, hi, monkeypatch, max_tiles)
    group = tcuda.gate_group_size(N_TILES)
    window = tcuda._resolve_gate_window(group)
    assert (group, window) == ((1, 16) if max_tiles == 8192 else (4, 0))
    n_full, n = 5 * 256, 5 * 256 + 37
    rays = _hard_rays(n, lo, hi)
    accel = (torch.from_numpy(lo), torch.from_numpy(hi))
    gate = tcuda._gate_tables(accel, torch.from_numpy(rays), N_TILES, 128, window=window)
    aabb, wtab, order_j, counts_j, group_j = jpallas._gate_tables(
        (jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(rays[:, :n_full]), 5, 256, N_TILES,
        128, window=window)
    assert group_j == gate.group == group
    n_boxes = boxes.shape[0]
    np.testing.assert_array_equal(np.asarray(aabb)[:6].T, gate.boxes.numpy())
    counts = np.asarray(counts_j)[:5, 0]
    np.testing.assert_array_equal(gate.counts[:5].numpy(), counts)
    crossed, minnear = gate_cross_reference(torch.from_numpy(rays), boxes)
    np.testing.assert_array_equal(crossed.sum(dim=1).numpy(), gate.counts.numpy())
    if window:
        n_w = -(-n_boxes // window)
        np.testing.assert_array_equal(np.asarray(wtab)[:5, :n_w, 6 * window],
                                      gate.suffmin[:5].numpy())
    else:
        assert gate.suffmin.shape == (6, 0)
    order_j = np.asarray(order_j)[:5]
    blo, bhi = boxes[:, :3].numpy(), boxes[:, 3:].numpy()
    for b in range(5):
        assert set(order_j[b, : counts[b]]) == set(np.flatnonzero(crossed[b].numpy()))
        got = gate.order[b, : counts[b]].numpy()
        assert set(got) == set(order_j[b, : counts[b]])
        cent = rays[:3, b * 256:(b + 1) * 256].mean(axis=1)
        gap = np.maximum(np.maximum(blo - cent, cent - bhi), 0.0)
        key = (gap * gap).sum(axis=1)[order_j[b, : counts[b]]]
        distinct = np.ones(counts[b], bool)
        close = np.diff(key) <= 1e-5 * np.maximum(key[1:], 1e-12)
        distinct[1:] &= ~close
        distinct[:-1] &= ~close
        np.testing.assert_array_equal(got[distinct], order_j[b, : counts[b]][distinct])
    last = tcuda._gate_tables(accel, torch.from_numpy(rays[:, n_full:].copy()), N_TILES, 128,
                              window=window, ray_block=37)
    for name in ("order", "counts", "suffmin"):
        assert torch.equal(getattr(gate, name)[5:], getattr(last, name)), name


# ---------------------------------------------------------------------------
# a subset of blocks and the split's rule
# ---------------------------------------------------------------------------


def test_gate_tables_blocks_are_the_named_rows_in_order():
    """``GateTables.blocks(idx)`` (what kernel #2's plain version hands each
    emitter's blocks) holds rows ``idx`` of the per-block tables in that
    order and the shared fields unchanged, and equals the tables built from
    those blocks' rays alone."""
    lo, hi = _boxes()
    accel = (torch.from_numpy(lo), torch.from_numpy(hi))
    rays = torch.from_numpy(_hard_rays(6 * 256, lo, hi))
    gate = tcuda._gate_tables(accel, rays, N_TILES, 128, window=8)
    idx = torch.tensor([4, 1, 5, 1])
    sub = gate.blocks(idx)
    assert isinstance(sub, GateTables)
    for name in ("order", "counts", "suffmin"):
        assert torch.equal(getattr(sub, name), getattr(gate, name)[idx]), name
    assert sub.boxes is gate.boxes
    assert (sub.group, sub.window, sub.ray_block) == (gate.group, 8, 256)
    cols = (idx[:, None] * 256 + torch.arange(256)).reshape(-1)
    own = tcuda._gate_tables(accel, rays[:, cols].contiguous(), N_TILES, 128, window=8)
    for name in ("order", "counts", "suffmin"):
        assert torch.equal(getattr(sub, name), getattr(own, name)), name
    assert gate.blocks(idx[:0]).counts.shape == (0,)


@pytest.mark.parametrize(
    "n_blocks,gated,n_sms,split",
    [
        # ungated (four rays a thread): eight threads a ray up to four
        # blocks an SM, then two
        (1, False, 132, 8), (32, False, 132, 8), (132, False, 132, 8),
        (133, False, 132, 8), (264, False, 132, 8), (528, False, 132, 8),
        (529, False, 132, 2),
        (1024, False, 132, 2),  # the soup and soup8 launches
        (960, False, 132, 2), (60, False, 60, 8), (240, False, 60, 8), (241, False, 60, 2),
        # gated: the blocks are uneven: 16 threads a ray at 64 rays a CTA
        # (and four rays a thread)
        (32, True, 132, 16), (1024, True, 132, 16), (960, True, 132, 16), (3104, True, 132, 16),
        (100000, True, 60, 16), (0, False, 132, 1), (0, True, 132, 1),
    ],
)
def test_sweep_split_is_the_stated_function_of_the_shape(n_blocks, gated, n_sms, split):
    assert sweep_split(n_blocks, gated, n_sms).split == split
    if n_blocks:
        assert split in {g.split for g in tcuda.BUILT_GEOMETRIES[gated]}
    assert set(tcuda.UNGATED_SPLITS) | {tcuda.GATED_SPLIT} <= set(tcuda._SPLITS)


def test_sweep_split_never_grows_with_the_grid():
    """The threads a CTA (rays a CTA x threads a ray / rays a thread) never
    grow with the grid: gated, 256 at every size; ungated, 512 up to four
    blocks an SM and 128 past it."""
    for gated in (False, True):
        for n_sms in (7, 60, 132):
            geos = [sweep_split(n, gated, n_sms) for n in range(7, 40 * n_sms, 7)]
            threads = [g.threads for g in geos]
            assert all(a >= b for a, b in zip(threads, threads[1:])), (gated, n_sms)
            assert (threads[0], threads[-1]) == ((256, 256) if gated else (512, 128))


# ---------------------------------------------------------------------------
# the split plain versions
# ---------------------------------------------------------------------------


def _tie_pack():
    """A hand-built scene of four 128-triangle tiles. Tile 0 holds 64 random
    triangles of surface 1 in columns 64-127 and the same 64 with reversed
    winding, as surface 0, in columns 0-63: a ray through one hits its copy
    at exactly the same t, the two lie in different parts of the tile at
    split 2 and at split 4, and the codes (2*sid + front) differ. Tile 1
    repeats tile 0's surface-1 triangles as surface 2 (a tie across tiles),
    tile 2 is a cloud of surface 2, tile 3 the excluded emitter surface 3.
    Returns the scene tuple, the (lo, hi) boxes per tile and sid."""
    rng = np.random.default_rng(21)

    def cloud(n):
        c = rng.uniform(-1.0, 1.0, (n, 1, 3))
        return (c + rng.normal(scale=0.5, size=(n, 3, 3))).astype(np.float32)

    dup = cloud(64)
    tris = np.concatenate([dup[:, [0, 2, 1]], dup, dup, cloud(64), cloud(128), cloud(128)])
    sid = np.repeat([0, 1, 2, 2, 2, 3], [64, 64, 64, 64, 128, 128]).astype(np.int32)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    cross_e = np.cross(e1, e2).astype(np.float32)
    scene = (v0, e1, e2, cross_e, np.cross(v0, e2).astype(np.float32),
             np.cross(v0, e1).astype(np.float32),
             np.einsum("ij,ij->i", v0, cross_e).astype(np.float32), sid)
    pts = tris.reshape(4, 128 * 3, 3)
    return scene, (pts.min(axis=1), pts.max(axis=1)), sid


def _tie_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    order = np.argsort(o[:, 0], kind="stable")  # blocks of neighbours: the gate fires
    o, d = o[order], d[order]
    return np.concatenate([o, d, np.cross(o, d)], axis=1).astype(np.float32).T.copy()


@pytest.fixture(scope="module")
def tie():
    scene, accel, sid = _tie_pack()
    return (tuple(torch.from_numpy(a) for a in scene),
            tuple(torch.from_numpy(a) for a in accel), torch.from_numpy(sid),
            torch.from_numpy(_tie_rays(6 * 256 - 19, 4)))


OUTPUTS = pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"])


def test_tie_scene_ties_inside_one_tile(tie):
    """Many rays' nearest hit is shared by two triangles of different codes
    in different parts of tile 0: the smaller code must win at every split."""
    scene, _, sid, rays = tie
    m = sid < 2  # tile 0 alone
    pack = build_tri_pack(scene, m, m)
    on = torch.tensor([1, 0, 0, 0], dtype=torch.int32)
    codes, _ = sweep_rays_reference(rays, pack, on, 128, want_matrix=True, want_any=False)
    hit = codes[codes >= 0]
    assert hit.numel() > 150 and bool((hit < 2).all())  # surface 0's copy wins every tie
    only1 = build_tri_pack(scene, sid == 1, sid == 1)
    c1, _ = sweep_rays_reference(rays, only1, on, 128, want_matrix=True, want_any=False)
    assert torch.equal(c1 >= 0, codes >= 0)  # each hit has its twin on surface 1
    assert bool(((c1[c1 >= 0] - 2) + hit == 1).all())  # with the other front flag


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("mode", ["rows", "baked", "code"])
@OUTPUTS
def test_split_plain_version_equals_unsplit(tie, want_matrix, want_any, mode, gated):
    """``sweep_rays_reference(split=2 | 4)`` == ``split=1`` (codes, flags,
    visits), gated and ungated, in the three mask modes, with ties inside a
    tile and across tiles; the wrapper on CPU tensors takes the split its
    launch would have and gives the same."""
    scene, accel, sid, rays = tie
    for min_sid in (0, 1):
        m_any = sid != 3
        m_mat = m_any & (sid >= min_sid)
        prim = m_any if want_any else m_mat
        if mode == "code":
            pack = build_tri_pack(scene, torch.zeros_like(m_any), torch.zeros_like(m_any))
            kw = dict(code_bounds=(6.0, 2.0 * min_sid))
        else:
            pack = build_tri_pack(scene, m_any, m_mat, bake=prim if mode == "baked" else None)
            kw = dict(masks_baked=mode == "baked")
        kw.update(want_matrix=want_matrix, want_any=want_any)
        tiles_on = prim.reshape(-1, 128).any(dim=1).to(torch.int32)
        gate = tcuda._gate_tables(accel, rays, 4, 128, window=16) if gated else None
        outs = {}
        for split in (1, 2, 4):
            visits = torch.full((6,), -1, dtype=torch.int32)
            outs[split] = (*sweep_rays_reference(rays, pack, tiles_on, 128, gate=gate,
                                                 visits=visits, split=split, **kw), visits)
        for split in (2, 4):
            for a, b in zip(outs[split], outs[1]):
                assert torch.equal(a, b), (split, min_sid)
        got = sweep_rays(rays, pack, prim, tri_tile=128, accel=accel if gated else None, **kw)
        assert torch.equal(got[0], outs[1][0]) and torch.equal(got[1], outs[1][1])
        if want_matrix:
            assert int((outs[1][0] >= 0).sum()) > 300
            if min_sid == 0:
                assert int(((outs[1][0] >= 0) & (outs[1][0] < 2)).sum()) > 100  # ties won
        if want_any:
            assert int(outs[1][1].sum()) > 300
    with pytest.raises(ValueError, match="split"):
        sweep_rays_reference(rays, pack, tiles_on, 128, split=3, **kw)


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@OUTPUTS
def test_split_scheduled_plain_version_equals_unsplit(tie, want_matrix, want_any, gated):
    """``sweep_rays_scheduled_reference(split=2 | 4)`` == ``split=1`` with
    per-emitter tile activity, an all-zero row and a row past E."""
    scene, accel, sid, all_rays = tie
    rays = all_rays[:, : 5 * 256].contiguous()
    masks = torch.stack([
        torch.where(sid < 3, 2.0, 0.0), torch.where(sid == 0, 1.0, torch.where(sid < 3, 2.0, 0.0)),
        torch.zeros(sid.shape[0]),
    ])
    emap = torch.tensor([0, 1, 2, 3, 0], dtype=torch.int32)
    zeros = torch.zeros_like(sid, dtype=torch.bool)
    pack = build_tri_pack(scene, zeros, zeros)
    tiles_on = scheduled_tiles_on(masks, 128, want_matrix=want_matrix, want_any=want_any)
    gate = tcuda._gate_tables(accel, rays, 4, 128, window=16) if gated else None
    outs = {}
    for split in (1, 2, 4):
        visits = torch.full((5,), -1, dtype=torch.int32)
        outs[split] = (*sweep_rays_scheduled_reference(
            rays, pack, masks, emap, tiles_on, 128, want_matrix=want_matrix, want_any=want_any,
            gate=gate, visits=visits, split=split), visits)
    for split in (2, 4):
        for a, b in zip(outs[split], outs[1]):
            assert torch.equal(a, b), split
    got = sweep_rays_scheduled(rays, pack, masks, emap, tri_tile=128, want_matrix=want_matrix,
                               want_any=want_any, accel=accel if gated else None)
    assert torch.equal(got[0], outs[1][0]) and torch.equal(got[1], outs[1][1])
    assert outs[1][2].tolist()[2:4] == [0, 0]  # the zero row and the row past E: no visit
    if want_matrix:
        assert int((outs[1][0] >= 0).sum()) > 200


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@OUTPUTS
def test_split_plain_version_matches_pallas_interpret(tie, want_matrix, want_any, gated):
    """The split plain version of kernel #1 against the Pallas sweep in
    interpret mode on the tie scene (<= 0.1% of rays: XLA's FMAs), gated
    with the same boxes and ungated."""
    scene, accel, sid, all_rays = tie
    rays = all_rays[:, : 4 * 256].contiguous()
    m_any = sid != 3
    m_mat = m_any & (sid >= 1)
    prim = m_any if want_any else m_mat
    jscene = tuple(jnp.asarray(a.numpy()) for a in scene)
    jaccel = tuple(jnp.asarray(a.numpy()) for a in accel) if gated else None
    kw = dict(tri_tile=128, want_matrix=want_matrix, want_any=want_any)
    cj, aj = jpallas.sweep_rays(
        jnp.asarray(rays.numpy()),
        jpallas.build_tri_pack(jscene, jnp.asarray(m_any.numpy()), jnp.asarray(m_mat.numpy())),
        jnp.asarray(prim.numpy()), ray_block=256, interpret=True, accel=jaccel, **kw)
    cj, aj = np.asarray(cj), np.asarray(aj)
    pack = build_tri_pack(scene, m_any, m_mat)
    tiles_on = prim.reshape(-1, 128).any(dim=1).to(torch.int32)
    gate = tcuda._gate_tables(accel, rays, 4, 128, window=16) if gated else None
    n = rays.shape[1]
    for split in (2, 4):
        ct, at = sweep_rays_reference(rays, pack, tiles_on, 128, want_matrix=want_matrix,
                                      want_any=want_any, gate=gate, split=split)
        assert (ct.numpy() != cj).sum() <= n // 1000, split
        assert (at.numpy() != aj).sum() <= n // 1000, split
    if want_matrix:
        assert (cj >= 0).sum() > 200


def test_morton3_equals_the_bit_loop():
    """The shift-and-mask interleave of the coherence sort's key == the loop
    over bits and axes it replaces (the JAX package's ``_morton3``), for
    coordinates with bits above the ones it keeps."""
    from raystrack_tpu_torch.ops.trace import _morton3

    rng = np.random.default_rng(8)
    for bits in (3, 6, 8, 10):
        q = torch.from_numpy(rng.integers(0, 1 << 12, (4, 500, 3)).astype(np.int32))
        want = torch.zeros(q.shape[:-1], dtype=torch.int32)
        for b in range(bits):
            for axis in range(3):
                want = want | (((q[..., axis] >> b) & 1) << (3 * b + axis))
        got = _morton3(q, bits)
        assert got.dtype == torch.int32 and torch.equal(got, want), bits
