"""Port parity: the sweeps' CTA geometry (rays a CTA, threads a ray, tile
segments) in the plain versions, and the rule that picks it.

A block of 256 rays stays the gate's and ``emap``'s unit at every geometry;
a CTA serves 64, 128 or 256 of its rays with its own votes, and a segment
sweeps a contiguous part of the block's tiles or visit positions from a
fresh carry, folded in order by the carry's rule. Tolerances:

- every geometry against the 256-ray, one-thread, one-segment walk: codes,
  flags and the per-block visits bitwise (``torch.equal``): a CTA's rays
  keep the carries that walk gives them, so the CTAs of a block together
  sweep exactly the tiles it sweeps, and the fold is a minimum in the order
  (t, visit position, code);
- one geometry against the Pallas sweep in interpret mode: at most 0.1% of
  rays differ (XLA's CPU backend contracts a*b + c into FMAs).

The scene holds exact-t ties across tiles that the visit order decides: a
cluster of triangles is copied into two tiles under two surfaces, and the
gate visits the later tile first.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raystrack_tpu.ops.trace_pallas as jpallas

import raystrack_tpu_torch.ops.trace_cuda as tcuda
from raystrack_tpu_torch import config as tconfig
from raystrack_tpu_torch.ops.trace_cuda import (
    SweepGeometry, build_tri_pack, scheduled_tiles_on, sweep_rays, sweep_rays_reference,
    sweep_rays_scheduled, sweep_rays_scheduled_reference, sweep_split,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


N_TILES = 20  # tiles of 128 triangles
TILE = 128
N_RAYS = 6 * 256 - 19  # a partial last block
WALK = SweepGeometry(256, 1, 1)  # the 256-ray, one-segment walk
DUP_A, DUP_B = 2, 9  # the tiles holding the copied cluster


def _scene():
    """The scene: 20 tiles of 128 triangles along x. Tiles DUP_A and DUP_B
    each hold the same 64 triangles near x = 5 facing the rays (surfaces 1
    and 2); DUP_A's other half lies far beyond them (x = 14), DUP_B's behind
    the rays' origins (x = -2), so DUP_B's box holds the origins and the
    gate visits it first while the tile order takes DUP_A first. Tile 19 is
    the emitter (surface 0), the rest clouds of surfaces 3 and 4 behind
    the origins or beyond the cluster. Returns
    the scene tuple, the boxes (lo, hi) per tile and sid."""
    rng = np.random.default_rng(31)

    def cloud(n, x0, x1, spread=2.0, size=0.6):
        c = np.stack([rng.uniform(x0, x1, n), rng.uniform(-spread, spread, n),
                      rng.uniform(-spread, spread, n)], axis=1)[:, None]
        return (c + rng.normal(scale=size, size=(n, 3, 3))).astype(np.float32)

    dup = cloud(64, 4.5, 5.5, spread=1.2, size=0.5)
    tiles, sids = [], []
    for t in range(N_TILES):
        if t == DUP_A:
            tiles.append(np.concatenate([dup, cloud(64, 13.5, 14.5)]))
            sids.append(np.repeat([1, 3], 64))
        elif t == DUP_B:
            tiles.append(np.concatenate([dup, cloud(64, -2.2, -1.8, spread=0.8, size=0.2)]))
            sids.append(np.repeat([2, 4], 64))
        elif t == N_TILES - 1:
            tiles.append(cloud(128, -3.5, -3.0, size=0.3))
            sids.append(np.zeros(128, np.int64))
        else:  # clear of the rays' way to the copied cluster
            x0 = -20.0 + 2.0 * t if t < DUP_B else 8.0 + 2.0 * (t - DUP_B)
            tiles.append(cloud(128, x0, x0 + 2.0, spread=2.5, size=1.0))
            sids.append(np.full(128, 3 + t % 2))
    tris = np.concatenate(tiles)
    sid = np.concatenate(sids).astype(np.int32)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    cross_e = np.cross(e1, e2).astype(np.float32)
    scene = (v0, e1, e2, cross_e, np.cross(v0, e2).astype(np.float32),
             np.cross(v0, e1).astype(np.float32),
             np.einsum("ij,ij->i", v0, cross_e).astype(np.float32), sid)
    pts = tris.reshape(N_TILES, TILE * 3, 3)
    return scene, (pts.min(axis=1), pts.max(axis=1)), sid


def _rays(n, seed):
    """(9, n) rays from a small cluster at the origin, mostly along +x,
    some in every direction; sorted by x so blocks are neighbours."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)) * np.array([0.35, 0.6, 0.6])
    d[: 3 * n // 4, 0] = np.abs(d[: 3 * n // 4, 0]) + 1.5
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    order = np.argsort(o[:, 0] + 0.01 * rng.normal(size=n), kind="stable")
    o, d = o[order], d[order]
    return np.concatenate([o, d, np.cross(o, d)], axis=1).astype(np.float32).T.copy()


@pytest.fixture(scope="module")
def street():
    scene, accel, sid = _scene()
    return (tuple(torch.from_numpy(a) for a in scene),
            tuple(torch.from_numpy(a) for a in accel), torch.from_numpy(sid),
            torch.from_numpy(_rays(N_RAYS, 5)))


# the geometries the plain versions are held at: the rule's and others, at
# 1, 2 and 4 segments
GEOMETRIES = [SweepGeometry(r, s, g) for r, s in ((256, 1), (256, 4), (64, 8), (64, 16),
                                                   (128, 4), (64, 1), (128, 2))
              for g in (1, 2, 3, 4)]
GEO_IDS = [f"{g.rays}x{g.split}x{g.segments}" for g in GEOMETRIES]

# the gate: none, one box a tile with an early-exit window, and two-level
# in groups of 3 (7 boxes, the last 2 real tiles and a phantom) and of 7
# (3 boxes, the last 6 real tiles and a phantom)
GATES = {"ungated": None, "per_tile": 8192, "group3": 7, "group7": 3}


def _tables(accel, rays, max_tiles, monkeypatch):
    """The gate's tables at GATE_MAX_TILES = ``max_tiles`` (None: ungated)."""
    if max_tiles is None:
        return None
    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", max_tiles)
    group = tcuda.gate_group_size(N_TILES)
    gate = tcuda._gate_tables(accel, rays, N_TILES, TILE,
                              window=tcuda._resolve_gate_window(group))
    assert gate.group == {8192: 1, 7: 3, 3: 7}[max_tiles]
    return gate


def _operands(scene, sid, mode, want_any, min_sid=1):
    """(pack, primary mask, mask kwargs) of kernel #1 in mask mode ``mode``
    for the emitter surface 0."""
    m_any = sid != 0
    m_mat = m_any & (sid >= min_sid)
    prim = m_any if want_any else m_mat
    if mode == "code":
        zeros = torch.zeros_like(m_any)
        return build_tri_pack(scene, zeros, zeros), prim, dict(code_bounds=(0.0, 2.0 * min_sid))
    pack = build_tri_pack(scene, m_any, m_mat, bake=prim if mode == "baked" else None)
    return pack, prim, dict(masks_baked=mode == "baked")


# (mask mode, want_matrix, want_any): every mask mode with both outputs,
# and each output alone
VARIANTS = [("rows", True, True), ("baked", True, True), ("code", True, True),
            ("rows", True, False), ("baked", False, True)]


def _same_visits(v_block, v_walk, geo, gated):
    """A block's visits at ``geo`` against the walk's: equal, but for gated
    segments after the first, which sweep from a fresh carry."""
    if gated and geo.segments > 1:
        assert bool((v_block >= v_walk).all())
    else:
        assert torch.equal(v_block, v_walk)


def _sweep(rays, pack, prim, gate, geo, visits, want_matrix, want_any, **mask_kw):
    tiles_on = tcuda._gated_tiles_on(prim.reshape(-1, TILE).any(dim=1).to(torch.int32), gate)
    return sweep_rays_reference(rays, pack, tiles_on, TILE, want_matrix=want_matrix,
                                want_any=want_any, gate=gate, visits=visits, split=geo,
                                **mask_kw)


@pytest.mark.parametrize("gate_kind", list(GATES))
@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
def test_kernel_1_plain_at_every_geometry_equals_the_walk(street, monkeypatch, geo, gate_kind):
    """Kernel #1's plain version at ``geo`` == the 256-ray, one-segment walk
    (codes, flags; visits of each block at one segment, and ungated), in
    every mask mode and output variant, ungated and behind each gate; its
    per-CTA visits hold one row per CTA and segment, and at one segment its
    CTAs test no more pairs than the walk. A gated segment after the first
    starts without the carry, so its block sweeps at least the walk's
    tiles."""
    scene, accel, sid, rays = street
    gate = _tables(accel, rays, GATES[gate_kind], monkeypatch)
    n_blocks = -(-N_RAYS // 256)
    for mode, wm, wa in VARIANTS:
        pack, prim, kw = _operands(scene, sid, mode, wa)
        v_walk = torch.full((n_blocks,), -1, dtype=torch.int32)
        want = _sweep(rays, pack, prim, gate, WALK, v_walk, wm, wa, **kw)
        v_block = torch.full((n_blocks,), -2, dtype=torch.int32)
        got = _sweep(rays, pack, prim, gate, geo, v_block, wm, wa, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), mode
        _same_visits(v_block, v_walk, geo, gate is not None)
        v_unit = torch.full((geo.units(N_RAYS),), -3, dtype=torch.int32)
        again = _sweep(rays, pack, prim, gate, geo, v_unit, wm, wa, **kw)
        assert torch.equal(again[0], want[0]) and bool((v_unit >= 0).all())
        if geo.segments == 1:
            assert int(v_unit.sum()) * geo.rays <= int(v_walk.sum()) * 256
        if gate is None:
            assert bool((v_walk == int(prim.reshape(-1, TILE).any(dim=1).sum())).all())
        if wm:
            assert int((want[0] >= 0).sum()) > N_RAYS // 4
        if wa:
            assert int(want[1].sum()) > N_RAYS // 4


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
def test_kernel_2_plain_at_every_geometry_equals_the_walk(street, monkeypatch, geo, gated):
    """Kernel #2's plain version at ``geo`` == the walk (codes, flags,
    visits of each block), matrix + any and any-only, with an all-zero
    emitter row, a row past E and a negative row: those blocks sweep
    nothing (-1, 0, no visit) from every one of their CTAs."""
    scene, accel, sid, all_rays = street
    rays = all_rays[:, : 5 * 256].contiguous()
    gate = _tables(accel, rays, 8192 if gated else None, monkeypatch)
    masks = torch.stack([torch.where(sid > 0, 2.0, 0.0),
                         torch.where(sid == 3, 1.0, torch.where(sid > 0, 2.0, 0.0)),
                         torch.zeros(sid.shape[0])])
    emap = torch.tensor([0, 2, 1, 3, -1], dtype=torch.int32)
    zeros = torch.zeros_like(sid, dtype=torch.bool)
    pack = build_tri_pack(scene, zeros, zeros)
    for wm, wa in ((True, True), (False, True)):
        tiles_on = tcuda._gated_tiles_on(
            scheduled_tiles_on(masks, TILE, want_matrix=wm, want_any=wa), gate)
        kw = dict(want_matrix=wm, want_any=wa, gate=gate)
        v_walk = torch.full((5,), -1, dtype=torch.int32)
        want = sweep_rays_scheduled_reference(rays, pack, masks, emap, tiles_on, TILE,
                                              visits=v_walk, split=WALK, **kw)
        v_block = torch.full((5,), -2, dtype=torch.int32)
        got = sweep_rays_scheduled_reference(rays, pack, masks, emap, tiles_on, TILE,
                                             visits=v_block, split=geo, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (wm, wa)
        _same_visits(v_block, v_walk, geo, gated)
        v_unit = torch.full((geo.units(5 * 256),), -3, dtype=torch.int32)
        sweep_rays_scheduled_reference(rays, pack, masks, emap, tiles_on, TILE,
                                       visits=v_unit, split=geo, **kw)
        idle = v_unit.view(5, geo.per_block)[[1, 3, 4]]
        assert not bool(idle.any()) and v_walk[[1, 3, 4]].tolist() == [0, 0, 0]
        dead = want[0].view(5, 256)[[1, 3, 4]]
        assert bool((dead == -1).all()) and not bool(want[1].view(5, 256)[[1, 3, 4]].any())
        assert int(want[1].sum()) > 100


@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
def test_ties_across_tiles_fold_in_visit_order(street, monkeypatch, geo):
    """The copied cluster gives many rays two hits at exactly the same t in
    tiles DUP_A (surface 1) and DUP_B (surface 2). Ungated, the tile order
    takes DUP_A's; gated, the visit order takes DUP_B's, which the gate
    visits first. Every geometry keeps each walk's winner: its segments
    fold in order, and only a strictly smaller t replaces the carry."""
    scene, accel, sid, rays = street
    pack, prim, kw = _operands(scene, sid, "rows", False)
    walk = {}
    for kind in ("ungated", "per_tile"):
        gate = _tables(accel, rays, GATES[kind], monkeypatch)
        walk[kind] = _sweep(rays, pack, prim, gate, WALK, None, True, False, **kw)[0]
        got = _sweep(rays, pack, prim, gate, geo, None, True, False, **kw)[0]
        assert torch.equal(got, walk[kind]), kind
    ungated, gated = walk["ungated"] // 2, walk["per_tile"] // 2
    differ = ungated != gated
    assert int(differ.sum()) > 20  # the visit order decides these ties
    assert bool((ungated[differ] == 1).all()) and bool((gated[differ] == 2).all())


def test_plain_geometry_matches_pallas_interpret(street):
    """The plain gated version at 64 rays a CTA, 4 threads a ray and 2
    segments against the Pallas sweep in interpret mode with the same boxes
    (<= 0.1% of rays), matrix + any."""
    scene, accel, sid, all_rays = street
    rays = all_rays[:, : 4 * 256].contiguous()
    m_any = sid != 0
    m_mat = m_any & (sid >= 1)
    jscene = tuple(jnp.asarray(a.numpy()) for a in scene)
    cj, aj = jpallas.sweep_rays(
        jnp.asarray(rays.numpy()),
        jpallas.build_tri_pack(jscene, jnp.asarray(m_any.numpy()), jnp.asarray(m_mat.numpy())),
        jnp.asarray(m_any.numpy()), ray_block=256, interpret=True,
        accel=tuple(jnp.asarray(a.numpy()) for a in accel), tri_tile=TILE, want_matrix=True,
        want_any=True)
    cj, aj = np.asarray(cj), np.asarray(aj)
    gate = tcuda._gate_tables(accel, rays, N_TILES, TILE, window=16)
    pack = build_tri_pack(scene, m_any, m_mat)
    ct, at = _sweep(rays, pack, m_any, gate, SweepGeometry(64, 4, 2), None, True, True)
    n = rays.shape[1]
    assert (ct.numpy() != cj).sum() <= n // 1000
    assert (at.numpy() != aj).sum() <= n // 1000
    assert (cj >= 0).sum() > n // 4


def test_cpu_wrappers_run_at_the_rules_geometry(street, monkeypatch):
    """On CPU tensors the wrappers run the plain version at the geometry an
    H100 launch of their shape takes, and take visits of one row per block
    or one per CTA of that geometry; other row counts raise."""
    scene, accel, sid, rays = street
    pack, prim, kw = _operands(scene, sid, "baked", False)
    asked = []
    rule = tcuda.sweep_split

    def spy(n_blocks, gated, n_sms):
        asked.append((n_blocks, gated, n_sms))
        return rule(n_blocks, gated, n_sms)

    monkeypatch.setattr(tcuda, "sweep_split", spy)
    geo = rule(6, True, 132)
    v_cta = torch.zeros(geo.units(N_RAYS), dtype=torch.int32)
    got = sweep_rays(rays, pack, prim, tri_tile=TILE, want_matrix=True, want_any=False,
                     accel=accel, visits=v_cta, **kw)
    assert asked == [(6, True, 132)]
    gate = tcuda._gate_tables(accel, rays, N_TILES, TILE, window=16)
    v_plain = torch.zeros_like(v_cta)
    want = _sweep(rays, pack, prim, gate, geo, v_plain, True, False, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(v_cta, v_plain)
    v_block = torch.zeros(6, dtype=torch.int32)
    sweep_rays(rays, pack, prim, tri_tile=TILE, want_matrix=True, want_any=False, accel=accel,
               visits=v_block, **kw)
    v_walk = torch.zeros(6, dtype=torch.int32)
    _sweep(rays, pack, prim, gate, WALK, v_walk, True, False, **kw)
    assert torch.equal(v_block, v_walk)
    rows = {6, geo.units(N_RAYS)}
    bad = next(k for k in range(1, 40) if k not in rows)
    with pytest.raises(ValueError, match="visits"):
        sweep_rays(rays, pack, prim, tri_tile=TILE, want_matrix=True, want_any=False,
                   accel=accel, visits=torch.zeros(bad, dtype=torch.int32), **kw)
    assert sweep_rays.launches == sweep_rays_scheduled.launches == 0


def test_geometry_units_and_forcing():
    """A geometry's rows: CTAs (the last may be partial) times segments; a
    bare int names the whole-block geometry at that split, as a test or a
    measurement forces it; the plain versions refuse what they cannot
    split, and no kernel is built at more than one segment."""
    geo = SweepGeometry(64, 4, 2)
    assert geo.units(N_RAYS) == -(-N_RAYS // 64) * 2 and geo.per_block == 8
    assert SweepGeometry().units(N_RAYS) == 6 and SweepGeometry().per_block == 1
    assert tcuda._geometry(4) == SweepGeometry(256, 4, 1)
    assert tcuda._geometry(geo) is geo
    for n_blocks in (1, 66, 160, 192, 528, 529, 1024):  # before: 4 gated, 4 or 1 ungated
        for gated in (False, True):
            before = 4 if gated or n_blocks <= 4 * 132 else 1
            assert tcuda._whole_block(n_blocks, gated, 132) == SweepGeometry(
                256, before)
    rays = torch.zeros((9, 256))
    pack = torch.zeros((24, 128))
    on = torch.ones(1, dtype=torch.int32)
    for bad in (SweepGeometry(32, 4), SweepGeometry(64, 3), SweepGeometry(64, 4, 0), 32):
        with pytest.raises(ValueError, match="split"):
            sweep_rays_reference(rays, pack, on, 128, want_matrix=True, want_any=False,
                                 split=bad)
    for gated, built in tcuda.BUILT_GEOMETRIES.items():
        assert all(g.segments == 1 for g in built) if gated else all(
            g.rays == 256 for g in built)
        assert SweepGeometry(256, tcuda.GATED_SPLIT) in built if gated else all(
            SweepGeometry(256, s) in built for s in tcuda.UNGATED_SPLITS)


def test_a_gated_sweep_takes_one_segment(street):
    """The kernels cut only an ungated launch's tiles into segments: a gated
    segment after the first would start without the carry its votes need."""
    _, accel, _, rays = street
    gate = tcuda._gate_tables(accel, rays, N_TILES, TILE, window=16)
    with pytest.raises(ValueError, match="segment"):
        tcuda._gate_args(gate, SweepGeometry(64, 8, 2), N_RAYS, rays.device)
    args, parts = tcuda._gate_args(None, SweepGeometry(256, 4, 3), N_RAYS, rays.device)
    assert args[8:11] == (4, 256, 3) and [tuple(t.shape) for t in parts] == [(3, N_RAYS)] * 3


@pytest.mark.parametrize(
    "n_blocks,gated,n_sms,rays,split,segments,per_thread",
    [
        # ungated, up to four blocks an SM: whole blocks at 8 threads a ray
        # and 4 rays a thread (512 threads, one CTA an SM), cut into the 1-4
        # tile segments whose CTAs fill their last wave best (ties: the most)
        (1, False, 132, 256, 8, 4, 4), (32, False, 132, 256, 8, 4, 4),
        (34, False, 132, 256, 8, 3, 4), (66, False, 132, 256, 8, 4, 4),
        (67, False, 132, 256, 8, 3, 4), (128, False, 132, 256, 8, 4, 4),
        (160, False, 132, 256, 8, 4, 4), (192, False, 132, 256, 8, 4, 4),
        (200, False, 132, 256, 8, 3, 4), (300, False, 132, 256, 8, 3, 4),
        (528, False, 132, 256, 8, 4, 4), (16, False, 60, 256, 8, 3, 4),
        (240, False, 60, 256, 8, 4, 4), (2, False, 132, 256, 8, 4, 4),
        (44, False, 132, 256, 8, 3, 4), (99, False, 132, 256, 8, 4, 4),
        (400, False, 132, 256, 8, 4, 4), (28, False, 7, 256, 8, 4, 4),
        # past four blocks an SM: whole blocks at 2 threads a ray, 4 rays a
        # thread, one segment
        (529, False, 132, 256, 2, 1, 4), (1024, False, 132, 256, 2, 1, 4),
        (6144, False, 132, 256, 2, 1, 4), (241, False, 60, 256, 2, 1, 4),
        (29, False, 7, 256, 2, 1, 4),
        # gated: 64 x 16 at 4 rays a thread at every size
        (1, True, 132, 64, 16, 1, 4), (132, True, 132, 64, 16, 1, 4),
        (133, True, 132, 64, 16, 1, 4), (1024, True, 132, 64, 16, 1, 4),
        (100000, True, 60, 64, 16, 1, 4), (7, True, 7, 64, 16, 1, 4),
        # no blocks or no SMs: the whole block at one thread a ray
        (0, False, 132, 256, 1, 1, 1), (0, True, 132, 256, 1, 1, 1),
        (5, False, 0, 256, 1, 1, 1),
    ],
)
def test_the_rule_on_a_table_of_launch_shapes(n_blocks, gated, n_sms, rays, split, segments,
                                              per_thread):
    assert sweep_split(n_blocks, gated, n_sms) == SweepGeometry(rays, split, segments,
                                                                per_thread)


def test_the_rule_returns_built_geometries_only():
    """Every geometry the rule returns is one the kernels are built at; a
    gated launch's CTA is never a whole block."""
    for gated in (False, True):
        for n_sms in (7, 60, 114, 132):
            geos = {sweep_split(n, gated, n_sms) for n in range(1, 12 * n_sms)}
            assert geos <= set(tcuda.BUILT_GEOMETRIES[gated]), (gated, n_sms)
            assert not gated or all(g.rays < 256 for g in geos)
