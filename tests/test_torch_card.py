"""Card tests of the port: the CUDA sweep kernels against their plain
PyTorch versions at shapes the CPU tests cannot reach (ragged ray counts,
narrow and whole-scene tiles, skipped tiles, exact distance ties, per-emitter
tile activity, an all-masked emitter row), kernel #2 against kernel #1 per
emitter, the gated kernels against their plain gated versions and the
ungated kernels (per-tile and two-level gate, ragged ray counts), the count
kernel against its plain version and numpy.bincount, one device key per
card, solves on the card against the CPU and across the two routes, kernel
#1's code_bounds mode against its plain version and the baked kernel, a slim
(pack-resident) solve against the full-mode one, the FMA-peak probe
against its plain version, the gate's crossing kernel against its plain
version, every triangle split the sweep kernels are built at against
the one-thread-a-ray kernel and their plain ``split=`` versions, checkpointed
solves stopped mid-way and resumed on both routes, the command line on
the card against the in-process solve, and sharded chunks, rounds and
solves on a ray mesh (a logical mesh of 4 shards on the card, and every
card) against unsharded ones, the Halton tables built on the card
against the host build, with the packs, flat tables and solves made from
them, kernel #1 in code mode behind the two-level gate with a ragged
last group on a 2M-triangle slim city against its plain version, and the
two measurement scripts: ``bench_torch.run_chunk`` on the card against the
CPU with its launches, ``head_to_head_torch.materialize_rays`` == the rays
the card traced, ``bench_torch.main`` exiting 1 when a stage raises, and
the mask rows kernel of a scheduled round against its plain version on
synthetic cases and on the benchmark's canyon and ten-building city rounds,
the gate's walk counters of gated kernel #1 in code mode and gated
kernel #2 against their plain versions', and the per-emitter driver's slot
streams on a slim city of four emitters against every chunk on one stream.

They need one CUDA card and skip without one. On such a machine:

    python -m pytest --noconftest -m card tests/test_torch_card.py -q

(``--noconftest``: the suite's conftest configures JAX, which these tests
do not use.)
"""
import dataclasses

import numpy as np
import pytest
import torch

import raystrack_tpu_torch
from raystrack_tpu_torch import config as tconfig
from raystrack_tpu_torch.ops.count_cuda import (
    count_bins, count_bins_reference, count_codes, count_codes_reference,
)
from raystrack_tpu_torch.ops.peak_cuda import (
    fma_peak, fma_peak_reference, fma_peak_tolerance,
)
from raystrack_tpu_torch.ops.trace import (
    compute_masks, slim_operands, sort_rays_for_coherence,
)
from raystrack_tpu_torch.prepared import pack_scene
import raystrack_tpu_torch.ops.trace_cuda as tcuda
from raystrack_tpu_torch.ops.trace_cuda import (
    _gate_tables, _gated_tiles_on, _resolve_gate_window, build_tri_pack, gate_cross,
    gate_cross_reference, gate_group_size, scheduled_tiles_on, sweep_rays,
    sweep_rays_reference, sweep_rays_scheduled, sweep_rays_scheduled_reference,
    sweep_tile_width,
)

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _tie_scene():
    """Surfaces in sid order: ``low`` (128 triangles, any-hit only),
    ``emitter`` (128, never eligible: its tile is skipped) and ``dup``: 192
    triangles followed by the same 192 with reversed winding. A ray through
    a ``dup`` triangle hits its reversed copy at exactly the same t with the
    other front flag, so the tie rule decides the code: inside one sweep
    tile the smaller code wins, across tiles the earlier tile."""
    rng = np.random.default_rng(21)

    def cloud(n):
        centers = rng.uniform(-1.0, 1.0, (n, 1, 3))
        V = (centers + rng.normal(scale=0.5, size=(n, 3, 3))).reshape(-1, 3)
        return V.astype(np.float32), np.arange(3 * n, dtype=np.int32).reshape(-1, 3)

    V_low, F_low = cloud(128)
    V_em, F_em = cloud(128)
    V_dup, F_dup = cloud(192)
    F_dup = np.concatenate([F_dup, F_dup[:, [0, 2, 1]]])
    return [("low", V_low, F_low), ("emitter", V_em, F_em), ("dup", V_dup, F_dup)]


def _rays(n, seed, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d, np.cross(o, d)], axis=1).astype(np.float32).T
    return torch.from_numpy(np.ascontiguousarray(rays)).to(device)


@pytest.mark.parametrize("tri_tile", [128, 2048], ids=["tile128", "whole"])
@pytest.mark.parametrize("baked", [True, False], ids=["baked", "rows"])
@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_kernel_equals_plain_version(card, want_matrix, want_any, baked, tri_tile):
    """Bitwise equal (torch.equal) on the same card tensors; one launch per call."""
    sp = raystrack_tpu_torch.PreparedSolver(_tie_scene()).get_scene_pack(device=card)
    scene = (sp.v0, sp.e1, sp.e2, sp.cross_e, sp.w_u, sp.w_v, sp.d0, sp.sid)
    ext = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=card)
    m_any, m_mat = compute_masks(scene, ext, 1, 2)  # emitter 1, matrix from sid 2
    prim = m_any if want_any else m_mat
    pack = build_tri_pack(scene, m_any, m_mat, bake=prim if baked else None)
    tile = sweep_tile_width(sp.n_tri_pad, tri_tile)
    tiles_on = prim.reshape(-1, tile).any(dim=1).to(torch.int32)
    assert int(tiles_on.sum()) < tiles_on.numel() or tile == sp.n_tri_pad
    for n, seed in ((1, 0), (255, 1), (257, 2), (5000, 3)):
        rays = _rays(n, seed, card)
        before = sweep_rays.launches
        codes, any_hit = sweep_rays(rays, pack, prim, tri_tile=tri_tile,
                                    want_matrix=want_matrix, want_any=want_any,
                                    masks_baked=baked)
        torch.cuda.synchronize()
        assert sweep_rays.launches == before + 1
        want_codes, want_any_hit = sweep_rays_reference(
            rays, pack, tiles_on, tile, want_matrix=want_matrix,
            want_any=want_any, masks_baked=baked,
        )
        assert torch.equal(codes, want_codes), n
        assert torch.equal(any_hit, want_any_hit), n
        if n == 5000 and want_matrix:
            hit = codes[codes >= 0]
            assert hit.numel() > 100 and bool(((hit // 2) == 2).all())
        if n == 5000 and want_any:
            assert int(any_hit.sum()) > 100


def test_kernel_rejects_mixed_devices(card):
    rays = _rays(64, 0, card)
    pack = torch.zeros((24, 128), dtype=torch.float32, device=card)
    with pytest.raises(ValueError, match="rays are on"):
        sweep_rays(rays, pack, torch.ones(128, dtype=torch.bool), tri_tile=2048,
                   want_matrix=True, want_any=False)


def test_solve_on_card_matches_cpu(card):
    """Same keys and |dF| <= 1e-4: the card's sin/cos may round ray
    directions an ulp apart from the CPU's, moving a few edge rays. Two
    emitters on the card take the scheduled route (kernel #2); the CPU
    solve takes the per-emitter one."""
    meshes = [("bottom", *_square(0.0, False)), ("top", *_square(1.0, True))]
    kw = dict(samples=32, rays=1024, seed=11, min_iters=8, max_iters=8, reciprocity=False)
    before = sweep_rays_scheduled.launches
    got = raystrack_tpu_torch.view_factor_matrix(
        meshes, raystrack_tpu_torch.MatrixParams(device="gpu", **kw))
    assert sweep_rays_scheduled.launches > before
    want = raystrack_tpu_torch.view_factor_matrix(
        meshes, raystrack_tpu_torch.MatrixParams(device="cpu", **kw))
    assert set(got) == set(want)
    for sender, row in want.items():
        assert set(got[sender]) == set(row)
        for key, value in row.items():
            assert abs(got[sender][key] - value) <= 1e-4, (sender, key)
    assert abs(got["bottom"]["top_front"] - 0.1998249) <= 3e-3


def _square(z, flip):
    V = np.array([[-0.5, -0.5, z], [0.5, -0.5, z], [0.5, 0.5, z], [-0.5, 0.5, z]],
                 np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return V, (F[:, [0, 2, 1]].copy() if flip else F)


def _sched_inputs(card, n_blocks, seed):
    """The tie scene's zero-mask pack, four combined emitter rows (the
    third all zero: a dummy row) and a random emap over them."""
    sp = raystrack_tpu_torch.PreparedSolver(_tie_scene()).get_scene_pack(device=card)
    scene = (sp.v0, sp.e1, sp.e2, sp.cross_e, sp.w_u, sp.w_v, sp.d0, sp.sid)
    zeros = torch.zeros_like(sp.sid, dtype=torch.bool)
    sid = sp.sid.cpu().numpy()
    rows = [
        np.where(sid == 0, 1, np.where(sid == 2, 2, 0)),  # low any-only, dup matrix
        np.where(sid == 0, 2, np.where(sid == 1, 2, 0)),  # dup's tiles all off
        np.zeros_like(sid),
        np.where(sid < 3, 2, 0),
    ]
    masks = torch.from_numpy(np.stack(rows).astype(np.float32)).to(card)
    rng = np.random.default_rng(seed)
    emap = torch.from_numpy(rng.integers(0, 4, n_blocks).astype(np.int32)).to(card)
    rays = _rays(n_blocks * 256, seed, card)
    return scene, build_tri_pack(scene, zeros, zeros), masks, emap, rays


@pytest.mark.parametrize("tri_tile", [128, 2048], ids=["tile128", "whole"])
@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_scheduled_kernel_equals_plain_version(card, want_matrix, want_any, tri_tile):
    """Kernel #2 bitwise equal (torch.equal) to its plain version, with tile
    activity that differs between emitters and an all-zero emitter row;
    one launch per call."""
    _, pack, masks, emap, rays = _sched_inputs(card, 40, 5)
    tile = sweep_tile_width(pack.shape[1], tri_tile)
    tiles_on = scheduled_tiles_on(masks, tile, want_matrix=want_matrix, want_any=want_any)
    if tile < pack.shape[1]:
        assert len({tuple(r) for r in tiles_on.tolist()}) == 4  # ragged activity
    before = sweep_rays_scheduled.launches
    codes, any_hit = sweep_rays_scheduled(rays, pack, masks, emap, tri_tile=tri_tile,
                                          want_matrix=want_matrix, want_any=want_any)
    torch.cuda.synchronize()
    assert sweep_rays_scheduled.launches == before + 1
    want_codes, want_any_hit = sweep_rays_scheduled_reference(
        rays, pack, masks, emap, tiles_on, tile, want_matrix=want_matrix,
        want_any=want_any)
    assert torch.equal(codes, want_codes) and torch.equal(any_hit, want_any_hit)
    dummy = (emap == 2).repeat_interleave(256)
    assert bool((codes[dummy] == -1).all()) and not bool(any_hit[dummy].any())
    if want_matrix:
        assert int((codes >= 0).sum()) > 100
    if want_any:
        assert int(any_hit.sum()) > 100


def test_scheduled_kernel_equals_single_emitter_kernel(card):
    """Per emitter row, kernel #2's codes and flags equal kernel #1's with
    that emitter's masks as pack rows, on the same rays."""
    scene, pack, masks, emap, rays = _sched_inputs(card, 24, 8)
    codes, any_hit = sweep_rays_scheduled(rays, pack, masks, emap, tri_tile=128,
                                          want_matrix=True, want_any=True)
    block_of = emap.repeat_interleave(256)
    for e in range(4):
        sel = block_of == e
        m_any, m_mat = masks[e] > 0, masks[e] > 1
        c1, a1 = sweep_rays(rays[:, sel].contiguous(), build_tri_pack(scene, m_any, m_mat),
                            m_any, tri_tile=128, want_matrix=True, want_any=True)
        assert torch.equal(codes[sel], c1) and torch.equal(any_hit[sel], a1), e


def test_device_key_cuda_equals_indexed(card):
    """"cuda" and "cuda:<current>" name one card: one pack, not two."""
    ps = raystrack_tpu_torch.PreparedSolver(_tie_scene())
    kw = dict(samples=2, rays=16, flip_faces=False)
    assert ps.get_scene_pack(device="cuda") is ps.get_scene_pack(device=card)
    assert ps.get_emitter_pack(0, device="cuda", **kw) is ps.get_emitter_pack(
        0, device=card, **kw)
    assert ps.get_flat_tables(device="cuda", **kw) is ps.get_flat_tables(device=card, **kw)


def test_scheduled_solve_on_card_equals_per_emitter_solve(card, monkeypatch):
    """The two routes on the card: equal dicts (==); the scheduled one
    launches kernel #2 and not kernel #1."""
    meshes = [("bottom", *_square(0.0, False)), ("top", *_square(1.0, True))]
    params = raystrack_tpu_torch.MatrixParams(
        samples=16, rays=256, seed=3, min_iters=3, max_iters=12, tol=1e-3,
        reciprocity=False, device="gpu")
    monkeypatch.setattr(tconfig, "SCHEDULER", "grouped")
    want = raystrack_tpu_torch.view_factor_matrix(meshes, params)
    monkeypatch.setattr(tconfig, "SCHEDULER", "auto")
    before = (sweep_rays.launches, sweep_rays_scheduled.launches)
    got = raystrack_tpu_torch.view_factor_matrix(meshes, params)
    assert sweep_rays.launches == before[0]
    assert sweep_rays_scheduled.launches > before[1]
    assert got == want


@pytest.mark.parametrize("with_valid", [False, True], ids=["n_valid", "valid_flags"])
@pytest.mark.parametrize(
    "rows,length,n_surf",
    [(6, 2048, 11), (4, 65536, 2), (3, 5000, 7000), (2, 262144, 3), (1, 2049, 5),
     (2, 4096, 6145), (3, 0, 4)],
    ids=["canyon_rows", "soup_chunk", "global_bins", "chunk_rows", "two_ctas",
         "global_6145", "empty_rows"],
)
def test_count_kernel_equals_plain_version(card, rows, length, n_surf, with_valid):
    """The count kernel equal (torch.equal) to its plain version and to
    numpy.bincount per row, with misses, out-of-range codes, padded rays
    and rows whose n_valid is 0 or past the row, and with the valid flags of
    a sorted row (rays that count anywhere in it). Rows of 2,048 codes are
    one CTA's, longer rows several CTAs' that meet in the work buffer
    (``two_ctas``: one code past one CTA; ``chunk_rows``: a chunk's 262,144,
    128 CTAs); ``global_bins`` and
    ``global_6145`` have more codes than the kernel's shared bins and count
    in global memory; ``empty_rows`` has no rays, and its counts are zero."""
    rng = np.random.default_rng(rows + n_surf + length)
    codes = rng.integers(-3, 2 * n_surf + 3, size=(rows, length)).astype(np.int32)
    codes[:, : length // 2] = rng.integers(0, 4, size=(rows, length // 2))  # hot bins
    n_valid = rng.integers(0, length + 1, size=rows).astype(np.int32)
    n_valid[0], n_valid[-1] = 0, length + 7
    valid = rng.uniform(size=(rows, length)) < 0.7
    c_t, v_t = torch.from_numpy(codes).to(card), torch.from_numpy(n_valid).to(card)
    f_t = torch.from_numpy(valid).to(card) if with_valid else None
    before = count_bins.launches
    counts_f, counts_b = count_codes(c_t, v_t, n_surf, valid=f_t)
    torch.cuda.synchronize()
    assert count_bins.launches == before + 1
    plain = count_codes_reference(c_t, v_t, n_surf, f_t).view(rows, n_surf, 2)
    assert torch.equal(counts_f, plain[:, :, 1]) and torch.equal(counts_b, plain[:, :, 0])
    for r in range(rows):
        keep = np.arange(length) < n_valid[r]
        if with_valid:
            keep &= valid[r]
        row = codes[r][keep]
        want = np.bincount(row[(row >= 0) & (row < 2 * n_surf)],
                           minlength=2 * n_surf).reshape(n_surf, 2)
        np.testing.assert_array_equal(counts_b[r].cpu().numpy(), want[:, 0])
        np.testing.assert_array_equal(counts_f[r].cpu().numpy(), want[:, 1])
    if with_valid:  # the sorted rows' route: flags alone, every ray of a row in play
        counts_f, counts_b = count_codes(c_t, None, n_surf, valid=f_t)
        plain = count_codes_reference(c_t, None, n_surf, f_t).view(rows, n_surf, 2)
        assert torch.equal(counts_f, plain[:, :, 1]) and torch.equal(counts_b, plain[:, :, 0])


@pytest.mark.parametrize("rows,length,n_surf", [(128, 2048, 11), (4, 65536, 2), (2, 0, 3)],
                         ids=["round", "long_rows", "empty_rows"])
def test_count_kernel_writes_every_count(card, rows, length, n_surf):
    """With at most the shared bins' codes the kernel writes every count,
    zeros included, in one launch: the C entry on a buffer filled with -7
    leaves the plain version's counts, three times over, and leaves its work
    buffer (rows longer than one CTA's) zero, as it found it."""
    from raystrack_tpu_torch.ops.build import load_library

    rng = np.random.default_rng(rows)
    codes = torch.from_numpy(rng.integers(-1, 2 * n_surf, size=(rows, length)).astype(
        np.int32)).to(card)
    lib = load_library()
    assert 2 * n_surf <= lib.raystrack_count_smem_bins()
    work = torch.zeros(rows * (2 * n_surf + 1), dtype=torch.int32, device=card)
    needs_work = length > lib.raystrack_count_per_cta()
    for _ in range(3):
        out = torch.full((rows, 2 * n_surf), -7, dtype=torch.int32, device=card)
        err = lib.raystrack_count_codes(codes.data_ptr(), None, None, rows, length, 2 * n_surf,
                                        out.data_ptr(), work.data_ptr() if needs_work else None,
                                        torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        assert torch.equal(out, count_codes_reference(codes, None, n_surf))
        assert not bool(work.any())
    if needs_work:  # a long row refuses to run without its work buffer
        assert lib.raystrack_count_codes(codes.data_ptr(), None, None, rows, length,
                                         2 * n_surf, out.data_ptr(), None,
                                         torch.cuda.current_stream().cuda_stream) != 0


def _street_scene(n_tri=1100, seed=0, hx=32.0, hy=1.0, top=1.6):
    """tests/test_torch_gate.py's street: a 64 m canyon of roof and wall
    quads filled with random triangles, over a 64 x 0.2 m emitter strip."""
    V = np.array([[-hx, 0.1, 0], [hx, 0.1, 0], [hx, 0.3, 0], [-hx, 0.3, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-hx, -hy, 0.2], [hx, hy, top - 0.1], size=(n_tri, 3))
    spans = rng.normal(scale=0.3, size=(n_tri, 2, 3))
    tris = [np.concatenate([centers, centers + spans[:, 0], centers + spans[:, 1]], axis=1)]
    for x in np.arange(-hx, hx):
        for a, b, c, d in (
            ([x, -hy, top], [x, hy, top], [x + 1, hy, top], [x + 1, -hy, top]),
            ([x, -hy, 0], [x + 1, -hy, 0], [x + 1, -hy, top], [x, -hy, top]),
            ([x, hy, 0], [x, hy, top], [x + 1, hy, top], [x + 1, hy, 0]),
        ):
            tris += [np.array([a + b + c]), np.array([a + c + d])]
    Vc = np.concatenate(tris).reshape(-1, 3).astype(np.float32)
    return [("emitter", V, F),
            ("cloud", Vc, np.arange(Vc.shape[0], dtype=np.int32).reshape(-1, 3))]


@pytest.fixture(scope="module")
def street():
    """The street's accel pack on the card, emitter 0's masks and 6,000
    coherence-sorted rays from its strip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    sp = raystrack_tpu_torch.PreparedSolver(_street_scene()).get_scene_pack(
        use_accel=True, device=dev)
    scene = (sp.v0, sp.e1, sp.e2, sp.cross_e, sp.w_u, sp.w_v, sp.d0, sp.sid)
    masks = compute_masks(scene, torch.tensor([0, 1, 0], dtype=torch.int32, device=dev), 0, 1)
    rng = np.random.default_rng(3)
    n = 6000
    o = np.stack([rng.uniform(-32, 32, n), rng.uniform(0.1, 0.3, n), np.full(n, 1e-4)], 1)
    r1, r2 = rng.uniform(size=n), rng.uniform(size=n)
    d = np.stack([np.sqrt(1 - r1) * np.cos(2 * np.pi * r2),
                  np.sqrt(1 - r1) * np.sin(2 * np.pi * r2), np.sqrt(r1)], 1)
    o, d = (torch.from_numpy(a.astype(np.float32)).to(dev)[None] for a in (o, d))
    o, d, _ = sort_rays_for_coherence(o, d, torch.ones(o.shape[:2], dtype=torch.bool,
                                                       device=dev),
                                      scene_lo=sp.tile_lo.amin(0), scene_hi=sp.tile_hi.amax(0))
    o, d = o[0], d[0]
    rays = torch.cat([o, d, torch.linalg.cross(o, d)], dim=1).T.contiguous()
    return sp, scene, masks, rays


def _gated_plain(rays, pack, tiles_on, tile, accel, visits, **kw):
    """The plain gated sweep on the card with the wrapper's own tables."""
    n_tiles = pack.shape[1] // tile
    gate = _gate_tables(accel, rays, n_tiles, tile,
                        window=_resolve_gate_window(gate_group_size(n_tiles)))
    return sweep_rays_reference(rays, pack, _gated_tiles_on(tiles_on, gate), tile, gate=gate,
                                visits=visits, **kw)


@pytest.mark.parametrize("max_tiles,tri_tile", [(8192, 128), (2, 512)],
                         ids=["per_tile", "two_level"])
@pytest.mark.parametrize("baked", [True, False], ids=["baked", "rows"])
@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_gated_kernel_equals_plain_and_ungated(street, monkeypatch, want_matrix, want_any,
                                               baked, max_tiles, tri_tile):
    """Gated kernel #1 == its plain gated version (codes, flags and each
    block's visits) == the ungated kernel, at ray counts that are and are
    not multiples of 256; one gated launch per call."""
    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", max_tiles)
    sp, scene, (m_any, m_mat), rays_all = street
    prim = m_any if want_any else m_mat
    pack = build_tri_pack(scene, m_any, m_mat, bake=prim if baked else None)
    tile = sweep_tile_width(sp.n_tri_pad, tri_tile)
    tiles_on = prim.reshape(-1, tile).any(dim=1).to(torch.int32)
    kw = dict(want_matrix=want_matrix, want_any=want_any, masks_baked=baked)
    for n in (1, 257, 5 * 256, 6000):
        rays = rays_all[:, :n].contiguous()
        nb = -(-n // 256)
        visits = torch.full((nb,), -1, dtype=torch.int32, device=rays.device)
        before = sweep_rays.gated_launches
        codes, any_hit = sweep_rays(rays, pack, prim, tri_tile=tri_tile, accel=sp.accel,
                                    visits=visits, **kw)
        torch.cuda.synchronize()
        assert sweep_rays.gated_launches == before + 1
        plain_visits = torch.full_like(visits, -2)
        want = _gated_plain(rays, pack, tiles_on, tile, sp.accel, plain_visits, **kw)
        assert torch.equal(codes, want[0]) and torch.equal(any_hit, want[1]), n
        assert torch.equal(visits, plain_visits), n
        ungated = sweep_rays(rays, pack, prim, tri_tile=tri_tile, **kw)
        assert torch.equal(codes, ungated[0]) and torch.equal(any_hit, ungated[1]), n
    if max_tiles == 8192:
        assert int(visits.sum()) < nb * int(tiles_on.sum())  # the gate skipped tiles


@pytest.mark.parametrize("max_tiles,tri_tile", [(8192, 128), (2, 512)],
                         ids=["per_tile", "two_level"])
@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_gated_scheduled_kernel_equals_plain_and_ungated(street, monkeypatch, want_matrix,
                                                         want_any, max_tiles, tri_tile):
    """Gated kernel #2 == its plain gated version (with visits) == the
    ungated kernel, with an all-zero emitter row and a row past E."""
    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", max_tiles)
    sp, scene, (m_any, m_mat), rays_all = street
    rays = rays_all[:, : 20 * 256].contiguous()
    dev = rays.device
    masks = torch.stack([m_mat.float() * 2, m_any.float() + m_mat.float(),
                         torch.zeros_like(m_any, dtype=torch.float32)])
    emap = torch.from_numpy(
        np.random.default_rng(5).integers(0, 4, 20).astype(np.int32)).to(dev)
    zeros = torch.zeros_like(m_any)
    pack = build_tri_pack(scene, zeros, zeros)
    kw = dict(tri_tile=tri_tile, want_matrix=want_matrix, want_any=want_any)
    visits = torch.full((20,), -1, dtype=torch.int32, device=dev)
    before = sweep_rays_scheduled.gated_launches
    codes, any_hit = sweep_rays_scheduled(rays, pack, masks, emap, accel=sp.accel,
                                          visits=visits, **kw)
    torch.cuda.synchronize()
    assert sweep_rays_scheduled.gated_launches == before + 1
    tile = sweep_tile_width(sp.n_tri_pad, tri_tile)
    n_tiles = sp.n_tri_pad // tile
    gate = _gate_tables(sp.accel, rays, n_tiles, tile,
                        window=_resolve_gate_window(gate_group_size(n_tiles)))
    tiles_on = _gated_tiles_on(
        scheduled_tiles_on(masks, tile, want_matrix=want_matrix, want_any=want_any), gate)
    plain_visits = torch.full_like(visits, -2)
    want = sweep_rays_scheduled_reference(rays, pack, masks, emap, tiles_on, tile,
                                          want_matrix=want_matrix, want_any=want_any,
                                          gate=gate, visits=plain_visits)
    assert torch.equal(codes, want[0]) and torch.equal(any_hit, want[1])
    assert torch.equal(visits, plain_visits)
    ungated = sweep_rays_scheduled(rays, pack, masks, emap, **kw)
    assert torch.equal(codes, ungated[0]) and torch.equal(any_hit, ungated[1])
    idle = emap >= 2
    assert not bool(visits[idle].any()) and bool((codes.view(20, 256)[idle] == -1).all())


def test_gated_solves_on_card_equal_ungated(card, monkeypatch):
    """bvh="builtin" == bvh="off" on the card, both routes, on the street
    (12 sweep tiles of 128); the gated kernels ran."""
    import raystrack_tpu_torch.ops.trace as ttrace

    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 128)
    meshes = _street_scene(seed=2)
    kw = dict(samples=2, rays=8, seed=4, device="gpu", max_iters=3, min_iters=2, tol=1e-3,
              reciprocity=False)
    for route in ("grouped", "scheduled"):
        monkeypatch.setattr(tconfig, "SCHEDULER", route)
        before = sweep_rays.gated_launches + sweep_rays_scheduled.gated_launches
        on = raystrack_tpu_torch.view_factor_matrix(
            meshes, raystrack_tpu_torch.MatrixParams(bvh="builtin", **kw))
        assert sweep_rays.gated_launches + sweep_rays_scheduled.gated_launches > before
        off = raystrack_tpu_torch.view_factor_matrix(
            meshes, raystrack_tpu_torch.MatrixParams(bvh="off", **kw))
        assert on == off, route


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("kernel", ["kernel1", "kernel2"])
def test_work_counters_equal_the_visits_of_the_same_launches(street, kernel, gated):
    """While a profiler records, kernels #1 and #2 add their tiles swept and
    pairs tested to the device's counters: equal to the per-CTA visits of
    the same launches (a CTA's pairs: its tiles times the tile times its
    rays below N); with no profiler the counters do not move."""
    from torch.profiler import ProfilerActivity, profile

    from raystrack_tpu_torch import tracing

    sp, scene, (m_any, m_mat), rays_all = street
    dev = rays_all.device
    tile = sweep_tile_width(sp.n_tri_pad, 128)
    accel = sp.accel if gated else None
    for n in ((257, 6000) if kernel == "kernel1" else (20 * 256,)):
        rays = rays_all[:, :n].contiguous()
        geo = tcuda._launch_geometry(n, gated, dev)
        visits = torch.full((geo.units(n),), -1, dtype=torch.int32, device=dev)
        if kernel == "kernel1":
            pack = build_tri_pack(scene, m_any, m_mat, bake=m_mat)
            launch = lambda: sweep_rays(  # noqa: E731, B023
                rays, pack, m_mat, tri_tile=128, want_matrix=True, want_any=False,
                masks_baked=True, accel=accel, visits=visits)
        else:
            masks = torch.stack([m_mat.float() * 2, m_any.float() + m_mat.float()])
            emap = torch.from_numpy(
                np.random.default_rng(5).integers(0, 3, n // 256).astype(np.int32)).to(dev)
            zeros = torch.zeros_like(m_any)
            pack = build_tri_pack(scene, zeros, zeros)
            launch = lambda: sweep_rays_scheduled(  # noqa: E731, B023
                rays, pack, masks, emap, tri_tile=128, want_matrix=True, want_any=True,
                accel=accel, visits=visits)
        before = tracing.counts()
        launch()
        assert tracing.since(before)["pairs_tested"] == 0
        before = tracing.counts()
        with profile(activities=[ProfilerActivity.CPU]):
            launch()
        moved = tracing.since(before)
        held = (n - torch.arange(geo.units(n)) // geo.segments * geo.rays).clamp(max=geo.rays)
        units = visits.long().cpu()
        assert moved["tiles_swept"] == int(units.sum()) > 0, n
        assert moved["pairs_tested"] == int((units * held).sum()) * tile, n
        assert moved["rays_padded"] == n
        assert moved["tiles_offered"] == -(-n // geo.rays) * (sp.n_tri_pad // tile)


@pytest.mark.parametrize("max_tiles,tri_tile", [(8192, 128), (2, 512)],
                         ids=["per_tile", "two_level"])
@pytest.mark.parametrize("kernel", ["kernel1_code", "kernel2"])
def test_gate_walk_counters_equal_the_plain_walk(street, monkeypatch, kernel, max_tiles,
                                                 tri_tile):
    """While a profiler records, gated kernel #1 in code mode (on the
    street's slim pack) and gated kernel #2 add the boxes their CTAs listed
    and walked: equal, with the tiles swept and pairs tested, to what their
    plain versions count on the same card tensors at the launch's
    geometry; with no profiler nothing moves."""
    from torch.profiler import ProfilerActivity, profile

    from raystrack_tpu_torch import tracing

    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", max_tiles)
    sp, scene, (m_any, m_mat), rays_all = street
    dev = rays_all.device
    tile = sweep_tile_width(sp.n_tri_pad, tri_tile)
    n_tiles = sp.n_tri_pad // tile
    keys = ("tiles_swept", "pairs_tested", "boxes_listed", "boxes_walked")
    n = 6000 if kernel == "kernel1_code" else 20 * 256
    rays = rays_all[:, :n].contiguous()
    gate = _gate_tables(sp.accel, rays, n_tiles, tile,
                        window=_resolve_gate_window(gate_group_size(n_tiles)))
    assert gate.group == (1 if max_tiles == 8192 else 2)
    geo = tcuda._launch_geometry(n, True, dev)
    kw = dict(want_matrix=True, want_any=kernel == "kernel2")
    if kernel == "kernel1_code":
        meshes = _street_scene()
        slim = pack_scene(raystrack_tpu_torch.PreparedSolver(meshes).get_scene(use_accel=True),
                          len(meshes), device=dev, slim=True)
        mask, bounds = slim_operands(slim.sid, torch.tensor([0, 1, 0], dtype=torch.int32,
                                                            device=dev), 0, 1, want_any=False)
        launch = lambda: sweep_rays(  # noqa: E731
            rays, slim.tri_pack, mask, tri_tile=tri_tile, accel=sp.accel, code_bounds=bounds,
            **kw)
        tiles_on = mask.reshape(-1, tile).any(dim=1).to(torch.int32)
        plain = lambda: sweep_rays_reference(  # noqa: E731
            rays, slim.tri_pack, _gated_tiles_on(tiles_on, gate), tile, gate=gate,
            code_bounds=bounds, split=geo, **kw)
    else:
        masks = torch.stack([m_mat.float() * 2, m_any.float() + m_mat.float()])
        emap = torch.from_numpy(
            np.random.default_rng(5).integers(0, 3, n // 256).astype(np.int32)).to(dev)
        pack = build_tri_pack(scene, torch.zeros_like(m_any), torch.zeros_like(m_any))
        launch = lambda: sweep_rays_scheduled(  # noqa: E731
            rays, pack, masks, emap, tri_tile=tri_tile, accel=sp.accel, **kw)
        tiles_on = _gated_tiles_on(scheduled_tiles_on(masks, tile, **kw), gate)
        plain = lambda: sweep_rays_scheduled_reference(  # noqa: E731
            rays, pack, masks, emap, tiles_on, tile, gate=gate, split=geo, **kw)
    moved = {}
    for name, fn in (("card", launch), ("plain", plain)):
        before = tracing.counts()
        fn()
        assert all(tracing.since(before)[k] == 0 for k in keys), name
        before = tracing.counts()
        with profile(activities=[ProfilerActivity.CPU]):
            fn()
        moved[name] = {k: tracing.since(before)[k] for k in keys}
    assert moved["card"] == moved["plain"]
    assert moved["card"]["boxes_listed"] >= moved["card"]["boxes_walked"] > 0
    if gate.group > 1:
        assert moved["card"]["boxes_walked"] == moved["card"]["boxes_listed"]


def test_traced_solve_leaves_no_span_on_the_device(card, monkeypatch):
    """A solve under a profiler of the host and the card, on both routes:
    the host holds the program's spans, no device event is named after one
    (the spans are host cpu_ops, with no device shadow), the sweeps' work
    is counted, and the dicts equal the untraced solve's."""
    import raystrack_tpu_torch.ops.trace as ttrace
    from torch.profiler import ProfilerActivity, profile

    from raystrack_tpu_torch import tracing

    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 128)
    meshes = _street_scene(seed=2)
    params = raystrack_tpu_torch.MatrixParams(samples=2, rays=8, seed=4, device="gpu",
                                              max_iters=3, min_iters=2, tol=1e-3)
    cuda = torch.autograd.DeviceType.CUDA
    for route in ("grouped", "scheduled"):
        monkeypatch.setattr(tconfig, "SCHEDULER", route)
        plain = raystrack_tpu_torch.view_factor_matrix(meshes, params)
        before = tracing.counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = raystrack_tpu_torch.view_factor_matrix(meshes, params)
            torch.cuda.synchronize()
        moved = tracing.since(before)
        events = list(prof.profiler.kineto_results.events())
        host = {ev.name() for ev in events if ev.device_type() != cuda}
        device = [ev.name() for ev in events if ev.device_type() == cuda]
        assert traced == plain, route
        assert {"raystrack.solve.matrix", "raystrack.ops.sweep", "raystrack.ops.gate"} <= host
        assert device and not [n for n in device if n.startswith("raystrack.")], route
        assert moved["pairs_tested"] > 0 and moved["tiles_swept"] > 0, route


@pytest.mark.parametrize("max_tiles,tri_tile", [(8192, 128), (2, 512)],
                         ids=["per_tile", "two_level"])
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_code_mode_kernel_equals_plain_and_baked(street, monkeypatch, want_matrix, want_any,
                                                 gated, max_tiles, tri_tile):
    """Kernel #1 in code mode on the street's slim pack == its plain version
    (codes, flags, visits) == the baked kernel on the full-mode pack, at ray
    counts that are and are not multiples of 256; one code-mode launch per
    call, gated when the boxes are given."""
    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", max_tiles)
    sp, scene, (m_any, m_mat), rays_all = street
    dev = rays_all.device
    meshes = _street_scene()
    slim = pack_scene(raystrack_tpu_torch.PreparedSolver(meshes).get_scene(use_accel=True),
                      len(meshes), device=dev, slim=True)
    assert slim.slim and slim.v0 is None
    assert torch.equal(slim.tri_pack, build_tri_pack(scene, torch.zeros_like(m_any),
                                                     torch.zeros_like(m_any)))
    ext = torch.tensor([0, 1, 0], dtype=torch.int32, device=dev)
    mask, bounds = slim_operands(slim.sid, ext, 0, 1, want_any=want_any)
    prim = m_any if want_any else m_mat
    assert torch.equal(mask, prim) and bounds == (0.0, 2.0)
    baked = build_tri_pack(scene, m_any, m_mat, bake=prim)
    tile = sweep_tile_width(sp.n_tri_pad, tri_tile)
    tiles_on = prim.reshape(-1, tile).any(dim=1).to(torch.int32)
    accel = sp.accel if gated else None
    kw = dict(want_matrix=want_matrix, want_any=want_any)
    for n in (1, 257, 6000):
        rays = rays_all[:, :n].contiguous()
        nb = -(-n // 256)
        visits = torch.full((nb,), -1, dtype=torch.int32, device=dev)
        before = (sweep_rays.launches, sweep_rays.code_launches, sweep_rays.gated_launches)
        codes, any_hit = sweep_rays(rays, slim.tri_pack, mask, tri_tile=tri_tile, accel=accel,
                                    code_bounds=bounds, visits=visits, **kw)
        torch.cuda.synchronize()
        assert (sweep_rays.launches, sweep_rays.code_launches, sweep_rays.gated_launches) == (
            before[0] + 1, before[1] + 1, before[2] + gated)
        plain_visits = torch.full_like(visits, -2)
        if gated:
            want = _gated_plain(rays, slim.tri_pack, tiles_on, tile, sp.accel, plain_visits,
                                code_bounds=bounds, **kw)
        else:
            want = sweep_rays_reference(rays, slim.tri_pack, tiles_on, tile,
                                        code_bounds=bounds, visits=plain_visits, **kw)
        assert torch.equal(codes, want[0]) and torch.equal(any_hit, want[1]), n
        assert torch.equal(visits, plain_visits), n
        full = sweep_rays(rays, baked, prim, tri_tile=tri_tile, accel=accel, masks_baked=True,
                          **kw)
        assert torch.equal(codes, full[0]) and torch.equal(any_hit, full[1]), n
    if want_matrix:
        assert int((codes >= 0).sum()) > 1000
    if want_any:
        assert int(any_hit.sum()) > 1000


def test_code_mode_kernel_takes_its_two_codes(card):
    """The two float arguments reach the kernel: on the tie scene's pack
    each (emit, min) pair gives what the same pack's mask rows give."""
    meshes = _tie_scene()
    ps = raystrack_tpu_torch.PreparedSolver(meshes)
    full = ps.get_scene_pack(device=card)
    scene = (full.v0, full.e1, full.e2, full.cross_e, full.w_u, full.w_v, full.d0, full.sid)
    slim = pack_scene(ps.get_scene(), len(meshes), device=card, slim=True)
    rays = _rays(5000, 4, card)
    on = torch.ones_like(full.sid, dtype=torch.bool)
    kw = dict(tri_tile=128, want_matrix=True, want_any=True)
    seen = set()
    for emit_sid, min_sid in ((1, 2), (1, 0), (0, 1), (2, 0)):
        m_any = (full.sid != emit_sid) & (full.sid < 3)
        m_mat = m_any & (full.sid >= min_sid)
        want = sweep_rays(rays, build_tri_pack(scene, m_any, m_mat), on, **kw)
        got = sweep_rays(rays, slim.tri_pack, on, code_bounds=(2.0 * emit_sid, 2.0 * min_sid),
                         **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (emit_sid, min_sid)
        seen.add(tuple((got[0][got[0] >= 0] // 2).unique().tolist()))
    assert len(seen) == 4  # every pair of codes selects other surfaces
    with pytest.raises(ValueError, match="mutually exclusive"):
        sweep_rays(rays, slim.tri_pack, on, masks_baked=True, code_bounds=(0.0, 0.0), **kw)


@pytest.mark.parametrize("bvh", ["off", "builtin"])
def test_slim_solve_on_card_equals_full_solve(card, monkeypatch, bvh):
    """A slim solve on the card: the full-mode dict (==), per-emitter
    code-mode launches only (gated with the boxes), no scheduled round."""
    import raystrack_tpu_torch.ops.trace as ttrace

    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 128)
    meshes = _street_scene(seed=2)
    params = raystrack_tpu_torch.MatrixParams(
        samples=2, rays=8, seed=4, device="gpu", max_iters=3, min_iters=2, tol=1e-3,
        reciprocity=False, bvh=bvh)
    want = raystrack_tpu_torch.view_factor_matrix(meshes, params)
    monkeypatch.setattr(tconfig, "SLIM_PACK_MIN_TRIS", 1)
    ps = raystrack_tpu_torch.PreparedSolver(meshes)
    before = (sweep_rays.launches, sweep_rays.code_launches, sweep_rays.gated_launches,
              sweep_rays_scheduled.launches)
    got = raystrack_tpu_torch.view_factor_matrix(meshes, params, prepared=ps)
    assert ps.get_scene_pack(use_accel=bvh == "builtin", device=card).slim
    assert got == want and sum(len(row) for row in got.values()) >= 2
    n = sweep_rays.launches - before[0]
    assert n > 0 and sweep_rays.code_launches - before[1] == n
    assert sweep_rays.gated_launches - before[2] == (n if bvh == "builtin" else 0)
    assert sweep_rays_scheduled.launches == before[3]


def test_fma_peak_kernel_against_plain_version(card):
    """Every repeat of the probe within twice ``fma_peak_tolerance`` of the
    plain version (an FFMA rounds once, ``a * c + d`` twice) and within the
    tolerance of the float64 recurrence; all repeats bitwise the same."""
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((32, 128)).astype(np.float32)).to(card)
    c, d = 0.999999881, 0.25
    before = fma_peak.launches
    out = fma_peak(x, c, d, repeats=64)
    torch.cuda.synchronize()
    assert fma_peak.launches == before + 1 and out.shape == (64, 32, 128)
    tol = fma_peak_tolerance(x, c, d)
    plain = fma_peak_reference(x, c, d, 64)
    assert float((out - plain).abs().max()) <= 2 * tol
    exact = fma_peak_reference(x.double(), c, d, 64)
    assert float((out.double() - exact).abs().max()) <= tol
    assert bool((out == out[0]).all())
    assert fma_peak(x, c, d, repeats=0).shape == (0, 32, 128)
    assert fma_peak.launches == before + 1


@pytest.mark.parametrize(
    "n,n_boxes,ray_block,kind",
    [(6000, 12, 256, "street"), (700, 300, 37, "street"), (5 * 256, 1, 256, "street"),
     (3000, 600, 1024, "street"), (3000, 600, 2500, "street"), (6000, 489, 256, "octants"),
     (4096, 513, 256, "octants"), (2 * 256, 4883, 256, "octants"),
     (3000, 700, 256, "nan_inf"), (900, 100, 300, "nan_inf")],
    ids=["street", "ragged_small_blocks", "one_box", "wide_blocks", "staged_in_parts",
         "octants_489", "octants_513", "octants_4883", "nan_inf", "nan_inf_small"],
)
def test_gate_cross_kernel_equals_plain_version(street, n, n_boxes, ray_block, kind):
    """The crossing kernel == gate_cross_reference (torch.equal of crossed
    and minnear): a ragged last block, blocks narrower and wider than the
    256 threads and than the 1,024 rays staged at once, one box, box counts
    that are no multiple of a slice (K * 256 at K = 1, 2, 4 boxes a thread,
    the 10M city's 4,883 boxes), rays of every octant mixed with zero
    direction components, origins inside boxes, and in ``nan_inf`` NaN and
    infinite origins, infinite or huge directions and unbounded boxes; one
    launch."""
    _, _, _, rays_all = street
    dev = rays_all.device
    rays = rays_all[:, np.arange(n) % rays_all.shape[1]].clone()
    rng = np.random.default_rng(n_boxes + n)
    if kind != "street":  # direction signs drawn per ray and component
        sign = torch.from_numpy(np.where(rng.uniform(size=(3, n)) < 0.5, -1.0, 1.0)).to(dev)
        rays[3:6] *= sign.to(torch.float32)
    rays[3, ::5] = 0.0  # axis-parallel rays: the zero-direction group
    rays[4, ::7] = -0.0
    lo = np.stack([rng.uniform(-32, 30, n_boxes), rng.uniform(-1, 0.5, n_boxes),
                   rng.uniform(-0.2, 1.2, n_boxes)], 1)
    hi = lo + rng.uniform(0.05, 8.0, (n_boxes, 3))
    if kind == "nan_inf":
        for k, value in enumerate((float("nan"), float("inf"), float("-inf"))):
            rays[k % 3, k::13] = value
            rays[0:3, k + 6::41] = value
        rays[3, 4::37] = float("inf")
        rays[5, 5::43] = 3e38
        lo[::17, 0], hi[::19, 2] = -np.inf, np.inf
    rays = rays.contiguous()
    boxes = torch.from_numpy(np.concatenate([lo, hi], 1).astype(np.float32)).to(dev)
    before = gate_cross.launches
    crossed, minnear = gate_cross(rays, boxes, ray_block)
    torch.cuda.synchronize()
    assert gate_cross.launches == before + 1
    want_crossed, want_minnear = gate_cross_reference(rays, boxes, ray_block)
    assert crossed.dtype == torch.bool and crossed.shape == (-(-n // ray_block), n_boxes)
    assert torch.equal(crossed, want_crossed)
    assert torch.equal(minnear, want_minnear)
    assert bool(crossed.any())
    if n_boxes > 1:
        assert not bool(crossed.all())


@pytest.mark.parametrize("max_tiles,tri_tile", [(8192, 128), (2, 512)],
                         ids=["per_tile", "two_level"])
def test_gate_tables_through_the_kernel_equal_the_plain_tables(street, monkeypatch,
                                                               max_tiles, tri_tile):
    """Every field of the GateTables built through the crossing kernel ==
    those built through the plain crossing, with one box per tile and with
    groups."""
    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", max_tiles)
    sp, _, _, rays_all = street
    rays = rays_all[:, :5000].contiguous()
    tile = sweep_tile_width(sp.n_tri_pad, tri_tile)
    n_tiles = sp.n_tri_pad // tile
    window = _resolve_gate_window(gate_group_size(n_tiles))
    got = _gate_tables(sp.accel, rays, n_tiles, tile, window=window)
    monkeypatch.setattr(tcuda, "gate_cross", gate_cross_reference)
    want = _gate_tables(sp.accel, rays, n_tiles, tile, window=window)
    for name in ("boxes", "order", "counts", "suffmin"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.group, got.window) == (want.group, want.window)


def _force(monkeypatch, split):
    """Launch at ``split`` threads a ray, whatever the launch's shape."""
    monkeypatch.setattr(tcuda, "sweep_split", lambda n_blocks, gated, n_sms: split)


@pytest.mark.parametrize("max_tiles,tri_tile", [(8192, 128), (2, 512)],
                         ids=["per_tile", "two_level"])
@pytest.mark.parametrize("mode", ["rows", "baked", "code"])
@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_every_split_of_kernel_1_equals_one_thread_a_ray(street, monkeypatch, want_matrix,
                                                         want_any, mode, max_tiles, tri_tile):
    """Kernel #1 at every split it is built at == one thread a ray (codes,
    flags, visits), in the three mask modes, at a ray count that is no
    multiple of 256: ungated, the kernel at 4 against the kernel at 1 and its
    plain ``split=4`` version; gated (built at 4 only), the kernel against
    its plain version at ``split=4`` and at ``split=1``."""
    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", max_tiles)
    sp, scene, (m_any, m_mat), rays_all = street
    dev = rays_all.device
    prim = m_any if want_any else m_mat
    if mode == "code":
        zeros = torch.zeros_like(m_any)
        pack = build_tri_pack(scene, zeros, zeros)
        mask_kw = dict(code_bounds=(0.0, 2.0))
    else:
        pack = build_tri_pack(scene, m_any, m_mat, bake=prim if mode == "baked" else None)
        mask_kw = dict(masks_baked=mode == "baked")
    tile = sweep_tile_width(sp.n_tri_pad, tri_tile)
    tiles_on = prim.reshape(-1, tile).any(dim=1).to(torch.int32)
    rays = rays_all[:, :5900].contiguous()
    nb = -(-5900 // 256)
    kw = dict(want_matrix=want_matrix, want_any=want_any, **mask_kw)

    def kernel(accel, split, fill):
        with monkeypatch.context() as m:
            _force(m, split)
            v = torch.full((nb,), fill, dtype=torch.int32, device=dev)
            before = sweep_rays.launches
            out = sweep_rays(rays, pack, prim, tri_tile=tri_tile, accel=accel, visits=v, **kw)
            torch.cuda.synchronize()
            assert sweep_rays.launches == before + 1
        return (*out, v)

    assert tcuda.UNGATED_SPLITS == (1, 4) and tcuda.GATED_SPLIT == 4
    want = kernel(None, 1, -1)
    got = kernel(None, 4, -2)
    vp = torch.full((nb,), -3, dtype=torch.int32, device=dev)
    plain = sweep_rays_reference(rays, pack, tiles_on, tile, visits=vp, split=4, **kw)
    for a, b, c in zip(got, want, (*plain, vp)):
        assert torch.equal(a, b) and torch.equal(a, c)
    got = kernel(sp.accel, 4, -2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])  # gated == ungated
    for split in (1, 4):
        vp = torch.full((nb,), -3, dtype=torch.int32, device=dev)
        plain = _gated_plain(rays, pack, tiles_on, tile, sp.accel, vp, split=split, **kw)
        for a, b in zip(got, (*plain, vp)):
            assert torch.equal(a, b), split
    if want_matrix:
        assert int((want[0] >= 0).sum()) > 1000


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_every_split_of_kernel_2_equals_one_thread_a_ray(street, monkeypatch, want_matrix,
                                                         want_any, gated):
    """Kernel #2 at every split it is built at (1 and 4 ungated, 4 gated) ==
    its plain version at ``split=1`` and at its own split (codes, flags,
    visits), with an all-zero emitter row and a row past E."""
    sp, scene, (m_any, m_mat), rays_all = street
    rays = rays_all[:, : 20 * 256].contiguous()
    dev = rays.device
    masks = torch.stack([m_mat.float() * 2, m_any.float() + m_mat.float(),
                         torch.zeros_like(m_any, dtype=torch.float32)])
    emap = torch.from_numpy(
        np.random.default_rng(6).integers(0, 4, 20).astype(np.int32)).to(dev)
    zeros = torch.zeros_like(m_any)
    pack = build_tri_pack(scene, zeros, zeros)
    kw = dict(tri_tile=128, want_matrix=want_matrix, want_any=want_any)
    accel = sp.accel if gated else None
    tile = sweep_tile_width(sp.n_tri_pad, 128)
    n_tiles = sp.n_tri_pad // tile
    gate = _gate_tables(sp.accel, rays, n_tiles, tile,
                        window=_resolve_gate_window(gate_group_size(n_tiles))) if gated else None
    tiles_on = _gated_tiles_on(
        scheduled_tiles_on(masks, tile, want_matrix=want_matrix, want_any=want_any), gate)
    for split in (tcuda.GATED_SPLIT,) if gated else tcuda.UNGATED_SPLITS:
        with monkeypatch.context() as m:
            _force(m, split)
            v = torch.full((20,), -2, dtype=torch.int32, device=dev)
            got = sweep_rays_scheduled(rays, pack, masks, emap, accel=accel, visits=v, **kw)
            torch.cuda.synchronize()
        for plain_split in {1, split}:
            vp = torch.full((20,), -3, dtype=torch.int32, device=dev)
            plain = sweep_rays_scheduled_reference(
                rays, pack, masks, emap, tiles_on, tile, want_matrix=want_matrix,
                want_any=want_any, gate=gate, visits=vp, split=plain_split)
            assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]), split
            assert torch.equal(v, vp), split


def test_sweep_entries_take_the_split_and_the_timeline(street, monkeypatch):
    """The C entries' new arguments reach the kernels: a gated launch fills
    the timeline with one (start <= end, SM, positions >= visits) row per
    block; an ungated sweep takes none; a split the library is not built at
    (3, 8, and 2; 1 for a gated launch) is refused by either entry."""
    sp, scene, (m_any, m_mat), rays_all = street
    dev = rays_all.device
    pack = build_tri_pack(scene, m_any, m_mat, bake=m_mat)
    rays = rays_all[:, : 12 * 256].contiguous()
    kw = dict(tri_tile=128, want_matrix=True, want_any=False, masks_baked=True)
    visits = torch.zeros(12, dtype=torch.int32, device=dev)
    timeline = torch.zeros((12, 4), dtype=torch.int64, device=dev)
    sweep_rays(rays, pack, m_mat, visits=visits, timeline=timeline, accel=sp.accel, **kw)
    torch.cuda.synchronize()
    assert bool((timeline[:, 0] > 0).all()) and bool((timeline[:, 1] >= timeline[:, 0]).all())
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert bool(((timeline[:, 2] >= 0) & (timeline[:, 2] < n_sms)).all())
    assert bool((timeline[:, 3] >= visits).all()) and int(visits.sum()) > 0
    with pytest.raises(ValueError, match="gated"):
        sweep_rays(rays, pack, m_mat, timeline=timeline, **kw)
    masks = torch.stack([m_mat.float() * 2])
    emap = torch.zeros(12, dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(m_any)
    pack2 = build_tri_pack(scene, zeros, zeros)
    timeline.zero_()
    sweep_rays_scheduled(rays, pack2, masks, emap, tri_tile=128, want_matrix=True,
                         want_any=False, accel=sp.accel, timeline=timeline)
    torch.cuda.synchronize()
    assert bool((timeline[:, 1] >= timeline[:, 0]).all()) and bool((timeline[:, 0] > 0).all())
    for split, accel in ((3, None), (8, None), (2, None), (1, sp.accel), (2, sp.accel)):
        with monkeypatch.context() as m:
            _force(m, split)
            with pytest.raises(RuntimeError, match="CUDA error"):
                sweep_rays(rays, pack, m_mat, accel=accel, **kw)
            with pytest.raises(RuntimeError, match="CUDA error"):
                sweep_rays_scheduled(rays, pack2, masks, emap, tri_tile=128, want_matrix=True,
                                     want_any=False, accel=accel)


# ---------------------------------------------------------------------------
# the sky and the workflow: the count's bin uses, and the any-only and
# matrix + any variants as those solves launch them on a gated city
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_valid", [False, True], ids=["n_valid", "valid_flags"])
@pytest.mark.parametrize(
    "n_bins,rows,length",
    [(145, 128, 2048), (145, 4, 262144), (1, 128, 2048), (1, 2, 262144)],
    ids=["sky_bins_round", "sky_bins_chunk", "upward_round", "upward_chunk"],
)
def test_count_bins_kernel_equals_plain_version(card, n_bins, rows, length, with_valid):
    """``count_bins`` at the sky's 145 bins (patch ids) and 1 bin (upward
    flags), on a scheduled round's rows and a chunk's long rows (several
    CTAs meeting in the work buffer), with misses (-1), out-of-range ids,
    padded rays and a sorted row's valid flags: one launch, equal
    (torch.equal) to the plain version and to numpy.bincount per row."""
    rng = np.random.default_rng(n_bins + rows)
    ids = rng.integers(-2, n_bins + 2, size=(rows, length)).astype(np.int32)
    ids[:, : length // 3] = rng.integers(0, min(n_bins, 5), size=(rows, length // 3))  # hot bins
    n_valid = rng.integers(0, length + 1, size=rows).astype(np.int32)
    n_valid[-1] = length
    valid = rng.uniform(size=(rows, length)) < 0.7
    i_t, v_t = torch.from_numpy(ids).to(card), torch.from_numpy(n_valid).to(card)
    f_t = torch.from_numpy(valid).to(card) if with_valid else None
    before = count_bins.launches
    got = count_bins(i_t, n_bins, v_t, valid=f_t)
    torch.cuda.synchronize()
    assert count_bins.launches == before + 1
    assert torch.equal(got, count_bins_reference(i_t, n_bins, v_t, f_t))
    for r in range(rows):
        keep = np.arange(length) < n_valid[r]
        if with_valid:
            keep &= valid[r]
        row = ids[r][keep]
        np.testing.assert_array_equal(
            got[r].cpu().numpy(), np.bincount(row[(row >= 0) & (row < n_bins)],
                                              minlength=n_bins))
    if with_valid:
        assert torch.equal(count_bins(i_t, n_bins, None, valid=f_t),
                           count_bins_reference(i_t, n_bins, None, f_t))


def _box_city(n_boxes=4000, extent=60.0, seed=2):
    """A ground under random boxes, near geometry occluding far (chip_smoke.py's
    ``city_meshes`` at a card test's size): 48,002 triangles, 24 tiles of
    2,048."""
    V = np.array([[-extent, -extent, 0], [extent, -extent, 0],
                  [extent, extent, 0], [-extent, extent, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-extent, extent, (n_boxes, 2))
    w = rng.uniform(1.0, 4.0, (n_boxes, 2))
    h = rng.uniform(2.0, 25.0, n_boxes)
    box_f = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
                      [1, 5, 6], [1, 6, 2], [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]],
                     np.int32)
    vs = np.empty((n_boxes, 8, 3), np.float32)
    x0, y0 = (cx - w).T
    x1, y1 = (cx + w).T
    vs[:, (0, 3, 4, 7), 0] = x0[:, None]
    vs[:, (1, 2, 5, 6), 0] = x1[:, None]
    vs[:, (0, 1, 4, 5), 1] = y0[:, None]
    vs[:, (2, 3, 6, 7), 1] = y1[:, None]
    vs[:, :4, 2] = 0.05
    vs[:, 4:, 2] = h[:, None]
    faces = box_f[None] + 8 * np.arange(n_boxes, dtype=np.int32)[:, None, None]
    return [("ground", V, F), ("city", vs.reshape(-1, 3), faces.reshape(-1, 3))]


@pytest.fixture(scope="module")
def sky_city():
    """The box city's accel pack on the card and one iteration of the
    ground's rays (57,600 real, padded to whole blocks of 2,048),
    coherence-sorted as chunk_body sorts them: the rays the sky and workflow
    solves sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from raystrack_tpu_torch.ops.trace import _sorted_for_gate, generate_rays, ray_pack
    from raystrack_tpu_torch.solver import _cp_rows

    dev = torch.device("cuda", torch.cuda.current_device())
    ps = raystrack_tpu_torch.PreparedSolver(_box_city())
    sp = ps.get_scene_pack(use_accel=True, device=dev)
    em = ps.get_emitter_pack(0, samples=1, rays=4, flip_faces=False, device=dev)
    o, d = generate_rays((em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2),
                         (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v,
                          em.tri_n, em.tri_eps),
                         torch.from_numpy(_cp_rows(3, 0, 0, 1)).to(dev))
    n = o.shape[1]
    valid = (torch.arange(n, device=dev) < em.n_rays_once)[None]
    o, d, _ = _sorted_for_gate(o, d, valid, sp.accel)
    return sp, em, ray_pack(o, d).contiguous()


SKY_KINDS = {"any": (False, True, 0), "matrix_any": (True, True, 1)}


@pytest.mark.parametrize("kind", sorted(SKY_KINDS))
def test_sky_variants_of_kernel_1_on_a_gated_city_chunk(sky_city, kind):
    """Kernel #1's any-only variant (the sky: min_sid 0) and matrix + any
    variant (the workflow: reciprocity, min_sid 1) on the operands the solves
    build (the m_any-baked pack, emitter_operands(want_any=True)): one gated
    launch == the ungated kernel over the whole chunk, and == the plain gated
    version (visits too) on the leading 16 blocks; the any-hit flags are not
    all alike."""
    from raystrack_tpu_torch.ops.trace import emitter_operands

    sp, em, rays = sky_city
    want_matrix, want_any, min_sid = SKY_KINDS[kind]
    scene = (sp.v0, sp.e1, sp.e2, sp.cross_e, sp.w_u, sp.w_v, sp.d0, sp.sid)
    ext = torch.tensor([0, 1, 0], dtype=torch.int32, device=rays.device)
    pack, mask = emitter_operands(scene, ext, 0, min_sid, em.plane_vec, want_any=True)
    kw = dict(want_matrix=want_matrix, want_any=want_any, masks_baked=True)
    before = sweep_rays.gated_launches
    codes, any_hit = sweep_rays(rays, pack, mask, tri_tile=2048, accel=sp.accel, **kw)
    torch.cuda.synchronize()
    assert sweep_rays.gated_launches == before + 1
    ungated = sweep_rays(rays, pack, mask, tri_tile=2048, **kw)
    assert torch.equal(codes, ungated[0]) and torch.equal(any_hit, ungated[1])
    assert 0 < int(any_hit.sum()) < rays.shape[1]
    sub = rays[:, : 16 * 256].contiguous()
    tile = sweep_tile_width(sp.n_tri_pad, 2048)
    tiles_on = mask.reshape(-1, tile).any(dim=1).to(torch.int32)
    visits = torch.full((16,), -1, dtype=torch.int32, device=rays.device)
    plain_visits = torch.full_like(visits, -2)
    got = sweep_rays(sub, pack, mask, tri_tile=2048, accel=sp.accel, visits=visits, **kw)
    want = _gated_plain(sub, pack, tiles_on, tile, sp.accel, plain_visits, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(visits, plain_visits)


@pytest.mark.parametrize("kind", sorted(SKY_KINDS))
def test_sky_variants_of_kernel_2_on_a_gated_city_round(sky_city, kind):
    """Kernel #2's any-only and matrix + any variants on a round of two
    emitter rows (the ground's combined mask row as the sky or the workflow
    sets it, and an all-zero row) over the city chunk's rays: one gated
    launch == the ungated kernel, == the plain gated version on the leading
    16 blocks (visits too), and == kernel #1 on the ground's blocks."""
    from raystrack_tpu_torch.ops.trace import combined_masks, emitter_operands

    sp, em, rays = sky_city
    dev = rays.device
    want_matrix, want_any, min_sid = SKY_KINDS[kind]
    scene = (sp.v0, sp.e1, sp.e2, sp.cross_e, sp.w_u, sp.w_v, sp.d0, sp.sid)
    ext = torch.tensor([[0, 1, 0], [0, 1, 0]], dtype=torch.int32, device=dev)
    masks = combined_masks(scene, ext, torch.tensor([0, 0], dtype=torch.int32, device=dev),
                           torch.tensor([min_sid, min_sid], dtype=torch.int32, device=dev),
                           torch.stack([em.plane_vec, em.plane_vec]))
    masks[1] = 0.0
    n_blocks = rays.shape[1] // 256
    emap = torch.from_numpy((np.arange(n_blocks) % 7 == 3).astype(np.int32)).to(dev)
    zeros = torch.zeros_like(sp.sid, dtype=torch.bool)
    pack = build_tri_pack(scene, zeros, zeros)
    kw = dict(want_matrix=want_matrix, want_any=want_any)
    before = sweep_rays_scheduled.gated_launches
    codes, any_hit = sweep_rays_scheduled(rays, pack, masks, emap, tri_tile=2048,
                                          accel=sp.accel, **kw)
    torch.cuda.synchronize()
    assert sweep_rays_scheduled.gated_launches == before + 1
    ungated = sweep_rays_scheduled(rays, pack, masks, emap, tri_tile=2048, **kw)
    assert torch.equal(codes, ungated[0]) and torch.equal(any_hit, ungated[1])
    ground = (emap == 0).repeat_interleave(256)
    pack1, mask1 = emitter_operands(scene, ext[0], 0, min_sid, em.plane_vec, want_any=True)
    one = sweep_rays(rays[:, ground].contiguous(), pack1, mask1, masks_baked=True,
                     tri_tile=2048, accel=sp.accel, **kw)
    assert torch.equal(codes[ground], one[0]) and torch.equal(any_hit[ground], one[1])
    assert not bool(any_hit[~ground].any()) and bool((codes[~ground] == -1).all())
    sub = rays[:, : 16 * 256].contiguous()
    tile = sweep_tile_width(sp.n_tri_pad, 2048)
    n_tiles = sp.n_tri_pad // tile
    visits = torch.full((16,), -1, dtype=torch.int32, device=dev)
    got = sweep_rays_scheduled(sub, pack, masks, emap[:16].contiguous(), tri_tile=2048,
                               accel=sp.accel, visits=visits, **kw)
    gate = _gate_tables(sp.accel, sub, n_tiles, tile,
                        window=_resolve_gate_window(gate_group_size(n_tiles)))
    tiles_on = _gated_tiles_on(
        scheduled_tiles_on(masks, tile, want_matrix=want_matrix, want_any=want_any), gate)
    plain_visits = torch.full_like(visits, -2)
    want = sweep_rays_scheduled_reference(sub, pack, masks, emap[:16].contiguous(), tiles_on,
                                          tile, gate=gate, visits=plain_visits, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(visits, plain_visits)


@pytest.mark.parametrize("discrete", [False, True], ids=["merged", "discrete"])
def test_sky_and_workflow_solves_on_card(card, monkeypatch, discrete):
    """On the box city, gated: the sky's and the workflow's scheduled dicts
    == their per-emitter dicts == bvh="off", every sweep and count on the
    card; the any-only and matrix + any launches are counted."""
    meshes = _box_city(n_boxes=1500)
    mp = raystrack_tpu_torch.MatrixParams(samples=0, rays=64, min_iters=3, max_iters=3,
                                          device="gpu")
    sp = raystrack_tpu_torch.SkyParams(samples=0, rays=64, min_iters=3, max_iters=3,
                                       device="gpu", discrete=discrete)
    out = {}
    for route in ("scheduled", "grouped"):
        for bvh in ("auto", "off"):
            monkeypatch.setattr(tconfig, "SCHEDULER", route)
            before = (sweep_rays.launches + sweep_rays_scheduled.launches, count_bins.launches)
            m, s = dataclasses.replace(mp, bvh=bvh), dataclasses.replace(sp, bvh=bvh)
            out[route, bvh] = (
                raystrack_tpu_torch.view_factor_to_tregenza_sky(meshes, s),
                raystrack_tpu_torch.view_factor_matrix_and_sky(meshes, matrix_params=m,
                                                               sky_params=s))
            torch.cuda.synchronize()
            assert sweep_rays.launches + sweep_rays_scheduled.launches > before[0]
            assert count_bins.launches > before[1]
    first = out["scheduled", "auto"]
    assert all(v == first for v in out.values())
    assert sum(first[0]["ground"].values()) > 0.0 and first[1][0]["ground"]


RESUME_KINDS = ("matrix", "sky", "workflow")


def _resume_solve(kind, meshes, ckpt=None):
    """The box city's solve of ``kind`` on the card, 2 then 6 iterations
    against a tolerance it cannot reach (two scheduled rounds)."""
    kw = dict(samples=0, rays=64, min_iters=2, max_iters=8, tol=1e-12, device="gpu")
    mp = raystrack_tpu_torch.MatrixParams(reciprocity=False, **kw)
    sp = raystrack_tpu_torch.SkyParams(discrete=True, **kw)
    if kind == "matrix":
        return raystrack_tpu_torch.view_factor_matrix(meshes, mp, checkpoint_dir=ckpt)
    if kind == "sky":
        return raystrack_tpu_torch.view_factor_to_tregenza_sky(meshes, sp, checkpoint_dir=ckpt)
    return raystrack_tpu_torch.view_factor_outside_workflow(
        meshes, matrix_params=dataclasses.replace(mp, reciprocity=True), sky_params=sp,
        checkpoint_dir=ckpt)


@pytest.mark.parametrize("route", ["scheduled", "grouped"])
@pytest.mark.parametrize("kind", RESUME_KINDS)
def test_checkpointed_solve_killed_and_resumed_on_card(card, monkeypatch, tmp_path, kind,
                                                       route):
    """A checkpointed solve on the card, stopped by a crash in
    ``_entry_done`` at the first emitter that finishes (a snapshot after
    every round or chunk), resumes from its snapshots: the result == the
    uninterrupted solve's, and the resume launched the route's gated
    kernel on the card."""
    import raystrack_tpu_torch.solver as tsolver

    meshes = _box_city(n_boxes=1500)
    monkeypatch.setattr(tconfig, "SCHEDULER", route)
    plain = _resume_solve(kind, meshes)
    monkeypatch.setattr(tconfig, "CHECKPOINT_PROGRESS_S", 0.0)
    real_done = tsolver._entry_done

    def crash(entry):
        raise RuntimeError("killed mid-solve")

    monkeypatch.setattr(tsolver, "_entry_done", crash)
    with pytest.raises(RuntimeError, match="killed mid-solve"):
        _resume_solve(kind, meshes, str(tmp_path / "ckpt"))
    monkeypatch.setattr(tsolver, "_entry_done", real_done)
    assert list((tmp_path / "ckpt").glob("*.progress.json"))
    lines = []
    monkeypatch.setattr(tsolver, "_log", lines.append)
    kernel = sweep_rays_scheduled if route == "scheduled" else sweep_rays
    before = kernel.gated_launches
    got = _resume_solve(kind, meshes, str(tmp_path / "ckpt"))
    assert kernel.gated_launches > before
    assert any("resuming from iteration" in line for line in lines)
    assert got == plain


@pytest.mark.parametrize("command", RESUME_KINDS)
def test_cli_on_card_writes_the_in_process_json(card, tmp_path, command):
    """``python -m raystrack_tpu_torch <command> <file.obj>``, no
    ``--device`` (the card), writes the JSON the in-process solve of the
    file's meshes saves; the matrix's ``--stream-out --checkpoint-dir`` run
    too."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from raystrack_tpu_torch import load_meshes_obj, load_vf_matrix_json, save_meshes_obj
    from raystrack_tpu_torch.io import save_vf_matrix_json

    root = Path(__file__).resolve().parents[1]
    scene = save_meshes_obj(_box_city(n_boxes=1500), str(tmp_path / "city.obj"))
    flags = ["--samples", "0", "--rays", "64", "--min-iters", "3", "--max-iters", "3"]
    outs = {"matrix": ["--out", str(tmp_path / "m.json")],
            "sky": ["--out", str(tmp_path / "s.json"), "--discrete"],
            "workflow": ["--out-prefix", str(tmp_path / "w_")]}[command]
    runs = [outs]
    if command == "matrix":
        runs.append(["--out", str(tmp_path / "streamed.json"), "--stream-out",
                     "--checkpoint-dir", str(tmp_path / "ckpt")])
    env = dict(os.environ, PYTHONPATH=str(root))
    for extra in runs:
        proc = subprocess.run([sys.executable, "-m", "raystrack_tpu_torch", command, scene,
                               *flags, *extra], cwd=tmp_path, env=env, capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    meshes = load_meshes_obj(scene)
    kw = dict(samples=0, rays=64, min_iters=3, max_iters=3, device="gpu")
    if command == "matrix":
        want = {"m.json": raystrack_tpu_torch.view_factor_matrix(
            meshes, raystrack_tpu_torch.MatrixParams(**kw))}
        want["streamed.json"] = want["m.json"]
    elif command == "sky":
        want = {"s.json": raystrack_tpu_torch.view_factor_to_tregenza_sky(
            meshes, raystrack_tpu_torch.SkyParams(discrete=True, **kw))}
    else:
        scene_vf, sky_vf, rest_vf = raystrack_tpu_torch.view_factor_outside_workflow(
            meshes, matrix_params=raystrack_tpu_torch.MatrixParams(**kw),
            sky_params=raystrack_tpu_torch.SkyParams(**kw))
        want = {"w_vf_scene.json": scene_vf, "w_sky_vf.json": sky_vf, "w_rest_vf.json": rest_vf}
    for name, vf in want.items():
        ref = save_vf_matrix_json(vf, str(tmp_path / "ref" / name))
        assert load_vf_matrix_json(str(tmp_path / name)) == load_vf_matrix_json(ref), name


# ---------------------------------------------------------------------------
# the ray mesh on the card: a logical mesh of 4 shards on one card
# ---------------------------------------------------------------------------

MESH_KINDS = {"matrix": (True, False, False), "any": (False, True, False),
              "any_discrete": (False, True, True), "matrix_any": (True, True, False)}


@pytest.fixture(scope="module")
def mesh_city():
    """The box city's prepared solver and its accel scene pack on the card,
    full and slim."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    ps = raystrack_tpu_torch.PreparedSolver(_box_city())
    full = ps.get_scene_pack(use_accel=True, device=dev)
    slim = pack_scene(ps.get_scene(use_accel=True), 2, device=dev, slim=True)
    return ps, full, slim, dev


def _mesh(kind, dev):
    """A logical mesh of 4 shards on ``dev``, or ``ray_mesh()``: one shard
    a visible card (one on a one-card machine)."""
    from raystrack_tpu_torch.parallel import ray_mesh

    return ray_mesh([dev] * 4) if kind == "logical4" else ray_mesh()


def _launch_counts():
    return (sweep_rays.launches, sweep_rays.gated_launches, sweep_rays.code_launches,
            sweep_rays_scheduled.launches, sweep_rays_scheduled.gated_launches,
            count_bins.launches, gate_cross.launches)


@pytest.mark.parametrize("mesh_kind", ["logical4", "every_card"])
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("mode", ["baked", "code"])
@pytest.mark.parametrize("kind", sorted(MESH_KINDS))
def test_sharded_chunk_on_a_mesh_equals_unsharded(mesh_city, kind, mode, gated, mesh_kind):
    """trace_chunk_sharded over ray_mesh([card] * 4), and over ray_mesh()
    (every card), == chunk_body on the whole chunk (2 iterations of the
    ground's 57,600 rays), every output bitwise and gathered on the card,
    in each variant of kernel #1 (baked pack, and the slim pack's code
    mode): a sweep launch a shard, a count launch a shard and output, a
    crossing launch a shard gated."""
    from raystrack_tpu_torch.ops.trace import chunk_body, emitter_operands
    from raystrack_tpu_torch.parallel import trace_chunk_sharded
    from raystrack_tpu_torch.solver import _cp_rows

    ps, full, slim, dev = mesh_city
    mesh = _mesh(mesh_kind, dev)
    n = mesh.size
    want_matrix, want_any, discrete = MESH_KINDS[kind]
    flags = dict(want_matrix=want_matrix, want_any=want_any, discrete=discrete)
    ext = torch.tensor([0, 1, 0], dtype=torch.int32, device=dev)
    ems = [ps.get_emitter_pack(0, samples=1, rays=4, flip_faces=False, align=align,
                               device=dev)
           for align in (tconfig.RAY_BLOCK, n * tconfig.RAY_BLOCK)]
    if mode == "baked":
        scene = (full.v0, full.e1, full.e2, full.cross_e, full.w_u, full.w_v, full.d0,
                 full.sid)
        pack, mask = emitter_operands(scene, ext, 0, 1, ems[0].plane_vec, want_any=want_any)
        bounds = None
    else:
        mask, bounds = slim_operands(slim.sid, ext, 0, 1, want_any=want_any)
        pack = slim.tri_pack
    accel = full.accel if gated else None
    cp = torch.from_numpy(_cp_rows(3, 0, 0, 2)).to(dev)

    def args(em):
        return (pack, mask, (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2),
                (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v, em.tri_n,
                 em.tri_eps), cp, 2, em.n_rays_once, accel, bounds)

    single = chunk_body(*args(ems[0]), **flags)
    before = _launch_counts()
    sharded = trace_chunk_sharded(mesh, *args(ems[1]), **flags)
    for card_dev in mesh.distinct:
        torch.cuda.synchronize(card_dev)
    d = [b - a for a, b in zip(before, _launch_counts())]
    n_out = int(want_matrix) + int(want_any)
    assert d == [n, n * gated, n * (mode == "code"), 0, 0, n * n_out, n * gated]
    assert sorted(sharded) == sorted(single)
    for key in single:
        assert sharded[key].device == dev and torch.equal(sharded[key], single[key]), key
    assert sum(int(v.sum()) for v in single.values()) > 0


@pytest.mark.parametrize("mesh_kind", ["logical4", "every_card"])
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("kind", sorted(MESH_KINDS))
def test_sharded_round_on_a_mesh_equals_unsharded(mesh_city, kind, gated, mesh_kind):
    """scheduled_trace_sharded over ray_mesh([card] * 4), and over
    ray_mesh(), == scheduled_trace on a round of 67 rows (3 iterations of
    the ground, 1 of the city, each 16 blocks, and 3 of the ground again:
    not a multiple of 4), packed counts bitwise, in each variant of kernel
    #2: a launch a shard."""
    from raystrack_tpu_torch.ops.trace import scheduled_trace
    from raystrack_tpu_torch.parallel.sharding import scheduled_trace_sharded
    from raystrack_tpu_torch.prepared import emitter_plane_vec
    from raystrack_tpu_torch.solver import _build_emitter_surface_mask, _cp_rows

    ps, full, _, dev = mesh_city
    want_matrix, want_any, discrete = MESH_KINDS[kind]
    tt, tg, offsets, n_pad = ps.get_flat_tables(samples=0, rays=256, flip_faces=False,
                                                device=dev)
    emitters = ps.get_emitters(samples=0, rays=256, flip_faces=False)
    rows = []
    for e, it in ((0, 0), (0, 1), (0, 2), (1, 3)):
        rows += [[e, it, int(offsets[e]) + b * 256, b * 256]
                 for b in range(int(n_pad[e]) // 256)]
    rows += [[0, 4, int(offsets[0]) + b * 256, b * 256] for b in range(3)]
    ext = np.zeros((2, 3), np.int32)
    for e in range(2):
        ext[e, :2] = _build_emitter_surface_mask(e, emitters[e], *ps.get_mesh_bounds())
    scene = (full.v0, full.e1, full.e2, full.cross_e, full.w_u, full.w_v, full.d0, full.sid)
    zeros = torch.zeros_like(full.sid, dtype=torch.bool)
    put = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(dev)  # noqa: E731
    args = (scene, build_tri_pack(scene, zeros, zeros), tt, tg,
            put(np.concatenate([_cp_rows(3, 0, 0, 3), _cp_rows(3, 1, 0, 1),
                                _cp_rows(3, 0, 3, 1)]), torch.float32),
            put(ext, torch.int32), put([0, 1], torch.int32), put([1, 0], torch.int32),
            put([em.n_cells * 256 for em in emitters], torch.int32),
            put(np.stack([emitter_plane_vec(em) for em in emitters]), torch.float32),
            put(rows, torch.int32), put([0, 1], torch.int32))
    assert args[10].shape[0] == 67
    kw = dict(sched_block=256, accel=full.accel if gated else None, want_matrix=want_matrix,
              want_any=want_any, discrete=discrete)
    single = scheduled_trace(*args, **kw)
    mesh = _mesh(mesh_kind, dev)
    n = mesh.size
    before = _launch_counts()
    sharded = scheduled_trace_sharded(mesh, *args, **kw)
    for card_dev in mesh.distinct:
        torch.cuda.synchronize(card_dev)
    d = [b - a for a, b in zip(before, _launch_counts())]
    n_out = int(want_matrix) + int(want_any)
    assert d == [0, 0, 0, n, n * gated, n * n_out, n * gated]
    assert torch.equal(sharded, single)
    assert int(single.sum()) > 0


@pytest.mark.parametrize("route", ["scheduled", "grouped"])
def test_sharded_solves_on_card_equal_unsharded(card, monkeypatch, route):
    """On the box city, gated: the matrix, the discrete sky and the outside
    workflow on ray_mesh() (every card) and on a logical mesh of 4 shards
    == mesh=None, on each route; a mesh mixing the card and the CPU raises
    ValueError."""
    from raystrack_tpu_torch.parallel import ray_mesh

    meshes = _box_city(n_boxes=1500)
    monkeypatch.setattr(tconfig, "SCHEDULER", route)
    kw = dict(samples=0, rays=64, min_iters=3, max_iters=3, device="gpu")
    mp = raystrack_tpu_torch.MatrixParams(reciprocity=False, **kw)
    sp = raystrack_tpu_torch.SkyParams(discrete=True, **kw)
    ps = raystrack_tpu_torch.PreparedSolver(meshes)

    def solves(mesh):
        return (raystrack_tpu_torch.view_factor_matrix(meshes, mp, prepared=ps, mesh=mesh),
                raystrack_tpu_torch.view_factor_to_tregenza_sky(meshes, sp, prepared=ps,
                                                                mesh=mesh),
                raystrack_tpu_torch.view_factor_outside_workflow(
                    meshes, matrix_params=mp, sky_params=sp, prepared=ps, mesh=mesh))

    base = solves(None)
    for mesh in (ray_mesh(), ray_mesh([card] * 4)):
        before = _launch_counts()
        assert solves(mesh) == base
        torch.cuda.synchronize()
        d = [b - a for a, b in zip(before, _launch_counts())]
        assert (d[0] if route == "grouped" else d[3]) > 0
    assert len(ps._scene_pack_cache) == len(ray_mesh().distinct)  # one copy a card
    with pytest.raises(ValueError, match="cannot mix"):
        ray_mesh([card, torch.device("cpu")])


# ---------------------------------------------------------------------------
# The Halton device builder on the card
# ---------------------------------------------------------------------------


MID_CITY_TRIS = 2_000_000  # 1,999,994 triangles, 2,000,896 padded: 977 tiles of 2,048
MID_MAX_TILES = 400  # 977 tiles -> groups of 3 over 326 boxes; the last 2 real tiles, 1 phantom


@pytest.fixture(scope="module")
def mid_city():
    """The 2M-triangle occluded city (``city_100m_torch.city_meshes``)
    packed slim on the card, and the ground's first iteration of rays at
    samples=1 (49,152, 192 blocks), coherence-sorted as ``chunk_body``
    sorts them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from city_100m_torch import city_meshes
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.solver import _cp_rows, _emission_geometry, _ray_tables

    dev = torch.device("cuda", torch.cuda.current_device())
    meshes = city_meshes(MID_CITY_TRIS)
    ps = raystrack_tpu_torch.PreparedSolver(meshes)
    slim = pack_scene(ps.get_scene(use_accel=True), len(meshes), device=dev, slim=True)
    em = ps.get_emitter_pack(0, samples=1, rays=1, flip_faces=False, device=dev)
    o, d = T.generate_rays(_ray_tables(em), _emission_geometry(em),
                           torch.from_numpy(_cp_rows(0, 0, 0, 1)).to(dev))
    valid = (torch.arange(em.n_rays_pad, device=dev) < em.n_rays_once)[None]
    o, d, _ = T._sorted_for_gate(o, d, valid, slim.accel)
    return slim, T.ray_pack(o, d)


@pytest.mark.parametrize("n", [49152, 5000], ids=["chunk", "ragged"])
@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_two_level_code_kernel_on_a_slim_city_equals_plain(mid_city, monkeypatch, want_matrix,
                                                           want_any, n):
    """Kernel #1 in code mode behind the two-level gate with a ragged last
    group (groups of 3 tiles, one phantom) on the 2M city's slim pack: ==
    its plain gated version on the leading blocks (codes, flags, visits:
    the kernel's own tables, their rows of those blocks) and == the
    ungated kernel over all ``n`` rays; one gated code-mode launch."""
    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", MID_MAX_TILES)
    slim, rays_all = mid_city
    rays = rays_all[:, :n].contiguous()
    dev = rays.device
    tile = sweep_tile_width(slim.n_tri_pad, 2048)
    n_tiles = slim.n_tri_pad // tile
    assert (n_tiles, gate_group_size(n_tiles)) == (977, 3) and -(-n_tiles // 3) * 3 - n_tiles == 1
    ext = torch.tensor([0, 1, 0], dtype=torch.int32, device=dev)
    mask, bounds = slim_operands(slim.sid, ext, 0, 0, want_any=want_any)
    kw = dict(want_matrix=want_matrix, want_any=want_any)
    nb = -(-n // 256)
    gate = _gate_tables(slim.accel, rays, n_tiles, tile, window=_resolve_gate_window(3))
    assert gate.group == 3 and gate.window == 0 and gate.boxes.shape[0] == 326
    monkeypatch.setattr(tcuda, "_gate_for", lambda accel, *args: None if accel is None else gate)
    visits = torch.full((nb,), -1, dtype=torch.int32, device=dev)
    before = (sweep_rays.gated_launches, sweep_rays.code_launches)
    codes, any_hit = sweep_rays(rays, slim.tri_pack, mask, tri_tile=2048, accel=slim.accel,
                                code_bounds=bounds, visits=visits, **kw)
    torch.cuda.synchronize()
    assert (sweep_rays.gated_launches, sweep_rays.code_launches) == (before[0] + 1, before[1] + 1)
    k = min(nb, 20)
    lead = slice(0, min(n, k * 256))
    tiles_on = _gated_tiles_on(mask.reshape(-1, tile).any(dim=1).to(torch.int32), gate)
    plain_visits = torch.full((k,), -2, dtype=torch.int32, device=dev)
    want = sweep_rays_reference(rays[:, lead].contiguous(), slim.tri_pack, tiles_on, tile,
                                code_bounds=bounds, gate=gate.blocks(torch.arange(k, device=dev)),
                                visits=plain_visits, split=tcuda.GATED_SPLIT, **kw)
    assert torch.equal(codes[lead], want[0]) and torch.equal(any_hit[lead], want[1])
    assert torch.equal(visits[:k], plain_visits)
    full = torch.zeros_like(visits)
    ungated = sweep_rays(rays, slim.tri_pack, mask, tri_tile=2048, code_bounds=bounds,
                         visits=full, **kw)
    assert torch.equal(codes, ungated[0]) and torch.equal(any_hit, ungated[1])
    assert int(visits.sum()) < int(full.sum())  # the gate skipped tiles
    if want_matrix:
        assert int((codes >= 0).sum()) > n // 2
    if want_any:
        assert int(any_hit.sum()) > n // 2


@pytest.fixture
def halton_clean(monkeypatch):
    import raystrack_tpu_torch.ops.halton as thalton

    monkeypatch.delenv(tconfig.TABLE_CACHE_ENV, raising=False)
    monkeypatch.delenv(tconfig.DEVICE_HALTON_ENV, raising=False)
    thalton.cached_halton_dims.cache_clear()
    thalton.cached_halton.cache_clear()
    yield thalton
    thalton.cached_halton_dims.cache_clear()
    thalton.cached_halton.cache_clear()


@pytest.mark.parametrize("base", [5, 2, 3, 7, 11])
def test_device_halton_bitwise_equals_host_on_card(card, halton_clean, base):
    """4,194,304 entries (the smoke's phase 21 size) built on the card are
    the host build, bit for bit: the exact float64 division included."""
    thalton = halton_clean
    n = 4_194_304
    table = thalton._halton_dim_device(n, base, card)
    assert table.device.type == "cuda" and table.dtype == torch.float32
    assert torch.equal(table.cpu(), torch.from_numpy(thalton._halton_dim_host(n, base)))


@pytest.mark.parametrize("base,length", [(2, 40_000), (3, 4096 * 2 + 3_000), (11, 4097)])
def test_device_halton_chunk_stitching_on_card(card, halton_clean, monkeypatch, base, length):
    thalton = halton_clean
    monkeypatch.setattr(thalton, "DEVICE_CHUNK", 4096)
    table = thalton._halton_dim_device(length, base, card)
    assert torch.equal(table.cpu(), torch.from_numpy(thalton._halton_dim_host(length, base)))


@pytest.mark.parametrize("g,chunk", [(2048, None), (91, 4096)])
def test_device_halton_grid_bitwise_on_card(card, halton_clean, monkeypatch, g, chunk):
    """The (u, v) grid built on the card (2048 x 2048 cells, and chunk
    seams) is the host grid bit for bit: the float64 sum and division too."""
    thalton = halton_clean
    if chunk is not None:
        monkeypatch.setattr(thalton, "DEVICE_CHUNK", chunk)
    for got, want in zip(thalton._halton_grid_device(g, card), thalton._halton_grid_host(g)):
        assert got.is_cuda and torch.equal(got.cpu(), torch.from_numpy(want))


def test_device_tables_pack_and_solve_on_card(card, halton_clean, monkeypatch):
    """With the threshold lowered so every emitter's tables and grid are
    built on the card: the emitter packs and the flat tables stay on the
    card and equal the host-built ones, and solves on both routes give the
    dicts of the host tables (RAYSTRACK_TPU_DEVICE_HALTON=0)."""
    import raystrack_tpu_torch.prepared as tprep

    thalton = halton_clean
    meshes = [("a", *_quad(0.0, 1)), ("b", *_quad(1.0, -1)), ("c", *_quad(2.0, 1))]
    monkeypatch.setattr(tconfig, "DEVICE_MIN_LENGTH", 50)  # the 64-cell grids too

    def run():
        ps = raystrack_tpu_torch.PreparedSolver(meshes)
        pack = ps.get_emitter_pack(0, samples=64, rays=64, flip_faces=False, device=card)
        flat = ps.get_flat_tables(samples=64, rays=64, flip_faces=False, device=card)[0]
        out = {}
        for route in ("scheduled", "grouped"):
            monkeypatch.setattr(tconfig, "SCHEDULER", route)
            out[route] = raystrack_tpu_torch.view_factor_matrix(
                meshes, raystrack_tpu_torch.MatrixParams(
                    samples=64, rays=64, min_iters=3, max_iters=3, reciprocity=False,
                    device="gpu"), prepared=ps)
        return pack, flat, out

    dev_pack, dev_flat, dev_vf = run()
    assert isinstance(thalton.cached_halton_dims(64 * 64, card)[0], torch.Tensor)
    assert isinstance(thalton.cached_halton(8, card)[0], torch.Tensor)
    monkeypatch.setenv(tconfig.DEVICE_HALTON_ENV, "0")
    thalton.cached_halton_dims.cache_clear()
    thalton.cached_halton.cache_clear()
    host_pack, host_flat, host_vf = run()
    for field in ("u_cell", "v_cell", "h_tri", "h_u", "h_v", "h_r1", "h_r2"):
        a, b = getattr(dev_pack, field), getattr(host_pack, field)
        assert a.is_cuda and torch.equal(a, b), field
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(dev_flat, host_flat))
    assert dev_vf == host_vf and dev_vf["scheduled"] == dev_vf["grouped"]


def _quad(z, normal):
    V = np.array([[0, 0, z], [1, 0, z], [1, 1, z], [0, 1, z]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]] if normal > 0 else [[0, 2, 1], [0, 3, 2]], np.int32)
    return V, F


# ---------------------------------------------------------------------------
# bench_torch.py and head_to_head_torch.py on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accel", [False, True], ids=["brute", "accel"])
def test_bench_run_chunk_on_card_equals_cpu(card, accel):
    """``bench_torch.run_chunk`` on a 10,000-triangle city: the card's
    counts == the CPU's within max(2, 0.001 n_rays) per surface and
    iteration (raygen ulps), one launch of kernel #1 (gated with
    ``accel``), of the count and, gated, of the crossing kernel."""
    import bench_torch

    meshes = bench_torch.city_meshes(10_000, 30.0)
    kw = dict(accel=accel, seed=4, chunk=2, samples=1, rays=2)
    k0 = bench_torch.launches()
    got, em, sc = bench_torch.run_chunk(raystrack_tpu_torch.PreparedSolver(meshes), card, **kw)
    made = bench_torch.launches_since(k0)
    want, _, _ = bench_torch.run_chunk(raystrack_tpu_torch.PreparedSolver(meshes),
                                       torch.device("cpu"), **kw)
    assert made == dict(k1=1, k1_gated=int(accel), k2=0, k2_gated=0, count=1, cross=int(accel))
    tol = max(2, int(0.001 * em.n_rays_once))
    for key in ("counts_f", "counts_b"):
        assert got[key].is_cuda
        assert int((got[key].cpu() - want[key]).abs().max()) <= tol, key
    assert int(got["counts_b"].sum()) > 5_000


def test_head_to_head_rays_are_the_rays_the_card_traced(card, monkeypatch):
    """``head_to_head_torch.materialize_rays`` gives, bitwise, the valid
    rays the gated dispatch generated on the card (before its sort)."""
    import bench_torch
    import head_to_head_torch
    from raystrack_tpu_torch.ops import trace as T

    traced = []
    real = T.generate_rays
    monkeypatch.setattr(T, "generate_rays", lambda *a: traced.append(real(*a)) or traced[-1])
    ps = raystrack_tpu_torch.PreparedSolver(bench_torch.city_meshes(50_000, 60.0))
    _, em, _ = bench_torch.run_chunk(ps, card, accel=True, seed=7, chunk=2, samples=1, rays=2)
    monkeypatch.undo()
    o, d = head_to_head_torch.materialize_rays(em, 2, 7, card)
    assert len(traced) == 1 and o.shape == (2 * em.n_rays_once, 3)
    for got, want in zip((o, d), traced[0]):
        assert np.array_equal(got, want[:, : em.n_rays_once].reshape(-1, 3).cpu().numpy())


def test_bench_main_exits_1_when_a_stage_raises_on_card(card, monkeypatch, capsys):
    """``bench_torch.main`` on the card with the district raising: the
    headline line first (the soup, kernel #1 and the count launched 6 times:
    a warm-up and 5 timed), the enriched line last with the district empty,
    exit 1."""
    import json

    import bench_torch

    def boom(dev):
        raise RuntimeError("district failed on the card")

    monkeypatch.setattr(bench_torch, "district_solve", boom)
    monkeypatch.setattr(bench_torch, "city_curve", lambda dev, budget, calibrate=False: {})
    monkeypatch.setattr(bench_torch, "canyon_and_plates", lambda dev: (0.1, 1e-5))
    assert bench_torch.main([]) == 1
    lines = capsys.readouterr().out.splitlines()
    head, last = json.loads(lines[0]), json.loads(lines[-1])
    assert head["metric"] == "ray_triangle_tests_per_sec" and head["n_tri"] == 98304
    assert head["rays_per_dispatch"] == 4 * 65536 and head["value"] > 1e9
    assert last["failed"] == ["district"] and last["district_97_emitters_solve_s"] is None
    assert last["launches"]["headline"] == dict(k1=6, k1_gated=0, k2=0, k2_gated=0, count=6,
                                                cross=0)


# ---------------------------------------------------------------------------
# the CTA geometry: every geometry the kernels are built at, on the main
# path's launches, against the plain version and whole-block CTAs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def geometry_cases(mid_city):
    """The launches the geometry rule serves, as chip_smoke.py captures
    them: kernel #1 gated on the 1M city's first ground -> city chunk (1,024
    blocks), kernel #2 gated on the first ``city_plates`` round (960 blocks),
    kernel #1 in code mode behind the two-level gate on the 2M slim city's
    chunk (192 blocks), kernel #1 ungated on the soup chunk (1,024 blocks).
    Each: rays, accel (None: ungated), the tile, its tile flags, the kernel
    ``kernel(rays, **kw)`` and the plain version ``plain(rays, tiles_on,
    **kw)``."""
    import chip_smoke
    from raystrack_tpu_torch import view_factor, view_factor_matrix
    from raystrack_tpu_torch.ops import trace as T

    dev = torch.device("cuda", torch.cuda.current_device())
    cases = chip_smoke.solve_cases()
    city, vf_params = cases["city"]
    plates, plates_params = cases["city_plates"]
    out = {}
    chunk = chip_smoke.first_call(T, "chunk_body", lambda: view_factor(
        city[0], city[1], vf_params, prepared=raystrack_tpu_torch.PreparedSolver(city)))
    rays, pack, mask, accel, tile, tiles_on = chip_smoke.city_chunk_inputs(chunk)
    kw1 = dict(want_matrix=True, want_any=False, masks_baked=True)
    out["city_chunk"] = (rays, accel, tile, tiles_on, lambda r, **kw: sweep_rays(
        r, pack, mask, tri_tile=tile, **kw1, **kw), lambda r, t_on, **kw: sweep_rays_reference(
        r, pack, t_on, tile, **kw1, **kw))
    rnd = chip_smoke.first_call(T, "scheduled_trace", lambda: view_factor_matrix(
        plates, plates_params, prepared=raystrack_tpu_torch.PreparedSolver(plates)))
    rays2, pack2, masks, emap, accel2, tile2, t_on2 = chip_smoke.city_round_inputs(rnd)
    kw2 = dict(want_matrix=True, want_any=False)
    out["city_plates_round"] = (
        rays2, accel2, tile2, t_on2, lambda r, **kw: sweep_rays_scheduled(
            r, pack2, masks, emap[: r.shape[1] // 256].contiguous(), tri_tile=tile2, **kw2, **kw),
        lambda r, t_on, **kw: sweep_rays_scheduled_reference(
            r, pack2, masks, emap[: r.shape[1] // 256], t_on, tile2, **kw2, **kw))
    slim, rays3 = mid_city
    mask3, bounds = slim_operands(slim.sid, torch.tensor([0, 1, 0], dtype=torch.int32,
                                                         device=dev), 0, 0)
    tile3 = sweep_tile_width(slim.n_tri_pad, 2048)
    kw3 = dict(want_matrix=True, want_any=False, code_bounds=bounds)
    out["slim_city_two_level"] = (
        rays3, slim.accel, tile3, mask3.reshape(-1, tile3).any(dim=1).to(torch.int32),
        lambda r, **kw: sweep_rays(r, slim.tri_pack, mask3, tri_tile=tile3, **kw3, **kw),
        lambda r, t_on, **kw: sweep_rays_reference(r, slim.tri_pack, t_on, tile3, **kw3, **kw))
    soup, soup_params = cases["soup"]
    scene, rays4, m_any, m_mat, tpad, _ = chip_smoke.soup_inputs(
        dev, raystrack_tpu_torch.PreparedSolver(soup), soup_params.seed)
    pack4 = build_tri_pack(scene, m_any, m_mat, bake=m_mat)
    tile4 = sweep_tile_width(tpad, 2048)
    out["soup_chunk"] = (rays4, None, tile4, m_mat.reshape(-1, tile4).any(dim=1).to(torch.int32),
                         lambda r, **kw: sweep_rays(r, pack4, m_mat, tri_tile=tile4, **kw1, **kw),
                         lambda r, t_on, **kw: sweep_rays_reference(r, pack4, t_on, tile4, **kw1,
                                                                    **kw))
    return out


GEOMETRY_CASES = [(case, g.name)
                  for case, gated in (("city_chunk", True), ("city_plates_round", True),
                                      ("slim_city_two_level", True), ("soup_chunk", False))
                  for g in tcuda.BUILT_GEOMETRIES[gated]]


@pytest.mark.parametrize("case,geometry", GEOMETRY_CASES,
                         ids=[f"{c}-{g}" for c, g in GEOMETRY_CASES])
def test_every_built_geometry_equals_plain_and_whole_blocks(geometry_cases, monkeypatch, case,
                                                            geometry):
    """Each kernel at each geometry it is built at, forced, on the main
    path's launches: codes, flags and each block's visits == the launch at
    whole 256-ray blocks a CTA (the geometry before, ``_whole_block``), and, on 16
    leading blocks, codes, flags and each CTA's visits == its plain version
    at the same geometry (gated: on the kernel's own tables)."""
    if case == "slim_city_two_level":
        monkeypatch.setattr(tconfig, "GATE_MAX_TILES", MID_MAX_TILES)
    rays, accel, tile, tiles_on, kernel, plain = geometry_cases[case]
    dev, n = rays.device, rays.shape[1]
    nb = -(-n // 256)
    gated = accel is not None
    geo = next(g for g in tcuda.BUILT_GEOMETRIES[gated] if g.name == geometry)
    gate = tcuda._gate_for(accel, rays, tiles_on.shape[-1] * tile, tile, tile, dev)
    assert (gate is not None) == gated
    t_on = _gated_tiles_on(tiles_on, gate)

    def run(g, rows):
        v = torch.full((rows,), -1, dtype=torch.int32, device=dev)
        with monkeypatch.context() as m:
            _force(m, g)
            m.setattr(tcuda, "_gate_for", lambda *args: gate)
            before = (sweep_rays.launches + sweep_rays_scheduled.launches)
            codes, any_hit = kernel(rays, accel=accel, visits=v)
            torch.cuda.synchronize()
            assert sweep_rays.launches + sweep_rays_scheduled.launches == before + 1
        return codes, any_hit, v

    whole = run(tcuda._whole_block(nb, gated, tcuda._sm_count(dev)), nb)
    got = run(geo, nb)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)
    per_cta = run(geo, geo.units(n))[2]
    k = min(16, nb)
    sub = rays[:, : k * 256].contiguous()
    rows = geo.units(sub.shape[1])
    vp = torch.full((rows,), -2, dtype=torch.int32, device=dev)
    codes, any_hit = plain(sub, t_on, gate=None if gate is None else gate.blocks(
        torch.arange(k, device=dev)), visits=vp, split=geo)
    assert torch.equal(codes, got[0][: k * 256]) and torch.equal(any_hit, got[1][: k * 256])
    assert torch.equal(vp, per_cta[:rows])
    assert int((got[0] >= 0).sum()) > n // 10
    if gated and geo.rays < 256:  # its CTAs test no more pairs than the walk
        assert int(per_cta.sum()) * geo.rays <= int(whole[2].sum()) * 256


# ---------------------------------------------------------------------------
# a scheduled round's mask rows: the kernel of csrc/masks.cu against its
# plain version
# ---------------------------------------------------------------------------


MASK_SHAPES = [(e, t) for e in (1, 2, 11, 97) for t in (2048, 6144, 1_000_000)]
MASK_CASES = ([f"E{e}-T{t}" for e, t in MASK_SHAPES]
              + ["E11-T6144-nonplanar", "E97-T1000000-nonplanar", "canyon_matrix",
                 "city_buildings"])


def _benchmark_rounds(cell_name: str, seed: int = 2200000020):
    """Every ``combined_masks`` call of one solve of the benchmark's cell
    ``cell_name`` (``vfbench``'s scene and traffic from ``seed``), with the
    rows it returned, and the launches of the mask kernel and of kernel #2
    over the solve."""
    import raystrack_tpu_torch.solver as solver
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.ops.masks_cuda import mask_rows
    from vfbench import harness

    cell = harness.Cell.load(cell_name)
    meshes = cell.meshes(seed)
    calls = []
    real, quiet = T.combined_masks, solver._log
    try:
        solve = harness.program_solver(cell.traffic, meshes, "gpu")
        T.combined_masks = lambda *args: calls.append((args, real(*args))) or calls[-1][1]
        launches = (mask_rows.launches, sweep_rays_scheduled.launches)
        solve(harness.solve_seed(seed, 1))
        launches = (mask_rows.launches - launches[0],
                    sweep_rays_scheduled.launches - launches[1])
    finally:
        T.combined_masks, solver._log = real, quiet
    return calls, launches


@pytest.mark.parametrize("case", MASK_CASES)
def test_mask_rows_kernel_equals_plain_version(card, case):
    """The kernel's (E, Tpad) rows == the plain version's on the card and ==
    the rows numpy computes one float32 operation at a time, bitwise, one
    launch a call: on the synthetic cases of ``tests/_mask_cases.py`` (E of
    1 to 97 rows over 2,048 to 10^6 triangles; planar and non-planar
    emitters, tol 0 and not, inactive surfaces and rows, sid == emit_sid,
    min_sid at both ends, padding, NaN, infinite, overflowing and
    subnormal coordinates; and rounds with no planar row, where the kernel
    leaves the geometry unread), and on every round of one solve of the
    benchmark's ``canyon_matrix`` (about 34 rounds of up to 11 rows over
    128 padded triangles) and ``city_buildings`` (one round of (10,
    10,000,384)), where the kernel launched once a round: as often as
    kernel #2."""
    from raystrack_tpu_torch.ops.masks_cuda import mask_rows
    from raystrack_tpu_torch.ops.trace import combined_masks, combined_masks_reference
    from _mask_cases import mask_case, on, spec_rows

    if case.startswith("E"):
        n_emit, n_tri = (int(x[1:]) for x in case.split("-")[:2])
        host = mask_case(n_emit, n_tri, seed=n_emit + n_tri,
                         planar=not case.endswith("nonplanar"))
        args = on(host, card)
        before = mask_rows.launches
        got = combined_masks(*args)
        assert mask_rows.launches == before + 1
        calls = [(args, got)]
        assert np.array_equal(got.cpu().numpy(), spec_rows(*host))
    else:
        calls, (n_masks, n_rounds) = _benchmark_rounds(case)
        assert n_masks == n_rounds == len(calls) and n_rounds >= 1
        shapes = {tuple(got.shape) for _, got in calls}
        if case == "canyon_matrix":  # 22 triangles padded to 128; a round's rows vary
            assert {t for _, t in shapes} == {128} and max(e for e, _ in shapes) > 1
        else:
            assert shapes == {(10, 10_000_384)}
    for args, got in calls:
        assert got.device == card and got.dtype == torch.float32
        want = combined_masks_reference(*args)
        assert torch.equal(got, want)
        assert bool((want == 2).any())
    if case == "canyon_matrix":
        for args, got in calls:
            assert np.array_equal(got.cpu().numpy(), spec_rows(*args))


# ---------------------------------------------------------------------------
# The per-emitter driver's slots: chunks of several emitters side by side
# ---------------------------------------------------------------------------


SLOT_ANCHORS = [(-10.0, -5.0), (0.0, -5.0), (10.0, -5.0), (0.0, 5.0)]
SLOT_CHUNKS = 3 * len(SLOT_ANCHORS)  # 6 iterations a building: chunks of 4, 1 and 1


@pytest.fixture(scope="module")
def slot_city():
    """The 2M-triangle city split as the benchmark's ``slim_city_buildings``
    splits the 3e7 one (``vfbench``'s scene builder): four buildings of the
    16 boxes nearest each anchor emit, and the ground with every other box
    is the one receiver, ``city``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vfbench.scenes.occluded_city import build

    return build({"triangles": MID_CITY_TRIS, "extent": 100.0}, 5, buildings=SLOT_ANCHORS,
                 boxes_per_building=16)


def _slot_solve(meshes, seed, monkeypatch):
    """The slim cell's matrix solve of ``meshes`` from a fresh
    ``PreparedSolver``: packed slim (threshold 1), the two-level gate in
    groups of 3, exactly 6 iterations an emitter; (dict, the counters'
    change under a profiler, the current stream of each chunk's sweep)."""
    from torch.profiler import ProfilerActivity, profile

    from raystrack_tpu_torch import tracing
    from raystrack_tpu_torch.parallel import sharding

    monkeypatch.setattr(tconfig, "SLIM_PACK_MIN_TRIS", 1)
    monkeypatch.setattr(tconfig, "GATE_MAX_TILES", MID_MAX_TILES)
    streams = []
    real = sharding.trace_chunk_sharded

    def seen(*args, **kwargs):
        streams.append(torch.cuda.current_stream())
        return real(*args, **kwargs)

    params = raystrack_tpu_torch.MatrixParams(
        samples=0, rays=256, seed=seed, device="gpu", bvh="auto", tol=1e-4, min_iters=6,
        max_iters=6, convergence_interval=1, reciprocity=True)
    ps = raystrack_tpu_torch.PreparedSolver(meshes)
    with monkeypatch.context() as m:
        m.setattr(sharding, "trace_chunk_sharded", seen)
        m.setattr(tracing, "_device_work", {})  # the counters' buffer: made inside the drive
        with profile(activities=[ProfilerActivity.CPU]):
            before = tracing.counts()
            got = raystrack_tpu_torch.view_factor_matrix(meshes, params, prepared=ps)
            moved = tracing.since(before)
    assert ps.get_scene_pack(use_accel=True, device=streams[0].device).slim
    return got, moved, streams


def _one_stream(monkeypatch):
    """Every slot on the caller's current stream."""
    import raystrack_tpu_torch.solver as solver

    monkeypatch.setattr(solver, "_side_stream",
                        lambda device, slot: torch.cuda.current_stream(device))


@pytest.mark.parametrize("seed", [3, 1956475827, 2**31 + 5])
def test_slot_streams_give_the_one_stream_dicts_on_a_slim_city(card, slot_city, monkeypatch,
                                                               seed):
    """Four buildings of the 2M slim city, swept in code mode behind the
    two-level gate: the dicts and every work counter with the slots'
    streams == with every chunk on the current stream, bit for bit. The
    chunks rotate over slots 0, 1, 2, slot 0 the caller's current stream
    and 1 and 2 a side stream each; all but the first overlap."""
    caller = torch.cuda.current_stream(card)
    before = (sweep_rays.code_launches, sweep_rays.gated_launches)
    got, moved, streams = _slot_solve(slot_city, seed, monkeypatch)
    assert (sweep_rays.code_launches - before[0], sweep_rays.gated_launches - before[1]) == (
        SLOT_CHUNKS, SLOT_CHUNKS)
    assert len(streams) == SLOT_CHUNKS and len(set(streams)) == 3
    assert [s == caller for s in streams] == [i % 3 == 0 for i in range(SLOT_CHUNKS)]
    assert streams[1] == streams[4] != streams[2] == streams[5]
    assert (moved["chunks_dispatched"], moved["chunks_overlapped"]) == (SLOT_CHUNKS,
                                                                       SLOT_CHUNKS - 1)
    _one_stream(monkeypatch)
    want, moved_one, streams_one = _slot_solve(slot_city, seed, monkeypatch)
    assert set(streams_one) == {caller}
    assert got == want and moved == moved_one
    assert sum(len(row) for row in got.values()) >= len(SLOT_ANCHORS)


def test_slot_streams_with_tables_built_inside_the_drive(card, slot_city, halton_clean,
                                                         monkeypatch):
    """Each emitter's pack left lazy and the Halton tables' caches empty, so
    the first chunk builds the buildings' shared Halton tables on the card
    inside the drive (on slot 0) and the chunks on slots 1 and 2 read them,
    as they add to a counters' buffer the drive made: the dicts and the
    counters == with every chunk on the current stream, and == the solve
    whose packs were built before the drive."""
    import raystrack_tpu_torch.solver as solver

    seed = 2200000020
    eager, moved_eager, _ = _slot_solve(slot_city, seed, monkeypatch)
    monkeypatch.setenv(tconfig.DEVICE_HALTON_ENV, "1")
    real_run = solver._emitter_run
    monkeypatch.setattr(solver, "_emitter_run",
                        lambda *a, **k: real_run(*a, **{**k, "lazy": True}))
    builds = []
    real_dims = halton_clean._halton_dim_device
    monkeypatch.setattr(halton_clean, "_halton_dim_device",
                        lambda *a: builds.append(a[:2]) or real_dims(*a))
    got, moved, streams = _slot_solve(slot_city, seed, monkeypatch)
    assert builds and len(set(streams)) == 3  # built in the drive, read on three streams
    halton_clean.cached_halton_dims.cache_clear()
    halton_clean.cached_halton.cache_clear()
    del builds[:]
    _one_stream(monkeypatch)
    want, moved_one, _ = _slot_solve(slot_city, seed, monkeypatch)
    assert builds
    assert got == want == eager and moved == moved_one == moved_eager
