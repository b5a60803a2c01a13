"""Card tests of the port: the CUDA sweep kernels against their plain
PyTorch versions at shapes the CPU tests cannot reach (ragged ray counts,
narrow and whole-scene tiles, skipped tiles, exact distance ties, per-emitter
tile activity, an all-masked emitter row), kernel #2 against kernel #1 per
emitter, the count kernel against its plain version and numpy.bincount,
one device key per card, and solves on the card against the CPU and across
the two routes.

They need one CUDA card and skip without one. On such a machine:

    python -m pytest --noconftest -m card tests/test_torch_card.py -q

(``--noconftest``: the suite's conftest configures JAX, which these tests
do not use.)
"""
import numpy as np
import pytest
import torch

import raystrack_tpu_torch
from raystrack_tpu_torch import config as tconfig
from raystrack_tpu_torch.ops.count_cuda import count_codes, count_codes_reference
from raystrack_tpu_torch.ops.trace import compute_masks
from raystrack_tpu_torch.ops.trace_cuda import (
    build_tri_pack, scheduled_tiles_on, sweep_rays, sweep_rays_reference,
    sweep_rays_scheduled, sweep_rays_scheduled_reference, sweep_tile_width,
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


@pytest.mark.parametrize(
    "rows,length,n_surf",
    [(6, 2048, 11), (4, 65536, 2), (3, 5000, 7000)],
    ids=["canyon_rows", "soup_chunk", "global_bins"],
)
def test_count_kernel_equals_plain_version(card, rows, length, n_surf):
    """The count kernel equal (torch.equal) to its plain version and to
    numpy.bincount per row, with misses, out-of-range codes, padded rays
    and rows whose n_valid is 0 or past the row; ``global_bins`` has more
    codes than the kernel's shared-memory bins and counts in global memory."""
    rng = np.random.default_rng(rows + n_surf)
    codes = rng.integers(-3, 2 * n_surf + 3, size=(rows, length)).astype(np.int32)
    codes[:, : length // 2] = rng.integers(0, 4, size=(rows, length // 2))  # hot bins
    n_valid = rng.integers(0, length + 1, size=rows).astype(np.int32)
    n_valid[0], n_valid[-1] = 0, length + 7
    c_t, v_t = torch.from_numpy(codes).to(card), torch.from_numpy(n_valid).to(card)
    before = count_codes.launches
    counts_f, counts_b = count_codes(c_t, v_t, n_surf)
    torch.cuda.synchronize()
    assert count_codes.launches == before + 1
    plain = count_codes_reference(c_t, v_t, n_surf).view(rows, n_surf, 2)
    assert torch.equal(counts_f, plain[:, :, 1]) and torch.equal(counts_b, plain[:, :, 0])
    for r in range(rows):
        row = codes[r, : max(0, min(int(n_valid[r]), length))]
        want = np.bincount(row[(row >= 0) & (row < 2 * n_surf)],
                           minlength=2 * n_surf).reshape(n_surf, 2)
        np.testing.assert_array_equal(counts_b[r].cpu().numpy(), want[:, 0])
        np.testing.assert_array_equal(counts_f[r].cpu().numpy(), want[:, 1])
