"""Card tests of the port: the CUDA sweep kernel against its plain PyTorch
version at shapes the CPU tests cannot reach (ragged ray counts, narrow and
whole-scene tiles, skipped tiles, exact distance ties), and a solve on the
card against the same solve on the CPU.

They need one CUDA card and skip without one. On such a machine:

    python -m pytest --noconftest -m card tests/test_torch_card.py -q

(``--noconftest``: the suite's conftest configures JAX, which these tests
do not use.)
"""
import numpy as np
import pytest
import torch

import raystrack_tpu_torch
from raystrack_tpu_torch.ops.trace import compute_masks
from raystrack_tpu_torch.ops.trace_cuda import (
    build_tri_pack, sweep_rays, sweep_rays_reference, sweep_tile_width,
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
    directions an ulp apart from the CPU's, moving a few edge rays."""
    meshes = [("bottom", *_square(0.0, False)), ("top", *_square(1.0, True))]
    kw = dict(samples=32, rays=1024, seed=11, min_iters=8, max_iters=8, reciprocity=False)
    before = sweep_rays.launches
    got = raystrack_tpu_torch.view_factor_matrix(
        meshes, raystrack_tpu_torch.MatrixParams(device="gpu", **kw))
    assert sweep_rays.launches > before
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
