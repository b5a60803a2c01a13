"""Möller–Trumbore sweeps of rays against all triangles: the CUDA kernels'
wrappers, their plain PyTorch versions, and the operand pack they consume.

Counterpart of ``raystrack_tpu/ops/trace_pallas.py``: ``sweep_rays``
(kernel #1, one emitter), ``sweep_rays_scheduled`` (kernel #2, each block
of 256 rays names its own emitter) and their shared tile math
``_tile_step``. Both kernels live in ``csrc/sweep.cu``.

Layouts:

- rays ``(9, N)`` f32 rows ``[o | d | o x d]``,
- pack ``(24, Tpad)`` f32 rows: 0-2 cross_e, 3-5 e1, 6-8 e2, 9-11 v0 x e2,
  12-14 v0 x e1, 15 d0 = v0 . cross_e, 16 code_base = 2*sid, 17 mask_any,
  18 mask_mat, 19-23 zero,
- kernel #2's combined mask rows ``(E, Tpad)`` f32 ``m_any + m_mat`` in
  {0, 1, 2} (any-hit eligible if > 0, matrix eligible if > 1) and its
  ``emap`` ``(N / 256,)`` int32, the emitter row of each block of rays,
- outputs ``(N,)`` int32: the nearest eligible hit packed as
  ``2*sid + front`` (-1 on a miss), and a 0/1 any-hit flag.

Per-pair math and epsilons: ``|det| >= 1e-7``, ``t > 1e-6``,
``front = det > 0``. The nearest-hit fold runs over tiles of
``sweep_tile_width(Tpad, tri_tile)`` triangles: inside a tile the smallest
code wins among the triangles at the tile's minimum ``t``; across tiles only
a strictly smaller ``t`` replaces the carry. Tiles with no eligible triangle
(per emitter, for kernel #2) are skipped whole.
"""
from __future__ import annotations

from typing import Tuple

import torch

INF = 1.0e20
TRI_ROWS = 24  # 19 used; the pack keeps the JAX package's row count

ROW_CE = 0
ROW_E1 = 3
ROW_E2 = 6
ROW_WU = 9
ROW_WV = 12
ROW_D0 = 15
ROW_CODE = 16
ROW_MASK_ANY = 17
ROW_MASK_MAT = 18

# Triangles per shared-memory stage of the kernel (csrc/sweep.cu kStage);
# every sweep tile width is a multiple of it.
_STAGE = 128

# Rays per block of kernel #2 (csrc/sweep.cu kThreads): emap names one
# emitter per block of this many rays, as the JAX package's ray_block.
RAY_SUBBLOCK = 256

# (B, T) pair elements per step of the plain version: bounds its memory.
_REF_PAIRS = 1 << 22


def sweep_tile_width(n_tri_pad: int, tri_tile: int) -> int:
    """The tile width the sweep uses: the requested width halved until it
    divides the padded triangle count."""
    tile = min(tri_tile, n_tri_pad)
    while tile > 128 and n_tri_pad % tile != 0:
        tile //= 2
    return tile


def build_tri_pack(scene: Tuple, m_any, m_mat, *, bake=None) -> torch.Tensor:
    """Assemble the (24, Tpad) f32 operand pack for one dispatch.

    ``scene`` is ``(v0, e1, e2, cross_e, w_u, w_v, d0, sid)``; ``m_any`` and
    ``m_mat`` are per-triangle bool masks. Padded triangles carry
    cross_e = 0, so det = 0 rejects them without any mask.

    With ``bake`` (a per-triangle bool mask) the cross_e rows of ineligible
    triangles are zeroed, so det = 0 rejects them like padding and the
    sweep can skip its per-pair test of that mask. Baking is result-exact.
    """
    v0, e1, e2, cross_e, w_u, w_v, d0, sid = scene
    if bake is not None:
        cross_e = torch.where(bake[:, None], cross_e, torch.zeros_like(cross_e))
    n = v0.shape[0]
    pack = torch.zeros((TRI_ROWS, n), dtype=torch.float32, device=v0.device)
    pack[ROW_CE:ROW_CE + 3] = cross_e.T
    pack[ROW_E1:ROW_E1 + 3] = e1.T
    pack[ROW_E2:ROW_E2 + 3] = e2.T
    pack[ROW_WU:ROW_WU + 3] = w_u.T
    pack[ROW_WV:ROW_WV + 3] = w_v.T
    pack[ROW_D0] = d0
    pack[ROW_CODE] = (sid * 2).to(torch.float32)
    pack[ROW_MASK_ANY] = m_any.to(torch.float32)
    pack[ROW_MASK_MAT] = m_mat.to(torch.float32)
    return pack


def _mask_tests(want_any: bool, masks_baked: bool) -> Tuple[bool, bool]:
    """Which per-pair mask-row tests the plain version runs: a baked pack
    folds the primary mask (m_any when any-hits are wanted, else m_mat)
    into zeroed cross_e rows, so only the secondary m_mat test remains, and
    only when both outputs are wanted. The kernel derives the same two
    tests from its template flags."""
    test_any = not masks_baked
    test_mat = not (masks_baked and not want_any)
    return test_any, test_mat


def sweep_rays_reference(
    rays: torch.Tensor,
    tri_pack: torch.Tensor,
    tiles_on: torch.Tensor,
    tile: int,
    *,
    want_matrix: bool,
    want_any: bool,
    masks_baked: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sweep kernel: ``_tile_step`` in tensor
    ops, looped over triangle tiles of width ``tile`` (skipping tiles whose
    ``tiles_on`` flag is 0) and over ray chunks that bound its memory.

    Each product and sum rounds separately and ``t = t_num / det`` is an
    IEEE division, as in the kernel, so the two agree bitwise.
    """
    n = rays.shape[1]
    test_any, test_mat = _mask_tests(want_any, masks_baked)
    device = rays.device
    codes = torch.full((n,), -1, dtype=torch.int32, device=device)
    any_out = torch.zeros((n,), dtype=torch.int32, device=device)
    active = [i for i, on in enumerate(tiles_on.tolist()) if on]
    chunk = max(1, _REF_PAIRS // tile)
    for r0 in range(0, n, chunk):
        ox, oy, oz, dx, dy, dz, cx, cy, cz = (
            rays[j, r0 : r0 + chunk, None] for j in range(9)
        )
        b = ox.shape[0]
        best_t = torch.full((b, 1), INF, dtype=torch.float32, device=device)
        best_code = torch.full((b, 1), -1, dtype=torch.int32, device=device)
        any_hit = torch.zeros((b, 1), dtype=torch.bool, device=device)
        for i in active:
            tri = tri_pack[:, i * tile : (i + 1) * tile]
            row = lambda r: tri[r : r + 1]  # noqa: E731 - (1, T) operand row
            ce_x, ce_y, ce_z = row(ROW_CE), row(ROW_CE + 1), row(ROW_CE + 2)
            det = -(dx * ce_x + dy * ce_y + dz * ce_z)
            t_num = ox * ce_x + oy * ce_y + oz * ce_z - row(ROW_D0)
            u_num = (
                cx * row(ROW_E2) + cy * row(ROW_E2 + 1) + cz * row(ROW_E2 + 2)
                + dx * row(ROW_WU) + dy * row(ROW_WU + 1) + dz * row(ROW_WU + 2)
            )
            v_num = -(
                cx * row(ROW_E1) + cy * row(ROW_E1 + 1) + cz * row(ROW_E1 + 2)
                + dx * row(ROW_WV) + dy * row(ROW_WV + 1) + dz * row(ROW_WV + 2)
            )
            sign = torch.where(det >= 0.0, 1.0, -1.0)
            abs_det = det * sign
            un = u_num * sign
            vn = v_num * sign
            t_hit = t_num / det
            margin = torch.minimum(
                torch.minimum(abs_det - 1e-7, un),
                torch.minimum(vn, abs_det - (un + vn)),
            )
            valid = (margin >= 0.0) & (t_hit > 1e-6)
            if want_any:
                blocked = valid & (row(ROW_MASK_ANY) > 0.0) if test_any else valid
                any_hit |= blocked.any(dim=1, keepdim=True)
            if want_matrix:
                mat_ok = valid & (row(ROW_MASK_MAT) > 0.0) if test_mat else valid
                t_masked = torch.where(mat_ok, t_hit, INF)
                tile_best = t_masked.amin(dim=1, keepdim=True)
                code_all = row(ROW_CODE).to(torch.int32) + (det > 0.0).to(torch.int32)
                code = torch.where(t_masked == tile_best, code_all, 2**30).amin(
                    dim=1, keepdim=True
                )
                take = tile_best < best_t
                best_t = torch.where(take, tile_best, best_t)
                best_code = torch.where(take, code, best_code)
        codes[r0 : r0 + b] = torch.where(best_t < INF, best_code, -1)[:, 0]
        any_out[r0 : r0 + b] = any_hit[:, 0].to(torch.int32)
    return codes, any_out


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} (got {t.dtype})")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape} (got {tuple(t.shape)})")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, rays are on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(rays, tri_pack, want_matrix: bool, want_any: bool,
                  tri_tile: int, name: str, **others) -> Tuple[torch.device, int, int, int]:
    """Checks both wrappers share; returns (device, N, Tpad, tile)."""
    if not (want_matrix or want_any):
        raise ValueError(f"{name} needs want_matrix or want_any")
    for arg, t in (("rays", rays), ("tri_pack", tri_pack), *others.items()):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{arg} must be a torch.Tensor")
    if rays.dim() != 2 or tri_pack.dim() != 2:
        raise ValueError("rays must be (9, N) and tri_pack (24, Tpad)")
    device = rays.device
    n, n_tri_pad = int(rays.shape[1]), int(tri_pack.shape[1])
    _check("rays", rays, torch.float32, (9, n), device)
    _check("tri_pack", tri_pack, torch.float32, (TRI_ROWS, n_tri_pad), device)
    tile = sweep_tile_width(n_tri_pad, tri_tile)
    if n_tri_pad == 0 or tile % _STAGE or n_tri_pad % tile:
        raise ValueError(
            f"sweep tile {tile} (from tri_tile={tri_tile}) must be a multiple of "
            f"{_STAGE} dividing the pack width {n_tri_pad}"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors (got {device})")
    if n >= 2**31 or n_tri_pad >= 2**31:
        raise ValueError(f"{name} takes fewer than 2**31 rays and triangles")
    return device, n, n_tri_pad, tile


def sweep_rays(
    rays: torch.Tensor,  # (9, N) f32: [o | d | o x d] rows
    tri_pack: torch.Tensor,  # (24, Tpad) f32
    sweep_mask: torch.Tensor,  # (Tpad,) bool: triangles this sweep may touch
    *,
    tri_tile: int,
    want_matrix: bool,
    want_any: bool,
    masks_baked: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sweep all rays against all triangles; returns (codes (N,), any (N,)).

    ``masks_baked`` promises the pack was built with :func:`build_tri_pack`'s
    ``bake`` option, letting the sweep drop per-pair tests of that mask.

    CUDA tensors go to the kernel of ``csrc/sweep.cu`` (launched on the
    current stream, not synchronised; ``sweep_rays.launches`` counts the
    launches); CPU tensors go to :func:`sweep_rays_reference`.
    """
    device, n, n_tri_pad, tile = _check_common(
        rays, tri_pack, want_matrix, want_any, tri_tile, "sweep_rays",
        sweep_mask=sweep_mask,
    )
    _check("sweep_mask", sweep_mask, torch.bool, (n_tri_pad,), device)
    tiles_on = sweep_mask.reshape(-1, tile).any(dim=1).to(torch.int32)

    if device.type == "cpu":
        return sweep_rays_reference(
            rays, tri_pack, tiles_on, tile, want_matrix=want_matrix,
            want_any=want_any, masks_baked=masks_baked,
        )

    from .build import load_library

    lib = load_library()
    codes = torch.empty((n,), dtype=torch.int32, device=device)
    any_hit = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:  # nothing to launch
        return codes, any_hit
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.raystrack_sweep_rays(
            rays.data_ptr(), n, tri_pack.data_ptr(), n_tri_pad,
            tiles_on.data_ptr(), tile,
            int(want_matrix), int(want_any), int(masks_baked),
            codes.data_ptr(), any_hit.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
    sweep_rays.launches += 1
    return codes, any_hit


sweep_rays.launches = 0


def scheduled_tiles_on(masks: torch.Tensor, tile: int, *, want_matrix: bool,
                       want_any: bool) -> torch.Tensor:
    """(E, n_tiles) int32 per-emitter tile activity of kernel #2: a tile is
    on for emitter e when its row holds a triangle eligible for what the
    sweep computes (> 1 for matrix only, > 0 when any-hits are wanted)."""
    thresh = 1.0 if (want_matrix and not want_any) else 0.0
    n_emit, n_tri_pad = masks.shape
    return (masks.view(n_emit, n_tri_pad // tile, tile) > thresh).any(dim=2).to(torch.int32)


def sweep_rays_scheduled_reference(
    rays: torch.Tensor,
    tri_pack: torch.Tensor,
    masks: torch.Tensor,
    emap: torch.Tensor,
    tiles_on: torch.Tensor,
    tile: int,
    *,
    want_matrix: bool,
    want_any: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #2: per emitter row named in
    ``emap``, its blocks of rays are swept by :func:`sweep_rays_reference`
    (the same pair math and tie rule) against the pack with that emitter's
    combined row written into the mask rows (``> 0`` any, ``> 1`` matrix)
    and that emitter's row of ``tiles_on``. A block whose row lies outside
    ``0..E-1`` sweeps nothing (-1 and 0), as in the kernel."""
    n = rays.shape[1]
    codes = torch.full((n,), -1, dtype=torch.int32, device=rays.device)
    any_out = torch.zeros((n,), dtype=torch.int32, device=rays.device)
    ray_emitter = emap.repeat_interleave(RAY_SUBBLOCK)
    for e in torch.unique(emap).tolist():
        if not 0 <= e < masks.shape[0]:
            continue
        idx = torch.nonzero(ray_emitter == e).squeeze(1)
        pack = tri_pack.clone()
        pack[ROW_MASK_ANY] = (masks[e] > 0.0).to(torch.float32)
        pack[ROW_MASK_MAT] = (masks[e] > 1.0).to(torch.float32)
        c, a = sweep_rays_reference(
            rays.index_select(1, idx).contiguous(), pack, tiles_on[e], tile,
            want_matrix=want_matrix, want_any=want_any, masks_baked=False,
        )
        codes[idx] = c
        any_out[idx] = a
    return codes, any_out


def sweep_rays_scheduled(
    rays: torch.Tensor,  # (9, N) f32: [o | d | o x d] rows, N = 256 * n_blocks
    tri_pack: torch.Tensor,  # (24, Tpad) f32; its mask rows are not read
    masks: torch.Tensor,  # (E, Tpad) f32 combined rows m_any + m_mat
    emap: torch.Tensor,  # (N / 256,) i32: block of 256 rays -> emitter row
    *,
    tri_tile: int,
    want_matrix: bool,
    want_any: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-emitter sweep; returns (codes (N,), any (N,)).

    Each block of 256 rays is swept for the emitter row ``emap`` names:
    its eligibility comes from that row of ``masks`` and whole tiles with
    no eligible triangle for that emitter are skipped. Per ray the result
    equals :func:`sweep_rays` with that emitter's masks. A block whose row
    lies outside ``0..E-1`` sweeps nothing (codes -1, any 0): reading
    ``emap`` on the host would wait for the card.

    CUDA tensors go to kernel #2 of ``csrc/sweep.cu`` (launched on the
    current stream, not synchronised; ``sweep_rays_scheduled.launches``
    counts the launches); CPU tensors go to
    :func:`sweep_rays_scheduled_reference`.
    """
    device, n, n_tri_pad, tile = _check_common(
        rays, tri_pack, want_matrix, want_any, tri_tile, "sweep_rays_scheduled",
        masks=masks, emap=emap,
    )
    if masks.dim() != 2 or emap.dim() != 1:
        raise ValueError("masks must be (E, Tpad) and emap (N / 256,)")
    n_emit = int(masks.shape[0])
    _check("masks", masks, torch.float32, (n_emit, n_tri_pad), device)
    if n % RAY_SUBBLOCK:
        raise ValueError(f"sweep_rays_scheduled takes a multiple of {RAY_SUBBLOCK} rays")
    _check("emap", emap, torch.int32, (n // RAY_SUBBLOCK,), device)
    tiles_on = scheduled_tiles_on(masks, tile, want_matrix=want_matrix, want_any=want_any)

    if device.type == "cpu":
        return sweep_rays_scheduled_reference(
            rays, tri_pack, masks, emap, tiles_on, tile,
            want_matrix=want_matrix, want_any=want_any,
        )

    from .build import load_library

    lib = load_library()
    codes = torch.empty((n,), dtype=torch.int32, device=device)
    any_hit = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:  # nothing to launch
        return codes, any_hit
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.raystrack_sweep_rays_scheduled(
            rays.data_ptr(), n, tri_pack.data_ptr(), n_tri_pad,
            masks.data_ptr(), n_emit, emap.data_ptr(), tiles_on.data_ptr(), tile,
            int(want_matrix), int(want_any),
            codes.data_ptr(), any_hit.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"scheduled sweep kernel launch failed: CUDA error {err}")
    sweep_rays_scheduled.launches += 1
    return codes, any_hit


sweep_rays_scheduled.launches = 0

__all__ = [
    "build_tri_pack", "sweep_rays", "sweep_rays_reference", "sweep_rays_scheduled",
    "sweep_rays_scheduled_reference", "scheduled_tiles_on", "sweep_tile_width",
    "RAY_SUBBLOCK", "TRI_ROWS",
]
