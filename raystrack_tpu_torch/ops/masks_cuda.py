"""A scheduled round's (E, Tpad) mask rows: the CUDA kernel's wrapper.

The kernel lives in ``csrc/masks.cu``: one launch reads each triangle's
v0, e1, e2 and sid once and writes its E rows' entries, each ``m_any +
m_mat`` in {0, 1, 2} with a planar emitter's plane cull folded in. Its
plain version is ``ops/trace.py`` ``combined_masks_reference``, which the
CPU takes; :func:`ops.trace.combined_masks` picks between the two.
"""
from __future__ import annotations

from typing import Tuple

import torch


def check_mask_args(scene: Tuple, surf_active_ext, emit_sid, min_sid,
                    plane_vec) -> torch.device:
    """The checks of the mask rows' arguments (``combined_masks``): the
    scene's v0, e1, e2 (Tpad, 3) f32 and sid (Tpad,) int32,
    ``surf_active_ext`` (E, S+1) int32, ``emit_sid``/``min_sid`` (E,) int32
    and ``plane_vec`` (E, 8) f32, all contiguous on one cpu or cuda device.
    Returns that device."""
    v0, e1, e2, sid = scene[0], scene[1], scene[2], scene[7]
    named = (("v0", v0), ("e1", e1), ("e2", e2), ("sid", sid),
             ("surf_active_ext", surf_active_ext), ("emit_sid", emit_sid),
             ("min_sid", min_sid), ("plane_vec", plane_vec))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if sid.dim() != 1 or surf_active_ext.dim() != 2 or surf_active_ext.shape[1] < 1:
        raise ValueError(f"sid must be (Tpad,) and surf_active_ext (E, S+1) (got "
                         f"{tuple(sid.shape)} and {tuple(surf_active_ext.shape)})")
    n_tri, n_emit = sid.shape[0], surf_active_ext.shape[0]
    device = sid.device
    want = {"v0": (torch.float32, (n_tri, 3)), "e1": (torch.float32, (n_tri, 3)),
            "e2": (torch.float32, (n_tri, 3)), "sid": (torch.int32, (n_tri,)),
            "surf_active_ext": (torch.int32, tuple(surf_active_ext.shape)),
            "emit_sid": (torch.int32, (n_emit,)), "min_sid": (torch.int32, (n_emit,)),
            "plane_vec": (torch.float32, (n_emit, 8))}
    for name, t in named:
        dtype, shape = want[name]
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} (got {t.dtype})")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape} (got {tuple(t.shape)})")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, sid is on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the mask rows are built on cuda or cpu tensors (got {device})")
    if n_tri >= 2**31 or n_emit >= 2**31 or surf_active_ext.shape[1] >= 2**31:
        raise ValueError("the mask rows take fewer than 2**31 triangles, rows and columns")
    return device


def mask_rows(scene: Tuple, surf_active_ext, emit_sid, min_sid, plane_vec) -> torch.Tensor:
    """The (E, Tpad) f32 rows of ``combined_masks_reference`` from the
    kernel of ``csrc/masks.cu``, bitwise, on CUDA tensors (checked as
    :func:`check_mask_args` says): one launch on the current stream, not
    synchronised; ``mask_rows.launches`` counts them."""
    device = check_mask_args(scene, surf_active_ext, emit_sid, min_sid, plane_vec)
    if device.type != "cuda":
        raise ValueError(f"mask_rows runs on cuda tensors (got {device}); "
                         "combined_masks takes the plain version on the cpu")
    from .build import load_library

    lib = load_library()
    v0, e1, e2, sid = scene[0], scene[1], scene[2], scene[7]
    n_emit, n_cols = surf_active_ext.shape
    n_tri = sid.shape[0]
    out = torch.empty((n_emit, n_tri), dtype=torch.float32, device=device)
    if n_emit == 0 or n_tri == 0:  # nothing to launch
        return out
    args = (v0.data_ptr(), e1.data_ptr(), e2.data_ptr(), sid.data_ptr(),
            surf_active_ext.data_ptr(), n_cols, emit_sid.data_ptr(), min_sid.data_ptr(),
            plane_vec.data_ptr(), n_emit, n_tri, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = lib.raystrack_mask_rows(*args)
    if err != 0:
        raise RuntimeError(f"mask rows kernel launch failed: CUDA error {err}")
    mask_rows.launches += 1
    return out


mask_rows.launches = 0


__all__ = ["check_mask_args", "mask_rows"]
