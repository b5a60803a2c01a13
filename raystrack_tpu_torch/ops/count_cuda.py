"""Exact per-row hit counts of the sweeps' codes: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of the JAX package's per-code compare-and-sum
(``raystrack_tpu/ops/trace.py`` ``count_code``). The kernel lives in
``csrc/count.cu``: per-block bins in shared memory, one global add per
(block, bin). Both routes count with it: rows are iterations on the
per-emitter route and schedule rows on the scheduled route.
"""
from __future__ import annotations

from typing import Tuple

import torch

# (rows, codes, L) compare elements per step of the plain version: bounds its memory.
_COUNT_ELEMS = 1 << 27


def count_codes_reference(codes: torch.Tensor, n_valid: torch.Tensor,
                          n_surf: int) -> torch.Tensor:
    """Plain version of the count kernel: (rows, 2*n_surf) int32 counts.

    Each row's codes are compared with every code 0..2*n_surf-1 at once and
    summed along the ray axis, in row steps that bound the (rows, codes, L)
    compare to ``_COUNT_ELEMS`` elements. Rays past a row's ``n_valid``,
    misses and codes outside that range count nowhere.
    """
    rows, length = codes.shape
    n_codes = 2 * n_surf
    ray = torch.arange(length, dtype=n_valid.dtype, device=codes.device)
    codes = torch.where(ray[None, :] < n_valid[:, None], codes, -1)
    targets = torch.arange(n_codes, dtype=codes.dtype, device=codes.device)[None, :, None]
    step = max(1, _COUNT_ELEMS // max(1, n_codes * length))
    parts = [
        (codes[r0 : r0 + step, None, :] == targets).sum(dim=2, dtype=torch.int32)
        for r0 in range(0, rows, step)
    ]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def count_codes(codes: torch.Tensor, n_valid: torch.Tensor,
                n_surf: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row front/back hit counts: codes (rows, L) int32 ``2*sid + front``
    (-1 on a miss) and n_valid (rows,) int32, the number of leading rays of
    each row that count -> ``(counts_f, counts_b)`` (rows, n_surf) int32.

    Exact: padded rays, misses and codes outside 0..2*n_surf-1 count
    nowhere. CUDA tensors go to the kernel of ``csrc/count.cu`` (launched on
    the current stream, not synchronised; ``count_codes.launches`` counts
    the launches); CPU tensors go to :func:`count_codes_reference`.
    """
    for name, t in (("codes", codes), ("n_valid", n_valid)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32 (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.dim() != 2 or tuple(n_valid.shape) != (codes.shape[0],):
        raise ValueError(
            f"codes must be (rows, L) and n_valid (rows,) "
            f"(got {tuple(codes.shape)} and {tuple(n_valid.shape)})")
    if n_valid.device != codes.device:
        raise ValueError(f"n_valid is on {n_valid.device}, codes are on {codes.device}")
    device = codes.device
    rows, length = (int(s) for s in codes.shape)
    n_codes = 2 * int(n_surf)
    if device.type == "cpu":
        counts = count_codes_reference(codes, n_valid, n_surf)
    elif device.type == "cuda":
        if rows * length >= 2**31 or n_codes >= 2**31:
            raise ValueError("count_codes takes fewer than 2**31 codes and bins")
        from .build import load_library

        lib = load_library()
        counts = torch.zeros((rows, n_codes), dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.raystrack_count_codes(
                codes.data_ptr(), n_valid.data_ptr(), rows, length, n_codes,
                counts.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"count kernel launch failed: CUDA error {err}")
        count_codes.launches += 1
    else:
        raise ValueError(f"count_codes runs on cuda or cpu tensors (got {device})")
    counts = counts.view(rows, n_surf, 2)
    return counts[:, :, 1], counts[:, :, 0]


count_codes.launches = 0

__all__ = ["count_codes", "count_codes_reference"]
