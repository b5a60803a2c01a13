"""Exact per-row hit counts of the sweeps' codes: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of the JAX package's per-code compare-and-sum
(``raystrack_tpu/ops/trace.py`` ``count_code``). The kernel lives in
``csrc/count.cu``: one launch that writes every count, bins in shared
memory, a row per CTA or, for longer rows, per group of CTAs that meet in a
work buffer the kernel leaves zero.
Both routes count with it: rows are iterations on the per-emitter route and
schedule rows on the scheduled route.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# (rows, codes, L) compare elements per step of the plain version: bounds its memory.
_COUNT_ELEMS = 1 << 27


def count_codes_reference(codes: torch.Tensor, n_valid: Optional[torch.Tensor],
                          n_surf: int, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the count kernel: (rows, 2*n_surf) int32 counts.

    Ray i of a row counts when i < its ``n_valid`` (every ray when
    ``n_valid`` is None) and ``valid[row, i]`` (every ray when ``valid`` is
    None). Each row's codes are compared with every code 0..2*n_surf-1 at
    once and summed along the ray axis, in row steps that bound the (rows,
    codes, L) compare to ``_COUNT_ELEMS`` elements. Rays that do not count,
    misses and codes outside that range count nowhere.
    """
    rows, length = codes.shape
    n_codes = 2 * n_surf
    if n_valid is not None:
        ray = torch.arange(length, dtype=n_valid.dtype, device=codes.device)
        keep = ray[None, :] < n_valid[:, None]
        valid = keep if valid is None else keep & valid
    if valid is not None:
        codes = torch.where(valid, codes, -1)
    targets = torch.arange(n_codes, dtype=codes.dtype, device=codes.device)[None, :, None]
    step = max(1, _COUNT_ELEMS // max(1, n_codes * length))
    parts = [
        (codes[r0 : r0 + step, None, :] == targets).sum(dim=2, dtype=torch.int32)
        for r0 in range(0, rows, step)
    ]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


# (C entry, most codes a row's counts are written whole for, codes a CTA
# counts), at first use
_ENTRY = None
# (device index, stream) -> the kernel's work buffer: int32, zero between launches
_WORK = {}


def _entry():
    global _ENTRY
    if _ENTRY is None:
        from .build import load_library

        lib = load_library()
        _ENTRY = (lib.raystrack_count_codes, int(lib.raystrack_count_smem_bins()),
                  int(lib.raystrack_count_per_cta()))
    return _ENTRY


def _work(device: torch.device, stream: int, n_ints: int) -> torch.Tensor:
    """The kernel's work buffer for launches on ``stream``: zeroed when it is
    allocated (or grown), and left zero by every launch, so one buffer a
    stream serves every call. Launches on one stream never overlap."""
    key = (device.index, stream)
    work = _WORK.get(key)
    if work is None or work.numel() < n_ints:
        work = _WORK[key] = torch.zeros(n_ints, dtype=torch.int32, device=device)
    return work


def count_codes(codes: torch.Tensor, n_valid: Optional[torch.Tensor], n_surf: int, *,
                valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row front/back hit counts: codes (rows, L) int32 ``2*sid + front``
    (-1 on a miss) -> ``(counts_f, counts_b)`` (rows, n_surf) int32.

    Ray i of a row counts when i < its ``n_valid`` ((rows,) int32, the
    number of leading rays of each row that count; None: all of them) and
    ``valid[row, i]`` ((rows, L) bool, after a coherence sort has moved the
    real rays; None: all of them). Exact: rays that do not count, misses and
    codes outside 0..2*n_surf-1 count nowhere. CUDA tensors go to the
    kernel of ``csrc/count.cu`` (one launch on the current stream, not
    synchronised, and no zero-fill unless a row has more codes than the
    kernel's shared bins, or the stream's work buffer is allocated or grown;
    ``count_codes.launches`` counts the launches); CPU tensors go to
    :func:`count_codes_reference`.
    """
    if not isinstance(codes, torch.Tensor):
        raise TypeError("codes must be a torch.Tensor")
    if codes.dtype != torch.int32:
        raise TypeError(f"codes must be torch.int32 (got {codes.dtype})")
    if codes.dim() != 2:
        raise ValueError(f"codes must be (rows, L) (got {tuple(codes.shape)})")
    for name, t, dtype, shape in (("n_valid", n_valid, torch.int32, codes.shape[:1]),
                                  ("valid", valid, torch.bool, codes.shape)):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor or None")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} (got {t.dtype})")
        if t.shape != shape:
            raise ValueError(f"codes must be (rows, L) and {name} {tuple(shape)} "
                             f"(got {tuple(codes.shape)} and {tuple(t.shape)})")
        if t.device != codes.device:
            raise ValueError(f"{name} is on {t.device}, codes are on {codes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    device = codes.device
    rows, length = codes.shape
    n_codes = 2 * int(n_surf)
    if device.type == "cpu":
        counts = count_codes_reference(codes, n_valid, n_surf, valid)
    elif device.type == "cuda":
        if rows * length >= 2**31 or n_codes >= 2**31:
            raise ValueError("count_codes takes fewer than 2**31 codes and bins")
        fn, smem_bins, per_cta = _entry()
        stream = torch.cuda.current_stream(device).cuda_stream
        work = None
        if n_codes > smem_bins:  # global bins: the kernel adds, so they start at zero
            counts = torch.zeros((rows, n_codes), dtype=torch.int32, device=device)
        else:  # every count written by the kernel
            counts = torch.empty((rows, n_codes), dtype=torch.int32, device=device)
            if length > per_cta:  # a row's CTAs meet in the work buffer
                work = _work(device, stream, rows * (n_codes + 1)).data_ptr()
        args = (codes.data_ptr(), n_valid.data_ptr() if n_valid is not None else None,
                valid.data_ptr() if valid is not None else None, rows, length, n_codes,
                counts.data_ptr(), work, stream)
        if device.index == torch.cuda.current_device():
            err = fn(*args)
        else:
            with torch.cuda.device(device):
                err = fn(*args)
        if err != 0:
            raise RuntimeError(f"count kernel launch failed: CUDA error {err}")
        count_codes.launches += 1
    else:
        raise ValueError(f"count_codes runs on cuda or cpu tensors (got {device})")
    counts = counts.view(rows, n_surf, 2)
    return counts[:, :, 1], counts[:, :, 0]


count_codes.launches = 0

__all__ = ["count_codes", "count_codes_reference"]
