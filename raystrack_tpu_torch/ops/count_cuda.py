"""Exact per-row histograms of small integer ids: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of the JAX package's per-value compare-and-sum
(``raystrack_tpu/ops/trace.py`` ``count_code`` and ``count_bin``). The kernel
lives in ``csrc/count.cu``: one launch that writes every count, bins in
shared memory, a row per CTA or, for longer rows, per group of CTAs that
meet in a work buffer the kernel leaves zero. It counts any number of bins,
so it serves three uses on both routes (rows are iterations on the
per-emitter route and schedule rows on the scheduled route):

- the matrix: a ray's nearest-hit code ``2*sid + front`` in ``2*n_surf``
  bins (:func:`count_codes`);
- the discrete sky: a missed ray's Tregenza patch in 145 bins;
- the merged sky: one bin for a missed upward ray.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# (rows, bins, L) compare elements per step of the plain version: bounds its memory.
_COUNT_ELEMS = 1 << 27


def count_bins_reference(ids: torch.Tensor, n_bins: int, n_valid: Optional[torch.Tensor] = None,
                         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the count kernel: (rows, n_bins) int32 counts.

    Entry i of a row counts when i < its ``n_valid`` (every entry when
    ``n_valid`` is None) and ``valid[row, i]`` (every entry when ``valid``
    is None). Each row's ids are compared with every bin 0..n_bins-1 at
    once and summed along the row, in row steps that bound the (rows, bins,
    L) compare to ``_COUNT_ELEMS`` elements. Entries that do not count and
    ids outside that range (a miss is -1) count nowhere.
    """
    rows, length = ids.shape
    if n_valid is not None:
        pos = torch.arange(length, dtype=n_valid.dtype, device=ids.device)
        keep = pos[None, :] < n_valid[:, None]
        valid = keep if valid is None else keep & valid
    if valid is not None:
        ids = torch.where(valid, ids, -1)
    targets = torch.arange(n_bins, dtype=ids.dtype, device=ids.device)[None, :, None]
    step = max(1, _COUNT_ELEMS // max(1, n_bins * length))
    parts = [
        (ids[r0 : r0 + step, None, :] == targets).sum(dim=2, dtype=torch.int32)
        for r0 in range(0, rows, step)
    ]
    if not parts:
        return torch.zeros((0, n_bins), dtype=torch.int32, device=ids.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def count_codes_reference(codes: torch.Tensor, n_valid: Optional[torch.Tensor],
                          n_surf: int, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`count_bins_reference` of nearest-hit codes: (rows, 2*n_surf)
    int32, the back count of surface s at column 2s and its front count at
    2s + 1."""
    return count_bins_reference(codes, 2 * n_surf, n_valid, valid)


# (C entry, most bins a row's counts are written whole for, ids a CTA
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


def _check_rows(ids, n_valid, valid, name: str) -> None:
    """The checks of :func:`count_bins`' arguments, its ids called ``name``."""
    if not isinstance(ids, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if ids.dtype != torch.int32:
        raise TypeError(f"{name} must be torch.int32 (got {ids.dtype})")
    if ids.dim() != 2:
        raise ValueError(f"{name} must be (rows, L) (got {tuple(ids.shape)})")
    for arg, t, dtype, shape in (("n_valid", n_valid, torch.int32, ids.shape[:1]),
                                 ("valid", valid, torch.bool, ids.shape)):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{arg} must be a torch.Tensor or None")
        if t.dtype != dtype:
            raise TypeError(f"{arg} must be {dtype} (got {t.dtype})")
        if t.shape != shape:
            raise ValueError(f"{name} must be (rows, L) and {arg} {tuple(shape)} "
                             f"(got {tuple(ids.shape)} and {tuple(t.shape)})")
        if t.device != ids.device:
            raise ValueError(f"{arg} is on {t.device}, {name} are on {ids.device}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    if not ids.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def count_bins(ids: torch.Tensor, n_bins: int, n_valid: Optional[torch.Tensor] = None, *,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row histogram: ids (rows, L) int32 -> counts (rows, n_bins) int32.

    Entry i of a row counts when i < its ``n_valid`` ((rows,) int32, the
    number of leading entries of each row that count; None: all of them)
    and ``valid[row, i]`` ((rows, L) bool, after a coherence sort has moved
    the real rays; None: all of them). Exact: entries that do not count and
    ids outside 0..n_bins-1 count nowhere. CUDA tensors go to the kernel of
    ``csrc/count.cu`` (one launch on the current stream, not synchronised,
    and no zero-fill unless a row has more bins than the kernel's shared
    bins, or the stream's work buffer is allocated or grown;
    ``count_bins.launches`` counts the launches); CPU tensors go to
    :func:`count_bins_reference`.
    """
    _check_rows(ids, n_valid, valid, "ids")
    n_bins = int(n_bins)
    if n_bins < 0:
        raise ValueError(f"n_bins must not be negative (got {n_bins})")
    device = ids.device
    rows, length = ids.shape
    if device.type == "cpu":
        return count_bins_reference(ids, n_bins, n_valid, valid)
    if device.type != "cuda":
        raise ValueError(f"count_bins runs on cuda or cpu tensors (got {device})")
    if rows * length >= 2**31 or n_bins >= 2**31:
        raise ValueError("count_bins takes fewer than 2**31 ids and bins")
    fn, smem_bins, per_cta = _entry()
    stream = torch.cuda.current_stream(device).cuda_stream
    work = None
    if n_bins > smem_bins:  # global bins: the kernel adds, so they start at zero
        counts = torch.zeros((rows, n_bins), dtype=torch.int32, device=device)
    else:  # every count written by the kernel
        counts = torch.empty((rows, n_bins), dtype=torch.int32, device=device)
        if length > per_cta:  # a row's CTAs meet in the work buffer
            work = _work(device, stream, rows * (n_bins + 1)).data_ptr()
    args = (ids.data_ptr(), n_valid.data_ptr() if n_valid is not None else None,
            valid.data_ptr() if valid is not None else None, rows, length, n_bins,
            counts.data_ptr(), work, stream)
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"count kernel launch failed: CUDA error {err}")
    count_bins.launches += 1
    return counts


count_bins.launches = 0


def count_codes(codes: torch.Tensor, n_valid: Optional[torch.Tensor], n_surf: int, *,
                valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row front/back hit counts: codes (rows, L) int32 ``2*sid + front``
    (-1 on a miss) -> ``(counts_f, counts_b)`` (rows, n_surf) int32 views of
    one :func:`count_bins` over ``2 * n_surf`` bins (its one launch on a
    CUDA tensor, counted in ``count_bins.launches``)."""
    _check_rows(codes, n_valid, valid, "codes")
    counts = count_bins(codes, 2 * int(n_surf), n_valid, valid=valid)
    counts = counts.view(codes.shape[0], int(n_surf), 2)
    return counts[:, :, 1], counts[:, :, 0]


__all__ = ["count_bins", "count_bins_reference", "count_codes", "count_codes_reference"]
