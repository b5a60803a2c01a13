# Copied from raystrack_tpu/ops/halton.py: the host builder, the disk cache and the
# two-part dims cache (host-only NumPy); the device builder is torch.
"""Low-discrepancy Halton tables for QMC emission sampling.

The radical inverse is computed exactly in float64 and stored as float32;
the stratified grid uses bases (2, 3) with ``u=(h2(c+1)+c//g)/g``,
``v=(h3(c+1)+c%g)/g``, and the five per-ray dimensions use bases
(5, 2, 3, 7, 11) starting at index 1. The tables are bitwise equal to the
JAX package's.

Tables of ``config.DEVICE_MIN_LENGTH`` entries or more asked for on a CUDA
device are built on that device and stay there (``_halton_dim_device``:
the int64 digit reversal, the exact float64 division and the float32 cast
in chunks), bitwise equal to the host build. Tables of
``config.DISK_CACHE_MIN_LENGTH`` entries or more are memoized on disk when
``RAYSTRACK_TPU_TABLE_CACHE`` names a directory, under the JAX package's
file names, so either package reads the tables the other wrote.
"""
from __future__ import annotations

import os
from functools import lru_cache
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import config as _cfg

Table = Union[np.ndarray, torch.Tensor]

BASES = (5, 2, 3, 7, 11)


def _digit_count(max_index: int, base: int) -> int:
    """Digits needed to represent every index up to ``max_index`` in ``base``."""
    k, bound = 1, base
    while bound <= max_index:
        k += 1
        bound *= base
    return k


def radical_inverse(indices: np.ndarray, base: int) -> np.ndarray:
    """Vectorized van der Corput radical inverse in the given base (float64).

    The radical inverse of an integer with K base-b digits is the rational
    ``reverse_digits(n) / b**K``. For indices < 2**31 both numerator and
    denominator stay below 2**53, so the single f64 division yields the
    correctly rounded radical inverse.
    """
    idx = np.asarray(indices, dtype=np.int64)
    if idx.size == 0:
        return np.zeros(idx.shape, dtype=np.float64)
    max_index = int(idx.max())
    if max_index >= 1 << 31:
        raise ValueError("radical_inverse supports indices < 2**31")
    k = _digit_count(max_index, base)
    rev = np.zeros(idx.shape, dtype=np.int64)
    remaining = idx.copy()
    for _ in range(k):
        rev = rev * base + remaining % base
        remaining //= base
    # base**k in exact integer arithmetic first: < 2**53, so the float is
    # exact and the division rounds once
    return rev / float(base**k)


def _table_cache_dir() -> Optional[Path]:
    """Optional on-disk cache for large tables (``RAYSTRACK_TPU_TABLE_CACHE``,
    read at each call)."""
    raw = os.environ.get(_cfg.TABLE_CACHE_ENV)
    if not raw:
        return None
    path = Path(raw)
    path.mkdir(parents=True, exist_ok=True)
    return path


def _device_halton_enabled(length: int) -> bool:
    """``RAYSTRACK_TPU_DEVICE_HALTON`` (read at each call): 0/off/false never,
    1/on/true always, else (auto) from ``config.DEVICE_MIN_LENGTH`` entries."""
    raw = os.environ.get(_cfg.DEVICE_HALTON_ENV, "auto").lower()
    if raw in ("0", "off", "false"):
        return False
    if raw in ("1", "on", "true"):
        return True
    return length >= _cfg.DEVICE_MIN_LENGTH


# Entries a chunk of the device builder: its int64 temporaries stay near
# 400 MB whatever the table's length.
DEVICE_CHUNK = 1 << 24


def _radical_inverse_device(first: int, last: int, base: int, k: int,
                            device: torch.device) -> torch.Tensor:
    """``radical_inverse(range(first, last + 1), base)`` in float64 on
    ``device``, for indices of at most ``k`` digits: the int64 digit loop
    runs exactly ``k`` times, and the one division by ``base**k`` is by a
    float64 tensor on the same device (CUDA divides by a CPU scalar as a
    multiply by its reciprocal, which is not correctly rounded). So every
    value is the host's, bit for bit."""
    rem = torch.arange(first, last + 1, dtype=torch.int64, device=device)
    rev = torch.zeros_like(rem)
    for _ in range(k):
        rev.mul_(base).add_(torch.remainder(rem, base))
        rem = torch.div(rem, base, rounding_mode="floor")
    denom = torch.full((1,), float(base**k), dtype=torch.float64, device=device)
    return rev.to(torch.float64).div_(denom)


def _halton_dim_device(length: int, base: int, device) -> torch.Tensor:
    """First ``length`` Halton f32 values in ``base`` (indices 1..length),
    built on ``device`` in chunks of ``DEVICE_CHUNK`` and left there; the
    digit count is the whole table's, as ``radical_inverse`` takes it, so
    the table is bitwise the host build. Errors raise."""
    device = torch.device(device)
    k = _digit_count(length, base)
    blocks = [
        _radical_inverse_device(start + 1, min(start + DEVICE_CHUNK, length), base, k,
                                device).to(torch.float32)
        for start in range(0, length, DEVICE_CHUNK)
    ]
    if not blocks:
        return torch.zeros(0, dtype=torch.float32, device=device)
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks)


def _halton_dim_host(length: int, base: int) -> np.ndarray:
    """First ``length`` Halton values in ``base`` (indices 1..length), f32, on
    the host."""
    return radical_inverse(np.arange(1, length + 1, dtype=np.int64), base).astype(np.float32)


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _halton_dim(length: int, base: int, device=None) -> Table:
    """First ``length`` Halton values in ``base`` (indices 1..length), f32.

    In order: the disk cache, when it is set and the table has
    ``config.DISK_CACHE_MIN_LENGTH`` entries or more (a host array); the
    device builder, when ``device`` is a CUDA device and
    ``_device_halton_enabled(length)`` (a tensor on ``device``; with the disk
    cache on, written there from one device-to-host copy); else the host
    build (a host array). Host and device tables are bitwise equal.
    """
    cache_dir = _table_cache_dir() if length >= _cfg.DISK_CACHE_MIN_LENGTH else None
    path = None
    if cache_dir is not None:
        path = cache_dir / f"halton_b{base}_n{length}.npy"
        if path.exists():
            try:
                arr = np.load(path)
                if arr.shape == (length,) and arr.dtype == np.float32:
                    return arr
            except Exception:
                pass
    if _on_card(device) and _device_halton_enabled(length):
        out = _halton_dim_device(length, base, device)
        if path is not None:
            _publish(path, out.cpu().numpy())
        return out
    arr = _halton_dim_host(length, base)
    if path is not None:
        _publish(path, arr)
    return arr


def _publish(path: Path, arr: np.ndarray) -> None:
    # per-process tmp name: concurrent builders of the same table must
    # not interleave writes into one tmp file before the atomic publish
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npy")
    np.save(tmp, arr)
    tmp.replace(path)


def _halton_grid_host(g: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stratified g*g Halton jitter grid on the host: per-cell (u, v) in [0, 1)."""
    cells = np.arange(g * g, dtype=np.int64)
    row = (cells // g).astype(np.float64)
    col = (cells % g).astype(np.float64)
    u = ((radical_inverse(cells + 1, 2) + row) / g).astype(np.float32)
    v = ((radical_inverse(cells + 1, 3) + col) / g).astype(np.float32)
    return u, v


def _halton_grid_device(g: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_halton_grid_host(g)`` built on ``device`` in chunks, bitwise: the
    float64 sum and the division by ``g`` (a tensor on the device) round as
    the host's do."""
    device = torch.device(device)
    n = g * g
    k2, k3 = _digit_count(n, 2), _digit_count(n, 3)
    g64 = torch.full((1,), float(g), dtype=torch.float64, device=device)
    us, vs = [], []
    for start in range(0, n, DEVICE_CHUNK):
        last = min(start + DEVICE_CHUNK, n)
        cells = torch.arange(start, last, dtype=torch.int64, device=device)
        row = torch.div(cells, g, rounding_mode="floor")
        col = (cells - row * g).to(torch.float64)
        row = row.to(torch.float64)
        us.append(_radical_inverse_device(start + 1, last, 2, k2, device).add_(row)
                  .div_(g64).to(torch.float32))
        vs.append(_radical_inverse_device(start + 1, last, 3, k3, device).add_(col)
                  .div_(g64).to(torch.float32))
    if len(us) == 1:
        return us[0], vs[0]
    return torch.cat(us), torch.cat(vs)


def _build_grid(g: int, device: Optional[str]) -> Tuple[Table, Table]:
    return _halton_grid_host(g) if device is None else _halton_grid_device(g, device)


# Host grids as the JAX package caches them; grids built on a card (g*g of
# config.DEVICE_MIN_LENGTH cells or more: 213 MB at the 1M city's 26.6M
# cells) keep the 2 most recent, as the big dims do.
_cached_grid_host = lru_cache(maxsize=128)(_build_grid)
_cached_grid_device = lru_cache(maxsize=2)(_build_grid)


def cached_halton(samples: int, device=None) -> Tuple[Table, Table]:
    """Stratified g*g Halton jitter grid (``g = samples``): per-cell (u, v) in
    [0, 1), host arrays, but tensors on ``device`` where the device builder
    takes ``g*g`` entries (``_dims_key``); cached by ``(g, device)``."""
    g = int(samples)
    key = _dims_key(g * g, device)
    if key is None:
        return _cached_grid_host(g, None)
    return _cached_grid_device(g, key)


def _grid_cache_clear() -> None:
    _cached_grid_host.cache_clear()
    _cached_grid_device.cache_clear()


cached_halton.cache_clear = _grid_cache_clear


def _build_dims(n: int, device: Optional[str]) -> Tuple[Table, ...]:
    return tuple(_halton_dim(n, base, device) for base in BASES)


# Device tables PIN device memory while cached (5 * length * 4 bytes: 1.8 GB
# for a 89M-ray emitter), so lengths of config.DEVICE_MIN_LENGTH or more
# keep only the 2 most recent entries; a scene's same-size emitters share one.
_cached_dims_small = lru_cache(maxsize=128)(_build_dims)
_cached_dims_big = lru_cache(maxsize=2)(_build_dims)


def _dims_key(n: int, device) -> Optional[str]:
    """The device a table set of ``n`` entries is built on, as a cache key:
    the CUDA device named with its index, or None for the host tables (the
    CPU, no device, or the builder off for this length)."""
    if not (_on_card(device) and _device_halton_enabled(n)):
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def cached_halton_dims(length: int, device=None) -> Tuple[Table, ...]:
    """Five cached per-ray Halton dimensions: bases (5, 2, 3, 7, 11).

    Order: triangle pick, barycentric u, barycentric v, hemisphere r1, r2.
    Host arrays, but tensors on ``device`` where ``_halton_dim`` builds
    them there; cached by ``(length, device)``, so a table built for one
    card is never handed to another.
    """
    n = int(length)
    key = _dims_key(n, device)
    if n >= _cfg.DEVICE_MIN_LENGTH:
        return _cached_dims_big(n, key)
    return _cached_dims_small(n, key)


def _dims_cache_clear() -> None:
    _cached_dims_small.cache_clear()
    _cached_dims_big.cache_clear()


# one call clears both partitions, as the JAX package's does
cached_halton_dims.cache_clear = _dims_cache_clear


__all__ = ["radical_inverse", "cached_halton", "cached_halton_dims"]
