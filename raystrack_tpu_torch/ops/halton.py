# Copied from raystrack_tpu/ops/halton.py: the host builder only (host-only NumPy).
"""Low-discrepancy Halton tables for QMC emission sampling.

The radical inverse is computed exactly in float64 and stored as float32;
the stratified grid uses bases (2, 3) with ``u=(h2(c+1)+c//g)/g``,
``v=(h3(c+1)+c%g)/g``, and the five per-ray dimensions use bases
(5, 2, 3, 7, 11) starting at index 1. The tables are bitwise equal to the
JAX package's.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np


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


def _halton_dim(length: int, base: int) -> np.ndarray:
    """First ``length`` Halton values in ``base`` (indices 1..length), f32."""
    return radical_inverse(np.arange(1, length + 1, dtype=np.int64), base).astype(
        np.float32
    )


@lru_cache(maxsize=128)
def cached_halton(samples: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stratified g*g Halton jitter grid: per-cell (u, v) in [0, 1)."""
    g = int(samples)
    cells = np.arange(g * g, dtype=np.int64)
    row = (cells // g).astype(np.float64)
    col = (cells % g).astype(np.float64)
    u = ((radical_inverse(cells + 1, 2) + row) / g).astype(np.float32)
    v = ((radical_inverse(cells + 1, 3) + col) / g).astype(np.float32)
    return u, v


@lru_cache(maxsize=16)
def cached_halton_dims(
    length: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Five cached per-ray Halton dimensions: bases (5, 2, 3, 7, 11).

    Order: triangle pick, barycentric u, barycentric v, hemisphere r1, r2.
    """
    n = int(length)
    return tuple(_halton_dim(n, base) for base in (5, 2, 3, 7, 11))


__all__ = ["radical_inverse", "cached_halton", "cached_halton_dims"]
