# Copied from raystrack_tpu/utils/geometry.py (host-only NumPy).
"""Legacy geometry helpers kept for API parity.

Reference: src/raystrack/utils/geometry.py:7-64.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

Mesh = Tuple[str, np.ndarray, np.ndarray]


def flatten_receivers(meshes: List[Mesh], idx_emit: int, skip: Iterable[int] = ()):
    """Return flattened receiver triangle arrays ``(v0, e1, e2, sid, norm)``.

    ``idx_emit`` is kept for callers deciding whether to exclude the emitter;
    the emitter is NOT excluded automatically — pass its index via ``skip``.
    """
    del idx_emit  # kept in the signature for compatibility
    skip_set = set(skip)
    v0s, e1s, e2s, sids, norms = [], [], [], [], []
    for sid, (_, V, F) in enumerate(meshes):
        if sid in skip_set:
            continue
        a = V[F[:, 0]].astype(np.float32)
        b = V[F[:, 1]].astype(np.float32)
        c = V[F[:, 2]].astype(np.float32)
        e1 = b - a
        e2 = c - a
        n = np.cross(e1, e2)
        n = n / np.linalg.norm(n, axis=1)[:, None]
        v0s.append(a)
        e1s.append(e1)
        e2s.append(e2)
        sids.append(np.full(len(F), sid, np.int32))
        norms.append(n.astype(np.float32))

    if not v0s:
        empty3 = np.empty((0, 3), np.float32)
        return empty3, empty3.copy(), empty3.copy(), np.empty((0,), np.int32), empty3.copy()
    return (
        np.concatenate(v0s),
        np.concatenate(e1s),
        np.concatenate(e2s),
        np.concatenate(sids),
        np.concatenate(norms),
    )


def flip_meshes(meshes: List[Mesh]) -> List[Mesh]:
    """Return a deep-copied mesh list with every triangle winding reversed."""
    return [(name, V.copy(), F[:, [0, 2, 1]].copy()) for name, V, F in meshes]


__all__ = ["flatten_receivers", "flip_meshes"]
