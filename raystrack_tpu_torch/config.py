"""Runtime knobs of the PyTorch port, read from the same environment
variables (and with the same defaults) as ``raystrack_tpu.config``.

Only the knobs the per-emitter matrix solve reads are carried over; they
are read once, at import.
"""
from __future__ import annotations

import os


def _env_int(name: str, default: int, *, minimum: int = 1) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return max(minimum, int(default))
    try:
        return max(minimum, int(raw))
    except ValueError:
        return max(minimum, int(default))


# Ray-count alignment unit: per-emitter ray batches are zero-padded to a
# multiple of it (padded rays are masked out of every count).
RAY_BLOCK = _env_int("RAYSTRACK_TPU_RAY_BLOCK", 2048)

# Bucket per-emitter ray counts into a {2^i, 3*2^i} block series (<= 33%
# masked-ray overhead). Set to 0 for exact block-multiple padding.
RAY_BUCKETING = _env_int("RAYSTRACK_TPU_RAY_BUCKETING", 1, minimum=0)

# Target rays per dispatched chunk; bounds how many Monte-Carlo iterations
# one chunk fuses (chunk = clamp(target / rays_per_iteration)).
TARGET_CHUNK_RAYS = _env_int("RAYSTRACK_TPU_TARGET_CHUNK_RAYS", 4_194_304)

# Hard cap on iterations fused per chunk (power-of-four sizes up to it).
MAX_CHUNK = _env_int("RAYSTRACK_TPU_MAX_CHUNK", 64)

# Speculation: after min_iters a chunk may run ceil(iters_done *
# SPECULATION_PCT / 100) iterations past the next convergence check;
# overshoot iterations are discarded, so results are unchanged.
SPECULATION_PCT = _env_int("RAYSTRACK_TPU_SPECULATION_PCT", 25, minimum=0)

# Sweep tile width: the nearest-hit fold ties break to the smallest code
# inside one tile of this width (halved until it divides the padded
# triangle count) and to the earlier tile across tiles, as in the JAX
# package's Pallas sweep; whole tiles with no eligible triangle are skipped.
PALLAS_TRI_TILE = _env_int("RAYSTRACK_TPU_PALLAS_TRI_TILE", 2048)

__all__ = [
    "RAY_BLOCK",
    "RAY_BUCKETING",
    "TARGET_CHUNK_RAYS",
    "MAX_CHUNK",
    "SPECULATION_PCT",
    "PALLAS_TRI_TILE",
]
