"""Runtime knobs of the PyTorch port, read from the same environment
variables (and with the same defaults) as ``raystrack_tpu.config``.

Only the knobs the matrix solve reads are carried over. They are read
once, at import; the solver reads them through this module at call time,
so a test or a harness may set them on the module.
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

# Multi-emitter route: "scheduled" packs every pending emitter's next
# iterations into one dispatch per convergence round (the whole-scene
# scheduled driver and the multi-emitter sweep kernel); "grouped" solves
# emitter by emitter (the per-emitter pipelined driver: the JAX package's
# grouped vmap driver is not ported, ROADMAP port queue 1); "auto" picks
# "scheduled" on a CUDA card and "grouped" on the CPU.
SCHEDULER = os.environ.get("RAYSTRACK_TPU_SCHEDULER", "auto").lower()

# Scheduled-driver flat-table budget: the scheduler keeps 7 f32 per-ray
# tables spanning every emitter's padded ray count on the device; past this
# many total rays it declines and the per-emitter driver runs instead
# (64M rays ~= 1.8 GB of tables).
SCHED_MAX_FLAT_RAYS = _env_int("RAYSTRACK_TPU_SCHED_MAX_FLAT_RAYS", 67_108_864)

# Scheduled-round block budget floor: a round always admits at least this
# many RAY_BLOCK-sized blocks even when TARGET_CHUNK_RAYS is tiny.
SCHED_MIN_BLOCKS = _env_int("RAYSTRACK_TPU_SCHED_MIN_BLOCKS", 256)

# Round pipelining: the scheduled driver dispatches convergence round k+1
# before it fetches round k's counts, so the card works while the host
# replays. Overshoot iterations of emitters that converge in round k are
# discarded by the replay; results are identical. 0 = sequential.
SCHED_PIPELINE = _env_int("RAYSTRACK_TPU_SCHED_PIPELINE", 1, minimum=0)

# Fused multi-round dispatch: plan up to this many consecutive convergence
# rounds into one dispatch, each from the position round pipelining plans
# from. 0 = auto = no fusing (the JAX package measured fusing slower than
# pipelining); results are identical either way.
SCHED_FUSE_ROUNDS = _env_int("RAYSTRACK_TPU_SCHED_FUSE_ROUNDS", 0, minimum=0)

# Implicit PreparedSolver reuse: solves without an explicit prepared= keep
# up to 4 content-keyed PreparedSolvers (with their device packs and flat
# tables) alive. Set to 0 to disable; clear_prepared_cache() drops them.
PREPARED_CACHE = _env_int("RAYSTRACK_TPU_PREPARED_CACHE", 1, minimum=0)

__all__ = [
    "RAY_BLOCK",
    "RAY_BUCKETING",
    "TARGET_CHUNK_RAYS",
    "MAX_CHUNK",
    "SPECULATION_PCT",
    "PALLAS_TRI_TILE",
    "SCHEDULER",
    "SCHED_MAX_FLAT_RAYS",
    "SCHED_MIN_BLOCKS",
    "SCHED_PIPELINE",
    "SCHED_FUSE_ROUNDS",
    "PREPARED_CACHE",
]
