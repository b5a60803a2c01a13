"""Runtime knobs of the PyTorch port, read from the same environment
variables (and with the same defaults) as ``raystrack_tpu.config``, but for
``SLIM_PACK_MIN_TRIS``, whose default is reckoned from the card's memory.

Only the knobs the port's solves read are carried over. They are read
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


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return float(default)
    try:
        return float(raw)
    except Exception:
        return float(default)


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

# Past this many padded triangles pack_scene pads to a multiple of
# PALLAS_TRI_TILE instead of 128, so the sweep tile never shrinks and the
# pack equals the JAX package's (which streams such scenes from HBM). A
# module constant, not read from the environment: the packs must stay the
# JAX package's at its default.
PALLAS_MAX_TRIS = 32768

# Largest width pack_scene records as the scene's ScenePack.tri_tile (the
# JAX package's XLA sweep tile), halved until it divides the padded count.
# Nothing in the port sweeps at it: the field exists so the packs match the
# JAX package's field for field.
TRI_TILE = 512

# Triangles per AABB of the scene's acceleration boxes (ScenePack.tile_lo /
# tile_hi); every sweep tile width is a multiple of it, so the gate's boxes
# reduce from these.
ACCEL_GRAIN = 128

# AABB distance gate: one box per sweep tile up to this many tiles; past
# it one box per group of consecutive Morton-ordered tiles (two-level).
GATE_MAX_TILES = _env_int("RAYSTRACK_TPU_GATE_MAX_TILES", 8192)

# Largest tiles-per-box group the two-level gate takes; beyond it the sweep
# runs ungated.
GATE_MAX_GROUP = _env_int("RAYSTRACK_TPU_GATE_MAX_GROUP", 64)

# Visit positions per early-exit check of the per-tile gate: at every K-th
# position a block whose rays are all settled below the rest of its visit
# list stops. 8 or 16 (other values > 1 mean 16); 0 or 1 turns the early
# exit off.
GATE_WINDOW = _env_int("RAYSTRACK_TPU_GATE_WINDOW", 16, minimum=0)

# Slim (pack-resident) scene threshold, in padded triangles: at or above it
# pack_scene builds the (24, Tpad) sweep operand pack once, in chunks, and
# keeps only it, the surface ids and the acceleration boxes on the device,
# instead of the scene's per-triangle fields from which every emitter
# assembles its own baked pack. Slim scenes sweep with kernel #1 in its
# code_bounds mode, emitter by emitter (the scheduled driver is declined,
# which costs a many-emitter solve its one dispatch per round), and return
# the same dicts, so the threshold sits as high as memory lets it.
# The reckoning, on an NVIDIA H100 80GB HBM3 at a 700.00 W limit
# (chip_smoke.py phase 14: the 1M- and the 10M-triangle city, the slope
# between the two sizes, in bytes per padded triangle). view_factor ground
# -> city, one emitter: a full-mode solve peaks at 191.4 (80.2 of resident
# fields, the emitter's 96-byte baked pack and the temporaries of building
# it), a slim one at 115.5 (100.2 resident). The heavier path is the
# full-mode scheduled matrix: the zero-mask scene pack, the flat tables'
# geometry stack (80 bytes per emitter and face of the largest mesh, here
# the boxes, nearly the whole scene) and a round's (E, Tpad) mask rows with
# their temporaries come to 249.5 + 132.8 per emitter row, 1577.5 with ten
# ground plates (960.3 of it resident). Of the card's 85.0e9 bytes a full-
# mode round of ten emitters passes half at 2.69e7 padded triangles and all
# at 5.39e7 (one emitter: 2.22e8 and 4.44e8); the default is the first of
# these, rounded down, which leaves the other half to ray tables, chunks
# and rounds of more emitters. Slim mode's peak passes the card at 7.36e8.
SLIM_PACK_MIN_TRIS = _env_int("RAYSTRACK_TPU_SLIM_PACK_MIN_TRIS", 25_000_000)

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

# Mid-emitter progress checkpoints: while an emitter is still converging,
# its exact monitor state snapshots to
# <checkpoint_dir>/emitter_NNNNN.progress.json at most every this many
# seconds, so very long single-emitter solves resume mid-stream (the
# iteration RNG is absolute-indexed, so a resumed solve is bit-identical).
# 0 = snapshot after every chunk or round; negative disables snapshots.
CHECKPOINT_PROGRESS_S = _env_float("RAYSTRACK_TPU_CHECKPOINT_PROGRESS_S", 60.0)

# Halton tables (ops/halton.py), under the JAX package's names and values.
# A table of DEVICE_MIN_LENGTH entries or more asked for on a CUDA device is
# built on it and stays there (the emitter packs and flat tables pad and
# concatenate it there); RAYSTRACK_TPU_DEVICE_HALTON, read at each build,
# forces the device builder off (0/off/false) or on (1/on/true) at any
# length; "auto" (the default) keeps the threshold. The CPU always builds
# on the host.
DEVICE_MIN_LENGTH = 2_000_000
DEVICE_HALTON_ENV = "RAYSTRACK_TPU_DEVICE_HALTON"

# A directory named by RAYSTRACK_TPU_TABLE_CACHE (read at each build)
# memoizes tables of DISK_CACHE_MIN_LENGTH entries or more as
# halton_b{base}_n{length}.npy, the JAX package's files: either package reads
# the tables the other wrote. Unset: no table touches the disk.
DISK_CACHE_MIN_LENGTH = 4_000_000
TABLE_CACHE_ENV = "RAYSTRACK_TPU_TABLE_CACHE"

__all__ = [
    "RAY_BLOCK",
    "RAY_BUCKETING",
    "TARGET_CHUNK_RAYS",
    "MAX_CHUNK",
    "SPECULATION_PCT",
    "PALLAS_TRI_TILE",
    "PALLAS_MAX_TRIS",
    "TRI_TILE",
    "ACCEL_GRAIN",
    "GATE_MAX_TILES",
    "GATE_MAX_GROUP",
    "GATE_WINDOW",
    "SLIM_PACK_MIN_TRIS",
    "SCHEDULER",
    "SCHED_MAX_FLAT_RAYS",
    "SCHED_MIN_BLOCKS",
    "SCHED_PIPELINE",
    "SCHED_FUSE_ROUNDS",
    "PREPARED_CACHE",
    "CHECKPOINT_PROGRESS_S",
    "DEVICE_MIN_LENGTH",
    "DEVICE_HALTON_ENV",
    "DISK_CACHE_MIN_LENGTH",
    "TABLE_CACHE_ENV",
]
