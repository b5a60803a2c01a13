"""View-factor solves of the PyTorch port: the matrix, the sky and both.

Counterpart of ``raystrack_tpu/solver.py``'s ``view_factor_matrix``,
``view_factor_to_tregenza_sky`` and ``view_factor_matrix_and_sky`` (the
shared-ray workflow), and of their two routes on an accelerator:

- the whole-scene scheduled driver (``_drive_scheduled`` ->
  ``ops.trace.scheduled_trace`` -> sweep kernel #2): every pending
  emitter's next iterations go into one dispatch per convergence round; a
  CUDA solve of more than one emitter takes it;
- the per-emitter pipelined driver (``_drive_pipelined`` -> ``_EmitterRun``
  -> ``ops.trace.chunk_body`` -> sweep kernel #1): single emitters,
  emitters too big for a round, CPU solves by default, and
  ``RAYSTRACK_TPU_SCHEDULER=grouped``.

The three are one solve (``_solve``) of one or both sides, the matrix and
the sky: it builds an ``_Entry`` per emitter (``_build_entry``: its run and
a monitor for each side) and drives them through the scheduled driver, then
the per-emitter one. The emitter partitions of ``parallel/distribute.py``
build and drive their entries the same way.

The JAX package's third route, its grouped vmap driver (``_drive_grouped``,
``_batched_step``) and its XLA sweep (``_resolve_kernel`` picks it below
``PALLAS_MIN_TRIS`` = 512 triangles and on the CPU), is not carried over:
the per-emitter driver and kernel #1 take those solves, with the same
dicts, and on the card kernel #1 runs such a scene (ex06's 252-triangle
city) near its FP32 bound (``config.py``'s docstring).

The matrix sweeps want the nearest hit, the sky sweeps only whether a ray
hits anything (any-only), and the workflow both at once (matrix + any)
until one side converges. Both routes replay per-iteration counts through
float64 monitors on the host, so stopping behaviour matches a strictly
sequential solve and the two routes return equal dicts. Also as in the JAX
package:

- reciprocity half-matrix tracing (only receivers with id > emitter are
  intersected; the transpose is back-filled as F*Ai/Aj),
- planar emitters cull receivers whose bounding box lies entirely behind the
  emission plane,
- per-emitter progress lines keep the format
  ``(i/n) [name] K iter, R rays -> T s (BVH=..., device=...)`` (the
  workflow's: ``[name] traced K iter, ... (scene=M iter, sky=S iter, ...)``),
- solves without ``prepared=`` reuse an implicit, content-keyed LRU of
  ``PreparedSolver``s (``clear_prepared_cache`` empties it),
- ``mesh=`` (a ``parallel.sharding.RayMesh``) splits every trace over several
  devices, a chunk's rays or a round's rows, with dicts bitwise equal to
  the unsharded solve's (``parallel/sharding.py``); with no mesh a solve
  runs the same path on the one-shard mesh of ``params.device``,
- ``checkpoint_dir=`` resumes a stopped solve (``_CheckpointStore``: one
  JSON file per finished emitter and, every ``CHECKPOINT_PROGRESS_S``
  seconds, a snapshot of each pending one's monitors; the JAX package's
  layout and fingerprint), ``row_sink=`` streams the matrix's rows as they
  complete (``_OrderedRowSink``), and ``RAYSTRACK_TPU_PROFILE=<dir>``
  writes a ``torch.profiler`` trace of each public solve and its work
  counters (``tracing.py``: the spans and counters a profiler records).

A scene of ``SLIM_PACK_MIN_TRIS`` padded triangles or more is packed slim
(``prepared.pack_scene``): the device holds one operand pack for the whole
solve, every emitter takes the per-emitter driver and sweeps that pack with
eligibility from its code row, and the dict equals the full-mode one.

With ``bvh`` on (``auto`` from 512 faces), both routes gate their sweeps
by the scene's AABBs where it has more than one sweep tile (see
``ops/trace_cuda.py``), which changes no result. On a CUDA
device the sweeps are the kernels of ``csrc/sweep.cu``; on the CPU they are
the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import config as _cfg
from . import tracing as _tracing
from .config import RAY_BLOCK
from .convergence import MatrixMonitor, SkyMonitor, plan_chunk
from .ops import trace as _trace
from .ops.trace_cuda import build_tri_pack
from .params import MatrixParams, SkyParams
from .parallel import sharding as _sharding
from .prepared import (
    EmitterPack,
    LazyEmitterPack,
    PreparedEmitter,
    PreparedSolver,
    ScenePack,
    _pad_rays,
    emitter_plane_vec,
)
from .utils.helpers import enforce_reciprocity_and_rowsum as _enforce_reciprocity_and_rowsum
from .utils.logging import _log as _default_log

Mesh = Tuple[str, np.ndarray, np.ndarray]
VFDict = Dict[str, Dict[str, float]]

_BVH_AUTO_THRESHOLD = 512

# Injectable log hook (tests and harnesses may monkeypatch it).
_log = _default_log


def _select_bvh(bvh: Optional[str], total_faces: int) -> bool:
    mode = (bvh or "auto").lower()
    if mode not in ("auto", "off", "builtin"):
        raise ValueError(f"bvh must be 'auto', 'off', or 'builtin' (got {bvh!r})")
    if mode == "builtin":
        return True
    if mode == "off":
        return False
    return total_faces >= _BVH_AUTO_THRESHOLD


def _resolve_device(device: Optional[str]) -> torch.device:
    """``auto`` -> the current CUDA card when one is present, else the CPU;
    ``gpu`` -> require a card; ``cpu`` -> the CPU."""
    dev = (device or "auto").lower()
    if dev not in ("auto", "gpu", "cpu"):
        raise ValueError(f"device must be 'auto', 'gpu', or 'cpu' (got {device!r})")
    if dev == "cpu":
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    if dev == "gpu":
        raise RuntimeError("device='gpu' requested but no CUDA device is available")
    return torch.device("cpu")


def _check_mesh(mesh) -> None:
    """``mesh`` must be None or a :class:`parallel.sharding.RayMesh`."""
    if mesh is not None and not isinstance(mesh, _sharding.RayMesh):
        raise TypeError("mesh must be a RayMesh from raystrack_tpu_torch.parallel.ray_mesh() "
                        f"(got {type(mesh).__name__})")


def _placements(mesh, device: Optional[str]) -> Tuple[torch.device, _sharding.RayMesh]:
    """``(home, mesh)``: the device a solve's packs live on and its counts
    gather on, and the ray mesh it traces over. No mesh is the one-shard
    mesh of ``device`` resolved, so every solve takes the one sharded path.
    Under a caller's mesh its devices, not ``device``, decide the platform,
    and each distinct device of the mesh holds one copy of the packs (the
    JAX package's replicated placement), fetched through the
    ``PreparedSolver``'s per-device caches."""
    _check_mesh(mesh)
    if mesh is None:
        mesh = _sharding.RayMesh((_resolve_device(device),))
    return mesh.devices[0], mesh


def _ray_align(mesh: _sharding.RayMesh) -> int:
    """Per-emitter ray padding: ``RAY_BLOCK`` times the mesh's shard count,
    so every shard of a chunk traces whole blocks."""
    return RAY_BLOCK * mesh.size


def _device_label(device: torch.device) -> str:
    return "cpu" if device.type == "cpu" else "gpu"


def _use_scheduler(device: torch.device, emitters=None, rays: int = 0,
                   align: int = 1) -> bool:
    """Whether a multi-emitter solve takes the whole-scene scheduled driver
    (one dispatch per convergence round) instead of the per-emitter one.
    ``SCHEDULER`` "auto" = scheduled on a CUDA card, per-emitter on the CPU.

    The scheduled driver reads rays from scene-wide flat tables (7 f32
    tensors spanning every emitter's padded ray count); past
    ``SCHED_MAX_FLAT_RAYS`` total rays it is declined even if requested."""
    if emitters is not None:
        total = sum(_pad_rays(e.n_cells * rays, align) for e in emitters)
        if total > _cfg.SCHED_MAX_FLAT_RAYS:
            return False
    if _cfg.SCHEDULER == "scheduled":
        return True
    if _cfg.SCHEDULER == "grouped":
        return False
    return device.type != "cpu"


# Content-keyed LRU of implicit PreparedSolvers: repeated solves of the same
# geometry without an explicit prepared= reuse its host prep, Halton tables,
# device packs and flat tables. Keyed by mesh names and raw vertex/face
# bytes, so an in-place edit rebuilds; capped at a few scenes, and skipped
# for meshes past 64 MiB, whose hashing would cost more than it saves.
_PREPARED_LRU: Dict[str, PreparedSolver] = {}
_PREPARED_LRU_MAX = 4
_PREPARED_HASH_MAX_BYTES = 64 * 1024 * 1024


def hash_meshes(hasher, meshes: List[Mesh]) -> None:
    """Feed mesh content into ``hasher``: names are length-delimited and
    array shapes are hashed beside the bytes, so the stream is injective up
    to the f32/int32 casts below (all prep casts to f32 at point of use)."""
    for name, V, F in meshes:
        nb = name.encode()
        hasher.update(np.int64([len(nb), V.shape[0], F.shape[0]]).tobytes())
        hasher.update(nb)
        hasher.update(np.ascontiguousarray(V, dtype=np.float32).tobytes())
        hasher.update(np.ascontiguousarray(F, dtype=np.int32).tobytes())


def _meshes_fingerprint(meshes: List[Mesh]) -> Optional[str]:
    total = sum(V.nbytes + F.nbytes for _, V, F in meshes)
    if total > _PREPARED_HASH_MAX_BYTES:
        return None
    hasher = hashlib.sha256()
    hash_meshes(hasher, meshes)
    return hasher.hexdigest()


def clear_prepared_cache() -> None:
    """Drop the implicit PreparedSolver cache (its device tensors are freed
    once nothing else holds them). Solves with ``prepared=`` are unaffected."""
    _PREPARED_LRU.clear()


def _ensure_prepared(meshes: List[Mesh], prepared: Optional[PreparedSolver]) -> PreparedSolver:
    if prepared is not None:
        if not isinstance(prepared, PreparedSolver):
            raise TypeError("prepared must be a PreparedSolver instance")
        return prepared
    key = _meshes_fingerprint(meshes) if _cfg.PREPARED_CACHE else None
    if key is None:
        return PreparedSolver(meshes)
    solver = _PREPARED_LRU.pop(key, None)
    if solver is None:
        # deep copies: the cached solver preps lazily (a new bvh mode or
        # sampling setup later), so it must own the geometry it was keyed
        # by; an in-place edit of the caller's arrays must not reach it
        solver = PreparedSolver([(name, V.copy(), F.copy()) for name, V, F in meshes])
    _PREPARED_LRU[key] = solver  # re-insert: dict order is the LRU order
    while len(_PREPARED_LRU) > _PREPARED_LRU_MAX:
        _PREPARED_LRU.pop(next(iter(_PREPARED_LRU)))
    return solver


def _matrix_receivers(idx_emit: int, n_surf: int, reciprocity: bool) -> List[int]:
    if reciprocity:
        return list(range(idx_emit + 1, n_surf))
    return [j for j in range(n_surf) if j != idx_emit]


def _matrix_skip(idx_emit: int, reciprocity: bool) -> Tuple[int, int]:
    """(emitter sid to exclude, minimum sid eligible for matrix hits)."""
    return (idx_emit, idx_emit + 1) if reciprocity else (idx_emit, 0)


class _OrderedRowSink:
    """Stream COMPLETE rows to ``row_sink`` under the reciprocity half-solve.

    With ``reciprocity=True`` the transpose back-fill
    F(i->j) = F(j->i) * Aj / Ai lands in row i the moment emitter j < i
    converges, and no emitter j > i ever contributes to row i — so row i is
    complete exactly when emitters 0..i have all finished. This coordinator
    collects per-emitter results in completion order (the schedulers finish
    emitters in any order) and sinks rows in EMITTER order as the finished
    prefix grows, each merged with every back-fill contribution directed at
    it, making the streamed output equal the returned matrix. A resumed
    solve finishes its restored rows here too, so they stream again.
    """

    def __init__(self, sink, names: List[str]):
        self._sink = sink
        self._names = names
        self._pending_backfill: Dict[str, Dict[str, float]] = {}
        self._finished: Dict[int, Dict[str, float]] = {}
        self._next = 0

    def finish(self, idx: int, row: Dict[str, float],
               backfill: Dict[str, Dict[str, float]]) -> None:
        for name_r, entries in backfill.items():
            self._pending_backfill.setdefault(name_r, {}).update(entries)
        self._finished[idx] = row
        while self._next in self._finished:
            complete = dict(self._finished.pop(self._next))
            name = self._names[self._next]
            contrib = self._pending_backfill.pop(name, None)
            if contrib:
                complete.update(contrib)
            self._sink(name, complete)
            self._next += 1


def _build_emitter_surface_mask(
    idx_emit: int,
    emitter: PreparedEmitter,
    bounds_center: np.ndarray,
    bounds_extent: np.ndarray,
) -> np.ndarray:
    """Per-surface active flags: emitter off; for planar emitters, also cull
    receivers whose AABB lies entirely behind the emission plane."""
    n_surf = int(bounds_center.shape[0])
    active = np.ones(n_surf, dtype=np.uint8)
    if 0 <= idx_emit < n_surf:
        active[idx_emit] = 0
    if not emitter.plane_is_planar:
        return active

    normal = emitter.plane_normal.astype(np.float64)
    signed = (bounds_center.astype(np.float64) - emitter.plane_origin) @ normal
    radius = bounds_extent.astype(np.float64) @ np.abs(normal)
    behind = (signed + radius) <= float(emitter.plane_tol)
    behind[idx_emit] = False
    active[behind] = 0
    return active


def _matrix_active_receivers(
    idx_emit: int, n_surf: int, reciprocity: bool, surf_active: np.ndarray
) -> Tuple[List[int], np.ndarray]:
    receivers = [
        j for j in _matrix_receivers(idx_emit, n_surf, reciprocity) if surf_active[j] != 0
    ]
    return receivers, np.asarray(receivers, dtype=np.int32)


def _cp_rows(seed: int, idx_emit: int, itr_start: int, chunk: int) -> np.ndarray:
    """Cranley-Patterson offsets for ``chunk`` iterations.

    Iteration ``itr`` draws 2 grid + 5 dimension offsets from
    ``np.random.default_rng(seed + idx_emit + itr)``, so results are
    reproducible and independent of chunking.
    """
    rows = np.empty((chunk, 7), dtype=np.float32)
    for k in range(chunk):
        rng = np.random.default_rng(seed + idx_emit + itr_start + k)
        rows[k, :2] = rng.random(2, dtype=np.float32)
        rows[k, 2:] = rng.random(5, dtype=np.float32)
    return rows


# (device index, slot) -> the per-emitter driver's stream of that slot on that
# card (slots 1 and up), made at first use and kept for later solves
_SIDE_STREAMS: Dict[Tuple[int, int], "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device, slot: int) -> "torch.cuda.Stream":
    """Slot ``slot``'s own stream on the CUDA ``device``."""
    key = (device.index, slot)
    stream = _SIDE_STREAMS.get(key)
    if stream is None:
        stream = _SIDE_STREAMS[key] = torch.cuda.Stream(device=device)
    return stream


class _Slots:
    """The per-emitter driver's ``depth`` in-flight slots. A chunk takes the
    lowest free slot (:meth:`take`) and gives it back at its harvest
    (:meth:`give`); on a CUDA device each slot enqueues on a stream of its
    own on every card of the mesh, so chunks of different emitters run side
    by side on the card. Slot 0 is the caller's current stream: a solve that
    never has two chunks in flight runs on it alone. Slots 1 and up take
    :func:`_side_stream`.

    Ordering across the streams:

    - the *fence* is an event on every card that covers what the caller
      queued before the drive and what every dispatch since has built at
      first use (an emitter's operands and packs, the counters' buffer). A
      slot waits on it before it enqueues anything, and a dispatch records
      the next one after its builds and before its sweep (:meth:`fence`),
      so no slot waits for another's sweep, and no slot's allocation is
      written before an earlier build has read what it held;
    - an emitter's next chunk is dispatched only after its last one was
      harvested, so its own state is complete on any slot;
    - a chunk's inputs stay referenced until its harvest
      (:meth:`_EmitterRun.dispatch_chunk`), so no memory that a stream
      still reads goes back to the allocator;
    - :meth:`join` makes the caller's streams wait on the side streams the
      drive used, however it ended.

    While tracing is on, :meth:`take` counts ``chunks_dispatched`` and
    ``chunks_overlapped``, the chunks taken while another slot's chunk was
    unharvested. On the CPU there are no streams: the slots only count.
    """

    def __init__(self, devices, depth: int):
        cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
        self._depth = depth
        self._streams = [{d: torch.cuda.current_stream(d) for d in cards}] + [
            {d: _side_stream(d, k) for d in cards} for k in range(1, depth)]
        self._free = list(range(depth))
        self._used = set()
        self.fence(0)

    def take(self) -> "_Slot":
        if _tracing.on():
            _tracing.add(chunks_dispatched=1,
                         chunks_overlapped=int(len(self._free) < self._depth))
        k = min(self._free)
        self._free.remove(k)
        self._used.add(k)
        return _Slot(self, k)

    def give(self, slot: "_Slot") -> None:
        self._free.append(slot.index)

    @contextlib.contextmanager
    def enter(self, k: int):
        """Enqueue on slot ``k``'s streams, behind the fence."""
        streams = self._streams[k]
        if k != self._fence_slot:
            for d, stream in streams.items():
                stream.wait_event(self._fence[d])
        with contextlib.ExitStack() as stack:
            if k and streams:
                current = torch.cuda.current_device()
                for stream in streams.values():
                    stack.enter_context(torch.cuda.stream(stream))
                stack.enter_context(torch.cuda.device(current))
            yield

    def fence(self, k: int) -> None:
        """Record the fence on slot ``k``'s streams."""
        self._fence = {d: stream.record_event() for d, stream in self._streams[k].items()}
        self._fence_slot = k

    def join(self) -> None:
        for k in self._used - {0}:
            for d, stream in self._streams[k].items():
                self._streams[0][d].wait_stream(stream)


@dataclass(frozen=True)
class _Slot:
    """A slot taken from :class:`_Slots`; the default, no slots, is the
    caller's current stream with no fence."""

    slots: Optional[_Slots] = None
    index: int = 0

    def streams(self):
        """The context that enqueues on this slot's streams."""
        if self.slots is None:
            return contextlib.nullcontext()
        return self.slots.enter(self.index)

    def fence(self) -> None:
        """Later chunks on every slot wait for what this one queued so far."""
        if self.slots is not None:
            self.slots.fence(self.index)


class _EmitterRun:
    """Dispatches chunked tracing for one emitter.

    The emitter's masks and baked operand pack (98 bytes per padded
    triangle on the solve's device) are built at its first dispatch of a
    kind and reused by every later chunk of that kind. The pack bakes the
    primary mask of the kind, as the JAX package bakes it per dispatch:
    m_any when any-hits are wanted (the sky, and the workflow while its sky
    is pending), else m_mat. So a run holds at most two packs, one per
    kind, and :meth:`release` drops both when the emitter finishes. An
    emitter the scheduled driver finishes never builds one. On a slim
    scene pack no per-emitter pack exists: the operands are the scene's
    resident ``tri_pack``, a sweep mask from the surface ids and the
    emitter's two codes (``code_bounds``).

    Every chunk is split over the shards of the run's ray ``mesh``
    (``parallel.sharding.trace_chunk_sharded``; a solve without a mesh
    passes the one-shard mesh of ``device``): the run's packs stay on
    ``device`` (``mesh.devices[0]``), ``replica(d)`` gives the scene and
    emitter packs on each other distinct device ``d`` of the mesh, and the
    operands are built once a kind and a distinct device.
    """

    def __init__(
        self,
        scene_pack: ScenePack,
        em_pack,
        surf_active: np.ndarray,
        emit_sid: int,
        min_sid: int,
        seed: int,
        idx_emit: int,
        device: torch.device,
        *,
        mesh: _sharding.RayMesh,
        replica: Optional[Callable[[torch.device], Tuple[ScenePack, EmitterPack]]] = None,
    ):
        self.scene_pack = scene_pack
        self.em_pack = em_pack  # EmitterPack or LazyEmitterPack
        self.device = device
        self.mesh = mesh
        self._replica = replica
        self._surf_ext = np.zeros(surf_active.shape[0] + 1, dtype=np.int32)
        self._surf_ext[:-1] = surf_active  # the padding sid n_surf stays inactive
        self.emit_sid = int(emit_sid)
        self.min_sid = int(min_sid)
        # (want_any, device) -> (operand pack, sweep mask, code_bounds or None)
        self.packs: Dict[Tuple[bool, torch.device],
                         Tuple[torch.Tensor, torch.Tensor, Optional[Tuple]]] = {}
        self.seed = seed
        self.idx_emit = idx_emit
        self.itr_next = 0  # absolute iteration index (drives the RNG stream)

    def _packs_on(self, device: torch.device) -> Tuple[ScenePack, EmitterPack]:
        """The scene and emitter packs on ``device``: the run's own, or a
        mesh device's replicas."""
        if device == self.device:
            return self.scene_pack, self.em_pack
        return self._replica(device)

    def operands(self, want_any: bool, device: Optional[torch.device] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Tuple]]:
        """The operand pack (baked for this kind, or a slim scene's
        resident one), the sweep mask and the slim ``code_bounds`` (None
        for a baked pack) of a dispatch that does or does not want
        any-hits, on ``device`` (default: the run's), built on first use."""
        device = self.device if device is None else device
        ops = self.packs.get((want_any, device))
        if ops is None:
            sp, em = self._packs_on(device)
            surf_ext = _upload([self._surf_ext], np.int32, device)[0]
            if sp.slim:
                mask, bounds = _trace.slim_operands(
                    sp.sid, surf_ext, self.emit_sid, self.min_sid, want_any=want_any)
                ops = (sp.tri_pack, mask, bounds)
            else:
                pack, mask = _trace.emitter_operands(
                    (sp.v0, sp.e1, sp.e2, sp.cross_e, sp.w_u, sp.w_v, sp.d0, sp.sid),
                    surf_ext, self.emit_sid, self.min_sid, em.plane_vec,
                    want_any=want_any,
                )
                ops = (pack, mask, None)
            self.packs[want_any, device] = ops
        return ops

    def release(self) -> None:
        """Drop the operands; a later dispatch would build them again. A
        slim scene's resident pack stays with its scene pack."""
        self.packs.clear()

    @_tracing.spanned("raystrack.chunk.dispatch")
    def dispatch_chunk(self, chunk: int, *, want_matrix: bool, want_any: bool,
                       discrete: bool, slot: _Slot = _Slot()
                       ) -> Callable[[], Dict[str, np.ndarray]]:
        """Queue ``chunk`` iterations of the outputs the three flags pick
        (:func:`ops.trace.chunk_body`) on ``slot``'s streams (default: the
        current stream) without synchronising, so the driver can keep
        several emitters in flight; returns a function that waits for this
        chunk's counts only and hands them back as NumPy arrays. The counts
        are the mesh's shards' sum, gathered on the run's device behind one
        copy."""
        cp = torch.from_numpy(_cp_rows(self.seed, self.idx_emit, self.itr_next, chunk))
        self.itr_next += chunk
        on_card = self.device.type == "cuda"
        if on_card:  # a pageable upload would wait for all queued work
            cp = cp.pin_memory()
        flags = dict(want_matrix=want_matrix, want_any=want_any, discrete=discrete)
        n_surf, n_once = self.scene_pack.n_surf, self.em_pack.n_rays_once
        if _tracing.on():
            _tracing.add(rays_real=chunk * n_once)
        devices = self.mesh.distinct
        with slot.streams():
            # what a dispatch builds at first use (operands, packs and their
            # tables, the counters' buffer) comes before the fence: chunks on
            # other slots wait for it, and not for this chunk's sweep
            ops = {d: self.operands(want_any, d) for d in devices}
            packs = {d: self._packs_on(d) for d in devices}
            tables = {d: _ray_tables(em) for d, (_, em) in packs.items()}
            geom = {d: _emission_geometry(em) for d, (_, em) in packs.items()}
            if _tracing.on():
                for d in devices:
                    if d.type == "cuda":
                        _tracing.device_work(d)
            slot.fence()
            out = _sharding.trace_chunk_sharded(
                self.mesh, {d: o[0] for d, o in ops.items()},
                {d: o[1] for d, o in ops.items()}, tables, geom, cp, n_surf, n_once,
                accel={d: sp.accel for d, (sp, _) in packs.items()},
                code_bounds=ops[self.device][2], **flags)
            ready = None
            if on_card:
                # copy now, behind this chunk's work only: waiting on the event
                # leaves the other slots' chunks running on the card
                out = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
        held = [ops, packs]  # read on the card until the harvest

        def harvest() -> Dict[str, np.ndarray]:
            with _tracing.span("raystrack.chunk.wait"):
                if ready is not None:
                    ready.synchronize()
            held.clear()
            return {k: v.numpy() for k, v in out.items()}

        return harvest


def _ray_tables(em) -> Tuple[torch.Tensor, ...]:
    """An emitter pack's seven per-ray tables, in ``chunk_body``'s order."""
    return (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2)


def _emission_geometry(em) -> Tuple[torch.Tensor, ...]:
    """An emitter pack's emission geometry, in ``chunk_body``'s order."""
    return (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v, em.tri_n, em.tri_eps)


@dataclass(frozen=True)
class _Setup:
    """What the emitters of one solve share: the prepared scene, the ray
    stream's parameters ``p`` (samples, rays, seed, bvh), the side the rays
    leave from, the device the packs live on and the ray mesh (see
    :func:`_placements`), whether the sweeps are gated, and the scene pack,
    the emitters and the meshes' bounds."""

    prepared: PreparedSolver
    p: Dict
    flip_faces: bool
    device: torch.device
    mesh: _sharding.RayMesh
    use_bvh: bool
    scene_pack: ScenePack
    emitters: List[PreparedEmitter]
    bounds: Tuple[np.ndarray, np.ndarray]


def _setup(meshes: List[Mesh], prepared: Optional[PreparedSolver], p: Dict, mesh, *,
           flip_faces: bool) -> _Setup:
    """The setup of a solve of ``meshes`` whose rays ``p`` draws."""
    device, mesh = _placements(mesh, p["device"])
    prepared_solver = _ensure_prepared(meshes, prepared)
    use_bvh = _select_bvh(p["bvh"], prepared_solver.total_faces)
    emitters = prepared_solver.get_emitters(
        samples=p["samples"], rays=p["rays"], flip_faces=flip_faces)
    bounds = prepared_solver.get_mesh_bounds()
    scene_pack = prepared_solver.get_scene_pack(use_accel=use_bvh, device=device)
    return _Setup(prepared_solver, p, flip_faces, device, mesh, use_bvh, scene_pack,
                  emitters, bounds)


@dataclass(eq=False)
class _Entry:
    """One emitter's work in a solve: its run, receivers and sweep masks, a
    monitor for each side the solve has (``matrix``, ``sky``; None for a
    side it lacks, and for the matrix of a workflow emitter with no
    receivers), ``trace_iters``, the iterations of its ray stream that a
    monitor used, and the solve's hooks and the rows they assemble."""

    run: _EmitterRun
    idx: int
    name: str
    receivers: List[int]
    surf_active: np.ndarray
    emit_sid: int
    min_sid: int
    matrix: Optional[MatrixMonitor] = None
    sky: Optional[SkyMonitor] = None
    trace_iters: int = 0
    on_done: Optional[Callable[["_Entry"], None]] = None
    on_progress: Optional[Callable[["_Entry"], None]] = None
    started: Optional[float] = None
    elapsed: Optional[float] = None
    finished: bool = False
    progress_ts: float = 0.0
    row: Dict[str, float] = field(default_factory=dict)
    backfill: Dict[str, Dict[str, float]] = field(default_factory=dict)
    sky_row: Dict[str, float] = field(default_factory=dict)
    stats: Dict[str, float] = field(default_factory=dict)

    @property
    def monitors(self) -> List:
        """The monitors that are not None."""
        return [m for m in (self.matrix, self.sky) if m is not None]

    @property
    def pending(self) -> bool:
        return any(not m.done for m in self.monitors)

    def used(self) -> int:
        """``trace_iters`` advanced past every iteration a monitor consumed."""
        self.trace_iters = max(self.trace_iters, *(m.iters_done for m in self.monitors))
        return self.trace_iters


def _entry_progress(entry: _Entry) -> None:
    """Rate-limited mid-emitter snapshot hook, fired by every driver after an
    entry's chunk or round replay while it stays pending. No-op unless the
    solve attached ``on_progress``, and never after :func:`_entry_done`."""
    if entry.on_progress is None or entry.finished:
        return
    if _cfg.CHECKPOINT_PROGRESS_S < 0:
        return
    now = time.time()
    if now - entry.progress_ts < _cfg.CHECKPOINT_PROGRESS_S:
        return
    entry.progress_ts = now
    entry.on_progress(entry)


def _entry_done(entry: _Entry) -> None:
    """Completion hook, once per entry: drop the run's operands, stamp the
    emitter's wall time and fire the entry's ``on_done`` callback."""
    if entry.finished:
        return
    entry.finished = True
    entry.run.release()
    if entry.started is not None:
        entry.elapsed = time.time() - entry.started
    if entry.on_done is not None:
        entry.on_done(entry)


def _make_emitter_pack(prepared_solver: PreparedSolver, idx_emit: int, p: Dict,
                       flip_faces: bool, align: int, device: torch.device, *,
                       lazy: bool):
    """EmitterPack for one emitter; lazy when the scheduled driver will read
    rays from the scene-wide flat tables instead."""
    def factory() -> EmitterPack:
        return prepared_solver.get_emitter_pack(
            idx_emit, samples=p["samples"], rays=p["rays"],
            flip_faces=flip_faces, align=align, device=device,
        )

    if not lazy:
        return factory()
    emitter = prepared_solver.get_emitter(
        idx_emit, samples=p["samples"], rays=p["rays"], flip_faces=flip_faces
    )
    n_once = emitter.n_cells * p["rays"]
    return LazyEmitterPack(
        factory, n_rays_once=n_once, n_rays_pad=_pad_rays(n_once, align),
        plane_host=emitter_plane_vec(emitter),
    )


def _emitter_run(setup: _Setup, idx_emit: int, surf_active: np.ndarray, emit_sid: int,
                 min_sid: int, *, lazy: bool) -> _EmitterRun:
    """One emitter's run on the solve's device (``mesh.devices[0]``), its
    rays padded to :func:`_ray_align`; its emitter pack lazy when the
    scheduled driver will read rays from the flat tables instead. The packs
    on the mesh's other devices come from the ``PreparedSolver``'s
    per-device caches, one copy a distinct device, at the first chunk that
    needs them."""
    prepared_solver, p, flip_faces = setup.prepared, setup.p, setup.flip_faces
    align = _ray_align(setup.mesh)
    em_pack = _make_emitter_pack(prepared_solver, idx_emit, p, flip_faces, align, setup.device,
                                 lazy=lazy)

    def replica(dev: torch.device) -> Tuple[ScenePack, EmitterPack]:
        return (prepared_solver.get_scene_pack(use_accel=setup.use_bvh, device=dev),
                _make_emitter_pack(prepared_solver, idx_emit, p, flip_faces, align, dev,
                                   lazy=False))

    return _EmitterRun(setup.scene_pack, em_pack, surf_active, emit_sid, min_sid, p["seed"],
                       idx_emit, setup.device, mesh=setup.mesh, replica=replica)


def _build_entry(setup: _Setup, idx_emit: int, name: str, *, matrix: Optional[Dict],
                 sky: Optional[Dict], reciprocity: bool, lazy: bool) -> Optional[_Entry]:
    """Emitter ``idx_emit``'s entry in a solve of the sides whose parameters
    ``matrix`` and ``sky`` hold (None for a side the solve lacks): its
    surface mask and receivers, the sid skip (the matrix's when the solve
    has one), its run (``lazy`` as in :func:`_emitter_run`) and a monitor
    for each side. None for a matrix-only emitter with no receivers, which
    traces nothing."""
    n_surf = len(setup.emitters)
    surf_active = _build_emitter_surface_mask(idx_emit, setup.emitters[idx_emit], *setup.bounds)
    receivers: List[int] = []
    emit_sid, min_sid = idx_emit, 0
    if matrix is not None:
        receivers, recv_idx = _matrix_active_receivers(idx_emit, n_surf, reciprocity,
                                                       surf_active)
        if not receivers and sky is None:
            return None
        emit_sid, min_sid = _matrix_skip(idx_emit, reciprocity)
    run = _emitter_run(setup, idx_emit, surf_active, emit_sid, min_sid, lazy=lazy)

    def limits(q: Dict) -> Dict:
        # CPU solves check convergence every iteration; the interval only
        # batches checks on the card
        return dict(n_rays_once=run.em_pack.n_rays_once, tol=q["tol"], tol_mode=q["tol_mode"],
                    min_iters=q["min_iters"], max_iters=q["max_iters"],
                    interval=1 if setup.device.type == "cpu" else q["convergence_interval"])

    return _Entry(
        run=run, idx=idx_emit, name=name, receivers=receivers, surf_active=surf_active,
        emit_sid=emit_sid, min_sid=min_sid,
        matrix=MatrixMonitor(n_surf, recv_idx, **limits(matrix)) if receivers else None,
        sky=SkyMonitor(discrete=bool(sky["discrete"]), **limits(sky)) if sky is not None else None,
    )


def _iteration(counts: np.ndarray, rows) -> np.ndarray:
    """One iteration's counts: row ``rows`` of a chunk's (an int), or the
    sum of a scheduled round's rows ``rows`` (a slice)."""
    return counts[rows] if isinstance(rows, int) else counts[rows].sum(axis=0)


def _consume(entry: _Entry, host, rows, want_matrix: bool, want_any: bool) -> bool:
    """Fold one iteration of a dispatch's host counts (``rows``, as in
    :func:`_iteration`) into each of the entry's monitors that the dispatch
    served and that is still pending; False when there was none."""
    used = False
    m, s = entry.matrix, entry.sky
    if want_matrix and m is not None and not m.done:
        m.consume_iteration(_iteration(host["counts_f"], rows),
                            _iteration(host["counts_b"], rows))
        used = True
    if want_any and s is not None and not s.done:
        if s.discrete:
            s.consume_iteration(_iteration(host["sky_bins"], rows))
        else:
            s.consume_iteration(int(_iteration(host["upward"], rows)))
        used = True
    return used


def _drive_slots(entries: List[_Entry], depth: int) -> _Slots:
    """The in-flight slots of a per-emitter drive over ``entries``, with
    streams on every card of their runs' meshes."""
    return _Slots([d for e in entries for d in e.run.mesh.distinct], depth)


def _drive_pipelined(entries: List[_Entry], *, depth: int = 3) -> None:
    """Round-robin per-emitter solves with pipelined dispatch.

    Up to ``depth`` emitters have a chunk queued on the device at once, so
    the host-side float64 replay and RNG generation of one emitter overlap
    device work of the others; each chunk holds one of ``depth`` slots
    (:class:`_Slots`), and on a card the slots' streams run the chunks side
    by side. Results are identical to a sequential driver.

    An entry's chunk traces the outputs of its pending monitors (the
    workflow's matrix + any while both are pending, then the pending one
    alone), as many iterations as the longest of their plans. The replay
    folds each iteration into the monitors the chunk served and rewinds the
    ray stream to ``trace_iters``, past the iterations no monitor used.
    Monitors still pending are driven to completion in place and
    :func:`_entry_done` runs once per entry as it finishes.
    """
    queue = deque(e for e in entries if e.pending)
    inflight: deque = deque()
    slots = _drive_slots(entries, depth)
    try:
        while queue or inflight:
            while queue and len(inflight) < depth:
                entry = queue.popleft()
                chunk = max(
                    plan_chunk(
                        mon.iters_done,
                        min_iters=mon.min_iters,
                        interval=mon.interval,
                        max_iters=mon.max_iters,
                        rays_per_iter=entry.run.em_pack.n_rays_pad,
                        projected_total=mon.projected_total(),
                    )
                    for mon in entry.monitors
                    if not mon.done
                )
                if chunk <= 0:
                    for mon in entry.monitors:
                        mon.done = True
                    _entry_done(entry)
                    continue
                want_matrix = entry.matrix is not None and not entry.matrix.done
                want_any = entry.sky is not None and not entry.sky.done
                slot = slots.take()
                harvest = entry.run.dispatch_chunk(
                    chunk, want_matrix=want_matrix, want_any=want_any,
                    discrete=entry.sky is not None and entry.sky.discrete, slot=slot)
                inflight.append((entry, harvest, chunk, want_matrix, want_any, slot))
            if not inflight:
                break
            entry, harvest, chunk, want_matrix, want_any, slot = inflight.popleft()
            host = harvest()
            slots.give(slot)
            with _tracing.span("raystrack.chunk.consume"):
                for k in range(chunk):
                    if not _consume(entry, host, k, want_matrix, want_any):
                        break
                entry.run.itr_next = entry.used()
                if entry.pending:
                    _entry_progress(entry)
                    queue.append(entry)
                else:
                    _entry_done(entry)
    finally:
        slots.join()


@dataclass
class _Round:
    """One dispatched convergence round of the scheduled driver."""

    host: torch.Tensor  # packed counts, on the host once ``ready`` fires
    ready: Optional[torch.cuda.Event]  # None on the CPU: already there
    plan: List[Tuple]  # (entry, start_row, blocks per iteration, iterations)
    n_rows: int


def _upload(arrays: List[np.ndarray], dtype, device: torch.device) -> List[torch.Tensor]:
    """Move host arrays of one dtype to ``device`` in one copy: flattened
    into one pinned buffer, uploaded without waiting on queued work, and
    handed back as views of their shapes."""
    flat = torch.from_numpy(np.concatenate([np.ravel(a).astype(dtype) for a in arrays]))
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    out, off = [], 0
    for a in arrays:
        out.append(flat[off : off + a.size].view(a.shape))
        off += a.size
    return out


def _drive_scheduled(entries: List[_Entry], setup: _Setup, *, want_matrix: bool,
                     want_any: bool, discrete: bool) -> None:
    """Whole-scene scheduled solves: one dispatch per convergence round.

    Builds a block schedule spanning every pending emitter's next chunk and
    runs it as one :func:`ops.trace.scheduled_trace` of the outputs the
    three flags pick (one launch of sweep kernel #2; the solve's sides, for
    every round), then replays per-(emitter, iteration) sums of the rows'
    counts through each monitor that is still pending. The dispatch count
    becomes the number of convergence rounds of the slowest emitter instead
    of emitters x rounds. The replay never rewinds an entry's
    ``run.itr_next``: under round pipelining it may already cover a
    dispatched-but-unconsumed round.

    A round holds at most ``max(SCHED_MIN_BLOCKS, TARGET_CHUNK_RAYS //
    RAY_BLOCK)`` schedule rows of ``RAY_BLOCK`` rays (the rays are
    materialised for the kernel); an emitter whose single iteration exceeds
    that stays pending for the per-emitter driver. Each round dispatches
    exactly its rows: eager PyTorch compiles nothing per shape, so the JAX
    package's size buckets, padding rows and background precompiles have no
    counterpart.

    With ``SCHED_PIPELINE`` (default on) round k+1 is planned and dispatched
    before round k's counts are fetched; a round whose emitters all
    converged while it was in flight is dropped without the fetch.

    Each round's rows are split over the shards of the setup's ray mesh
    (``parallel.sharding.scheduled_trace_sharded``; ``mesh.devices[0]`` is
    the setup's device): the scene pack, the flat tables and the geometry
    stack are held once a distinct device of the mesh, and the round's CP
    and emitter rows copied to each once.
    """
    prepared_solver, p, device = setup.prepared, setup.p, setup.device
    n_surf = len(setup.emitters)
    # device -> (scene operands, tri_pack, flat tables, geometry stack, accel)
    replicas: Dict[torch.device, Tuple] = {}
    with _tracing.span("raystrack.round.setup"):
        for dev in setup.mesh.distinct:
            sp = (setup.scene_pack if dev == device
                  else prepared_solver.get_scene_pack(use_accel=setup.use_bvh, device=dev))
            # offsets and n_pad: host arrays, the same on every device. Every
            # offset is a RAY_BLOCK multiple: scheduled_trace takes the tables
            # as (-1, RAY_BLOCK) rows
            tables_flat, geom_stacked, offsets, n_pad = prepared_solver.get_flat_tables(
                samples=p["samples"], rays=p["rays"], flip_faces=setup.flip_faces,
                align=RAY_BLOCK, device=dev,
            )
            scene_t = (sp.v0, sp.e1, sp.e2, sp.cross_e, sp.w_u, sp.w_v, sp.d0, sp.sid)
            # one pack with zero mask rows serves every emitter of every round:
            # kernel #2 takes eligibility from the per-round combined mask rows
            no_mask = torch.zeros_like(sp.sid, dtype=torch.bool)
            replicas[dev] = (scene_t, build_tri_pack(scene_t, no_mask, no_mask), tables_flat,
                             geom_stacked, sp.accel)
        # each emitter's faces: a round searches its rows' CDFs in the stack's
        # first columns only (ops.trace.scheduled_rays)
        n_faces = np.array([em.cdf.shape[0] for em in setup.emitters])

    def entry_plan(entry: _Entry, rays_per_iter: int) -> int:
        # exact chunks: a round reaches each checkpoint at once. Under round
        # pipelining itr_next runs one dispatched-but-unconsumed round ahead
        # of iters_done; planning then measures from the hypothetical
        # position "in-flight round consumed, nothing converged, projections
        # unmoved". With nothing in flight this is the sequential plan.
        itr_next = entry.run.itr_next
        return max(
            plan_chunk(
                max(m.iters_done, itr_next),
                min_iters=m.min_iters,
                interval=m.interval,
                max_iters=m.max_iters,
                rays_per_iter=rays_per_iter,
                projected_total=m.projected_total(),
                pow4=False,
            )
            for m in entry.monitors
            if not m.done
        )

    max_blocks = max(_cfg.SCHED_MIN_BLOCKS, _cfg.TARGET_CHUNK_RAYS // RAY_BLOCK)
    # an emitter whose single iteration exceeds the round budget can never
    # fit a round: it stays pending for the per-emitter driver, which
    # bounds rays per dispatch
    pending = [
        e for e in entries
        if e.pending and int(n_pad[e.idx]) // RAY_BLOCK <= max_blocks
    ]
    fuse_rounds = _cfg.SCHED_FUSE_ROUNDS or 1

    @_tracing.spanned("raystrack.round.build")
    def build_round(pending: List[_Entry]) -> Optional[_Round]:
        """Plan the next convergence round(s) over ``pending`` and dispatch
        them without waiting. Returns None when no entry has plannable
        work. Advances each planned entry's ``run.itr_next``."""
        # vectorised schedule assembly: under round pipelining this host
        # code sits between dispatches, so per-row Python loops would
        # serialise against device work
        row_chunks: List[np.ndarray] = []
        cp_chunks: List[np.ndarray] = []
        n_rows = 0
        n_cps = 0
        plan: List[Tuple] = []  # (entry, start_row, bpi, n_iters)
        round_rows: Dict[int, int] = {}  # global emitter idx -> local row
        for _ in range(fuse_rounds):
            progressed = False
            for entry in pending:
                run = entry.run
                e = entry.idx
                bpi = int(n_pad[e]) // RAY_BLOCK
                if n_rows and n_rows + bpi > max_blocks:
                    # not even one iteration fits this round; the entry
                    # stays pending and leads the next round
                    continue
                budget = max(1, (max_blocks - n_rows) // max(1, bpi))
                chunk = min(entry_plan(entry, int(n_pad[e])), budget)
                if chunk <= 0:
                    continue
                local_e = round_rows.setdefault(e, len(round_rows))
                start_row = n_rows
                cp_chunks.append(_cp_rows(run.seed, run.idx_emit, run.itr_next, chunk))
                b_off = np.arange(bpi, dtype=np.int32) * RAY_BLOCK
                rows_e = np.empty((chunk, bpi, 4), dtype=np.int32)
                rows_e[..., 0] = local_e
                rows_e[..., 1] = n_cps + np.arange(chunk, dtype=np.int32)[:, None]
                rows_e[..., 2] = int(offsets[e]) + b_off[None, :]
                rows_e[..., 3] = b_off[None, :]
                row_chunks.append(rows_e.reshape(-1, 4))
                n_rows += chunk * bpi
                n_cps += chunk
                run.itr_next += chunk
                plan.append((entry, start_row, bpi, chunk))
                progressed = True
                if n_rows >= max_blocks:
                    break
            if not progressed or n_rows >= max_blocks:
                break
        if not plan:
            return None
        if _tracing.on():
            _tracing.add(rays_real=sum(chunk * entry.run.em_pack.n_rays_once
                                       for entry, _, _, chunk in plan))

        # the round's emitter rows: only the emitters it references
        by_entry = {entry.idx: entry for entry, *_ in plan}
        n_round = len(round_rows)
        surf_b = np.zeros((n_round, n_surf + 1), dtype=np.int32)
        emit_b = np.zeros(n_round, dtype=np.int32)
        min_b = np.zeros(n_round, dtype=np.int32)
        once_b = np.zeros(n_round, dtype=np.int32)
        plane_b = np.zeros((n_round, 8), dtype=np.float32)
        sel = np.zeros(n_round, dtype=np.int32)
        for e, local_e in round_rows.items():
            entry = by_entry[e]
            sel[local_e] = e
            surf_b[local_e, :-1] = entry.surf_active
            emit_b[local_e] = entry.emit_sid
            min_b[local_e] = entry.min_sid
            once_b[local_e] = entry.run.em_pack.n_rays_once
            plane_b[local_e] = entry.run.em_pack.plane_host

        schedule, surf_t, emit_t, min_t, once_t, sel_t = _upload(
            [np.concatenate(row_chunks), surf_b, emit_b, min_b, once_b, sel],
            np.int32, device,
        )
        cp_t, plane_t = _upload([np.concatenate(cp_chunks), plane_b], np.float32, device)
        flags = dict(sched_block=RAY_BLOCK, want_matrix=want_matrix, want_any=want_any,
                     discrete=discrete)
        round_rows = (cp_t, surf_t, emit_t, min_t, once_t, plane_t, schedule, sel_t)
        per_dev = [{d: r[i] for d, r in replicas.items()} for i in range(5)]
        faces = int(n_faces[sel].max())  # the CDF columns the round's emitters fill
        per_dev[3] = {d: (g[0][:, :faces],) + tuple(g[1:]) for d, g in per_dev[3].items()}
        flat = _sharding.scheduled_trace_sharded(setup.mesh, *per_dev[:4], *round_rows,
                                                 accel=per_dev[4], **flags)
        if device.type != "cuda":
            return _Round(flat, None, plan, n_rows)
        # one packed copy, behind this round's work only
        host = flat.to("cpu", non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
        return _Round(host, ready, plan, n_rows)

    def consume_round(round_: _Round) -> None:
        with _tracing.span("raystrack.round.wait"):
            if round_.ready is not None:
                round_.ready.synchronize()
        with _tracing.span("raystrack.round.consume"):
            host = _trace.unpack_outputs(round_.host.numpy(), round_.n_rows, n_surf,
                                         want_matrix=want_matrix, want_any=want_any,
                                         discrete=discrete)
            for entry, start_row, bpi, chunk in round_.plan:
                for c in range(chunk):
                    r0 = start_row + c * bpi
                    if not _consume(entry, host, slice(r0, r0 + bpi), want_matrix, want_any):
                        break
                entry.run.itr_next = max(entry.run.itr_next, entry.used())
                if entry.pending:
                    _entry_progress(entry)
                else:
                    _entry_done(entry)

    pipeline = _cfg.SCHED_PIPELINE > 0
    inflight: Optional[_Round] = None
    while True:
        nxt = build_round(pending) if pending else None
        if nxt is None and inflight is None:
            if pending:
                # nothing plannable and nothing in flight: these entries can
                # never finish (monitors at max_iters whose replay never
                # ran); close them out as the sequential driver would
                for entry in pending:
                    for m in entry.monitors:
                        m.done = True
                    _entry_done(entry)
            break
        if not pipeline and nxt is not None:
            consume_round(nxt)  # sequential: fetch before planning the next
            pending = [e for e in pending if e.pending]
            continue
        if inflight is not None:
            if any(e.pending for e, *_ in inflight.plan):
                consume_round(inflight)
                pending = [e for e in pending if e.pending]
            # else: every emitter of the round converged while it was in
            # flight; its iterations would all be discarded, so it is
            # dropped without the fetch
        inflight = nxt


class _CheckpointStore:
    """Per-emitter JSON checkpoints for resumable solves.

    One file per emitter under ``dir/``, written atomically (tmp + rename).
    A config fingerprint (solver params + mesh names and content) guards
    against resuming with a different setup. The layout, payload keys and
    fingerprint are the JAX package's, so either package resumes the
    other's directory.
    """

    def __init__(self, directory: str, params_dict: Dict, meshes: List[Mesh]):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        hasher = hashlib.sha256(
            json.dumps(
                {"params": {k: params_dict[k] for k in sorted(params_dict)}},
                sort_keys=True,
            ).encode()
        )
        # geometry content, not just shape: edited vertices must invalidate
        hash_meshes(hasher, meshes)
        self.fingerprint = hasher.hexdigest()[:16]
        self._mismatch_logged = False

    def _path(self, idx: int) -> Path:
        return self.dir / f"emitter_{idx:05d}.json"

    def _note_mismatch(self, path: Path) -> None:
        # A stale fingerprint silently re-solves from zero (params, mesh
        # content, or the fingerprint stream itself changed); say so ONCE
        # per store so a long resumed solve's restart isn't a mystery.
        if not self._mismatch_logged:
            self._mismatch_logged = True
            _log(
                f"checkpoint dir {self.dir} holds entries with a different "
                "config/geometry fingerprint; ignoring them and re-solving "
                f"(first: {path.name})"
            )

    def _read(self, path: Path):
        """The payload at ``path``, or None when it is missing, torn or of
        another fingerprint."""
        try:
            data = json.loads(path.read_text(encoding="utf-8"))
        except (OSError, ValueError):  # missing, or a torn or foreign file
            return None
        if not isinstance(data, dict):
            return None
        if data.get("fingerprint") != self.fingerprint:
            self._note_mismatch(path)
            return None
        return data

    def load(self, idx: int):
        """An emitter's finished checkpoint, or None."""
        return self._read(self._path(idx))

    def save(self, idx: int, name: str, row, backfill, stats, **extra) -> None:
        """``extra`` lands as additional top-level keys (e.g. the shared-ray
        workflow's ``sky=`` row); ``stats`` is reserved for stderr dicts."""
        payload = {
            "fingerprint": self.fingerprint,
            "emitter": name,
            "row": row,
            "backfill": backfill,
            "stats": stats,
            **extra,
        }
        self._write(self._path(idx), payload)
        self.clear_progress(idx)

    def _write(self, path: Path, payload) -> None:
        # per-process tmp name: two resuming solves sharing a checkpoint dir
        # must not interleave writes before the atomic publish
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps(payload, sort_keys=True), encoding="utf-8")
        tmp.replace(path)

    # -- mid-emitter progress snapshots -----------------------------------

    def _progress_path(self, idx: int) -> Path:
        return self.dir / f"emitter_{idx:05d}.progress.json"

    def load_progress(self, idx: int):
        """Monitor-state snapshot of a partially converged emitter, or None."""
        return self._read(self._progress_path(idx))

    def save_progress(self, idx: int, state: Dict) -> None:
        self._write(self._progress_path(idx), {"fingerprint": self.fingerprint, **state})

    def clear_progress(self, idx: int) -> None:
        self._progress_path(idx).unlink(missing_ok=True)

    def resume(self, entry: "_Entry", n_surf: int, both: bool) -> None:
        """Resume ``entry`` from its emitter's progress snapshot, if there is
        one, and snapshot it from now on (:func:`_snapshot`; ``both`` for the
        workflow's). A snapshot holds only consumed iterations, so the ray
        stream resumes at the first one no monitor has seen."""
        progress = self.load_progress(entry.idx)
        if progress is not None:
            _load_snapshot(entry, progress, both)
            entry.run.itr_next = entry.trace_iters = max(m.iters_done for m in entry.monitors)
            _log(f"({entry.idx + 1}/{n_surf}) [{entry.name}] resuming from "
                 f"iteration {entry.run.itr_next}")
        entry.on_progress = lambda e: self.save_progress(e.idx, _snapshot(e, both))


def _snapshot(entry: _Entry, both: bool) -> Dict:
    """Progress snapshot of an entry: its one monitor, or both of a
    workflow entry (``matrix`` None for an emitter with no receivers)."""
    if not both:
        return {"monitor": entry.monitors[0].state_dict()}
    return {"matrix": None if entry.matrix is None else entry.matrix.state_dict(),
            "sky": entry.sky.state_dict()}


def _load_snapshot(entry: _Entry, snapshot: Dict, both: bool) -> None:
    if not both:
        entry.monitors[0].load_state(snapshot["monitor"])
        return
    if entry.matrix is not None and snapshot.get("matrix") is not None:
        entry.matrix.load_state(snapshot["matrix"])
    entry.sky.load_state(snapshot["sky"])


def _start_entries(entries: List[_Entry], on_done: Callable[[_Entry], None]) -> None:
    """Stamp each entry's start and attach its ``on_done``. An entry that a
    snapshot restored converged (its full checkpoint not yet written) is
    assembled now and traces nothing."""
    t_solve = time.time()
    for entry in entries:
        entry.started = t_solve
        entry.on_done = on_done
        if not entry.pending:
            _entry_done(entry)


def _matrix_row(monitor: Optional[MatrixMonitor], receivers: List[int], meshes: List[Mesh],
                idx_emit: int, reciprocity: bool, areas) -> Tuple[Dict, Dict, Dict]:
    """One emitter's converged matrix row ``{receiver_front/back: F}``, its
    stderr row, and the reciprocity back-fill ``{receiver: {emitter_front:
    F * Ai / Aj}}`` (empty rows when the monitor traced nothing)."""
    row: Dict[str, float] = {}
    stats_row: Dict[str, float] = {}
    backfill: Dict[str, Dict[str, float]] = {}
    if monitor is None or monitor.total_rays <= 0:
        return row, stats_row, backfill
    name_e = meshes[idx_emit][0]
    se_f = monitor.wf.stderr()
    se_b = monitor.wb.stderr()
    total = float(monitor.total_rays)
    for j in receivers:
        name_r = meshes[j][0]
        f = monitor.hits_f[j] / total
        b = monitor.hits_b[j] / total
        if f > 0.0:
            row[f"{name_r}_front"] = f
            stats_row[f"{name_r}_front"] = float(se_f[j])
            if reciprocity and areas is not None and areas[j] > 0.0:
                back = f * (areas[idx_emit] / areas[j])
                backfill.setdefault(name_r, {})[f"{name_e}_front"] = back
        if b > 0.0:
            row[f"{name_r}_back"] = b
            stats_row[f"{name_r}_back"] = float(se_b[j])
    return row, stats_row, backfill


def _sky_keys(discrete: bool) -> List[str]:
    return [f"Sky_Patch_{i}" for i in range(1, 146)] if discrete else ["Sky"]


def _sky_row(monitor: SkyMonitor, discrete: bool) -> Tuple[Dict, Dict]:
    """One emitter's converged sky row (``Sky``, or ``Sky_Patch_1`` ..
    ``Sky_Patch_145``) and its stderr row."""
    total = float(max(1, monitor.total_rays))
    if discrete:
        frac = monitor.counts_total.astype(np.float64) / total
        se = monitor.bins_w.stderr()
        keys = _sky_keys(True)
        return ({k: float(frac[i]) for i, k in enumerate(keys)},
                {k: float(se[i]) for i, k in enumerate(keys)})
    return ({"Sky": float(monitor.upward_total / total)},
            {"Sky": float(monitor.sky_w.stderr())})




def _solve(meshes: List[Mesh], *, matrix: Optional[Dict], sky: Optional[Dict],
           prepared: Optional[PreparedSolver], mesh, checkpoint_dir: Optional[str],
           row_sink=None) -> Tuple[Optional[VFDict], Optional[VFDict], VFDict]:
    """The solve behind the three public ones, of the sides whose parameter
    dicts ``matrix`` and ``sky`` hold: None for a side it lacks, and with
    both the shared-ray workflow, its rays drawn by ``matrix``'s settings.
    Returns ``(vf_scene, sky_vf, stats)``, None for a side it lacks."""
    both = matrix is not None and sky is not None
    p = matrix if matrix is not None else sky
    with _tracing.span("raystrack.solve.entries"):
        # the sky emits outward, and the workflow's matrix with it
        setup = _setup(meshes, prepared, p, mesh,
                       flip_faces=matrix is not None and bool(matrix["flip_faces"]))
        device, use_bvh = setup.device, setup.use_bvh
        reciprocity = matrix is not None and bool(matrix["reciprocity"])
        discrete = sky is not None and bool(sky["discrete"])
        store = None
        if checkpoint_dir:
            keyed = p if not both else {**{f"m.{k}": v for k, v in matrix.items()},
                                        **{f"s.{k}": v for k, v in sky.items()}}
            store = _CheckpointStore(checkpoint_dir, keyed, meshes)
        areas = [e.total_area for e in setup.emitters] if reciprocity else None
        # a slim (pack-resident) scene goes emitter by emitter: that driver
        # sweeps the resident pack as it is, where the scheduled one would
        # assemble a second pack from per-triangle fields a slim scene does
        # not hold
        use_scheduler = not setup.scene_pack.slim and _use_scheduler(
            device, setup.emitters, p["rays"], RAY_BLOCK)

        names = [name for name, _, _ in meshes]
        n_surf = len(names)
        vf_scene: Optional[VFDict] = {name: {} for name in names} if matrix is not None else None
        sky_vf: Optional[VFDict] = ({name: {k: 0.0 for k in _sky_keys(discrete)} for name in names}
                                    if sky is not None else None)
        stats_result: VFDict = {}
        # Reciprocity lands back-fill in other emitters' rows; the ordered
        # coordinator defers each sink until its row's back-fill is complete.
        ordered_sink = (
            _OrderedRowSink(row_sink, names)
            if (row_sink is not None and reciprocity)
            else None
        )
        n_restored = 0
        entries: List[_Entry] = []
        # restore checkpoints, skip emitters that trace nothing, build the
        # work list; a single mesh has nothing to block its sky
        for idx_emit, name_e in enumerate(names if matrix is not None or n_surf > 1 else []):
            saved = store.load(idx_emit) if store is not None else None
            if saved is not None:
                n_restored += 1
                stats = saved.get("stats", {})
                if matrix is None:
                    sky_vf[name_e].update(saved["row"])
                else:
                    vf_scene[name_e].update(saved["row"])
                    for other, back_entries in saved.get("backfill", {}).items():
                        vf_scene[other].update(back_entries)
                if both and "sky" in saved:
                    sky_vf[name_e].update(saved["sky"])
                    # the stats slot carries a duplicate of the sky row under
                    # "sky" for readers of the older layout; strip it
                    stats = {k: v for k, v in stats.items() if k != "sky"}
                elif both:
                    # the older layout parked the sky row in the stats slot
                    sky_vf[name_e].update(stats.get("sky", {}))
                    stats = {}
                stats_result[name_e] = stats
                if sky is None:
                    # re-sunk: the stream of the stopped solve did not outlive it
                    if ordered_sink is not None:
                        ordered_sink.finish(idx_emit, saved["row"], saved.get("backfill", {}))
                    elif row_sink is not None:
                        row_sink(name_e, saved["row"])
                    _log(f"({idx_emit + 1}/{n_surf}) [{name_e}] restored from "
                         f"checkpoint ({len(saved['row'])} receivers)")
                else:
                    _log(f"({idx_emit + 1}/{n_surf}) [{name_e}] restored from checkpoint")
                continue
            entry = _build_entry(setup, idx_emit, name_e, matrix=matrix, sky=sky,
                                 reciprocity=reciprocity, lazy=use_scheduler)
            if entry is None:  # a matrix-only emitter with no receivers
                _log(_progress_line(idx_emit, n_surf, name_e, 0, 0, 0.0, use_bvh, device))
                stats_result[name_e] = {}
                if store is not None:
                    store.save(idx_emit, name_e, {}, {}, {})
                if ordered_sink is not None:
                    # traces nothing itself, but its row still collects earlier
                    # emitters' back-fill (e.g. the LAST emitter under
                    # reciprocity, whose whole row is back-fill)
                    ordered_sink.finish(idx_emit, {}, {})
                continue
            if store is not None:
                store.resume(entry, n_surf, both)
            entries.append(entry)

        def assemble(entry: _Entry) -> None:
            """Build the emitter's rows and stats as it converges (one stats
            row over both sides' keys), checkpoint them and sink the matrix
            row, so a solve stopped later keeps every finished emitter."""
            row, stats, backfill = _matrix_row(
                entry.matrix, entry.receivers, meshes, entry.idx, reciprocity, areas)
            sky_row: Dict[str, float] = {}
            # the workflow leaves the sky row of an untraced sky empty
            if sky is not None and (not both or entry.sky.total_rays > 0):
                sky_row, sky_stats = _sky_row(entry.sky, discrete)
                stats.update(sky_stats)
            entry.row, entry.stats, entry.backfill, entry.sky_row = row, stats, backfill, sky_row
            if store is not None and both:
                # the top-level "sky" is the layout; the duplicate inside stats
                # keeps the file readable by readers of the older layout
                store.save(entry.idx, entry.name, row, backfill, {**stats, "sky": sky_row},
                           sky=sky_row)
            elif store is not None:
                store.save(entry.idx, entry.name, row if sky is None else sky_row, backfill,
                           stats)
            if ordered_sink is not None:
                ordered_sink.finish(entry.idx, row, backfill)
            elif row_sink is not None:
                row_sink(entry.name, row)

        _start_entries(entries, assemble)

    # whole-scene scheduled dispatches when possible, then the pipelined
    # per-emitter driver for whatever is left (single emitters, emitters too
    # big for a round)
    if len(entries) > 1 and use_scheduler:
        _drive_scheduled(entries, setup, want_matrix=matrix is not None,
                         want_any=sky is not None, discrete=discrete)
    _drive_pipelined(entries)

    with _tracing.span("raystrack.solve.rows"):
        # merge rows into the result in emitter order
        for entry in entries:
            if matrix is not None:
                vf_scene[entry.name].update(entry.row)
                for name_r, back_entries in entry.backfill.items():
                    vf_scene[name_r].update(back_entries)
            if sky is not None:
                sky_vf[entry.name].update(entry.sky_row)
            stats_result[entry.name] = entry.stats
            if both:
                matrix_iters = entry.matrix.iters_done if entry.matrix is not None else 0
                _log(
                    f"({entry.idx + 1}/{n_surf}) [{entry.name}] traced {entry.trace_iters} iter, "
                    f"{entry.trace_iters * entry.run.em_pack.n_rays_once:,} rays -> "
                    f"{entry.elapsed:0.3f}s  "
                    f"(scene={matrix_iters} iter, sky={entry.sky.iters_done} iter, "
                    f"BVH={'builtin' if use_bvh else 'off'}, device={_device_label(device)})"
                )
            else:
                (monitor,) = entry.monitors
                _log(_progress_line(entry.idx, n_surf, entry.name, monitor.iters_done,
                                    monitor.total_rays, entry.elapsed, use_bvh, device))
        if n_restored:
            _log(f"{n_restored}/{n_surf} emitters restored from checkpoint (not re-traced)")
        if sky is None and matrix["enforce_reciprocity_rowsum"]:
            _enforce_reciprocity_and_rowsum(vf_scene, meshes, areas)
    return vf_scene, sky_vf, stats_result


@_tracing.solve("matrix")
def view_factor_matrix(
    meshes: List[Mesh],
    params: MatrixParams,
    *,
    prepared: Optional[PreparedSolver] = None,
    mesh=None,
    return_stats: bool = False,
    checkpoint_dir: Optional[str] = None,
    row_sink=None,
):
    """Scene-to-scene view-factor matrix F(i->j) with front/back splits.

    With ``return_stats=True`` also returns ``{emitter: {receiver_key:
    stderr}}`` — the per-receiver standard error of the converged estimate.
    Emitters restored from ``checkpoint_dir`` report the stats their
    checkpoint recorded (``{}`` for skipped emitters). ``prepared`` reuses a
    :class:`PreparedSolver`'s geometry, tables and device packs across
    solves; without it an implicit content-keyed cache does the same
    (``RAYSTRACK_TPU_PREPARED_CACHE=0`` turns it off). Set
    ``RAYSTRACK_TPU_PROFILE=<dir>`` to write a ``torch.profiler`` Chrome
    trace of the solve and its work counters into ``<dir>``
    (:func:`tracing.solve`).

    A CUDA solve of more than one emitter goes through the whole-scene
    scheduled driver; ``RAYSTRACK_TPU_SCHEDULER=grouped`` sends it emitter
    by emitter instead and ``scheduled`` forces the scheduler on the CPU.
    Both routes return equal dicts.

    ``row_sink(name, row)`` is called as rows COMPLETE (pair it with
    :class:`~raystrack_tpu_torch.io.VFMatrixStreamWriter` to stream a large
    matrix to disk). With ``reciprocity=False`` a row is complete the moment
    its emitter converges and rows stream in completion order. With
    ``reciprocity=True`` row i also carries the transpose back-fill from
    every earlier emitter, so rows stream in emitter order, each once
    emitters 0..i have all converged: the streamed rows equal the returned
    matrix (before ``enforce_reciprocity_rowsum``, which the sink never
    sees). A resumed solve sinks every row, restored ones too: a stream
    that :class:`~raystrack_tpu_torch.io.VFMatrixStreamWriter` had not yet
    closed is lost with the stopped solve. (The JAX package does not re-sink
    restored rows.)

    ``checkpoint_dir`` makes long solves resumable: each emitter's finished
    row (with its reciprocity back-fill and stats) is written atomically as
    JSON the moment it converges, and, every ``CHECKPOINT_PROGRESS_S``
    seconds while it converges, its exact monitor state. A restarted solve
    restores finished emitters from disk and resumes the others from their
    snapshots (the iteration RNG is indexed by absolute iteration, so the
    result is bit-identical). Checkpoints are keyed by the parameters and
    the geometry: a changed seed or mesh invalidates them.

    ``mesh``, a :class:`~raystrack_tpu_torch.parallel.sharding.RayMesh` from
    :func:`~raystrack_tpu_torch.parallel.ray_mesh`, splits every trace over
    its devices: a per-emitter chunk's rays, a scheduled round's rows. The
    counts are exact integers, so the dict equals the unsharded one bitwise
    for any shard count. The packs live on ``mesh.devices[0]``, one copy a
    distinct device, and the mesh's devices, not ``params.device``, decide
    where the solve runs; with no mesh it is the one-shard mesh of
    ``params.device``. The checkpoint fingerprint leaves the mesh out: a
    solve stopped at one shard count resumes at another.
    """
    if not isinstance(params, MatrixParams):
        raise TypeError("params must be a MatrixParams instance")
    result, _, stats_result = _solve(meshes, matrix=params.as_dict(), sky=None,
                                     prepared=prepared, mesh=mesh,
                                     checkpoint_dir=checkpoint_dir, row_sink=row_sink)
    if return_stats:
        return result, stats_result
    return result


def view_factor(
    sender,
    receiver,
    params: MatrixParams,
    *,
    prepared: Optional[PreparedSolver] = None,
) -> VFDict:
    """View factors from sender mesh(es) to receiver mesh(es)."""
    senders = [sender] if isinstance(sender, tuple) else list(sender)
    receivers = [receiver] if isinstance(receiver, tuple) else list(receiver)
    vf_all = view_factor_matrix(senders + receivers, params=params, prepared=prepared)
    return {name: vf_all.get(name, {}) for name in (s[0] for s in senders)}



@_tracing.solve("sky")
def view_factor_to_tregenza_sky(
    meshes: List[Mesh],
    params: SkyParams,
    *,
    prepared: Optional[PreparedSolver] = None,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    return_stats: bool = False,
):
    """Sky view factor per emitter: merged ``Sky`` or 145 Tregenza patches.

    Every mesh emits (outward, ``flip_faces=False``); a ray counts for the
    sky when it hits no triangle of another active surface, and for the
    merged ``Sky`` only when it also points up (``dz > 0``). A single mesh
    has nothing to block its rays and traces nothing: its row is all zeros.

    With ``return_stats=True`` also returns ``{emitter: {key: stderr}}``,
    the standard error of each sky fraction (per patch when discrete).
    Routed as :func:`view_factor_matrix`: a CUDA solve of more than one
    emitter goes through the whole-scene scheduled driver (any-only
    launches of kernel #2), the rest emitter by emitter (any-only launches
    of kernel #1); both return equal dicts.

    ``checkpoint_dir`` makes the solve resumable as in
    :func:`view_factor_matrix`: each emitter's converged sky row (and its
    stats) is written atomically the moment it finishes, and its monitor
    state while it converges. ``mesh`` shards every trace as in
    :func:`view_factor_matrix`; the dict is the unsharded one.
    """
    if not isinstance(params, SkyParams):
        raise TypeError("params must be a SkyParams instance")
    if len(meshes) == 0:
        raise ValueError("meshes must not be empty")
    _, result, stats_result = _solve(meshes, matrix=None, sky=params.as_dict(),
                                     prepared=prepared, mesh=mesh,
                                     checkpoint_dir=checkpoint_dir)
    if return_stats:
        return result, stats_result
    return result


def outside_workflow_shareable(matrix_params: MatrixParams, sky_params: SkyParams) -> bool:
    """True when one traced ray set can serve both the matrix and the sky.

    Requires identical ray-generation and execution settings (samples, rays,
    seed, bvh, device, cuda_async, gpu_raygen) and ``flip_faces=False`` on
    the matrix side (the sky solve emits outward).
    """
    if bool(matrix_params.flip_faces):
        return False
    shared = ("samples", "rays", "seed", "bvh", "device", "cuda_async", "gpu_raygen")
    return all(getattr(matrix_params, k) == getattr(sky_params, k) for k in shared)



@_tracing.solve("workflow")
def view_factor_matrix_and_sky(
    meshes: List[Mesh],
    *,
    matrix_params: MatrixParams,
    sky_params: SkyParams,
    prepared: Optional[PreparedSolver] = None,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    return_stats: bool = False,
):
    """The scene matrix and the sky from one shared set of rays.

    Per emitter and iteration one ray set is traced once: the nearest hits
    feed the matrix, the rays that hit nothing feed the sky. The two
    converge independently; once one side is done the emitter's later
    chunks trace the other side alone (a matrix-only or any-only sweep),
    on the same iteration stream. So each dict equals the one
    :func:`view_factor_matrix` and :func:`view_factor_to_tregenza_sky`
    return with the same parameters.

    Returns ``(vf_scene, sky_vf)``, and with ``return_stats=True`` a third
    ``{emitter: {key: stderr}}`` holding both outputs' keys in one row.

    ``checkpoint_dir`` makes the solve resumable as in
    :func:`view_factor_matrix`: each emitter's matrix row, back-fill and sky
    row are written atomically once both outputs finish (the sky row under
    its own ``sky`` key, and for older readers also inside ``stats``),
    keyed by both parameter sets and the geometry; while it converges, both
    monitors' states. Checkpoints that carry the sky row only inside
    ``stats`` (the older layout) still restore. ``mesh`` shards every trace
    as in :func:`view_factor_matrix`; both dicts are the unsharded ones.
    """
    if not isinstance(matrix_params, MatrixParams):
        raise TypeError("matrix_params must be a MatrixParams instance")
    if not isinstance(sky_params, SkyParams):
        raise TypeError("sky_params must be a SkyParams instance")
    if not outside_workflow_shareable(matrix_params, sky_params):
        raise ValueError("matrix_params and sky_params are not compatible for shared tracing")
    vf_scene, sky_vf, stats_result = _solve(
        meshes, matrix=matrix_params.as_dict(), sky=sky_params.as_dict(), prepared=prepared,
        mesh=mesh, checkpoint_dir=checkpoint_dir)
    if return_stats:
        return vf_scene, sky_vf, stats_result
    return vf_scene, sky_vf


def _progress_line(
    idx_emit: int,
    n_surf: int,
    name: str,
    iters: int,
    rays: int,
    seconds: float,
    use_bvh: bool,
    device: torch.device,
) -> str:
    return (
        f"({idx_emit + 1}/{n_surf}) [{name}] {iters} iter, {rays:,} rays -> "
        f"{seconds:0.3f}s  (BVH={'builtin' if use_bvh else 'off'}, "
        f"device={_device_label(device)})"
    )


__all__ = [
    "view_factor_matrix", "view_factor", "view_factor_to_tregenza_sky",
    "view_factor_matrix_and_sky", "outside_workflow_shareable", "clear_prepared_cache",
    "hash_meshes",
]
