"""View-factor matrix solve of the PyTorch port.

Counterpart of ``raystrack_tpu/solver.py``'s ``view_factor_matrix`` and its
two routes on an accelerator:

- the whole-scene scheduled driver (``_drive_matrix_scheduled`` ->
  ``ops.trace.scheduled_trace`` -> sweep kernel #2): every pending
  emitter's next iterations go into one dispatch per convergence round;
  a CUDA solve of more than one emitter takes it;
- the per-emitter pipelined driver (``_drive_matrix_pipelined`` ->
  ``_EmitterRun`` -> ``ops.trace.chunk_body`` -> sweep kernel #1): single
  emitters, emitters too big for a round, CPU solves by default, and
  ``RAYSTRACK_TPU_SCHEDULER=grouped``.

Both replay per-iteration counts through float64 monitors on the host, so
stopping behaviour matches a strictly sequential solve and the two routes
return equal dicts. Also as in the JAX package:

- reciprocity half-matrix tracing (only receivers with id > emitter are
  intersected; the transpose is back-filled as F*Ai/Aj),
- planar emitters cull receivers whose bounding box lies entirely behind the
  emission plane,
- per-emitter progress lines keep the format
  ``(i/n) [name] K iter, R rays -> T s (BVH=..., device=...)``,
- solves without ``prepared=`` reuse an implicit, content-keyed LRU of
  ``PreparedSolver``s (``clear_prepared_cache`` empties it).

On a CUDA device the sweeps are the kernels of ``csrc/sweep.cu``; on the
CPU they are the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import hashlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import config as _cfg
from .config import RAY_BLOCK
from .convergence import MatrixMonitor, plan_chunk
from .ops import trace as _trace
from .ops.trace_cuda import build_tri_pack
from .params import MatrixParams
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


class _EmitterRun:
    """Dispatches chunked tracing for one emitter.

    The emitter's masks and baked operand pack (98 bytes per padded
    triangle on the solve's device) are built at its first dispatch,
    reused by every later chunk, and dropped by :meth:`release` when the
    emitter finishes. An emitter the scheduled driver finishes never
    builds them.
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
    ):
        self.scene_pack = scene_pack
        self.em_pack = em_pack  # EmitterPack or LazyEmitterPack
        self.device = device
        self._surf_ext = np.zeros(surf_active.shape[0] + 1, dtype=np.int32)
        self._surf_ext[:-1] = surf_active  # the padding sid n_surf stays inactive
        self.emit_sid = int(emit_sid)
        self.min_sid = int(min_sid)
        self.tri_pack: Optional[torch.Tensor] = None
        self.sweep_mask: Optional[torch.Tensor] = None
        self.seed = seed
        self.idx_emit = idx_emit
        self.itr_next = 0  # absolute iteration index (drives the RNG stream)

    def operands(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The baked pack and sweep mask, built on first use."""
        if self.tri_pack is None:
            sp = self.scene_pack
            self.tri_pack, self.sweep_mask = _trace.emitter_operands(
                (sp.v0, sp.e1, sp.e2, sp.cross_e, sp.w_u, sp.w_v, sp.d0, sp.sid),
                _upload([self._surf_ext], np.int32, self.device)[0], self.emit_sid,
                self.min_sid, self.em_pack.plane_vec,
            )
        return self.tri_pack, self.sweep_mask

    def release(self) -> None:
        """Drop the operands; a later dispatch would build them again."""
        self.tri_pack = self.sweep_mask = None

    def dispatch_chunk(self, chunk: int) -> Callable[[], Dict[str, np.ndarray]]:
        """Queue ``chunk`` iterations without synchronising, so the driver
        can keep several emitters in flight; returns a function that waits
        for this chunk's counts only and hands them back as NumPy arrays."""
        tri_pack, sweep_mask = self.operands()
        cp = torch.from_numpy(_cp_rows(self.seed, self.idx_emit, self.itr_next, chunk))
        self.itr_next += chunk
        em = self.em_pack
        on_card = self.device.type == "cuda"
        if on_card:  # a pageable upload would wait for all queued work
            cp = cp.pin_memory().to(self.device, non_blocking=True)
        out = _trace.chunk_body(
            tri_pack, sweep_mask,
            (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2),
            (em.cdf, em.tri_a, em.tri_e1, em.tri_e2,
             em.tri_u, em.tri_v, em.tri_n, em.tri_eps),
            cp, self.scene_pack.n_surf, em.n_rays_once,
        )
        if not on_card:
            return lambda: {k: v.numpy() for k, v in out.items()}
        # copy now, behind this chunk's work only: waiting on the event
        # leaves later emitters' chunks running on the card
        host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))

        def harvest() -> Dict[str, np.ndarray]:
            ready.synchronize()
            return {k: v.numpy() for k, v in host.items()}

        return harvest


def _entry_monitors(entry) -> List[MatrixMonitor]:
    """All monitors of an entry (the sky port adds a second kind)."""
    return [entry["monitor"]]


def _entry_done(entry) -> None:
    """Completion hook, once per entry: drop the run's operands, stamp the
    emitter's wall time and fire the entry's ``on_done`` callback."""
    if entry.get("_finished"):
        return
    entry["_finished"] = True
    entry["run"].release()
    if "started" in entry:
        entry["elapsed"] = time.time() - entry["started"]
    callback = entry.get("on_done")
    if callback is not None:
        callback(entry)


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


def _drive_matrix_pipelined(entries, *, depth: int = 3) -> None:
    """Round-robin per-emitter solves with pipelined dispatch.

    Up to ``depth`` emitters have a chunk queued on the device at once, so
    the host-side float64 replay and RNG generation of one emitter overlap
    device work of the others. Results are identical to a sequential driver.

    ``entries`` is a list of dicts with keys ``run`` (_EmitterRun) and
    ``monitor``; monitors still pending are driven to completion in place
    and :func:`_entry_done` runs once per entry as it finishes.
    """
    queue = deque(e for e in entries if not e["monitor"].done)
    inflight: deque = deque()

    while queue or inflight:
        while queue and len(inflight) < depth:
            entry = queue.popleft()
            mon = entry["monitor"]
            chunk = plan_chunk(
                mon.iters_done,
                min_iters=mon.min_iters,
                interval=mon.interval,
                max_iters=mon.max_iters,
                rays_per_iter=entry["run"].em_pack.n_rays_pad,
                projected_total=mon.projected_total(),
            )
            if chunk <= 0:
                mon.done = True
                _entry_done(entry)
                continue
            inflight.append((entry, entry["run"].dispatch_chunk(chunk), chunk))
        if not inflight:
            break
        entry, harvest, chunk = inflight.popleft()
        host = harvest()
        mon = entry["monitor"]
        for k in range(chunk):
            if mon.done:
                break
            mon.consume_iteration(host["counts_f"][k], host["counts_b"][k])
        # rewind past discarded speculative iterations
        entry["run"].itr_next = mon.iters_done
        if mon.done:
            _entry_done(entry)
        else:
            queue.append(entry)


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


def _drive_scheduled(entries, prepared_solver: PreparedSolver, p: Dict,
                     flip_faces: bool, align: int, scene_pack: ScenePack,
                     device: torch.device, n_surf: int, *, consume) -> None:
    """Whole-scene scheduled solves: one dispatch per convergence round.

    Builds a block schedule spanning every pending emitter's next chunk and
    runs it as one :func:`ops.trace.scheduled_trace` (one launch of sweep
    kernel #2), then replays per-(emitter, iteration) sums of the rows'
    counts through the monitors. The dispatch count becomes the number of
    convergence rounds of the slowest emitter instead of emitters x rounds.

    A round holds at most ``max(SCHED_MIN_BLOCKS, TARGET_CHUNK_RAYS //
    RAY_BLOCK)`` schedule rows of ``RAY_BLOCK`` rays (the rays are
    materialised for the kernel); an emitter whose single iteration exceeds
    that stays pending for the per-emitter driver. Each round dispatches
    exactly its rows: eager PyTorch compiles nothing per shape, so the JAX
    package's size buckets, padding rows and background precompiles have no
    counterpart.

    ``consume(entry, host, start_row, bpi, chunk)`` replays one entry's
    iterations through its monitor(s) and must advance
    ``entry['run'].itr_next`` monotonically (``max`` with the monitors'
    consumed count, never a smaller value: under round pipelining itr_next
    already covers the next dispatched-but-unconsumed round).

    With ``SCHED_PIPELINE`` (default on) round k+1 is planned and dispatched
    before round k's counts are fetched; a round whose emitters all
    converged while it was in flight is dropped without the fetch.
    """
    # Every flat-table offset must be a RAY_BLOCK multiple: scheduled_trace
    # takes the tables as (-1, RAY_BLOCK) rows. Offsets are align-multiples.
    if align % RAY_BLOCK:
        raise ValueError(
            f"scheduled driver requires align ({align}) to be a multiple of "
            f"RAY_BLOCK ({RAY_BLOCK})"
        )
    tables_flat, geom_stacked, offsets, n_pad = prepared_solver.get_flat_tables(
        samples=p["samples"], rays=p["rays"], flip_faces=flip_faces,
        align=align, device=device,
    )
    scene_t = (
        scene_pack.v0, scene_pack.e1, scene_pack.e2, scene_pack.cross_e,
        scene_pack.w_u, scene_pack.w_v, scene_pack.d0, scene_pack.sid,
    )
    # one pack with zero mask rows serves every emitter of every round:
    # kernel #2 takes eligibility from the per-round combined mask rows
    no_mask = torch.zeros_like(scene_pack.sid, dtype=torch.bool)
    tri_pack = build_tri_pack(scene_t, no_mask, no_mask)

    def entry_pending(entry) -> bool:
        return any(not m.done for m in _entry_monitors(entry))

    def entry_plan(entry, rays_per_iter: int) -> int:
        # exact chunks: a round reaches each checkpoint at once. Under round
        # pipelining itr_next runs one dispatched-but-unconsumed round ahead
        # of iters_done; planning then measures from the hypothetical
        # position "in-flight round consumed, nothing converged, projections
        # unmoved". With nothing in flight this is the sequential plan.
        itr_next = entry["run"].itr_next
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
            for m in _entry_monitors(entry)
            if not m.done
        )

    max_blocks = max(_cfg.SCHED_MIN_BLOCKS, _cfg.TARGET_CHUNK_RAYS // RAY_BLOCK)
    # an emitter whose single iteration exceeds the round budget can never
    # fit a round: it stays pending for the per-emitter driver, which
    # bounds rays per dispatch
    pending = [
        e for e in entries
        if entry_pending(e) and int(n_pad[e["idx"]]) // RAY_BLOCK <= max_blocks
    ]
    fuse_rounds = _cfg.SCHED_FUSE_ROUNDS or 1

    def build_round(pending) -> Optional[_Round]:
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
                run = entry["run"]
                e = entry["idx"]
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

        # the round's emitter rows: only the emitters it references
        by_entry = {entry["idx"]: entry for entry, *_ in plan}
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
            surf_b[local_e, :-1] = entry["surf_active"]
            emit_b[local_e] = entry["emit_sid"]
            min_b[local_e] = entry["min_sid"]
            once_b[local_e] = entry["run"].em_pack.n_rays_once
            plane_b[local_e] = entry["run"].em_pack.plane_host

        schedule, surf_t, emit_t, min_t, once_t, sel_t = _upload(
            [np.concatenate(row_chunks), surf_b, emit_b, min_b, once_b, sel],
            np.int32, device,
        )
        cp_t, plane_t = _upload([np.concatenate(cp_chunks), plane_b], np.float32, device)
        flat = _trace.scheduled_trace(
            scene_t, tri_pack, tables_flat, geom_stacked, cp_t, surf_t, emit_t,
            min_t, once_t, plane_t, schedule, sel_t, sched_block=RAY_BLOCK,
        )
        if device.type != "cuda":
            return _Round(flat, None, plan, n_rows)
        # one packed copy, behind this round's work only
        host = flat.to("cpu", non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
        return _Round(host, ready, plan, n_rows)

    def consume_round(round_: _Round) -> None:
        if round_.ready is not None:
            round_.ready.synchronize()
        host = _trace.unpack_outputs(round_.host.numpy(), round_.n_rows, n_surf)
        for entry, start_row, bpi, chunk in round_.plan:
            consume(entry, host, start_row, bpi, chunk)
            if not entry_pending(entry):
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
                    for m in _entry_monitors(entry):
                        m.done = True
                    _entry_done(entry)
            break
        if not pipeline and nxt is not None:
            consume_round(nxt)  # sequential: fetch before planning the next
            pending = [e for e in pending if entry_pending(e)]
            continue
        if inflight is not None:
            if any(entry_pending(e) for e, *_ in inflight.plan):
                consume_round(inflight)
                pending = [e for e in pending if entry_pending(e)]
            # else: every emitter of the round converged while it was in
            # flight; its iterations would all be discarded, so it is
            # dropped without the fetch
        inflight = nxt


def _drive_matrix_scheduled(entries, prepared_solver: PreparedSolver, p: Dict,
                            flip_faces: bool, align: int, scene_pack: ScenePack,
                            device: torch.device, n_surf: int) -> None:
    def consume(entry, host, start_row, bpi, chunk):
        mon = entry["monitor"]
        for c in range(chunk):
            if mon.done:
                break
            r0 = start_row + c * bpi
            mon.consume_iteration(
                host["counts_f"][r0 : r0 + bpi].sum(axis=0),
                host["counts_b"][r0 : r0 + bpi].sum(axis=0),
            )
        # never rewind: under round pipelining itr_next may already cover a
        # dispatched-but-unconsumed round
        entry["run"].itr_next = max(entry["run"].itr_next, mon.iters_done)

    _drive_scheduled(
        entries, prepared_solver, p, flip_faces, align, scene_pack, device,
        n_surf, consume=consume,
    )


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
    ``prepared`` reuses a :class:`PreparedSolver`'s geometry, tables and
    device packs across solves; without it an implicit content-keyed cache
    does the same (``RAYSTRACK_TPU_PREPARED_CACHE=0`` turns it off).

    A CUDA solve of more than one emitter goes through the whole-scene
    scheduled driver; ``RAYSTRACK_TPU_SCHEDULER=grouped`` sends it emitter
    by emitter instead and ``scheduled`` forces the scheduler on the CPU.
    Both routes return equal dicts.
    """
    if not isinstance(params, MatrixParams):
        raise TypeError("params must be a MatrixParams instance")
    for name, value, item in (
        ("mesh", mesh, "parallel/ (ray sharding with an NCCL sum of the counts)"),
        ("checkpoint_dir", checkpoint_dir, "checkpoints and row_sink"),
        ("row_sink", row_sink, "checkpoints and row_sink"),
    ):
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported yet (ROADMAP port queue: {item})"
            )
    p = params.as_dict()
    device = _resolve_device(p["device"])
    # CPU solves check convergence every iteration; the interval only
    # batches checks on the card
    interval = 1 if device.type == "cpu" else p["convergence_interval"]
    prepared_solver = _ensure_prepared(meshes, prepared)
    use_bvh = _select_bvh(p["bvh"], prepared_solver.total_faces)
    reciprocity = bool(p["reciprocity"])
    flip_faces = bool(p["flip_faces"])

    result: VFDict = {name: {} for name, _, _ in meshes}
    stats_result: VFDict = {}
    emitters = prepared_solver.get_emitters(
        samples=p["samples"], rays=p["rays"], flip_faces=flip_faces
    )
    areas = [e.total_area for e in emitters] if reciprocity else None
    bounds_center, bounds_extent = prepared_solver.get_mesh_bounds()
    align = RAY_BLOCK
    use_scheduler = _use_scheduler(device, emitters, p["rays"], align)
    scene_pack = prepared_solver.get_scene_pack(use_accel=use_bvh, device=device)

    n_surf = len(meshes)
    # Phase 1: skip emitters with no receivers, build the work list
    entries: List[Dict] = []
    for idx_emit, (name_e, _, _) in enumerate(meshes):
        emitter = emitters[idx_emit]
        surf_active = _build_emitter_surface_mask(
            idx_emit, emitter, bounds_center, bounds_extent
        )
        receivers, recv_idx = _matrix_active_receivers(
            idx_emit, n_surf, reciprocity, surf_active
        )
        if not receivers:
            _log(_progress_line(idx_emit, n_surf, name_e, 0, 0, 0.0, use_bvh, device))
            stats_result[name_e] = {}
            continue

        emit_sid, min_sid = _matrix_skip(idx_emit, reciprocity)
        em_pack = _make_emitter_pack(
            prepared_solver, idx_emit, p, flip_faces, align, device,
            lazy=use_scheduler,
        )
        run = _EmitterRun(
            scene_pack, em_pack, surf_active, emit_sid, min_sid,
            p["seed"], idx_emit, device,
        )
        monitor = MatrixMonitor(
            n_surf, recv_idx,
            n_rays_once=em_pack.n_rays_once,
            tol=p["tol"], tol_mode=p["tol_mode"],
            min_iters=p["min_iters"], interval=interval,
            max_iters=p["max_iters"],
        )
        entries.append(
            dict(run=run, monitor=monitor, idx=idx_emit, name=name_e,
                 receivers=receivers, surf_active=surf_active,
                 emit_sid=emit_sid, min_sid=min_sid)
        )

    def _assemble(entry) -> None:
        """Build the emitter's row, back-fill and stats as it converges."""
        idx_emit, name_e = entry["idx"], entry["name"]
        monitor = entry["monitor"]
        se_f = monitor.wf.stderr()
        se_b = monitor.wb.stderr()
        row: Dict[str, float] = {}
        stats_row: Dict[str, float] = {}
        backfill: Dict[str, Dict[str, float]] = {}
        total = float(monitor.total_rays)
        for j in entry["receivers"]:
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
        entry["row"] = row
        entry["stats"] = stats_row
        entry["backfill"] = backfill

    # Phase 2: whole-scene scheduled dispatches when possible, then the
    # pipelined per-emitter driver for whatever is left (single emitters,
    # emitters too big for a round)
    t_solve = time.time()
    for entry in entries:
        entry["started"] = t_solve
        entry["on_done"] = _assemble
    if len(entries) > 1 and use_scheduler:
        _drive_matrix_scheduled(
            entries, prepared_solver, p, flip_faces, align, scene_pack, device, n_surf,
        )
    _drive_matrix_pipelined(entries)
    solve_s = time.time() - t_solve

    # Phase 3: merge rows into the result in emitter order
    for entry in entries:
        idx_emit, name_e, monitor = entry["idx"], entry["name"], entry["monitor"]
        result[name_e].update(entry["row"])
        for name_r, back_entries in entry["backfill"].items():
            result[name_r].update(back_entries)
        stats_result[name_e] = entry["stats"]
        _log(
            _progress_line(
                idx_emit, n_surf, name_e, monitor.iters_done,
                monitor.total_rays, entry.get("elapsed", solve_s), use_bvh, device,
            )
        )

    if p["enforce_reciprocity_rowsum"]:
        _enforce_reciprocity_and_rowsum(result, meshes, areas)
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


__all__ = ["view_factor_matrix", "view_factor", "clear_prepared_cache", "hash_meshes"]
