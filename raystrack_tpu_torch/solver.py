"""View-factor solves of the PyTorch port: the matrix, the sky and both.

Counterpart of ``raystrack_tpu/solver.py``'s ``view_factor_matrix``,
``view_factor_to_tregenza_sky`` and ``view_factor_matrix_and_sky`` (the
shared-ray workflow), and of their two routes on an accelerator:

- the whole-scene scheduled driver (``_drive_scheduled`` under
  ``_drive_matrix_scheduled``, ``_drive_sky_scheduled`` and
  ``_drive_combined_scheduled`` -> ``ops.trace.scheduled_trace`` -> sweep
  kernel #2): every pending emitter's next iterations go into one dispatch
  per convergence round; a CUDA solve of more than one emitter takes it;
- the per-emitter pipelined driver (``_drive_pipelined`` under the matrix
  and sky drivers, and ``_drive_combined_pipelined`` -> ``_EmitterRun`` ->
  ``ops.trace.chunk_body`` -> sweep kernel #1): single emitters, emitters
  too big for a round, CPU solves by default, and
  ``RAYSTRACK_TPU_SCHEDULER=grouped``.

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
- ``checkpoint_dir=`` resumes a stopped solve (``_CheckpointStore``: one
  JSON file per finished emitter and, every ``CHECKPOINT_PROGRESS_S``
  seconds, a snapshot of each pending one's monitors; the JAX package's
  layout and fingerprint), ``row_sink=`` streams the matrix's rows as they
  complete (``_OrderedRowSink``), and ``RAYSTRACK_TPU_PROFILE=<dir>``
  writes a ``torch.profiler`` trace of the matrix solve.

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
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import config as _cfg
from .config import RAY_BLOCK
from .convergence import MatrixMonitor, SkyMonitor, plan_chunk
from .ops import trace as _trace
from .ops.trace_cuda import build_tri_pack
from .params import MatrixParams, SkyParams
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


def _maybe_profiler():
    """Optional ``torch.profiler`` capture, enabled by
    ``RAYSTRACK_TPU_PROFILE=<dir>``.

    Returns a callable producing a context manager: while it is open the
    profiler records CPU and (with a card) CUDA activity under
    ``record_function(name)``, and on exit it writes a Chrome trace
    ``<dir>/<name>.<pid>.<ns>.json``. Unset, the context manager does
    nothing.
    """
    trace_dir = os.environ.get("RAYSTRACK_TPU_PROFILE")
    if not trace_dir:
        return lambda name: contextlib.nullcontext()

    from torch.profiler import ProfilerActivity, profile, record_function

    @contextlib.contextmanager
    def annotated(name: str):
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function(name):
                yield
        out = Path(trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"{name}.{os.getpid()}.{time.time_ns()}.json"))

    return annotated


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
        # want_any -> (operand pack, sweep mask, code_bounds or None)
        self.packs: Dict[bool, Tuple[torch.Tensor, torch.Tensor, Optional[Tuple]]] = {}
        self.seed = seed
        self.idx_emit = idx_emit
        self.itr_next = 0  # absolute iteration index (drives the RNG stream)

    def operands(self, want_any: bool) -> Tuple[torch.Tensor, torch.Tensor, Optional[Tuple]]:
        """The operand pack (baked for this kind, or a slim scene's
        resident one), the sweep mask and the slim ``code_bounds`` (None
        for a baked pack) of a dispatch that does or does not want
        any-hits, built on first use."""
        ops = self.packs.get(want_any)
        if ops is None:
            sp = self.scene_pack
            surf_ext = _upload([self._surf_ext], np.int32, self.device)[0]
            if sp.slim:
                mask, bounds = _trace.slim_operands(
                    sp.sid, surf_ext, self.emit_sid, self.min_sid, want_any=want_any)
                ops = (sp.tri_pack, mask, bounds)
            else:
                pack, mask = _trace.emitter_operands(
                    (sp.v0, sp.e1, sp.e2, sp.cross_e, sp.w_u, sp.w_v, sp.d0, sp.sid),
                    surf_ext, self.emit_sid, self.min_sid, self.em_pack.plane_vec,
                    want_any=want_any,
                )
                ops = (pack, mask, None)
            self.packs[want_any] = ops
        return ops

    def release(self) -> None:
        """Drop the operands; a later dispatch would build them again. A
        slim scene's resident pack stays with its scene pack."""
        self.packs.clear()

    def dispatch_chunk(self, chunk: int, *, want_matrix: bool, want_any: bool,
                       discrete: bool) -> Callable[[], Dict[str, np.ndarray]]:
        """Queue ``chunk`` iterations of the outputs the three flags pick
        (:func:`ops.trace.chunk_body`) without synchronising, so the driver
        can keep several emitters in flight; returns a function that waits
        for this chunk's counts only and hands them back as NumPy arrays."""
        tri_pack, sweep_mask, code_bounds = self.operands(want_any)
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
            cp, self.scene_pack.n_surf, em.n_rays_once, accel=self.scene_pack.accel,
            code_bounds=code_bounds, want_matrix=want_matrix, want_any=want_any,
            discrete=discrete,
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


def _entry_monitors(entry) -> List:
    """All live monitors of an entry: its ``monitor`` (a matrix or sky
    solve), or the workflow's ``matrix_mon`` (None for an emitter with no
    receivers) and ``sky_mon``."""
    if "monitor" in entry:
        return [entry["monitor"]]
    return [m for m in (entry.get("matrix_mon"), entry.get("sky_mon")) if m is not None]


def _entry_progress(entry) -> None:
    """Rate-limited mid-emitter snapshot hook, fired by every driver after an
    entry's chunk or round replay while it stays pending. No-op unless the
    solve attached ``on_progress``, and never after :func:`_entry_done`."""
    callback = entry.get("on_progress")
    if callback is None or entry.get("_finished"):
        return
    if _cfg.CHECKPOINT_PROGRESS_S < 0:
        return
    now = time.time()
    if now - entry.get("_progress_ts", 0.0) < _cfg.CHECKPOINT_PROGRESS_S:
        return
    entry["_progress_ts"] = now
    callback(entry)


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


def _drive_pipelined(entries, *, want_matrix: bool, want_any: bool, discrete: bool,
                     consume, depth: int = 3) -> None:
    """Round-robin single-output per-emitter solves with pipelined dispatch.

    Up to ``depth`` emitters have a chunk queued on the device at once, so
    the host-side float64 replay and RNG generation of one emitter overlap
    device work of the others. Results are identical to a sequential driver.

    ``entries`` is a list of dicts with keys ``run`` (_EmitterRun) and
    ``monitor``; ``consume(monitor, host, k)`` folds iteration ``k`` of a
    chunk's host counts into the monitor. Monitors still pending are driven
    to completion in place and :func:`_entry_done` runs once per entry as it
    finishes.
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
            harvest = entry["run"].dispatch_chunk(
                chunk, want_matrix=want_matrix, want_any=want_any, discrete=discrete)
            inflight.append((entry, harvest, chunk))
        if not inflight:
            break
        entry, harvest, chunk = inflight.popleft()
        host = harvest()
        mon = entry["monitor"]
        for k in range(chunk):
            if mon.done:
                break
            consume(mon, host, k)
        # rewind past discarded speculative iterations
        entry["run"].itr_next = mon.iters_done
        if mon.done:
            _entry_done(entry)
        else:
            _entry_progress(entry)
            queue.append(entry)


def _consume_sky(mon: SkyMonitor, host, rows, discrete: bool) -> None:
    """Fold one iteration's sky counts (the sum of ``host``'s rows
    ``rows``: one row per-emitter, an iteration's schedule rows on the
    scheduled route) into ``mon``."""
    if discrete:
        mon.consume_iteration(host["sky_bins"][rows].sum(axis=0))
    else:
        mon.consume_iteration(int(host["upward"][rows].sum()))


def _drive_matrix_pipelined(entries, *, depth: int = 3) -> None:
    _drive_pipelined(
        entries, want_matrix=True, want_any=False, discrete=False,
        consume=lambda mon, host, k: mon.consume_iteration(
            host["counts_f"][k], host["counts_b"][k]),
        depth=depth,
    )


def _drive_sky_pipelined(entries, *, discrete: bool, depth: int = 3) -> None:
    _drive_pipelined(
        entries, want_matrix=False, want_any=True, discrete=discrete,
        consume=lambda mon, host, k: _consume_sky(mon, host, slice(k, k + 1), discrete),
        depth=depth,
    )


def _consume_both(entry, host, rows, discrete: bool, m_pending: bool = True,
                  s_pending: bool = True) -> None:
    """Fold one iteration of a shared-ray dispatch (``host``'s rows
    ``rows``) into each of the entry's monitors that the dispatch served
    and that is still pending, and advance ``trace_iters``, the iterations
    the emitter's RNG stream has consumed."""
    m, s = entry["matrix_mon"], entry["sky_mon"]
    used = False
    if m_pending and m is not None and not m.done:
        m.consume_iteration(host["counts_f"][rows].sum(axis=0),
                            host["counts_b"][rows].sum(axis=0))
        used = True
    if s_pending and not s.done:
        _consume_sky(s, host, rows, discrete)
        used = True
    if used:
        entry["trace_iters"] = max(entry["trace_iters"],
                                   m.iters_done if m is not None else 0, s.iters_done)


def _drive_combined_pipelined(entries, *, discrete: bool, depth: int = 3) -> None:
    """Pipelined round-robin over emitters with dual (matrix, sky) monitors.

    The shared-ray workflow's counterpart of :func:`_drive_pipelined`: each
    emitter's dispatch kind follows its own state machine (matrix + any
    while both outputs are pending, then only the pending one), and up to
    ``depth`` emitters keep a chunk in flight. The replay rewinds the RNG
    stream both outputs share to ``trace_iters``, past the iterations that
    neither monitor used.

    ``entries`` carry ``run``, ``matrix_mon`` (None without receivers),
    ``sky_mon`` and ``trace_iters``, which the replay advances.
    """
    queue = deque(e for e in entries if any(not m.done for m in _entry_monitors(e)))
    inflight: deque = deque()

    while queue or inflight:
        while queue and len(inflight) < depth:
            entry = queue.popleft()
            m, s = entry["matrix_mon"], entry["sky_mon"]
            m_pending = m is not None and not m.done
            s_pending = not s.done
            chunk = 0
            for mon in _entry_monitors(entry):
                if mon.done:
                    continue
                chunk = max(chunk, plan_chunk(
                    mon.iters_done,
                    min_iters=mon.min_iters,
                    interval=mon.interval,
                    max_iters=mon.max_iters,
                    rays_per_iter=entry["run"].em_pack.n_rays_pad,
                    projected_total=mon.projected_total(),
                ))
            if chunk <= 0:
                for mon in _entry_monitors(entry):
                    mon.done = True
                _entry_done(entry)
                continue
            harvest = entry["run"].dispatch_chunk(
                chunk, want_matrix=m_pending, want_any=s_pending, discrete=discrete)
            inflight.append((entry, harvest, chunk, m_pending, s_pending))
        if not inflight:
            break
        entry, harvest, chunk, m_pending, s_pending = inflight.popleft()
        host = harvest()
        for k in range(chunk):
            _consume_both(entry, host, slice(k, k + 1), discrete, m_pending, s_pending)
        entry["run"].itr_next = entry["trace_iters"]
        if all(m.done for m in _entry_monitors(entry)):
            _entry_done(entry)
        else:
            _entry_progress(entry)
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
                     device: torch.device, n_surf: int, *, want_matrix: bool,
                     want_any: bool, discrete: bool, consume) -> None:
    """Whole-scene scheduled solves: one dispatch per convergence round.

    Builds a block schedule spanning every pending emitter's next chunk and
    runs it as one :func:`ops.trace.scheduled_trace` of the outputs the
    three flags pick (one launch of sweep kernel #2), then replays
    per-(emitter, iteration) sums of the rows' counts through the monitors. The dispatch count becomes the number of
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
            accel=scene_pack.accel, want_matrix=want_matrix, want_any=want_any,
            discrete=discrete,
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
        host = _trace.unpack_outputs(round_.host.numpy(), round_.n_rows, n_surf,
                                     want_matrix=want_matrix, want_any=want_any,
                                     discrete=discrete)
        for entry, start_row, bpi, chunk in round_.plan:
            consume(entry, host, start_row, bpi, chunk)
            if not entry_pending(entry):
                _entry_done(entry)
            else:
                _entry_progress(entry)

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
        n_surf, want_matrix=True, want_any=False, discrete=False, consume=consume,
    )


def _drive_sky_scheduled(entries, prepared_solver: PreparedSolver, p: Dict, align: int,
                         scene_pack: ScenePack, device: torch.device, n_surf: int, *,
                         discrete: bool) -> None:
    def consume(entry, host, start_row, bpi, chunk):
        mon = entry["monitor"]
        for c in range(chunk):
            if mon.done:
                break
            r0 = start_row + c * bpi
            _consume_sky(mon, host, slice(r0, r0 + bpi), discrete)
        # never rewind (see _drive_matrix_scheduled.consume)
        entry["run"].itr_next = max(entry["run"].itr_next, mon.iters_done)

    _drive_scheduled(
        entries, prepared_solver, p, False, align, scene_pack, device, n_surf,
        want_matrix=False, want_any=True, discrete=discrete, consume=consume,
    )


def _drive_combined_scheduled(entries, prepared_solver: PreparedSolver, p: Dict,
                              align: int, scene_pack: ScenePack, device: torch.device,
                              n_surf: int, *, discrete: bool) -> None:
    """Scheduled shared-ray workflow: both outputs for every block of every
    round; each monitor consumes only while pending, the dual-monitor
    replay of :func:`_drive_combined_pipelined`."""

    def consume(entry, host, start_row, bpi, chunk):
        for c in range(chunk):
            r0 = start_row + c * bpi
            _consume_both(entry, host, slice(r0, r0 + bpi), discrete)
        # never rewind (see _drive_matrix_scheduled.consume)
        entry["run"].itr_next = max(entry["run"].itr_next, entry["trace_iters"])

    _drive_scheduled(
        entries, prepared_solver, p, False, align, scene_pack, device, n_surf,
        want_matrix=True, want_any=True, discrete=discrete, consume=consume,
    )


def _refuse_unported(mesh) -> None:
    """Raise ``NotImplementedError`` for ``mesh=``, the one solve option the
    port does not have yet, naming its ROADMAP item."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet (ROADMAP port queue 1, parallel/: ray sharding "
            "with an NCCL sum of the counts)"
        )


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

    def resume(self, entry: Dict, n_surf: int, load: Callable[[Dict, Dict], None],
               state: Callable[[Dict], Dict]) -> None:
        """Resume ``entry`` from its emitter's progress snapshot, if there is
        one, and snapshot it from now on.

        ``load(entry, snapshot)`` restores its monitors. A snapshot holds
        only consumed iterations, so the ray stream resumes at the first one
        no monitor has seen. ``state(entry)`` is the snapshot to save."""
        idx = entry["idx"]
        progress = self.load_progress(idx)
        if progress is not None:
            load(entry, progress)
            run = entry["run"]
            run.itr_next = max(m.iters_done for m in _entry_monitors(entry))
            _log(f"({idx + 1}/{n_surf}) [{entry['name']}] resuming from "
                 f"iteration {run.itr_next}")
        entry["on_progress"] = lambda e: self.save_progress(e["idx"], state(e))


def _monitor_state(entry: Dict) -> Dict:
    """Progress snapshot of a matrix or sky entry."""
    return {"monitor": entry["monitor"].state_dict()}


def _load_monitor_state(entry: Dict, snapshot: Dict) -> None:
    entry["monitor"].load_state(snapshot["monitor"])


def _combined_state(entry: Dict) -> Dict:
    """Progress snapshot of a shared-ray workflow entry: both monitors
    (``matrix`` None for an emitter with no receivers)."""
    m = entry["matrix_mon"]
    return {"matrix": None if m is None else m.state_dict(),
            "sky": entry["sky_mon"].state_dict()}


def _load_combined_state(entry: Dict, snapshot: Dict) -> None:
    if entry["matrix_mon"] is not None and snapshot.get("matrix") is not None:
        entry["matrix_mon"].load_state(snapshot["matrix"])
    entry["sky_mon"].load_state(snapshot["sky"])


def _start_entries(entries: List[Dict], on_done: Callable[[Dict], None]) -> float:
    """Stamp each entry's start and attach its ``on_done``. An entry that a
    snapshot restored converged (its full checkpoint not yet written) is
    assembled now and traces nothing. Returns the start time."""
    t_solve = time.time()
    for entry in entries:
        entry["started"] = t_solve
        entry["on_done"] = on_done
        if all(m.done for m in _entry_monitors(entry)):
            _entry_done(entry)
    return t_solve


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
    trace of the solve into ``<dir>``.

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
    """
    if not isinstance(params, MatrixParams):
        raise TypeError("params must be a MatrixParams instance")
    _refuse_unported(mesh)
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
    profiler = _maybe_profiler()
    store = _CheckpointStore(checkpoint_dir, p, meshes) if checkpoint_dir else None
    emitters = prepared_solver.get_emitters(
        samples=p["samples"], rays=p["rays"], flip_faces=flip_faces
    )
    areas = [e.total_area for e in emitters] if reciprocity else None
    bounds_center, bounds_extent = prepared_solver.get_mesh_bounds()
    align = RAY_BLOCK
    scene_pack = prepared_solver.get_scene_pack(use_accel=use_bvh, device=device)
    # a slim (pack-resident) scene goes emitter by emitter: that driver
    # sweeps the resident pack as it is, where the scheduled one would
    # assemble a second pack from per-triangle fields a slim scene does
    # not hold
    use_scheduler = not scene_pack.slim and _use_scheduler(
        device, emitters, p["rays"], align)

    n_surf = len(meshes)
    n_restored = 0
    # Reciprocity lands back-fill in other emitters' rows; the ordered
    # coordinator defers each sink until its row's back-fill is complete.
    ordered_sink = (
        _OrderedRowSink(row_sink, [name for name, _, _ in meshes])
        if (row_sink is not None and reciprocity)
        else None
    )
    # Phase 1: restore checkpoints, skip emitters with no receivers, build
    # the work list
    entries: List[Dict] = []
    for idx_emit, (name_e, _, _) in enumerate(meshes):
        saved = store.load(idx_emit) if store is not None else None
        if saved is not None:
            result[name_e].update(saved["row"])
            for other, back_entries in saved.get("backfill", {}).items():
                result[other].update(back_entries)
            stats_result[name_e] = saved.get("stats", {})
            n_restored += 1
            # re-sunk: the stream of the stopped solve did not outlive it
            if ordered_sink is not None:
                ordered_sink.finish(idx_emit, saved["row"], saved.get("backfill", {}))
            elif row_sink is not None:
                row_sink(name_e, saved["row"])
            _log(
                f"({idx_emit + 1}/{n_surf}) [{name_e}] restored from "
                f"checkpoint ({len(saved['row'])} receivers)"
            )
            continue
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
            if store is not None:
                store.save(idx_emit, name_e, {}, {}, {})
            if ordered_sink is not None:
                # traces nothing itself, but its row still collects earlier
                # emitters' back-fill (e.g. the LAST emitter under
                # reciprocity, whose whole row is back-fill)
                ordered_sink.finish(idx_emit, {}, {})
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
        entry = dict(run=run, monitor=monitor, idx=idx_emit, name=name_e,
                     receivers=receivers, surf_active=surf_active,
                     emit_sid=emit_sid, min_sid=min_sid)
        if store is not None:
            store.resume(entry, n_surf, _load_monitor_state, _monitor_state)
        entries.append(entry)

    def _assemble(entry) -> None:
        """Build the emitter's row, back-fill and stats as it converges,
        checkpoint it and sink its row, so a solve stopped later keeps every
        finished emitter."""
        idx_emit, name_e = entry["idx"], entry["name"]
        row, stats_row, backfill = _matrix_row(
            entry["monitor"], entry["receivers"], meshes, idx_emit, reciprocity, areas)
        entry.update(row=row, stats=stats_row, backfill=backfill)
        if store is not None:
            store.save(idx_emit, name_e, row, backfill, stats_row)
        if ordered_sink is not None:
            ordered_sink.finish(idx_emit, row, backfill)
        elif row_sink is not None:
            row_sink(name_e, row)

    t_solve = _start_entries(entries, _assemble)

    # Phase 2: whole-scene scheduled dispatches when possible, then the
    # pipelined per-emitter driver for whatever is left (single emitters,
    # emitters too big for a round)
    with profiler("matrix_solve"):
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
    if n_restored:
        _log(f"{n_restored}/{n_surf} emitters restored from checkpoint (not re-traced)")

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
    state while it converges.
    """
    if not isinstance(params, SkyParams):
        raise TypeError("params must be a SkyParams instance")
    if len(meshes) == 0:
        raise ValueError("meshes must not be empty")
    _refuse_unported(mesh)

    p = params.as_dict()
    discrete = bool(p["discrete"])
    device = _resolve_device(p["device"])
    interval = 1 if device.type == "cpu" else p["convergence_interval"]
    prepared_solver = _ensure_prepared(meshes, prepared)
    use_bvh = _select_bvh(p["bvh"], prepared_solver.total_faces)
    emitters = prepared_solver.get_emitters(
        samples=p["samples"], rays=p["rays"], flip_faces=False
    )
    bounds_center, bounds_extent = prepared_solver.get_mesh_bounds()
    align = RAY_BLOCK
    scene_pack = prepared_solver.get_scene_pack(use_accel=use_bvh, device=device)
    # slim (pack-resident) scenes take the per-emitter driver only
    use_scheduler = not scene_pack.slim and _use_scheduler(
        device, emitters, p["rays"], align)

    result: VFDict = {name: {k: 0.0 for k in _sky_keys(discrete)} for name, _, _ in meshes}
    stats_result: VFDict = {}
    store = _CheckpointStore(checkpoint_dir, p, meshes) if checkpoint_dir else None
    n_surf = len(meshes)
    n_restored = 0
    entries: List[Dict] = []
    if n_surf > 1:
        for idx_emit, (name_e, _, _) in enumerate(meshes):
            saved = store.load(idx_emit) if store is not None else None
            if saved is not None:
                result[name_e].update(saved["row"])
                stats_result[name_e] = saved.get("stats", {})
                n_restored += 1
                _log(f"({idx_emit + 1}/{n_surf}) [{name_e}] restored from checkpoint")
                continue
            surf_active = _build_emitter_surface_mask(
                idx_emit, emitters[idx_emit], bounds_center, bounds_extent
            )
            em_pack = _make_emitter_pack(
                prepared_solver, idx_emit, p, False, align, device, lazy=use_scheduler,
            )
            run = _EmitterRun(
                scene_pack, em_pack, surf_active, idx_emit, 0, p["seed"], idx_emit, device,
            )
            monitor = SkyMonitor(
                discrete=discrete,
                n_rays_once=em_pack.n_rays_once,
                tol=p["tol"], tol_mode=p["tol_mode"],
                min_iters=p["min_iters"], interval=interval,
                max_iters=p["max_iters"],
            )
            entry = dict(run=run, monitor=monitor, idx=idx_emit, name=name_e,
                         surf_active=surf_active, emit_sid=idx_emit, min_sid=0)
            if store is not None:
                store.resume(entry, n_surf, _load_monitor_state, _monitor_state)
            entries.append(entry)

    def _assemble(entry) -> None:
        entry["row"], entry["stats"] = _sky_row(entry["monitor"], discrete)
        if store is not None:
            store.save(entry["idx"], entry["name"], entry["row"], {}, entry["stats"])

    t_solve = _start_entries(entries, _assemble)
    if len(entries) > 1 and use_scheduler:
        _drive_sky_scheduled(
            entries, prepared_solver, p, align, scene_pack, device, n_surf,
            discrete=discrete,
        )
    _drive_sky_pipelined(entries, discrete=discrete)
    solve_s = time.time() - t_solve

    for entry in entries:
        idx_emit, name_e, monitor = entry["idx"], entry["name"], entry["monitor"]
        result[name_e].update(entry["row"])
        stats_result[name_e] = entry["stats"]
        _log(
            _progress_line(
                idx_emit, n_surf, name_e, monitor.iters_done,
                monitor.total_rays, entry.get("elapsed", solve_s), use_bvh, device,
            )
        )
    if n_restored:
        _log(f"{n_restored}/{n_surf} emitters restored from checkpoint (not re-traced)")
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
    ``stats`` (the older layout) still restore.
    """
    if not isinstance(matrix_params, MatrixParams):
        raise TypeError("matrix_params must be a MatrixParams instance")
    if not isinstance(sky_params, SkyParams):
        raise TypeError("sky_params must be a SkyParams instance")
    if not outside_workflow_shareable(matrix_params, sky_params):
        raise ValueError("matrix_params and sky_params are not compatible for shared tracing")
    _refuse_unported(mesh)

    mp = matrix_params.as_dict()
    sp = sky_params.as_dict()
    store = (
        _CheckpointStore(
            checkpoint_dir,
            {**{f"m.{k}": v for k, v in mp.items()},
             **{f"s.{k}": v for k, v in sp.items()}},
            meshes,
        )
        if checkpoint_dir
        else None
    )
    discrete = bool(sp["discrete"])
    reciprocity = bool(mp["reciprocity"])
    device = _resolve_device(mp["device"])
    on_cpu = device.type == "cpu"
    prepared_solver = _ensure_prepared(meshes, prepared)
    use_bvh = _select_bvh(mp["bvh"], prepared_solver.total_faces)
    emitters = prepared_solver.get_emitters(
        samples=mp["samples"], rays=mp["rays"], flip_faces=False
    )
    areas = [e.total_area for e in emitters] if reciprocity else None
    bounds_center, bounds_extent = prepared_solver.get_mesh_bounds()
    align = RAY_BLOCK
    scene_pack = prepared_solver.get_scene_pack(use_accel=use_bvh, device=device)
    use_scheduler = not scene_pack.slim and _use_scheduler(
        device, emitters, mp["rays"], align)

    vf_scene: VFDict = {name: {} for name, _, _ in meshes}
    sky_vf: VFDict = {name: {k: 0.0 for k in _sky_keys(discrete)} for name, _, _ in meshes}
    stats_result: VFDict = {}
    n_surf = len(meshes)
    n_restored = 0
    entries: List[Dict] = []
    for idx_emit, (name_e, _, _) in enumerate(meshes):
        saved = store.load(idx_emit) if store is not None else None
        if saved is not None:
            vf_scene[name_e].update(saved["row"])
            for other, back_entries in saved.get("backfill", {}).items():
                vf_scene[other].update(back_entries)
            if "sky" in saved:
                sky_vf[name_e].update(saved["sky"])
                # the stats slot carries a duplicate of the sky row under
                # "sky" for readers of the older layout; strip it
                stats_result[name_e] = {
                    k: v for k, v in saved.get("stats", {}).items() if k != "sky"
                }
            else:
                # the older layout parked the sky row in the stats slot
                sky_vf[name_e].update(saved.get("stats", {}).get("sky", {}))
                stats_result[name_e] = {}
            n_restored += 1
            _log(f"({idx_emit + 1}/{n_surf}) [{name_e}] restored from checkpoint")
            continue
        surf_active = _build_emitter_surface_mask(
            idx_emit, emitters[idx_emit], bounds_center, bounds_extent
        )
        receivers, recv_idx = _matrix_active_receivers(
            idx_emit, n_surf, reciprocity, surf_active
        )
        emit_sid, matrix_min_sid = _matrix_skip(idx_emit, reciprocity)
        em_pack = _make_emitter_pack(
            prepared_solver, idx_emit, mp, False, align, device, lazy=use_scheduler,
        )
        run = _EmitterRun(
            scene_pack, em_pack, surf_active, emit_sid, matrix_min_sid,
            mp["seed"], idx_emit, device,
        )
        matrix_mon = (
            MatrixMonitor(
                n_surf, recv_idx,
                n_rays_once=em_pack.n_rays_once,
                tol=mp["tol"], tol_mode=mp["tol_mode"],
                min_iters=mp["min_iters"],
                interval=1 if on_cpu else mp["convergence_interval"],
                max_iters=mp["max_iters"],
            )
            if receivers
            else None
        )
        sky_mon = SkyMonitor(
            discrete=discrete,
            n_rays_once=em_pack.n_rays_once,
            tol=sp["tol"], tol_mode=sp["tol_mode"],
            min_iters=sp["min_iters"],
            interval=1 if on_cpu else sp["convergence_interval"],
            max_iters=sp["max_iters"],
        )
        entry = dict(run=run, matrix_mon=matrix_mon, sky_mon=sky_mon,
                     idx=idx_emit, name=name_e, receivers=receivers,
                     surf_active=surf_active, emit_sid=emit_sid, min_sid=matrix_min_sid)
        if store is not None:
            store.resume(entry, n_surf, _load_combined_state, _combined_state)
        # the shared stream resumes past the iterations either monitor used
        entry["trace_iters"] = run.itr_next
        entries.append(entry)

    def _assemble(entry) -> None:
        """The emitter's matrix row, back-fill and sky row, and one stats
        row over both outputs' keys."""
        row, stats_row, backfill = _matrix_row(
            entry["matrix_mon"], entry["receivers"], meshes, entry["idx"], reciprocity, areas)
        sky_row: Dict[str, float] = {}
        if entry["sky_mon"].total_rays > 0:
            sky_row, sky_stats = _sky_row(entry["sky_mon"], discrete)
            stats_row.update(sky_stats)
        entry.update(row=row, stats=stats_row, backfill=backfill, sky_row=sky_row)
        if store is not None:
            # the top-level "sky" is the layout; the duplicate inside stats
            # keeps the file readable by readers of the older layout
            store.save(entry["idx"], entry["name"], row, backfill,
                       {**stats_row, "sky": sky_row}, sky=sky_row)

    t_solve = _start_entries(entries, _assemble)
    if len(entries) > 1 and use_scheduler:
        _drive_combined_scheduled(
            entries, prepared_solver, mp, align, scene_pack, device, n_surf,
            discrete=discrete,
        )
    _drive_combined_pipelined(entries, discrete=discrete)
    solve_s = time.time() - t_solve

    for entry in entries:
        idx_emit, name_e = entry["idx"], entry["name"]
        matrix_mon, sky_mon = entry["matrix_mon"], entry["sky_mon"]
        trace_iters = entry["trace_iters"]
        vf_scene[name_e].update(entry["row"])
        for name_r, back_entries in entry["backfill"].items():
            vf_scene[name_r].update(back_entries)
        sky_vf[name_e].update(entry["sky_row"])
        stats_result[name_e] = entry["stats"]
        matrix_iters = matrix_mon.iters_done if matrix_mon is not None else 0
        _log(
            f"({idx_emit + 1}/{n_surf}) [{name_e}] traced {trace_iters} iter, "
            f"{trace_iters * entry['run'].em_pack.n_rays_once:,} rays -> "
            f"{entry.get('elapsed', solve_s):0.3f}s  "
            f"(scene={matrix_iters} iter, sky={sky_mon.iters_done} iter, "
            f"BVH={'builtin' if use_bvh else 'off'}, device={_device_label(device)})"
        )
    if n_restored:
        _log(f"{n_restored}/{n_surf} emitters restored from checkpoint (not re-traced)")

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
