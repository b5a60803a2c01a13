"""View-factor matrix solve of the PyTorch port.

Counterpart of ``raystrack_tpu/solver.py``'s ``view_factor_matrix`` on its
per-emitter route (``_drive_matrix_pipelined`` -> ``_EmitterRun`` ->
chunk step -> sweep kernel):

- per emitter, the Monte-Carlo loop runs in speculative chunks queued on
  the device; the host replays per-iteration counts through float64
  monitors, so stopping behaviour matches a strictly sequential solve,
- reciprocity half-matrix tracing (only receivers with id > emitter are
  intersected; the transpose is back-filled as F*Ai/Aj),
- planar emitters cull receivers whose bounding box lies entirely behind the
  emission plane,
- per-emitter progress lines keep the format
  ``(i/n) [name] K iter, R rays -> T s (BVH=..., device=...)``.

On a CUDA device the sweep is the kernel of ``csrc/sweep.cu``; on the CPU
it is the kernel's plain PyTorch version.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import RAY_BLOCK
from .convergence import MatrixMonitor, plan_chunk
from .params import MatrixParams
from .prepared import EmitterPack, PreparedEmitter, PreparedSolver, ScenePack
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

    The emitter's masks and baked operand pack are built once, here, and
    reused by every chunk: 98 bytes per padded triangle on the solve's
    device for as long as the run lives.
    """

    def __init__(
        self,
        scene_pack: ScenePack,
        em_pack: EmitterPack,
        surf_active: np.ndarray,
        emit_sid: int,
        min_sid: int,
        seed: int,
        idx_emit: int,
        device: torch.device,
    ):
        from .ops.trace import emitter_operands

        self.scene_pack = scene_pack
        self.em_pack = em_pack
        self.device = device
        ext = np.zeros(surf_active.shape[0] + 1, dtype=np.int32)
        ext[:-1] = surf_active  # the padding sid n_surf stays inactive
        sp = scene_pack
        self.tri_pack, self.sweep_mask = emitter_operands(
            (sp.v0, sp.e1, sp.e2, sp.cross_e, sp.w_u, sp.w_v, sp.d0, sp.sid),
            torch.from_numpy(ext).to(device), int(emit_sid), int(min_sid),
            em_pack.plane_vec,
        )
        self.seed = seed
        self.idx_emit = idx_emit
        self.itr_next = 0  # absolute iteration index (drives the RNG stream)

    def dispatch_chunk(self, chunk: int) -> Callable[[], Dict[str, np.ndarray]]:
        """Queue ``chunk`` iterations without synchronising, so the driver
        can keep several emitters in flight; returns a function that waits
        for this chunk's counts only and hands them back as NumPy arrays."""
        from .ops.trace import chunk_body

        cp = torch.from_numpy(_cp_rows(self.seed, self.idx_emit, self.itr_next, chunk))
        self.itr_next += chunk
        em = self.em_pack
        on_card = self.device.type == "cuda"
        if on_card:  # a pageable upload would wait for all queued work
            cp = cp.pin_memory().to(self.device, non_blocking=True)
        out = chunk_body(
            self.tri_pack, self.sweep_mask,
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


def _drive_matrix_pipelined(entries, *, on_done, depth: int = 3) -> None:
    """Round-robin solves with pipelined dispatch.

    Up to ``depth`` emitters have a chunk queued on the device at once, so
    the host-side float64 replay and RNG generation of one emitter overlap
    device work of the others. Results are identical to a sequential driver.

    ``entries`` is a list of dicts with keys ``run`` (_EmitterRun) and
    ``monitor``; monitors are driven to completion in place and
    ``on_done(entry)`` runs once per entry as it finishes.
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
                on_done(entry)
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
            on_done(entry)
        else:
            queue.append(entry)


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
    device packs across solves.
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
    if prepared is not None and not isinstance(prepared, PreparedSolver):
        raise TypeError("prepared must be a PreparedSolver instance")

    p = params.as_dict()
    device = _resolve_device(p["device"])
    # CPU solves check convergence every iteration; the interval only
    # batches checks on the card
    interval = 1 if device.type == "cpu" else p["convergence_interval"]
    prepared_solver = prepared if prepared is not None else PreparedSolver(meshes)
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
        em_pack = prepared_solver.get_emitter_pack(
            idx_emit, samples=p["samples"], rays=p["rays"],
            flip_faces=flip_faces, align=RAY_BLOCK, device=device,
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
                 receivers=receivers)
        )

    def _assemble(entry) -> None:
        """Build the emitter's row, back-fill and stats as it converges."""
        entry["elapsed"] = time.time() - t_solve
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

    # Phase 2: the pipelined per-emitter driver
    t_solve = time.time()
    _drive_matrix_pipelined(entries, on_done=_assemble)
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


__all__ = ["view_factor_matrix", "view_factor"]
