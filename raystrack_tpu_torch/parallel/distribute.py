# Host-side partition logic copied from raystrack_tpu/parallel/distribute.py; the solves are the port's.
"""Distribute whole emitters across workers.

Counterpart of ``raystrack_tpu/parallel/distribute.py``. Emitters are
embarrassingly parallel: each worker solves the full scene's rows for its
own emitter subset (its rays still split over its devices with ``mesh=``,
``parallel.sharding``), and the per-worker row dicts merge losslessly with
``merge_vf_matrix``. This is the process-level layer above the ray mesh:
the mesh splits rays inside one process, the partitions split emitters
across processes (``parallel.multihost``) or across any other workers.

Each emitter runs on the per-emitter route (``solver._drive_monitors``),
so a worker needs nothing but its own emitters' packs; the rows equal the
full solves' exactly.

Reciprocity note: the half-matrix skip couples emitter i to receivers
j > i, so distributed solves run with ``reciprocity=False`` per worker (the
helpers enforce this) and apply the transpose back-fill
(:func:`backfill_reciprocity`) and any row-sum enforcement after the merge.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..params import MatrixParams
from ..prepared import PreparedSolver

Mesh = Tuple[str, np.ndarray, np.ndarray]
VFDict = Dict[str, Dict[str, float]]


def partition_emitters(n_emitters: int, n_parts: int, part: int) -> List[int]:
    """Deterministic strided partition of emitter indices.

    Striding (rather than contiguous blocks) balances cost when emitter
    sizes are sorted or clustered.
    """
    if not 0 <= part < n_parts:
        raise ValueError(f"part must be in [0, {n_parts}) (got {part})")
    return list(range(part, n_emitters, n_parts))


def view_factor_matrix_partition(
    meshes: List[Mesh],
    params: MatrixParams,
    *,
    n_parts: int,
    part: int,
    prepared: Optional[PreparedSolver] = None,
    mesh=None,
    half_matrix: bool = False,
) -> VFDict:
    """Solve only this worker's emitter subset; merge results across workers.

    Returns a row dict containing only the emitters in partition ``part``.
    Combine worker outputs with :func:`raystrack_tpu_torch.merge_vf_matrix`
    and, if desired, apply ``enforce_reciprocity_only`` /
    ``enforce_reciprocity_and_rowsum`` on the merged dict.

    ``half_matrix=True`` keeps the reciprocity work-skip (emitter i traces
    only receivers j > i) but defers the transpose back-fill to the caller:
    after merging ALL partitions, apply :func:`backfill_reciprocity` to
    reproduce the single-process ``reciprocity=True`` result exactly (the
    skip couples rows across emitters, so per-worker back-fill would be
    incomplete).
    """
    local = partition_emitters(len(meshes), n_parts, part)
    worker_params = MatrixParams(**params.as_dict())
    # Half-matrix back-fill and post-enforcement couple rows across
    # emitters; both must happen after the merge, not per worker.
    worker_params.reciprocity = False
    worker_params.enforce_reciprocity_rowsum = False

    solver = prepared if prepared is not None else PreparedSolver(meshes)
    result: VFDict = {}
    for idx in local:
        result.update(
            _solve_single_emitter(meshes, idx, worker_params, solver, mesh,
                                  half_matrix=half_matrix)
        )
    return result


def mesh_area(V: np.ndarray, F: np.ndarray) -> float:
    """Total triangle area of one mesh (matches prepare_emitters' CDF area)."""
    a = np.asarray(V[F[:, 0]], dtype=np.float32)
    e1 = np.asarray(V[F[:, 1]], dtype=np.float32) - a
    e2 = np.asarray(V[F[:, 2]], dtype=np.float32) - a
    return float((0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)).sum())


def backfill_reciprocity(merged: VFDict, meshes: List[Mesh]) -> VFDict:
    """Fill F(j->i) = F(i->j) * A_i / A_j for the untraced lower half.

    The post-merge counterpart of the single-process solver's in-loop
    back-fill (``solver.view_factor_matrix`` assembly): apply to the merged
    output of ``half_matrix=True`` partitions. In-place; returns ``merged``.
    """
    areas = [mesh_area(V, F) for _, V, F in meshes]
    for i, (name_i, _, _) in enumerate(meshes):
        row = merged.get(name_i, {})
        for j in range(i + 1, len(meshes)):
            name_j = meshes[j][0]
            f = row.get(f"{name_j}_front", 0.0)
            if f > 0.0 and areas[j] > 0.0:
                merged.setdefault(name_j, {})[f"{name_i}_front"] = f * (areas[i] / areas[j])
    return merged


def view_factor_sky_partition(
    meshes: List[Mesh],
    params,
    *,
    n_parts: int,
    part: int,
    prepared: Optional[PreparedSolver] = None,
    mesh=None,
) -> VFDict:
    """Solve only this worker's emitters' sky rows (merged or 145-patch).

    Sky rows are fully independent per emitter, so merged partitions equal
    the single-process :func:`raystrack_tpu_torch.view_factor_to_tregenza_sky`
    exactly. Combine worker outputs with ``merge_vf_matrix``.
    """
    local = partition_emitters(len(meshes), n_parts, part)
    solver = prepared if prepared is not None else PreparedSolver(meshes)
    result: VFDict = {}
    for idx in local:
        result.update(_solve_single_sky(meshes, idx, params, solver, mesh))
    return result


def view_factor_workflow_partition(
    meshes: List[Mesh],
    matrix_params,
    sky_params,
    *,
    n_parts: int,
    part: int,
    prepared: Optional[PreparedSolver] = None,
    mesh=None,
    half_matrix: bool = False,
) -> Tuple[VFDict, VFDict]:
    """Shared-ray (matrix + sky) solve of this worker's emitter subset.

    Returns ``(matrix_rows, sky_rows)``. As with the matrix partition,
    reciprocity back-fill must run after merging all partitions
    (``half_matrix=True`` + :func:`backfill_reciprocity`).
    """
    from ..solver import outside_workflow_shareable

    if not outside_workflow_shareable(matrix_params, sky_params):
        raise ValueError(
            "matrix_params and sky_params are not compatible for shared tracing"
        )
    local = partition_emitters(len(meshes), n_parts, part)
    worker_params = MatrixParams(**matrix_params.as_dict())
    worker_params.reciprocity = False
    worker_params.enforce_reciprocity_rowsum = False

    solver = prepared if prepared is not None else PreparedSolver(meshes)
    vf_rows: VFDict = {}
    sky_rows: VFDict = {}
    for idx in local:
        row, sky_row = _solve_single_combined(
            meshes, idx, worker_params, sky_params, solver, mesh, half_matrix=half_matrix,
        )
        vf_rows.update(row)
        sky_rows.update(sky_row)
    return vf_rows, sky_rows


def _emitter_context(meshes, idx_emit, p, prepared, mesh, *, flip_faces):
    """Shared per-emitter setup for the single-emitter partition solvers:
    ``(surf_active, make_run, interval)``. ``make_run(emit_sid, min_sid)``
    builds the emitter's run; ``interval(n)`` is the convergence interval
    the full solves use on this device for a requested ``n`` (every
    iteration on the CPU), so a partition's rows equal theirs."""
    from ..solver import (
        _build_emitter_surface_mask,
        _emitter_run,
        _placements,
        _select_bvh,
    )

    device, mesh = _placements(mesh, p["device"])
    use_bvh = _select_bvh(p["bvh"], prepared.total_faces)
    scene_pack = prepared.get_scene_pack(use_accel=use_bvh, device=device)
    emitters = prepared.get_emitters(samples=p["samples"], rays=p["rays"], flip_faces=flip_faces)
    centers, extents = prepared.get_mesh_bounds()
    surf_active = _build_emitter_surface_mask(idx_emit, emitters[idx_emit], centers, extents)

    def make_run(emit_sid: int, min_sid: int):
        return _emitter_run(prepared, p, idx_emit, surf_active, emit_sid, min_sid,
                            flip_faces=flip_faces, scene_pack=scene_pack, device=device,
                            mesh=mesh, lazy=False)

    def interval(n: int) -> int:
        return 1 if device.type == "cpu" else n

    return surf_active, make_run, interval


def _solve_single_emitter(
    meshes: List[Mesh],
    idx_emit: int,
    params: MatrixParams,
    prepared: PreparedSolver,
    mesh,
    *,
    half_matrix: bool = False,
) -> VFDict:
    """One emitter's row against the full scene."""
    from ..convergence import MatrixMonitor
    from ..solver import _drive_monitors, _matrix_active_receivers, _matrix_row, _matrix_skip

    p = params.as_dict()
    n_surf = len(meshes)
    name_e = meshes[idx_emit][0]
    surf_active, make_run, interval = _emitter_context(
        meshes, idx_emit, p, prepared, mesh, flip_faces=p["flip_faces"])
    receivers, recv_idx = _matrix_active_receivers(idx_emit, n_surf, half_matrix, surf_active)
    if not receivers:
        return {name_e: {}}

    run = make_run(*_matrix_skip(idx_emit, half_matrix))
    monitor = MatrixMonitor(
        n_surf, recv_idx,
        n_rays_once=run.em_pack.n_rays_once,
        tol=p["tol"], tol_mode=p["tol_mode"],
        min_iters=p["min_iters"], interval=interval(p["convergence_interval"]),
        max_iters=p["max_iters"],
    )
    _drive_monitors(run, monitor, None, discrete=False)
    return {name_e: _matrix_row(monitor, receivers, meshes, idx_emit, False, None)[0]}


def _solve_single_sky(meshes, idx_emit, params, prepared, mesh) -> VFDict:
    """One emitter's sky row; matches the full sky solver per emitter."""
    from ..convergence import SkyMonitor
    from ..solver import _drive_monitors, _sky_keys, _sky_row

    p = params.as_dict()
    discrete = bool(p["discrete"])
    name_e = meshes[idx_emit][0]
    sky_keys = _sky_keys(discrete)
    if len(meshes) <= 1:
        # parity with the full solver: single-mesh scenes report zero rows
        return {name_e: {k: 0.0 for k in sky_keys}}

    _, make_run, interval = _emitter_context(meshes, idx_emit, p, prepared, mesh,
                                             flip_faces=False)
    run = make_run(idx_emit, 0)
    monitor = SkyMonitor(
        discrete=discrete,
        n_rays_once=run.em_pack.n_rays_once,
        tol=p["tol"], tol_mode=p["tol_mode"],
        min_iters=p["min_iters"], interval=interval(p["convergence_interval"]),
        max_iters=p["max_iters"],
    )
    _drive_monitors(run, None, monitor, discrete=discrete)
    row = {k: 0.0 for k in sky_keys}
    row.update(_sky_row(monitor, discrete)[0])
    return {name_e: row}


def _solve_single_combined(
    meshes, idx_emit, matrix_params, sky_params, prepared, mesh, *, half_matrix: bool,
) -> Tuple[VFDict, VFDict]:
    """One emitter through the shared-ray state machine (matrix + sky)."""
    from ..convergence import MatrixMonitor, SkyMonitor
    from ..solver import (
        _drive_monitors, _matrix_active_receivers, _matrix_row, _matrix_skip, _sky_keys, _sky_row,
    )

    mp = matrix_params.as_dict()
    sp = sky_params.as_dict()
    discrete = bool(sp["discrete"])
    name_e = meshes[idx_emit][0]
    n_surf = len(meshes)

    surf_active, make_run, interval = _emitter_context(
        meshes, idx_emit, mp, prepared, mesh, flip_faces=False)
    receivers, recv_idx = _matrix_active_receivers(idx_emit, n_surf, half_matrix, surf_active)
    run = make_run(*_matrix_skip(idx_emit, half_matrix))
    matrix_mon = (
        MatrixMonitor(
            n_surf, recv_idx,
            n_rays_once=run.em_pack.n_rays_once,
            tol=mp["tol"], tol_mode=mp["tol_mode"],
            min_iters=mp["min_iters"], interval=interval(mp["convergence_interval"]),
            max_iters=mp["max_iters"],
        )
        if receivers
        else None
    )
    sky_mon = SkyMonitor(
        discrete=discrete,
        n_rays_once=run.em_pack.n_rays_once,
        tol=sp["tol"], tol_mode=sp["tol_mode"],
        min_iters=sp["min_iters"],
        interval=interval(sp["convergence_interval"]),
        max_iters=sp["max_iters"],
    )
    _drive_monitors(run, matrix_mon, sky_mon, discrete=discrete)

    sky_row = {k: 0.0 for k in _sky_keys(discrete)}
    if sky_mon.total_rays > 0:
        sky_row.update(_sky_row(sky_mon, discrete)[0])
    row = _matrix_row(matrix_mon, receivers, meshes, idx_emit, False, None)[0]
    return {name_e: row}, {name_e: sky_row}


__all__ = [
    "partition_emitters",
    "view_factor_matrix_partition",
    "view_factor_sky_partition",
    "view_factor_workflow_partition",
    "backfill_reciprocity",
    "mesh_area",
]
