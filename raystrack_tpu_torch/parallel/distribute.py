# Host-side partition logic copied from raystrack_tpu/parallel/distribute.py; the solves are the port's.
"""Distribute whole emitters across workers.

Counterpart of ``raystrack_tpu/parallel/distribute.py``. Emitters are
embarrassingly parallel: each worker solves the full scene's rows for its
own emitter subset (its rays still split over its devices with ``mesh=``,
``parallel.sharding``), and the per-worker row dicts merge losslessly with
``merge_vf_matrix``. This is the process-level layer above the ray mesh:
the mesh splits rays inside one process, the partitions split emitters
across processes (``parallel.multihost``) or across any other workers.

Each emitter runs on the per-emitter route (``solver._drive_pipelined``),
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
    from ..solver import _build_entry, _drive_pipelined, _matrix_row, _setup

    p = params.as_dict()
    name_e = meshes[idx_emit][0]
    setup = _setup(meshes, prepared, p, mesh, flip_faces=p["flip_faces"])
    entry = _build_entry(setup, idx_emit, name_e, matrix=p, sky=None,
                         reciprocity=half_matrix, lazy=False)
    if entry is None:
        return {name_e: {}}
    _drive_pipelined([entry])
    return {name_e: _matrix_row(entry.matrix, entry.receivers, meshes, idx_emit, False, None)[0]}


def _solve_single_sky(meshes, idx_emit, params, prepared, mesh) -> VFDict:
    """One emitter's sky row; matches the full sky solver per emitter."""
    from ..solver import _build_entry, _drive_pipelined, _setup, _sky_keys, _sky_row

    p = params.as_dict()
    discrete = bool(p["discrete"])
    name_e = meshes[idx_emit][0]
    row = {k: 0.0 for k in _sky_keys(discrete)}
    if len(meshes) <= 1:
        # parity with the full solver: single-mesh scenes report zero rows
        return {name_e: row}

    setup = _setup(meshes, prepared, p, mesh, flip_faces=False)
    entry = _build_entry(setup, idx_emit, name_e, matrix=None, sky=p, reciprocity=False,
                         lazy=False)
    _drive_pipelined([entry])
    row.update(_sky_row(entry.sky, discrete)[0])
    return {name_e: row}


def _solve_single_combined(
    meshes, idx_emit, matrix_params, sky_params, prepared, mesh, *, half_matrix: bool,
) -> Tuple[VFDict, VFDict]:
    """One emitter through the shared-ray state machine (matrix + sky)."""
    from ..solver import _build_entry, _drive_pipelined, _matrix_row, _setup, _sky_keys, _sky_row

    mp = matrix_params.as_dict()
    sp = sky_params.as_dict()
    discrete = bool(sp["discrete"])
    name_e = meshes[idx_emit][0]

    setup = _setup(meshes, prepared, mp, mesh, flip_faces=False)
    entry = _build_entry(setup, idx_emit, name_e, matrix=mp, sky=sp, reciprocity=half_matrix,
                         lazy=False)
    _drive_pipelined([entry])

    sky_row = {k: 0.0 for k in _sky_keys(discrete)}
    if entry.sky.total_rays > 0:
        sky_row.update(_sky_row(entry.sky, discrete)[0])
    row = _matrix_row(entry.matrix, entry.receivers, meshes, idx_emit, False, None)[0]
    return {name_e: row}, {name_e: sky_row}


__all__ = [
    "partition_emitters",
    "view_factor_matrix_partition",
    "view_factor_sky_partition",
    "view_factor_workflow_partition",
    "backfill_reciprocity",
    "mesh_area",
]
