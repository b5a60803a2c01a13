# Copied from raystrack_tpu/api.py (host-only post-processing; the solves are the port's).
"""Top-level outside workflow: scene matrix + sky view factors + residual.

The shared-ray solve when the two parameter sets agree on sampling and
execution, else the two solvers separately; the sky clamped so scene + sky
<= 1 (+1e-6); optional reciprocity / row-sum enforcement with row targets
``1 - sky``; and a per-emitter residual ``Rest`` so that scene + sky + rest
= 1.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .params import MatrixParams, SkyParams
from .prepared import PreparedSolver
from .solver import (
    _refuse_unported,
    outside_workflow_shareable,
    view_factor_matrix,
    view_factor_matrix_and_sky,
    view_factor_to_tregenza_sky,
)
from .utils.helpers import (
    enforce_reciprocity_and_rowsum as _enforce_reciprocity_and_rowsum,
    enforce_reciprocity_only as _enforce_reciprocity_only,
)

Mesh = Tuple[str, np.ndarray, np.ndarray]
VFDict = Dict[str, Dict[str, float]]


def _row_sum(row: Dict[str, float]) -> float:
    return float(sum(float(v) for v in row.values()))


def _sky_row_total(sky_row: Dict[str, float], discrete: bool) -> float:
    if discrete:
        return float(sum(float(v) for v in sky_row.values()))
    return float(sky_row.get("Sky", 0.0))


def _scale_sky_row(sky_row: Dict[str, float], scale: float, discrete: bool) -> float:
    """Scale a sky row in place; returns its new total."""
    if discrete:
        for key in list(sky_row.keys()):
            sky_row[key] = float(sky_row[key]) * scale
        return float(sum(float(v) for v in sky_row.values()))
    sky_row["Sky"] = float(sky_row.get("Sky", 0.0)) * scale
    return float(sky_row["Sky"])


def view_factor_outside_workflow(
    meshes: List[Mesh],
    *,
    matrix_params: MatrixParams,
    sky_params: SkyParams,
    prepared: Optional[PreparedSolver] = None,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    return_stats: bool = False,
):
    """Scene view-factor matrix, sky view factors and the residual per emitter.

    Returns ``(vf_scene, sky_vf, rest_vf)`` with ``scene + sky + rest = 1``
    per emitter. When the matrix and sky parameter sets agree on sampling and
    execution settings, one shared ray set per emitter feeds both outputs
    (:func:`~raystrack_tpu_torch.solver.view_factor_matrix_and_sky`);
    otherwise the two solvers run separately. Sky totals are clamped so
    scene + sky never exceeds 1 beyond a 1e-6 threshold, before and after the
    optional reciprocity enforcement.

    With ``return_stats=True`` a fourth element is returned: the solvers'
    merged ``{emitter: {key: stderr}}`` rows (receiver keys and sky keys).
    They describe the raw converged estimates: clamping and enforcement
    rescale values, not their sampling stderr.

    ``checkpoint_dir`` makes the solve resumable per emitter: the shared-ray
    path checkpoints each emitter's matrix and sky outputs together; the
    separate-solver fallback uses ``<dir>/matrix`` and ``<dir>/sky``.
    Post-processing (clamping, enforcement, residuals) is cheap and re-runs
    on every call.
    """
    if not isinstance(matrix_params, MatrixParams):
        raise TypeError("matrix_params must be a MatrixParams instance")
    if not isinstance(sky_params, SkyParams):
        raise TypeError("sky_params must be a SkyParams instance")
    _refuse_unported(mesh)

    threshold = 1e-6
    enforce_scene = bool(matrix_params.enforce_reciprocity_rowsum)
    reciprocity_flag = bool(matrix_params.reciprocity)
    discrete = bool(sky_params.discrete)

    # Row enforcement happens here (with sky-aware targets), never inside the
    # matrix solve itself.
    matrix_defaults = MatrixParams(**matrix_params.as_dict())
    matrix_defaults.enforce_reciprocity_rowsum = False

    stats: VFDict = {}
    if outside_workflow_shareable(matrix_defaults, sky_params):
        vf_scene, sky_vf, stats = view_factor_matrix_and_sky(
            meshes, matrix_params=matrix_defaults, sky_params=sky_params,
            prepared=prepared, checkpoint_dir=checkpoint_dir, return_stats=True,
        )
    else:
        vf_scene, m_stats = view_factor_matrix(
            meshes, params=matrix_defaults, prepared=prepared,
            checkpoint_dir=os.path.join(checkpoint_dir, "matrix") if checkpoint_dir else None,
            return_stats=True,
        )
        sky_vf, s_stats = view_factor_to_tregenza_sky(
            meshes, params=sky_params, prepared=prepared,
            checkpoint_dir=os.path.join(checkpoint_dir, "sky") if checkpoint_dir else None,
            return_stats=True,
        )
        for name, _, _ in meshes:
            stats[name] = {**m_stats.get(name, {}), **s_stats.get(name, {})}

    mesh_names = [name for name, _, _ in meshes]

    if enforce_scene:
        scene_totals = [max(0.0, _row_sum(vf_scene.get(n, {}))) for n in mesh_names]
        _enforce_reciprocity_and_rowsum(vf_scene, meshes, None, row_targets=scene_totals)

    # First clamp pass: cap sky so scene + sky <= 1 (+threshold).
    sky_totals: Dict[str, float] = {}
    for emitter in mesh_names:
        scene_sum = _row_sum(vf_scene.get(emitter, {}))
        sky_row = dict(sky_vf.get(emitter, {}))
        sky_total = _sky_row_total(sky_row, discrete)
        if scene_sum + sky_total > 1.0 + threshold and sky_total > 0.0:
            allowed = max(0.0, 1.0 - scene_sum)
            sky_total = _scale_sky_row(sky_row, min(1.0, allowed / sky_total), discrete)
            sky_vf[emitter] = sky_row
        sky_totals[emitter] = max(0.0, sky_total)

    if enforce_scene:
        targets = [max(0.0, 1.0 - sky_totals.get(n, 0.0)) for n in mesh_names]
        _enforce_reciprocity_and_rowsum(vf_scene, meshes, None, row_targets=targets)
    elif reciprocity_flag:
        _enforce_reciprocity_only(vf_scene, meshes)

    # Second pass after enforcement: re-clamp and compute the residual.
    rest_vf: VFDict = {}
    for emitter in mesh_names:
        scene_sum = _row_sum(vf_scene.get(emitter, {}))
        sky_row = dict(sky_vf.get(emitter, {}))
        sky_total = _sky_row_total(sky_row, discrete)

        combined = scene_sum + sky_total
        if combined > 1.0 + threshold and sky_total > 0.0:
            allowed = max(0.0, 1.0 - scene_sum)
            if allowed <= 0.0:
                sky_row = {key: 0.0 for key in sky_row}
                sky_total = 0.0
            else:
                sky_total = _scale_sky_row(
                    sky_row, min(1.0, allowed / sky_total), discrete
                )
            sky_vf[emitter] = sky_row
            combined = scene_sum + sky_total

        residual = 1.0 - combined
        if abs(residual) <= threshold:
            residual = 0.0
        rest_vf[emitter] = {"Rest": residual}

    if return_stats:
        return vf_scene, sky_vf, rest_vf, stats
    return vf_scene, sky_vf, rest_vf


__all__ = ["view_factor_outside_workflow"]
