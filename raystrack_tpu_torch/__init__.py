"""raystrack_tpu_torch — the PyTorch / CUDA port of raystrack_tpu.

Computes radiative view factors F(i->j) between named triangle meshes
``(name, V, F)``, sky view factors (merged or 145 Tregenza patches) and the
outside workflow that combines them, by quasi-Monte-Carlo ray tracing. Ray
generation, the Tregenza binning and the per-surface histograms' set-up are
PyTorch tensor code; the Möller–Trumbore sweeps (one emitter, and one
convergence round of many emitters) and the histograms are hand-written
CUDA kernels (``csrc/``) on an NVIDIA card and their plain PyTorch versions
on the CPU. The public surface follows ``raystrack_tpu``'s solver names;
the JAX package stays the reference.
"""
from .api import view_factor_outside_workflow
from .params import MatrixParams, SkyParams
from .prepared import PreparedSolver
from .solver import (
    clear_prepared_cache,
    outside_workflow_shareable,
    view_factor,
    view_factor_matrix,
    view_factor_matrix_and_sky,
    view_factor_to_tregenza_sky,
)

__all__ = [
    "MatrixParams", "SkyParams", "PreparedSolver", "view_factor_matrix", "view_factor",
    "view_factor_to_tregenza_sky", "view_factor_matrix_and_sky",
    "view_factor_outside_workflow", "outside_workflow_shareable", "clear_prepared_cache",
]
