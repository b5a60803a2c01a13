"""raystrack_tpu_torch — the PyTorch / CUDA port of raystrack_tpu.

Computes radiative view factors F(i->j) between named triangle meshes
``(name, V, F)``, sky view factors (merged or 145 Tregenza patches) and the
outside workflow that combines them, by quasi-Monte-Carlo ray tracing. Ray
generation, the Tregenza binning and the per-surface histograms' set-up are
PyTorch tensor code; the Möller–Trumbore sweeps (one emitter, and one
convergence round of many emitters) and the histograms are hand-written
CUDA kernels (``csrc/``) on an NVIDIA card and their plain PyTorch versions
on the CPU. The public surface is ``raystrack_tpu``'s 20 names: the
solvers, resumable through ``checkpoint_dir=`` and streamed through
``row_sink=`` / :class:`VFMatrixStreamWriter`, and the mesh and matrix
files (JSON, OBJ, PLY); ``python -m raystrack_tpu_torch`` is its command
line. The JAX package stays the reference.
"""
from .api import view_factor_outside_workflow
from .io import (
    VFMatrixStreamWriter,
    load_meshes_json,
    load_vf_matrix_json,
    merge_vf_matrix,
    save_meshes_json,
    save_vf_matrix_json,
)
from .obj import load_meshes_obj, save_meshes_obj
from .params import MatrixParams, SkyParams
from .ply import load_meshes_ply, save_mesh_ply
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
    "view_factor_matrix",
    "view_factor",
    "view_factor_to_tregenza_sky",
    "view_factor_matrix_and_sky",
    "view_factor_outside_workflow",
    "outside_workflow_shareable",
    "MatrixParams",
    "SkyParams",
    "PreparedSolver",
    "clear_prepared_cache",
    "save_vf_matrix_json",
    "VFMatrixStreamWriter",
    "load_vf_matrix_json",
    "save_meshes_json",
    "load_meshes_json",
    "load_meshes_obj",
    "save_meshes_obj",
    "load_meshes_ply",
    "save_mesh_ply",
    "merge_vf_matrix",
]
