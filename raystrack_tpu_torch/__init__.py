"""raystrack_tpu_torch — the PyTorch / CUDA port of raystrack_tpu.

Computes radiative view factors F(i->j) between named triangle meshes
``(name, V, F)`` by quasi-Monte-Carlo ray tracing. Ray generation and the
per-surface histograms are PyTorch tensor code; the Möller–Trumbore sweeps
(one emitter, and one convergence round of many emitters) are hand-written
CUDA kernels (``csrc/sweep.cu``) on an NVIDIA card and their plain PyTorch
versions on the CPU. The public surface follows ``raystrack_tpu``; the JAX
package stays the reference.
"""
from .params import MatrixParams
from .prepared import PreparedSolver
from .solver import clear_prepared_cache, view_factor, view_factor_matrix

__all__ = [
    "MatrixParams", "PreparedSolver", "view_factor_matrix", "view_factor",
    "clear_prepared_cache",
]
