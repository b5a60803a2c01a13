"""raystrack_tpu_torch — the PyTorch / CUDA port of raystrack_tpu.

Computes radiative view factors F(i->j) between named triangle meshes
``(name, V, F)`` by quasi-Monte-Carlo ray tracing. Ray generation and the
per-surface histograms are PyTorch tensor code; the Möller–Trumbore sweep
is a hand-written CUDA kernel (``csrc/sweep.cu``) on an NVIDIA card and its
plain PyTorch version on the CPU. The public surface follows
``raystrack_tpu``; the JAX package stays the reference.
"""
from .params import MatrixParams
from .prepared import PreparedSolver
from .solver import view_factor, view_factor_matrix

__all__ = ["MatrixParams", "PreparedSolver", "view_factor_matrix", "view_factor"]
