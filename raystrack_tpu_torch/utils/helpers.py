# Copied from raystrack_tpu/utils/helpers.py (host-only NumPy; the port imports no JAX).
"""Post-processing helpers: grid sizing and reciprocity enforcement.

- ``grid_from_density``: emission grid side ``g = max(4, ceil(sqrt(area*d)))``.
- ``enforce_reciprocity_and_rowsum``: symmetrize ``G = diag(A) F`` and apply
  symmetric diagonal (Sinkhorn-style) scaling until each row of ``diag(A) F``
  hits its target (area by default, or ``A * row_targets``), then map totals
  back onto the ``_front``/``_back`` key splits proportionally. Mutates the
  result dict in place and prunes keys whose adjusted value is non-positive.
- ``enforce_reciprocity_only``: pairwise area-weighted averaging of F(i->j)
  and F(j->i), without row scaling (the outside workflow's reciprocity).
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Iterable, List, Tuple

import numpy as np

Mesh = Tuple[str, np.ndarray, np.ndarray]
VFRow = Dict[str, float]
VFDict = Dict[str, VFRow]


def grid_from_density(area: float, density: float) -> int:
    """Return the Halton grid side length for a surface area and density."""
    g = int(np.ceil(np.sqrt(max(area, 0.0) * density)))
    return max(g, 4)


def mesh_areas(meshes: List[Mesh]) -> np.ndarray:
    """Total triangle area per mesh, float64."""
    out = np.zeros(len(meshes), dtype=np.float64)
    for i, (_, V, F) in enumerate(meshes):
        a = V[F[:, 1]] - V[F[:, 0]]
        b = V[F[:, 2]] - V[F[:, 0]]
        out[i] = 0.5 * float(np.linalg.norm(np.cross(a, b), axis=1).sum())
    return out


def strip_direction(key: str) -> str:
    """Drop a trailing ``_front``/``_back`` suffix from a receiver key."""
    for suffix in ("_front", "_back"):
        if key.endswith(suffix):
            return key[: -len(suffix)]
    return key


def _split_front_back(row: VFRow) -> Dict[str, Tuple[float, float]]:
    """Aggregate a result row into per-base-receiver (front, back) totals.

    Keys without a direction suffix count as *back* totals, so undirected
    entries survive round trips.
    """
    split: Dict[str, Tuple[float, float]] = {}
    for key, value in row.items():
        base = strip_direction(key)
        f, b = split.get(base, (0.0, 0.0))
        if key.endswith("_front"):
            split[base] = (f + float(value), b)
        else:
            split[base] = (f, b + float(value))
    return split


def _totals_matrix(result: VFDict, names: List[str]) -> np.ndarray:
    """Dense (n, n) float64 matrix of front+back totals between named meshes."""
    index = {name: i for i, name in enumerate(names)}
    F = np.zeros((len(names), len(names)), dtype=np.float64)
    for sname in names:
        row = result.get(sname, {})
        if not isinstance(row, dict):
            continue
        si = index[sname]
        for key, value in row.items():
            j = index.get(strip_direction(key))
            if j is not None:
                F[si, j] += float(value)
    return F


def _rescale_row_splits(
    row: VFRow,
    names: List[str],
    si: int,
    F_new: np.ndarray,
    *,
    prune_tol: float,
    skip_diagonal: bool,
) -> None:
    """Write adjusted totals back into ``row``'s front/back keys in place.

    Each receiver's new total is distributed proportionally to its previous
    front/back split; receivers with no previous entry get the full total on
    the back key. Keys falling to ``<= prune_tol`` are deleted.
    """
    split = _split_front_back(row)
    for bj, rname in enumerate(names):
        if skip_diagonal and bj == si:
            continue
        t_new = float(max(F_new[si, bj], 0.0))
        f_old, b_old = split.get(rname, (0.0, 0.0))
        t_old = f_old + b_old
        if t_old > 0.0:
            scale = t_new / t_old
            f_new, b_new = f_old * scale, b_old * scale
        else:
            f_new, b_new = 0.0, t_new

        for key, val in ((f"{rname}_front", f_new), (f"{rname}_back", b_new)):
            if val > prune_tol:
                row[key] = val
            elif key in row:
                del row[key]


def enforce_reciprocity_and_rowsum(
    result: VFDict,
    meshes: List[Mesh],
    areas: List[float] | None,
    row_targets: Iterable[float] | None = None,
    tol: float = 1e-10,
    max_iter: int = 500,
) -> None:
    """In-place adjust ``result`` so rows hit targets and reciprocity holds.

    Symmetrizes ``G = diag(A) F`` then iterates symmetric diagonal scaling
    ``d <- d * sqrt(target_row / current_row)`` (at most ``max_iter`` rounds,
    converged when ``max|d_new - d| < tol``), and maps the adjusted totals
    back to front/back splits proportionally.
    """
    names = [m[0] for m in meshes]
    n = len(names)
    A = np.asarray(areas, dtype=np.float64) if areas is not None else mesh_areas(meshes)

    if row_targets is None:
        target = A
    else:
        target = np.asarray(list(row_targets), dtype=np.float64)
        if target.shape != A.shape:
            raise ValueError("row_targets must match number of meshes")
        target = A * np.clip(target, 0.0, None)

    F = _totals_matrix(result, names)
    G = 0.5 * ((A[:, None] * F) + (A[:, None] * F).T)

    d = np.ones(n, dtype=np.float64)
    for _ in range(max_iter):
        row_sums = np.maximum(d * (G @ d), 1e-30)
        update = np.maximum(target / row_sums, 0.0)
        d_new = d * np.sqrt(update)
        done = float(np.max(np.abs(d_new - d))) < tol
        d = d_new
        if done:
            break

    Gp = (d[:, None] * G) * d[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        F_new = np.divide(Gp, A[:, None], out=np.zeros_like(Gp), where=A[:, None] > 0.0)

    for si, sname in enumerate(names):
        row = result.get(sname, {})
        _rescale_row_splits(row, names, si, F_new, prune_tol=0.0, skip_diagonal=False)
        result[sname] = row


def enforce_reciprocity_only(
    result: VFDict,
    meshes: List[Mesh],
    tol: float = 1e-12,
) -> None:
    """In-place pairwise reciprocity averaging without row scaling.

    For each unordered pair, replaces both totals with the area-weighted
    average ``g = (A_i F_ij + A_j F_ji) / 2`` mapped back through each side's
    area; pairs where both totals are ``<= tol`` are zeroed.
    """
    if tol <= 0.0:
        tol = 1e-12

    names = [m[0] for m in meshes]
    n = len(names)
    A = mesh_areas(meshes)
    F = _totals_matrix(result, names)

    F_new = F.copy()
    for i in range(n):
        for j in range(i + 1, n):
            fij, fji = F[i, j], F[j, i]
            if fij <= tol and fji <= tol:
                F_new[i, j] = F_new[j, i] = 0.0
                continue
            g = 0.5 * (A[i] * fij + A[j] * fji)
            F_new[i, j] = max(g / A[i], 0.0) if A[i] > 0.0 else 0.0
            F_new[j, i] = max(g / A[j], 0.0) if A[j] > 0.0 else 0.0

    for si, sname in enumerate(names):
        row = result.get(sname, {})
        if not isinstance(row, dict):
            row = {}
        _rescale_row_splits(row, names, si, F_new, prune_tol=tol, skip_diagonal=True)
        result[sname] = row


def hold_console_open(prompt: str = "Press Enter to close...") -> None:
    """Keep an interactive console window open after a script finishes.

    Same env-gated contract as the reference helper (reference:
    helpers.py:260-275): ``RAYSTRACK_HOLD_CONSOLE=0|false|no`` disables it,
    and non-interactive runs (no TTY on stdin, or no stdin at all) never
    block.
    """
    if os.environ.get("RAYSTRACK_HOLD_CONSOLE", "1").lower() in (
        "0", "false", "no",
    ):
        return
    stdin = getattr(sys, "stdin", None)
    interactive = stdin is not None and stdin.isatty()
    if not interactive:
        return
    try:
        input(prompt)
    except EOFError:
        pass  # closed stdin mid-prompt: nothing to hold open


__all__ = ["grid_from_density", "mesh_areas", "enforce_reciprocity_and_rowsum",
           "enforce_reciprocity_only", "hold_console_open"]
