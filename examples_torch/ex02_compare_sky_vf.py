#!/usr/bin/env python3
"""ex02 through the PyTorch port: two routes to the sky view factor.

Port of ``examples/ex02_compare_sky_vf.py``, on the CUDA card. Route 1
("derived"): add a large ground plane, solve the scene matrix, and take
``1 - sum(row)`` per emitter; everything not hitting geometry is sky.
Route 2 ("directional"): the merged-sky solver (the fraction of unblocked
upward rays), without the ground plane. For upward-facing or vertical
surfaces over a large ground the two agree up to Monte-Carlo noise and the
ground's finite extent.

    python3 examples_torch/ex02_compare_sky_vf.py

The ground's 89,458,688 rays an iteration take the per-emitter route; their
Halton tables are built on the card. This is the port's one copy of the
JAX example's ``ground_plane`` (that module imports the JAX package), which
``chip_smoke.py`` imports. Writes no file.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from examples.ex00_street_canyon_geometry import build_street_canyon  # noqa: E402
from raystrack_tpu_torch import (  # noqa: E402
    MatrixParams, SkyParams, view_factor_matrix, view_factor_to_tregenza_sky,
)

GROUND_NAME = "infinite_ground"
GROUND_MARGIN = 100.0  # extra extent beyond the scene bounds
SHARED = dict(samples=16, rays=128, seed=20, bvh="auto", device="gpu",
              min_iters=1, tol=1e-4, tol_mode="stderr", max_iters=50)


def ground_plane(meshes):
    """A large ground quad sized from the scene bounds, slightly below the
    lowest z so it never lies coplanar with scene geometry."""
    all_v = np.concatenate([V for _, V, _ in meshes], axis=0)
    lo = all_v.min(axis=0)
    hi = all_v.max(axis=0)
    x0, x1 = float(lo[0] - GROUND_MARGIN), float(hi[0] + GROUND_MARGIN)
    y0, y1 = float(lo[1] - GROUND_MARGIN), float(hi[1] + GROUND_MARGIN)
    z = float(lo[2]) - 1e-3
    V = np.array([[x0, y0, z], [x1, y0, z], [x1, y1, z], [x0, y1, z]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return GROUND_NAME, V, F


def matrix_params(**overrides) -> MatrixParams:
    """The scene matrix's parameters: ``SHARED``, then ``overrides``."""
    return MatrixParams(**{**SHARED, **overrides}, reciprocity=False)


def sky_params(**overrides) -> SkyParams:
    """The merged sky's parameters: ``SHARED``, then ``overrides``."""
    return SkyParams(**{**SHARED, **overrides}, discrete=False)


def main(out_dir: str | None = None, **overrides):
    """Compare the derived and the directional sky of every canyon surface.

    ``overrides`` feed both parameter sets (the tests pass tiny sampling
    and ``device="cpu"``). ``out_dir`` is accepted so that every example's
    ``main`` takes the same form; ex02 writes no file. Returns ``(derived,
    vf_sky, vf_scene)``: ``{name: 1 - sum(row)}`` clamped at 0, the merged
    sky's dict, and the matrix with the ground.
    """
    canyon = build_street_canyon()
    with_ground = canyon + [ground_plane(canyon)]

    print("Computing scene VF matrix (facades + large ground plane)...")
    vf_scene = view_factor_matrix(with_ground, params=matrix_params(**overrides))
    derived = {
        name: max(0.0, 1.0 - sum(float(v) for v in vf_scene.get(name, {}).values()))
        for name, _, _ in canyon
    }

    print("Computing directional merged-sky VF (no ground plane)...")
    vf_sky = view_factor_to_tregenza_sky(canyon, params=sky_params(**overrides))

    print(f"\n{'Emitter':32s}  {'1-sum(scene)':>12s}  {'dir-sky':>10s}  {'diff':>9s}")
    print("-" * 70)
    for name, _, _ in canyon:
        v1 = derived[name]
        v2 = vf_sky.get(name, {}).get("Sky", 0.0)
        print(f"{name:32s}  {v1:>12.6f}  {v2:>10.6f}  {v2 - v1:+9.6f}")
    return derived, vf_sky, vf_scene


if __name__ == "__main__":
    main()
