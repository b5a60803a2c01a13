#!/usr/bin/env python3
"""ex04 through the PyTorch port: inside-enclosure view factors with ``flip_faces=True``.

Port of ``examples/ex04_inside_enclosure.py``, on the CUDA card. A closed
unit cube built with OUTWARD normals; flipping emitter winding during
sampling makes every face emit inward, so each row of the interior
view-factor matrix must sum to ~1 (up to Monte-Carlo noise and seam-grazing
rays).

    python3 examples_torch/ex04_inside_enclosure.py

This is the port's one copy of the JAX example's ``make_box_unit_cube``
(that module imports the JAX package), which ``validate_torch.py``
imports. Writes ``build/examples_torch/inside_vf_matrix.json`` unless
``out_dir`` says otherwise; never into ``examples/``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from raystrack_tpu_torch import (  # noqa: E402
    MatrixParams, save_vf_matrix_json, view_factor_matrix,
)

OUT_DIR = ROOT / "build" / "examples_torch"


def make_box_unit_cube():
    """Six quads forming the closed unit cube [0,1]^3, outward normals."""

    def face(name, p0, p1, p2, p3, outward):
        V = np.array([p0, p1, p2, p3], dtype=np.float32)
        F = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
        n = np.cross(V[1] - V[0], V[2] - V[0])
        if np.dot(n, np.asarray(outward, np.float64)) < 0.0:
            F = F[:, [0, 2, 1]].copy()
        return name, V, F

    c = lambda x, y, z: (float(x), float(y), float(z))  # noqa: E731
    return [
        face("Bottom", c(0, 0, 0), c(1, 0, 0), c(1, 1, 0), c(0, 1, 0), (0, 0, -1)),
        face("Top", c(0, 0, 1), c(1, 0, 1), c(1, 1, 1), c(0, 1, 1), (0, 0, +1)),
        face("Front", c(0, 0, 0), c(1, 0, 0), c(1, 0, 1), c(0, 0, 1), (0, -1, 0)),
        face("Back", c(0, 1, 0), c(1, 1, 0), c(1, 1, 1), c(0, 1, 1), (0, +1, 0)),
        face("Left", c(0, 0, 0), c(0, 1, 0), c(0, 1, 1), c(0, 0, 1), (-1, 0, 0)),
        face("Right", c(1, 0, 0), c(1, 1, 0), c(1, 1, 1), c(1, 0, 1), (+1, 0, 0)),
    ]


def main(out_dir: str | None = None, **overrides):
    """Solve the cube from inside and save it; returns the dict.

    ``overrides`` feed MatrixParams (the tests pass tiny sampling and
    ``device="cpu"``); ``out_dir`` redirects the output JSON.
    """
    meshes = make_box_unit_cube()
    config = dict(
        samples=16,
        rays=128,
        seed=42,
        bvh="auto",
        device="gpu",
        flip_faces=True,
        reciprocity=False,
        max_iters=1000,
        tol=1e-3,
        tol_mode="stderr",
        min_iters=10,
    )
    config.update(overrides)
    vf = view_factor_matrix(meshes, params=MatrixParams(**config))

    for name in vf:
        row = vf[name]
        print(f"{name}: receivers={len(row):2d}, sum={sum(row.values()):.6f}")

    out = Path(out_dir or OUT_DIR) / "inside_vf_matrix.json"
    print("Saved:", save_vf_matrix_json(vf, str(out)))
    return vf


if __name__ == "__main__":
    main()
