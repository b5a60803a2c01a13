#!/usr/bin/env python3
"""ex01 through the PyTorch port: the street canyon's view-factor matrix.

Port of ``examples/ex01_compute_vf.py``: the same scene and settings, on
the CUDA card (``device="gpu"``; the JAX example's ``"auto"`` would fall
back to the CPU without one).

    python3 examples_torch/ex01_compute_vf.py

Writes ``build/examples_torch/vf_matrix.json`` unless ``out_dir`` says
otherwise; never into ``examples/``.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from examples.ex00_street_canyon_geometry import build_street_canyon  # noqa: E402
from raystrack_tpu_torch import (  # noqa: E402
    MatrixParams, save_vf_matrix_json, view_factor_matrix,
)

OUT_DIR = ROOT / "build" / "examples_torch"


def main(*, out_dir: str | None = None, **overrides):
    """Solve the canyon matrix and save it; returns the file's path.

    ``overrides`` feed straight into MatrixParams (the tests pass tiny
    sampling and ``device="cpu"``); ``out_dir`` redirects the output JSON.
    """
    meshes = build_street_canyon()
    config = dict(
        samples=16,
        rays=256,
        seed=7,
        bvh="auto",
        device="gpu",
        max_iters=200,
        tol=1e-4,
        tol_mode="stderr",
        min_iters=10,
        reciprocity=True,
    )
    config.update(overrides)
    vf = view_factor_matrix(meshes, params=MatrixParams(**config))

    for name, _, _ in meshes:
        row = vf.get(name, {})
        print(f"{name}: {len(row)} receivers, row sum = {sum(row.values()):.4f}")

    out = Path(out_dir or OUT_DIR)
    path = save_vf_matrix_json(vf, str(out / "vf_matrix.json"))
    print(f"Saved view-factor matrix to: {path}")
    return path


if __name__ == "__main__":
    main()
