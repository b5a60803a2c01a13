#!/usr/bin/env python3
"""ex05 through the PyTorch port: one PreparedSolver across solves that differ only by seed.

Port of ``examples/ex05_prepared_seed_compare.py``, on the CUDA card.
Prepared triangle buffers, Halton tables and device packs are built once;
each solve only regenerates its Cranley-Patterson offsets. The printed
mean|dF| table shows pure seed-to-seed Monte-Carlo scatter.

    python3 examples_torch/ex05_prepared_seed_compare.py

Writes no file.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from examples.ex00_street_canyon_geometry import build_street_canyon  # noqa: E402
from raystrack_tpu_torch import (  # noqa: E402
    MatrixParams, PreparedSolver, view_factor_matrix,
)

SEEDS = (1, 2, 3)


def solve(meshes, prepared, seed, **overrides):
    config = dict(
        samples=8,
        rays=256,
        seed=seed,
        bvh="auto",
        device="gpu",
        max_iters=100,
        tol=1e-4,
        tol_mode="stderr",
        min_iters=10,
        reciprocity=True,
    )
    config.update(overrides)
    t0 = time.time()
    vf = view_factor_matrix(meshes, params=MatrixParams(**config), prepared=prepared)
    return vf, time.time() - t0


def main(out_dir: str | None = None, **overrides):
    """Solve the canyon once a seed of ``SEEDS`` on one PreparedSolver.

    ``overrides`` feed MatrixParams (the tests pass tiny sampling and
    ``device="cpu"``). ``out_dir`` is accepted so that every example's
    ``main`` takes the same form; ex05 writes no file. Returns ``({seed:
    dict}, the PreparedSolver)``.
    """
    meshes = build_street_canyon()
    prepared = PreparedSolver(meshes)

    results = {}
    for seed in SEEDS:
        vf, seconds = solve(meshes, prepared, seed, **overrides)
        results[seed] = vf
        print(f"seed={seed}: solved in {seconds:.2f}s (prepared state reused)")

    base = results[SEEDS[0]]
    print(f"\n{'Emitter':16s}" + "".join(f"  mean|d| vs seed {s:>2d}" for s in SEEDS[1:]))
    for name, _, _ in meshes:
        row0 = base.get(name, {})
        cells = []
        for seed in SEEDS[1:]:
            row = results[seed].get(name, {})
            keys = set(row0) | set(row)
            diffs = [abs(row0.get(k, 0.0) - row.get(k, 0.0)) for k in keys]
            cells.append(float(np.mean(diffs)) if diffs else 0.0)
        print(f"{name:16s}" + "".join(f"  {c:18.6f}" for c in cells))
    return results, prepared


if __name__ == "__main__":
    main()
