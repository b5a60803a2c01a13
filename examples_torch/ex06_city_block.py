#!/usr/bin/env python3
"""ex06 through the PyTorch port: view factors in a procedural city block.

Port of ``examples/ex06_city_block.py``, on the CUDA card. The city comes
from that file's ``build_city`` (N x N box buildings of varied heights
over a ground plane; it imports no JAX). For the street-level south facade
of the centre building it computes

- the view-factor row against every other surface (reciprocity off: the
  emitter is traced against the full city), through the partition API:
  the per-emitter route, sweep kernel #1 once a chunk, and
- the merged sky view factor of every surface: the scheduled route, sweep
  kernel #2's any-only variant once a convergence round.

The 5 x 5 city has 126 surfaces and 252 triangles: one sweep tile, so no
AABB gate.

    python3 examples_torch/ex06_city_block.py

Writes no file.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from examples.ex06_city_block import GRID, build_city  # noqa: E402
from raystrack_tpu_torch import (  # noqa: E402
    MatrixParams, SkyParams, view_factor_to_tregenza_sky,
)
from raystrack_tpu_torch.parallel.distribute import (  # noqa: E402
    view_factor_matrix_partition,
)

SETTINGS = dict(samples=4, rays=256, seed=5, bvh="auto", device="gpu",
                max_iters=40, min_iters=10, tol=5e-4)


def target_name(grid: int = GRID) -> str:
    """The centre building's south facade: the emitter whose row is solved."""
    return f"b{grid // 2}{grid // 2}_south"


def main(out_dir: str | None = None, *, grid: int = GRID, **overrides):
    """Solve the facade's row and every surface's merged sky.

    ``grid`` sizes the city (the tests pass 3); ``overrides`` feed both
    parameter sets (the tests pass tiny sampling and ``device="cpu"``).
    ``out_dir`` is accepted so that every example's ``main`` takes the same
    form; ex06 writes no file. Returns ``(target, row, sky)``.
    """
    meshes = build_city(grid)
    n_tris = sum(F.shape[0] for _, _, F in meshes)
    print(f"City: {len(meshes)} surfaces, {n_tris} triangles")

    # street-level facade of the center building: solve just this emitter's
    # row against the whole city via the partition API
    settings = {**SETTINGS, **overrides}
    center = grid // 2
    target = target_name(grid)
    target_idx = next(i for i, m in enumerate(meshes) if m[0] == target)

    params = MatrixParams(**settings, reciprocity=False)
    t0 = time.time()
    row = view_factor_matrix_partition(
        meshes, params, n_parts=len(meshes), part=target_idx
    )[target]
    t_matrix = time.time() - t0

    top = sorted(row.items(), key=lambda kv: -kv[1])[:8]
    print(f"\n[{target}] row sum {sum(row.values()):.4f} "
          f"({len(row)} visible surfaces, {t_matrix:.1f}s)")
    for key, value in top:
        print(f"  {key:24s} {value:.4f}")

    t0 = time.time()
    sky = view_factor_to_tregenza_sky(meshes, params=SkyParams(**settings))
    t_sky = time.time() - t0
    print(f"\nSky view factors ({t_sky:.1f}s for all {len(meshes)} emitters):")
    print(f"  {target:24s} {sky[target]['Sky']:.4f}  (street canyon)")
    print(f"  {'ground':24s} {sky['ground']['Sky']:.4f}")
    roof = f"b{center}{center}_roof"
    print(f"  {roof:24s} {sky[roof]['Sky']:.4f}  (unobstructed roof)")
    return target, row, sky


if __name__ == "__main__":
    main()
