#!/usr/bin/env python3
"""ex08 through the PyTorch port: Monte-Carlo uncertainty on every output (return_stats).

Port of ``examples/ex08_uncertainty.py``, on the CUDA card. Every solver
accepts ``return_stats=True`` and returns one ``{emitter: {key: stderr}}``
row per emitter alongside its values: the standard error of the converged
estimate, from the same float64 Welford state that drives stderr
convergence. This example solves the street canyon three ways and prints
value ± stderr tables:

1. matrix solve: per-receiver stderr,
2. discrete sky solve (inside the workflow): per-patch stderr, summed in
   quadrature,
3. the same matrix with another seed: the seed-to-seed scatter against the
   combined stderr.

    python3 examples_torch/ex08_uncertainty.py

Writes no file.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from examples.ex00_street_canyon_geometry import build_street_canyon  # noqa: E402
from raystrack_tpu_torch import (  # noqa: E402
    MatrixParams, SkyParams, view_factor_matrix, view_factor_outside_workflow,
)

UNEXPECTED = "UNEXPECTED (>4 sigma)"


def main(out_dir: str | None = None, **overrides):
    """Solve and print the three tables.

    ``overrides`` feed the matrix parameters, from which the sky's are
    copied (the tests pass tiny sampling and ``device="cpu"``). ``out_dir``
    is accepted so that every example's ``main`` takes the same form; ex08
    writes no file. Returns a dict: ``matrix`` and ``workflow`` (values and
    stats of each solve), ``matrix_seed12``, and ``flags``, ``{key: "ok" or
    UNEXPECTED}`` of the road row's scatter table.
    """
    meshes = build_street_canyon()
    # reciprocity=False so EVERY row is traced: back-filled entries
    # (F(i->j) derived from F(j->i)*Aj/Ai) carry no stderr of their own
    config = dict(samples=8, rays=256, seed=11, tol=1e-4, tol_mode="stderr",
                  min_iters=10, max_iters=120, reciprocity=False, device="gpu")
    config.update(overrides)
    mp = MatrixParams(**config)
    sp = SkyParams(samples=mp.samples, rays=mp.rays, seed=mp.seed,
                   tol=mp.tol, tol_mode=mp.tol_mode, min_iters=mp.min_iters,
                   max_iters=mp.max_iters, device=mp.device, discrete=True)

    vf, stats = view_factor_matrix(meshes, params=mp, return_stats=True)
    print("matrix row for 'road' (value ± stderr):")
    road = sorted(vf["road"].items(), key=lambda kv: -kv[1])[:6]
    for key, val in road:
        se = stats["road"].get(key, float("nan"))
        print(f"  {key:18s} {val:0.6f} ± {se:0.2e}")

    vf_s, sky, rest, wstats = view_factor_outside_workflow(
        meshes, matrix_params=mp, sky_params=sp, return_stats=True,
    )
    patch_se = np.array([wstats["road"].get(f"Sky_Patch_{i}", 0.0)
                         for i in range(1, 146)])
    sky_total = sum(sky["road"].values())
    # patches are counted from one shared ray set; quadrature is an upper
    # bound on the merged fraction's error (patch counts anti-correlate)
    print(f"\nroad sky VF: {sky_total:0.6f} "
          f"(patch-quadrature stderr <= {np.sqrt((patch_se ** 2).sum()):0.6f})")
    print(f"road rest:   {rest['road']['Rest']:0.6f}")

    # the stderr column should explain seed-to-seed scatter: solve with
    # another seed and compare |dF| against the combined stderr
    mp2 = MatrixParams(**{**mp.as_dict(), "seed": 12})
    vf2, stats2 = view_factor_matrix(meshes, params=mp2, return_stats=True)
    print("\nseed 11 -> 12 scatter vs combined stderr (road row):")
    flags = {}
    for key, val in road:
        d = abs(vf2["road"].get(key, 0.0) - val)
        comb = np.hypot(stats["road"].get(key, 0.0),
                        stats2["road"].get(key, 0.0))
        flags[key] = "ok" if d < 4 * comb else UNEXPECTED
        print(f"  {key:18s} |dF|={d:0.2e}  sigma={comb:0.2e}  {flags[key]}")
    return dict(matrix=(vf, stats), workflow=(vf_s, sky, rest, wstats),
                matrix_seed12=(vf2, stats2), flags=flags)


if __name__ == "__main__":
    main()
