#!/usr/bin/env python3
"""ex03 through the PyTorch port: the outside workflow, scene + sky + rest = 1.

Port of ``examples/ex03_workflow.py``, on the CUDA card: the shared-ray
workflow (matrix + any sweeps until one side converges, then that side
alone) on the street canyon.

    python3 examples_torch/ex03_workflow.py

Writes ``vf_scene_workflow.json`` and ``sky_vf_workflow.json`` into
``build/examples_torch/`` unless ``out_dir`` says otherwise; never into
``examples/``.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from examples.ex00_street_canyon_geometry import build_street_canyon  # noqa: E402
from raystrack_tpu_torch import (  # noqa: E402
    MatrixParams, SkyParams, save_vf_matrix_json, view_factor_outside_workflow,
)

OUT_DIR = ROOT / "build" / "examples_torch"


def main(*, out_dir: str | None = None, **overrides):
    """Run the outside workflow on the canyon and save scene/sky outputs.

    ``overrides`` feed the shared sampling config (the tests pass tiny
    sampling and ``device="cpu"``); ``out_dir`` redirects the output JSONs.
    Returns ``(vf_scene, sky_vf, rest_vf)``.
    """
    meshes = build_street_canyon()
    shared = dict(samples=16, rays=256, seed=3, bvh="auto", device="gpu",
                  min_iters=10, max_iters=150, tol=1e-4, tol_mode="stderr")
    shared.update(overrides)
    matrix_params = MatrixParams(**shared, reciprocity=True)
    sky_params = SkyParams(**shared, discrete=False)

    vf_scene, sky_vf, rest_vf = view_factor_outside_workflow(
        meshes, matrix_params=matrix_params, sky_params=sky_params
    )

    print(f"{'Emitter':16s}  {'scene':>8s}  {'sky':>8s}  {'rest':>8s}  {'total':>8s}")
    for name, _, _ in meshes:
        scene_sum = sum(vf_scene.get(name, {}).values())
        sky_sum = sum(sky_vf.get(name, {}).values())
        rest = rest_vf[name]["Rest"]
        print(f"{name:16s}  {scene_sum:8.4f}  {sky_sum:8.4f}  {rest:8.4f}"
              f"  {scene_sum + sky_sum + rest:8.4f}")

    here = Path(out_dir or OUT_DIR)
    print("Saved:", save_vf_matrix_json(vf_scene, str(here / "vf_scene_workflow.json")))
    print("Saved:", save_vf_matrix_json(sky_vf, str(here / "sky_vf_workflow.json")))
    return vf_scene, sky_vf, rest_vf


if __name__ == "__main__":
    main()
