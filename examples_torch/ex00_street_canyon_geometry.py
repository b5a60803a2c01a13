#!/usr/bin/env python3
"""ex00 through the PyTorch port: save the street-canyon scene as JSON.

Port of ``examples/ex00_street_canyon_geometry.py``. The scene comes from
that file's ``build_street_canyon`` (it imports no JAX); the file is written
with ``raystrack_tpu_torch.io.save_meshes_json`` and equals the committed
``examples/street_canyon.json`` after ``json.load``.

    python3 examples_torch/ex00_street_canyon_geometry.py

Writes ``build/examples_torch/street_canyon.json`` unless ``out_dir`` says
otherwise; never into ``examples/``.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from examples.ex00_street_canyon_geometry import build_street_canyon  # noqa: E402
from raystrack_tpu_torch.io import save_meshes_json  # noqa: E402

OUT_DIR = ROOT / "build" / "examples_torch"


def main(out_dir: str | None = None) -> str:
    """Save the canyon's 11 meshes; returns the file's path."""
    meshes = build_street_canyon()
    out = Path(out_dir or OUT_DIR)
    path = save_meshes_json(meshes, str(out / "street_canyon.json"))
    print(f"Saved street canyon geometry to: {path}")
    print(f"Meshes: {[name for name, _, _ in meshes]}")
    return path


if __name__ == "__main__":
    main()
