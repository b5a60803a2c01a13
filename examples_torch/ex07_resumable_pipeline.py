#!/usr/bin/env python3
"""ex07 through the PyTorch port: external geometry, resumable solve, streaming output.

Port of ``examples/ex07_resumable_pipeline.py``, on the CUDA card. The mesh
files come from that file's ``write_demo_ply`` and ``write_demo_obj`` (it
imports no JAX at module level):

1. geometry arrives as mesh FILES (a binary PLY terrain tile and an OBJ
   building),
2. the matrix solve runs with ``checkpoint_dir=...`` so a preempted job
   resumes where it stopped (finished emitters replay from their
   checkpoint files, emitters still converging resume from their exact
   monitor-state snapshots),
3. the result streams to disk row by row (``VFMatrixStreamWriter``).

    python3 examples_torch/ex07_resumable_pipeline.py

Run it twice: the second run restores every emitter from the checkpoint
directory and only re-writes the output file. Without ``out_dir`` it works
in ``<tempdir>/raystrack_tpu_torch_ex07``, never in ``examples/``.
"""
from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from examples.ex07_resumable_pipeline import write_demo_obj, write_demo_ply  # noqa: E402
from raystrack_tpu_torch import (  # noqa: E402
    MatrixParams, VFMatrixStreamWriter, load_meshes_obj, load_meshes_ply,
    view_factor_matrix,
)


def main(out_dir: str | None = None, *, samples: int = 4, rays: int = 64,
         max_iters: int = 20, min_iters: int = 5, tol: float = 1e-3,
         device: str = "gpu") -> str:
    """Write the mesh files, solve with checkpoints, stream the rows out;
    returns the streamed file's path. ``device="cpu"`` runs the tests."""
    # Reusing the same directory across runs keeps the "run it twice,
    # second run resumes" demo.
    out = Path(out_dir) if out_dir else Path(tempfile.gettempdir()) / "raystrack_tpu_torch_ex07"
    out.mkdir(parents=True, exist_ok=True)

    ply_path = out / "terrain.ply"
    obj_path = out / "towers.obj"
    write_demo_ply(ply_path)
    write_demo_obj(obj_path)

    meshes = load_meshes_ply(str(ply_path), name="terrain")
    meshes += load_meshes_obj(str(obj_path))
    print(f"Scene: {len(meshes)} meshes, "
          f"{sum(F.shape[0] for _, _, F in meshes)} triangles")

    params = MatrixParams(samples=samples, rays=rays, seed=20,
                          max_iters=max_iters, min_iters=min_iters, tol=tol,
                          reciprocity=True, device=device)
    t0 = time.time()
    vf = view_factor_matrix(
        meshes, params=params, checkpoint_dir=str(out / "ckpt")
    )
    print(f"Solve (resumable): {time.time() - t0:0.2f}s")

    stream_path = out / "vf_streamed.json"
    with VFMatrixStreamWriter(str(stream_path)) as writer:
        for sender, row in vf.items():
            writer.write_row(sender, row)
    print(f"Streamed view-factor matrix to {stream_path}")
    return str(stream_path)


if __name__ == "__main__":
    main()
