# Copied from raystrack_tpu/cli.py; --device takes auto | gpu | cpu and defaults to gpu.
"""Command-line interface: solve view factors from mesh files.

Usage (also via ``python -m raystrack_tpu_torch``):

    raystrack-tpu-torch matrix scene.json --out vf.json --samples 16 --rays 256
    raystrack-tpu-torch sky scene.obj --discrete --out sky.json
    raystrack-tpu-torch workflow scene.json --out-prefix run1_

Meshes load from ``.json`` (save_meshes_json format), ``.obj``, or ``.ply``. Solver
fields map 1:1 onto MatrixParams/SkyParams. Subcommands, flags and outputs
are the JAX package's ``raystrack-tpu``'s, but for ``--device``: it takes
``auto``, ``gpu`` or ``cpu`` and defaults to ``gpu``, so a command line
runs on the card or fails at once where there is none; ``--device cpu``
asks for the CPU, and ``auto`` falls back to it as the Python API does.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List


def _load_meshes(path: str):
    if path.lower().endswith(".obj"):
        from .obj import load_meshes_obj

        return load_meshes_obj(path)
    if path.lower().endswith(".ply"):
        from .ply import load_meshes_ply

        return load_meshes_ply(path)
    from .io import load_meshes_json

    return load_meshes_json(path)


def _add_common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("meshes", help="scene file (.json, .obj, or .ply)")
    parser.add_argument("--samples", type=int, default=16)
    parser.add_argument("--rays", type=int, default=128)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--bvh", default="auto", choices=["auto", "off", "builtin"])
    parser.add_argument("--device", default="gpu", choices=["auto", "gpu", "cpu"],
                        help="gpu (default): the CUDA card, an error without one; "
                             "cpu: the CPU; auto: the card if present, else the CPU")
    parser.add_argument("--max-iters", type=int, default=100)
    parser.add_argument("--min-iters", type=int, default=5)
    parser.add_argument("--tol", type=float, default=1e-4)
    parser.add_argument("--tol-mode", default="stderr", choices=["stderr", "delta"])


def _matrix_params(args):
    from .params import MatrixParams

    return MatrixParams(
        samples=args.samples, rays=args.rays, seed=args.seed, bvh=args.bvh,
        device=args.device, max_iters=args.max_iters, min_iters=args.min_iters,
        tol=args.tol, tol_mode=args.tol_mode,
        reciprocity=not getattr(args, "no_reciprocity", False),
        enforce_reciprocity_rowsum=getattr(args, "enforce_rowsum", False),
        flip_faces=getattr(args, "flip_faces", False),
    )


def _sky_params(args):
    from .params import SkyParams

    return SkyParams(
        samples=args.samples, rays=args.rays, seed=args.seed, bvh=args.bvh,
        device=args.device, max_iters=args.max_iters, min_iters=args.min_iters,
        tol=args.tol, tol_mode=args.tol_mode,
        discrete=getattr(args, "discrete", False),
    )


def build_parser() -> argparse.ArgumentParser:
    """The parser of ``raystrack-tpu-torch``: its subcommands and flags."""
    parser = argparse.ArgumentParser(
        prog="raystrack-tpu-torch",
        description="quasi-Monte-Carlo view-factor solver on a CUDA card (PyTorch)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_matrix = sub.add_parser("matrix", help="scene-to-scene view-factor matrix")
    _add_common(p_matrix)
    p_matrix.add_argument("--out", default="vf_matrix.json")
    p_matrix.add_argument("--no-reciprocity", action="store_true")
    p_matrix.add_argument("--enforce-rowsum", action="store_true")
    p_matrix.add_argument("--flip-faces", action="store_true")
    p_matrix.add_argument("--strip-dir", action="store_true",
                          help="merge _front/_back keys in the output")
    p_matrix.add_argument("--checkpoint-dir", default=None,
                          help="resumable per-emitter checkpoints")
    p_matrix.add_argument("--stream-out", action="store_true",
                          help="stream rows to --out as emitters converge "
                               "(forces --no-reciprocity; rows land in "
                               "completion order)")

    p_sky = sub.add_parser("sky", help="sky view factors (merged or Tregenza)")
    _add_common(p_sky)
    p_sky.add_argument("--out", default="sky_vf.json")
    p_sky.add_argument("--discrete", action="store_true",
                       help="145 Tregenza patches instead of merged Sky")
    p_sky.add_argument("--checkpoint-dir", default=None,
                       help="resumable per-emitter checkpoints")

    p_flow = sub.add_parser("workflow",
                            help="outside workflow: scene + sky + rest = 1")
    _add_common(p_flow)
    p_flow.add_argument("--out-prefix", default="")
    p_flow.add_argument("--discrete", action="store_true")
    p_flow.add_argument("--no-reciprocity", action="store_true")
    p_flow.add_argument("--enforce-rowsum", action="store_true")
    p_flow.add_argument("--checkpoint-dir", default=None,
                        help="resumable per-emitter checkpoints")
    return parser


def main(argv: List[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.device == "gpu":
        import torch

        if not torch.cuda.is_available():
            # before the scene loads: a large file would take a while
            parser.error("--device gpu (the default) needs a CUDA card and none is "
                         "available; pass --device cpu to solve on the CPU")
    meshes = _load_meshes(args.meshes)
    print(f"Loaded {len(meshes)} meshes "
          f"({sum(F.shape[0] for _, _, F in meshes)} triangles)")

    from .io import save_vf_matrix_json

    if args.command == "matrix":
        from .solver import view_factor_matrix

        if args.stream_out:
            # streamed rows are complete under reciprocity too: the solver
            # defers each sink until its row's back-fill has all arrived
            if getattr(args, "enforce_rowsum", False):
                parser.error(
                    "--stream-out streams raw converged rows; "
                    "--enforce-rowsum post-processes the full matrix and "
                    "cannot be streamed (drop one of the two)"
                )
            from .io import VFMatrixStreamWriter

            with VFMatrixStreamWriter(args.out, strip_dir=args.strip_dir) as w:
                view_factor_matrix(
                    meshes, params=_matrix_params(args),
                    checkpoint_dir=args.checkpoint_dir,
                    row_sink=w.write_row,
                )
                path = w.close()
            print(f"Wrote {path} (streamed)")
        else:
            vf = view_factor_matrix(
                meshes, params=_matrix_params(args),
                checkpoint_dir=args.checkpoint_dir,
            )
            path = save_vf_matrix_json(vf, args.out, strip_dir=args.strip_dir)
            print(f"Wrote {path}")
    elif args.command == "sky":
        from .solver import view_factor_to_tregenza_sky

        if len(meshes) <= 1:
            # reference parity: the sky solver skips single-mesh scenes
            # (nothing occludes), returning zero rows
            print(
                "warning: single-mesh scene - the sky solver needs at least "
                "two meshes (reference behavior); output will be zeros. "
                "Use 'workflow' for an unobstructed-sky estimate."
            )
        sky = view_factor_to_tregenza_sky(
            meshes, params=_sky_params(args), checkpoint_dir=args.checkpoint_dir
        )
        path = save_vf_matrix_json(sky, args.out)
        print(f"Wrote {path}")
    else:
        from .api import view_factor_outside_workflow

        scene, sky, rest = view_factor_outside_workflow(
            meshes, matrix_params=_matrix_params(args),
            sky_params=_sky_params(args),
            checkpoint_dir=args.checkpoint_dir,
        )
        for label, data in (("vf_scene", scene), ("sky_vf", sky), ("rest_vf", rest)):
            path = save_vf_matrix_json(data, f"{args.out_prefix}{label}.json")
            print(f"Wrote {path}")
        totals = {
            name: sum(scene.get(name, {}).values())
            + sum(sky.get(name, {}).values())
            + rest[name]["Rest"]
            for name, _, _ in meshes
        }
        print("Row totals:", json.dumps({k: round(v, 6) for k, v in totals.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
