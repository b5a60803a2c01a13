# Copied from raystrack_tpu/obj.py (host-only): Wavefront OBJ meshes; files are byte-equal to the JAX package's.
"""Wavefront OBJ mesh ingestion.

Minimal, dependency-free loader for the common subset used by geometry
pipelines: ``v`` vertex positions and ``f`` faces (triangles or polygons,
fan-triangulated), with ``o``/``g`` statements splitting the file into named
meshes. Extends the reference's JSON-only mesh I/O so real scenes can be
imported directly.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

Mesh = Tuple[str, np.ndarray, np.ndarray]


def load_meshes_obj(load_path: str, *, default_name: str = "mesh") -> List[Mesh]:
    """Load ``(name, V, F)`` meshes from a Wavefront OBJ file.

    - vertices are shared across the file (OBJ indices are global); each
      named object/group gets its own compacted vertex array,
    - faces may be triangles or convex polygons (fan-triangulated),
    - ``f`` index forms ``v``, ``v/vt``, ``v//vn``, ``v/vt/vn`` and negative
      (relative) indices are all supported; texture/normal indices are
      ignored,
    - faces appearing before any ``o``/``g`` statement land in a mesh named
      ``default_name``.
    """
    path = Path(load_path)
    if not path.exists():
        raise FileNotFoundError(f"File not found: {load_path}")

    vertices: List[List[float]] = []
    groups: Dict[str, List[List[int]]] = {}
    order: List[str] = []
    current = default_name

    def vertex_index(token: str) -> int:
        raw = token.split("/")[0]
        idx = int(raw)
        if idx < 0:
            idx = len(vertices) + idx + 1
        if not 1 <= idx <= len(vertices):
            raise ValueError(f"OBJ face references undefined vertex {raw}")
        return idx - 1

    for line_no, line in enumerate(path.read_text(encoding="utf-8").splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            if len(parts) < 4:
                raise ValueError(f"line {line_no}: vertex needs 3 coordinates")
            vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag in ("o", "g"):
            current = " ".join(parts[1:]) if len(parts) > 1 else default_name
        elif tag == "f":
            if len(parts) < 4:
                raise ValueError(f"line {line_no}: face needs >= 3 vertices")
            idxs = [vertex_index(tok) for tok in parts[1:]]
            if current not in groups:
                groups[current] = []
                order.append(current)
            # fan triangulation preserves winding for convex polygons
            for k in range(1, len(idxs) - 1):
                groups[current].append([idxs[0], idxs[k], idxs[k + 1]])
        # vt / vn / usemtl / mtllib / s are ignored

    all_v = np.asarray(vertices, dtype=np.float32)
    meshes: List[Mesh] = []
    for name in order:
        faces = np.asarray(groups[name], dtype=np.int64)
        used = np.unique(faces)
        remap = np.zeros(int(used.max()) + 1, dtype=np.int64)
        remap[used] = np.arange(used.shape[0])
        meshes.append(
            (name, all_v[used].astype(np.float32), remap[faces].astype(np.int32))
        )
    if not meshes:
        raise ValueError("OBJ file contains no faces")
    return meshes


def save_meshes_obj(meshes: List[Mesh], save_path: str) -> str:
    """Write ``[(name, V, F), ...]`` as a Wavefront OBJ with one named
    object per mesh. Round-trips through :func:`load_meshes_obj` (vertex
    order and triangle winding preserved)."""
    path = Path(save_path)
    if not path.suffix:
        path = path.with_suffix(".obj")
    path.parent.mkdir(parents=True, exist_ok=True)

    lines: List[str] = ["# raystrack_tpu scene"]
    base = 0
    for name, V, F in meshes:
        V = np.asarray(V, dtype=np.float32)
        F = np.asarray(F, dtype=np.int64)
        if V.ndim != 2 or V.shape[1] != 3 or F.ndim != 2 or F.shape[1] != 3:
            raise ValueError(f"mesh {name!r} must be (N, 3) vertices and (M, 3) faces")
        lines.append(f"o {name}")
        lines.extend(
            # repr of the exact float64 value round-trips back to the same
            # float32 on load
            f"v {float(v[0])!r} {float(v[1])!r} {float(v[2])!r}" for v in V
        )
        lines.extend(
            f"f {f[0] + 1 + base} {f[1] + 1 + base} {f[2] + 1 + base}" for f in F
        )
        base += V.shape[0]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path.resolve())


__all__ = ["load_meshes_obj", "save_meshes_obj"]
