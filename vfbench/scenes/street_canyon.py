"""The upstream raystrack street canyon (examples/ex00_street_canyon_geometry.py
of philip-ba/raystrack v1.0.2, lines 68-102), frozen here.

Two facades 8 m apart, each five stacked 10 m x 4 m story panels (20 m
high): the facade at x = -4 faces +x (``east_side_i``), the one at x = +4
faces -x (``west_side_i``); a 10 m x 8 m road at z = 0 facing up. 11 meshes
of two triangles each, listed east/west interleaved by story, road last.
The scene is fixed: the seed does not change it.
"""
from __future__ import annotations

import numpy as np

QUAD = np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def _quad(corners, *, flip: bool):
    V = np.asarray(corners, dtype=np.float32)
    return V, (QUAD[:, [0, 2, 1]].copy() if flip else QUAD.copy())


def build(config: dict, seed: int, **options):
    """The canyon's meshes ``[(name, V float32 (n, 3), F int32 (m, 3)), ...]``."""
    del seed, options
    story, stories = float(config["story_height"]), int(config["stories"])
    half_w, half_g = float(config["facade_width"]) / 2.0, float(config["canyon_gap"]) / 2.0
    meshes = []
    for i in range(stories):
        z0, z1 = i * story, (i + 1) * story
        for name, x, faces_east in (("east_side", -half_g, True), ("west_side", half_g, False)):
            # walked with y increasing the winding faces +x; flipped to face -x
            V, F = _quad([(x, -half_w, z0), (x, half_w, z0), (x, half_w, z1), (x, -half_w, z1)],
                         flip=not faces_east)
            meshes.append((f"{name}_{i}", V, F))
    V, F = _quad([(-half_g, -half_w, 0.0), (half_g, -half_w, 0.0), (half_g, half_w, 0.0),
                  (-half_g, half_w, 0.0)], flip=False)
    meshes.append(("road", V, F))
    return meshes
