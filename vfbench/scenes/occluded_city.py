"""The occluded city: a square ground under dense random boxes, near geometry
occluding far. The box generator is the JAX package's ``bench._city``
(``occluded_city``; the port's copy is ``city_100m_torch.city_meshes``),
frozen here and seeded by the run's seed.

Boxes have half-widths U(1, 4) m, heights U(2, 25) m and bottoms at
z = 0.05 m over a ground at z = 0, so every ground point lies under many
boxes and every ray the ground emits ends on a box's bottom at z = 0.05:
F(ground -> city) is 1 whatever the sweep does. A solve that says something
about the nearest hit therefore emits from buildings inside the city: the
traffic names anchor points, the ``boxes_per_building`` boxes nearest to
each become a mesh of their own (``bld_<k>``, 12 triangles a box), and the
ground with every other box is the one receiver mesh ``city``, listed last.
A block of boxes rather than one keeps the emitter's size and surroundings,
and so the work, alike from seed to seed.
"""
from __future__ import annotations

import numpy as np

BOX_FACES = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6],
                      [0, 4, 5], [0, 5, 1], [1, 5, 6], [1, 6, 2],
                      [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]], np.int32)


def boxes(n_tri: int, extent: float, seed: int):
    """``bench._city``'s boxes: centres (n, 2) float64 and vertices (n, 8, 3)
    float32 for ``(n_tri - 2) // 12`` boxes drawn from ``seed``."""
    n_boxes = max(1, (n_tri - 2) // 12)
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-extent, extent, (n_boxes, 2))
    w = rng.uniform(1.0, 4.0, (n_boxes, 2))
    h = rng.uniform(2.0, 25.0, n_boxes)
    x0, y0 = (cx - w).T.astype(np.float32)
    x1, y1 = (cx + w).T.astype(np.float32)
    vs = np.empty((n_boxes, 8, 3), np.float32)
    vs[:, (0, 3, 4, 7), 0] = x0[:, None]
    vs[:, (1, 2, 5, 6), 0] = x1[:, None]
    vs[:, (0, 1, 4, 5), 1] = y0[:, None]
    vs[:, (2, 3, 6, 7), 1] = y1[:, None]
    vs[:, :4, 2] = np.float32(0.05)
    vs[:, 4:, 2] = h.astype(np.float32)[:, None]
    return cx, vs


def city_meshes(n_tri: int, extent: float, seed: int):
    """``bench._city`` whole: ``[("ground", ...), ("city", ...)]``."""
    _, vs = boxes(n_tri, extent, seed)
    return [_ground(extent), ("city", vs.reshape(-1, 3), _faces(vs.shape[0]))]


def _ground(extent: float):
    V = np.array([[-extent, -extent, 0], [extent, -extent, 0],
                  [extent, extent, 0], [-extent, extent, 0]], np.float32)
    return "ground", V, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def _faces(n_boxes: int) -> np.ndarray:
    return (BOX_FACES[None] + 8 * np.arange(n_boxes, dtype=np.int32)[:, None, None]
            ).reshape(-1, 3)


def pick_buildings(centres: np.ndarray, anchors, per_building: int = 1) -> np.ndarray:
    """(anchors, per_building) indices of the boxes whose centres are
    nearest to each anchor, nearest first, no box picked twice."""
    taken = np.zeros(centres.shape[0], dtype=bool)
    picked = []
    for ax, ay in anchors:
        d2 = (centres[:, 0] - ax) ** 2 + (centres[:, 1] - ay) ** 2
        d2[taken] = np.inf
        near = np.argpartition(d2, per_building - 1)[:per_building]
        near = near[np.argsort(d2[near], kind="stable")]
        taken[near] = True
        picked.append(near)
    return np.asarray(picked, dtype=np.int64).reshape(len(picked), per_building)


def build(config: dict, seed: int, buildings=(), boxes_per_building: int = 1):
    """The city of ``config`` drawn from ``seed``: one mesh per anchor in
    ``buildings`` (its ``boxes_per_building`` nearest boxes), then ``city``:
    the ground's two triangles and every other box. Without anchors,
    ``bench._city``'s two meshes."""
    n_tri, extent = int(config["triangles"]), float(config["extent"])
    if not buildings:
        return city_meshes(n_tri, extent, seed)
    centres, vs = boxes(n_tri, extent, seed)
    picked = pick_buildings(centres, buildings, int(boxes_per_building))
    meshes = [(f"bld_{k}", vs[ids].reshape(-1, 3), _faces(len(ids)))
              for k, ids in enumerate(picked)]
    rest = np.delete(vs, picked.ravel(), axis=0)
    _, gV, gF = _ground(extent)
    V = np.concatenate([gV, rest.reshape(-1, 3)])
    F = np.concatenate([gF, _faces(rest.shape[0]) + gV.shape[0]])
    meshes.append(("city", V, F))
    return meshes
