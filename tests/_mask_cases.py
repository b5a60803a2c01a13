"""Cases of a scheduled round's mask rows (``ops/trace.py`` ``combined_masks``)
shared by the CPU tests (``test_torch_masks.py``) and the card tests
(``test_torch_card.py``), and the rows they must give, computed with numpy
one float32 operation at a time. Imports nothing of JAX."""
import numpy as np
import torch

N_SURF = 7
NAN, INF = float("nan"), float("inf")
# the triangles a case sets by hand: (field, index, value)
SPECIAL = (
    ("v0", 16, (NAN, 0.5, 0.5)),  # a NaN vertex: every distance NaN
    ("e1", 17, (0.0, INF, 0.0)),  # +inf in an edge
    ("e2", 18, (0.0, 0.0, -INF)),  # -inf in an edge
    ("v0", 19, (INF, -INF, 0.0)),  # inf - inf: NaN once both axes count
    ("v0", 20, (3e38, 3e38, 3e38)),  # products that overflow to inf
    ("v0", 21, (1e-40, -1e-40, 1e-41)),  # subnormal coordinates
    ("e1", 21, (1e-39, 1e-39, -1e-39)),
)


def mask_case(n_emit: int, n_tri: int, seed: int, planar: bool = True):
    """``(scene, surf_active_ext, emit_sid, min_sid, plane_vec)`` on the CPU
    for ``n_emit`` emitter rows over ``n_tri`` padded triangles of
    ``N_SURF`` surfaces, as a scheduled round hands them to
    ``combined_masks``:

    - the last sixteenth of the triangles is padding: zero rows, sid
      ``N_SURF``, which hits the zero last column of ``surf_active_ext``;
    - triangles 0-15 lie in the plane z = 0, so an emitter with origin 0
      and normal +z puts every distance at exactly zero; triangles 16-21
      hold the NaN, infinite, overflowing and subnormal coordinates of
      ``SPECIAL``;
    - ``surf_active_ext`` draws -1..2 (inactive at or below zero), and
      some rows are wholly inactive; ``emit_sid`` is one of the triangles'
      sids; ``min_sid`` runs through 0, a random sid, ``N_SURF - 1`` and
      ``N_SURF``;
    - planes: every fourth row the z = 0 plane, the others a random origin
      and unit normal; ``tol`` 0, a positive, a negative and a large one;
      ``is_planar`` 1 for most rows, 0 or -1 (not planar) or NaN for some;
      with ``planar`` False, 0, -1 or NaN for every row: no row reads the
      triangles' geometry.
    """
    rng = np.random.default_rng(seed)
    n_real = n_tri - n_tri // 16
    fields = {k: rng.normal(scale=s, size=(n_tri, 3)).astype(np.float32)
              for k, s in (("v0", 4.0), ("e1", 1.0), ("e2", 1.0))}
    for k in fields:
        fields[k][:16, 2] = 0.0
        fields[k][n_real:] = 0.0
    for k, i, value in SPECIAL:
        fields[k][i] = np.array(value, dtype=np.float32)
    sid = rng.integers(0, N_SURF, n_tri).astype(np.int32)
    sid[n_real:] = N_SURF

    ext = rng.integers(-1, 3, (n_emit, N_SURF + 1)).astype(np.int32)
    ext[:, N_SURF] = 0
    ext[3::5] = 0
    emit = rng.integers(0, N_SURF, n_emit).astype(np.int32)
    mins = np.array([(0, int(rng.integers(0, N_SURF)), N_SURF - 1, N_SURF)[e % 4]
                     for e in range(n_emit)], dtype=np.int32)
    normal = rng.normal(size=(n_emit, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    plane = np.zeros((n_emit, 8), dtype=np.float32)
    plane[:, :3] = rng.normal(scale=2.0, size=(n_emit, 3))
    plane[:, 3:6] = normal
    plane[0::4, :6] = (0.0, 0.0, 0.0, 0.0, 0.0, 1.0)
    plane[:, 6] = np.array([(0.0, 1e-3, -1e-3, 2.0)[e % 4] for e in range(n_emit)])
    plane[:, 7] = 1.0
    plane[2::6, 7] = 0.0
    plane[5::12, 7] = -1.0
    plane[7::12, 7] = NAN
    if not planar:
        plane[:, 7] = np.array([(0.0, -1.0, NAN)[e % 3] for e in range(n_emit)])
    scene = tuple(torch.from_numpy(fields[k]) for k in ("v0", "e1", "e2"))
    scene = scene + (None, None, None, None, torch.from_numpy(sid))
    return (scene, torch.from_numpy(ext), torch.from_numpy(emit), torch.from_numpy(mins),
            torch.from_numpy(plane))


def on(case, device):
    """A case's tensors on ``device``."""
    scene, *rows = case
    scene = tuple(None if t is None else t.to(device) for t in scene)
    return (scene, *(t.to(device) for t in rows))


def spec_rows(scene, surf_active_ext, emit_sid, min_sid, plane_vec) -> np.ndarray:
    """The (E, Tpad) rows by numpy: per emitter, each product, sum and
    difference rounded to float32 on its own in ``combined_masks``' order,
    NaN-propagating maximums (``np.maximum``), then ``m_any + m_mat`` where
    the triangle is kept."""
    v0, e1, e2 = (scene[i].cpu().numpy() for i in range(3))
    sid = scene[7].cpu().numpy()
    ext, emit, mins, plane = (t.cpu().numpy() for t in (surf_active_ext, emit_sid, min_sid,
                                                        plane_vec))
    out = np.zeros((ext.shape[0], sid.shape[0]), dtype=np.float32)
    with np.errstate(all="ignore"):
        for e, p in enumerate(plane):
            nx, ny, nz = p[3], p[4], p[5]
            s0 = ((v0[:, 0] - p[0]) * nx + (v0[:, 1] - p[1]) * ny) + (v0[:, 2] - p[2]) * nz
            s1 = s0 + ((e1[:, 0] * nx + e1[:, 1] * ny) + e1[:, 2] * nz)
            s2 = s0 + ((e2[:, 0] * nx + e2[:, 1] * ny) + e2[:, 2] * nz)
            assert s0.dtype == s1.dtype == s2.dtype == np.float32
            keep = (np.maximum(np.maximum(s0, s1), s2) > p[6]) | ~(p[7] > 0)
            m_any = (ext[e][sid] > 0) & (sid != emit[e]) & keep
            m_mat = m_any & (sid >= mins[e])
            out[e] = m_any.astype(np.float32) + m_mat.astype(np.float32)
    return out
