"""A scheduled round's mask rows on the CPU: ``combined_masks`` takes its
plain version there (``combined_masks_reference``), bitwise equal to the
rows numpy computes one float32 operation at a time and to
``compute_masks`` per emitter; the NaN and infinite triangles' rows are
pinned, which the card tests hold the kernel of ``csrc/masks.cu`` to; the
arguments are checked before either version runs; and the kernel's launch
counter moves for nothing that runs here."""
import numpy as np
import pytest
import torch

from raystrack_tpu_torch import tracing
from raystrack_tpu_torch.ops import trace as T
from raystrack_tpu_torch.ops.masks_cuda import check_mask_args, mask_rows
from _mask_cases import N_SURF, mask_case, spec_rows

SHAPES = [(e, t) for e in (1, 2, 11, 97) for t in (2048, 6144)]


@pytest.mark.parametrize("n_emit,n_tri", SHAPES, ids=[f"E{e}-T{t}" for e, t in SHAPES])
def test_cpu_rows_are_the_plain_version_bitwise(n_emit, n_tri):
    case = mask_case(n_emit, n_tri, seed=n_emit * 7 + n_tri)
    got = T.combined_masks(*case)
    assert got.dtype == torch.float32 and got.shape == (n_emit, n_tri)
    assert torch.equal(got, T.combined_masks_reference(*case))
    want = spec_rows(*case)
    assert np.array_equal(got.numpy(), want)
    scene, ext, emit, mins, plane = case
    for e in range(n_emit):  # row e is the per-emitter masks of emitter e
        m_any, m_mat = T.compute_masks(scene, ext[e], int(emit[e]), int(mins[e]), plane[e])
        assert torch.equal(got[e], m_any.to(torch.float32) + m_mat.to(torch.float32))
    # the case reaches every value (row 0 has min_sid 0: no 1), and the
    # plane test culls triangles that the rows would otherwise keep
    assert set(np.unique(want).tolist()) == ({0.0, 2.0} if n_emit == 1 else {0.0, 1.0, 2.0})
    flat = plane.clone()
    flat[:, 7] = 0.0
    assert (spec_rows(scene, ext, emit, mins, flat) > want).any()


def test_nan_and_inf_triangles_are_pinned():
    """One surface, every triangle eligible: a planar emitter keeps a
    triangle exactly when no distance is NaN and the largest exceeds tol;
    a non-planar one keeps them all, NaN or not."""
    nan, inf = float("nan"), float("inf")
    v0 = torch.tensor([[nan, 0, 0], [0, 0, 0], [0, 0, 0], [inf, -inf, 0], [0, 0, 1], [0, 0, -1]],
                      dtype=torch.float32)
    e1 = torch.tensor([[0, 0, 1], [0, 0, inf], [0, 0, -inf], [0, 0, 0], [0, 0, 0], [0, 0, nan]],
                      dtype=torch.float32)
    e2 = torch.zeros_like(e1)
    sid = torch.zeros(6, dtype=torch.int32)
    scene = (v0, e1, e2, None, None, None, None, sid)
    ext = torch.tensor([[1, 0], [1, 0], [1, 0]], dtype=torch.int32)
    emit = torch.full((3,), 5, dtype=torch.int32)
    mins = torch.zeros(3, dtype=torch.int32)
    plane = torch.tensor([[0, 0, 0, 0, 0, 1, -1e30, 1],  # planar, any finite distance reaches
                          [0, 0, 0, 0, 0, 1, 0.5, 1],  # planar, tol 0.5
                          [0, 0, 0, 0, 0, 1, 0.5, 0]], dtype=torch.float32)  # not planar
    got = T.combined_masks(scene, ext, emit, mins, plane)
    # triangle: NaN vertex, +inf edge, -inf edge, inf - inf, z = 1, a NaN edge
    assert got.tolist() == [[0, 2, 2, 0, 2, 0],
                            [0, 2, 0, 0, 2, 0],
                            [2, 2, 2, 2, 2, 2]]
    assert np.array_equal(got.numpy(), spec_rows(scene, ext, emit, mins, plane))


def _fault(name):
    """A 2-row case over 2,048 triangles with one argument made wrong."""
    scene, ext, emit, mins, plane = mask_case(2, 2048, seed=3)
    scene = list(scene)
    bad = {
        "v0_float64": lambda: scene.__setitem__(0, scene[0].double()),
        "e2_shape": lambda: scene.__setitem__(2, scene[2][:, :2].contiguous()),
        "e1_strided": lambda: scene.__setitem__(1, scene[1].t().contiguous().t()),
        "sid_int64": lambda: scene.__setitem__(7, scene[7].long()),
        "sid_2d": lambda: scene.__setitem__(7, scene[7][:, None]),
        "v0_missing": lambda: scene.__setitem__(0, None),
    }
    if name in bad:
        bad[name]()
        return (tuple(scene), ext, emit, mins, plane)
    rows = dict(ext=ext, emit=emit, mins=mins, plane=plane)
    rows.update({
        "ext_float": dict(ext=ext.float()),
        "ext_strided": dict(ext=torch.zeros((2, 2 * (N_SURF + 1)), dtype=torch.int32)[:, ::2]),
        "ext_1d": dict(ext=ext[0]),
        "emit_int64": dict(emit=emit.long()),
        "emit_rows": dict(emit=emit[:1]),
        "mins_float": dict(mins=mins.float()),
        "plane_float64": dict(plane=plane.double()),
        "plane_width": dict(plane=plane[:, :7].contiguous()),
        "plane_strided": dict(plane=torch.zeros((8, 2), dtype=torch.float32).t()),
    }[name])
    return (tuple(scene), rows["ext"], rows["emit"], rows["mins"], rows["plane"])


FAULTS = {
    "v0_float64": TypeError, "e2_shape": ValueError, "e1_strided": ValueError,
    "sid_int64": TypeError, "sid_2d": ValueError, "v0_missing": TypeError,
    "ext_float": TypeError, "ext_strided": ValueError, "ext_1d": ValueError,
    "emit_int64": TypeError, "emit_rows": ValueError, "mins_float": TypeError,
    "plane_float64": TypeError, "plane_width": ValueError, "plane_strided": ValueError,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_argument_checks_raise(fault):
    args = _fault(fault)
    for fn in (T.combined_masks, mask_rows, check_mask_args):
        with pytest.raises(FAULTS[fault]):
            fn(*args)


def test_other_devices_are_refused():
    scene, ext, emit, mins, plane = mask_case(2, 2048, seed=4)
    meta = tuple(None if t is None else t.to("meta") for t in scene)
    rows = tuple(t.to("meta") for t in (ext, emit, mins, plane))
    for fn in (T.combined_masks, mask_rows):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(meta, *rows)
    with pytest.raises(ValueError, match="is on meta"):
        T.combined_masks(meta, ext, emit, mins, plane)


def test_launch_counter_moves_only_for_a_launch(monkeypatch):
    """The plain version launches nothing: CPU rows, a CPU scheduled solve
    and a refused call leave ``mask_rows.launches`` where it was, and
    ``tracing.counts()`` reads it."""
    from raystrack_tpu_torch import MatrixParams, PreparedSolver, config, view_factor_matrix

    monkeypatch.setattr(config, "SCHEDULER", "scheduled")

    before = mask_rows.launches
    case = mask_case(11, 2048, seed=5)
    T.combined_masks(*case)
    with pytest.raises(ValueError):
        mask_rows(*case)  # CPU tensors: refused before any launch
    quad = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
    meshes = [("bottom", quad, faces), ("top", quad[:, [1, 0, 2]] + [0, 0, 1], faces)]
    rounds = []
    real = T.combined_masks
    monkeypatch.setattr(T, "combined_masks", lambda *a: rounds.append(a) or real(*a))
    vf = view_factor_matrix(meshes, MatrixParams(samples=2, rays=16, seed=3, max_iters=2,
                                                 min_iters=2, reciprocity=False, device="cpu"),
                            prepared=PreparedSolver(meshes))
    assert rounds and vf["bottom"]["top_front"] > 0.1 and vf["top"]["bottom_front"] > 0.1
    assert mask_rows.launches == before
    assert tracing.counts()["mask_rows.launches"] == before
