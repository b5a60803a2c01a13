"""Port parity of the mesh and matrix files: ``io``, ``obj``, ``ply`` and
``utils/geometry``.

The cases of ``tests/test_io.py``, ``tests/test_ply.py`` (its CLI case is in
``tests/test_torch_cli.py``), the OBJ cases of ``tests/test_cli_obj.py`` and
the ``flip_meshes`` case of ``tests/test_solver.py``, through the port's
modules. Beside them, both packages save the same seeded meshes and
matrices: the files are byte-equal, and what either package loads from
them is ``np.array_equal`` (``==`` for matrices).
"""
import json
import struct

import numpy as np
import pytest
import torch

import raystrack_tpu
import raystrack_tpu.io as jio
import raystrack_tpu.obj as jobj
import raystrack_tpu.ply as jply
from raystrack_tpu.utils.geometry import flatten_receivers as jax_flatten_receivers

import raystrack_tpu_torch
from raystrack_tpu_torch.io import (
    VFMatrixStreamWriter,
    load_meshes_json,
    load_vf_matrix_json,
    merge_vf_matrix,
    save_meshes_json,
    save_vf_matrix_json,
)
from raystrack_tpu_torch.obj import load_meshes_obj, save_meshes_obj
from raystrack_tpu_torch.ply import load_meshes_ply, save_mesh_ply
from raystrack_tpu_torch.utils.geometry import flatten_receivers, flip_meshes


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


# ---------------------------------------------------------------------------
# tests/test_io.py
# ---------------------------------------------------------------------------


def test_merge_list_of_dicts():
    a = {"s1": {"r1": 0.1}, "s2": {"r1": 0.2}}
    b = {"s1": {"r2": 0.3, "r1": 0.15}}
    merged = merge_vf_matrix([a, b])
    assert merged == {"s1": {"r1": 0.15, "r2": 0.3}, "s2": {"r1": 0.2}}


def test_merge_rejects_bad_types():
    with pytest.raises(TypeError):
        merge_vf_matrix(42)
    with pytest.raises(TypeError):
        merge_vf_matrix([{"a": {}}, "nope"])


def test_save_drops_zeros_and_roundtrips(tmp_path):
    vf = {"s": {"hit": 0.5, "miss": 0.0}}
    path = save_vf_matrix_json(vf, str(tmp_path / "vf"))
    assert path.endswith(".json")
    assert load_vf_matrix_json(path) == {"s": {"hit": 0.5}}


def test_save_strip_dir_merges_directions(tmp_path):
    vf = {"s": {"r_front": 0.25, "r_back": 0.5, "other": 0.1}}
    path = save_vf_matrix_json(vf, str(tmp_path / "vf.json"), strip_dir=True)
    assert json.loads(open(path).read()) == {"s": {"r": 0.75, "other": 0.1}}


def test_mesh_roundtrip(tmp_path):
    V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=np.float32)
    F = np.array([[0, 1, 2]], dtype=np.int32)
    path = save_meshes_json([("tri", V, F)], str(tmp_path / "meshes"))
    [(name, V2, F2)] = load_meshes_json(path)
    assert name == "tri"
    np.testing.assert_array_equal(V2, V)
    np.testing.assert_array_equal(F2, F)
    assert V2.dtype == np.float32 and F2.dtype == np.int32


def test_mesh_save_validates(tmp_path):
    with pytest.raises(TypeError):
        save_meshes_json("nope", str(tmp_path / "x"))
    with pytest.raises(TypeError):
        save_meshes_json([("", np.zeros((3, 3)), np.zeros((1, 3), np.int32))],
                         str(tmp_path / "x"))
    with pytest.raises(ValueError):
        save_meshes_json([("m", np.zeros((3, 2)), np.zeros((1, 3), np.int32))],
                         str(tmp_path / "x"))


def test_load_missing_file():
    with pytest.raises(FileNotFoundError):
        load_vf_matrix_json("/nonexistent/file.json")
    with pytest.raises(FileNotFoundError):
        load_meshes_json("/nonexistent/file.json")


def test_stream_writer_matches_save(tmp_path):
    """A streamed matrix loads back equal to save_vf_matrix_json's output,
    zero pruning and strip_dir folding included."""
    vf = {
        "a": {"b_front": 0.25, "b_back": 0.05, "c_front": 0.0},
        "b": {"a_front": 0.5},
        "empty": {},
    }
    for strip_dir in (False, True):
        ref_path = save_vf_matrix_json(vf, str(tmp_path / f"ref_{strip_dir}"),
                                       strip_dir=strip_dir)
        with VFMatrixStreamWriter(str(tmp_path / f"stream_{strip_dir}"),
                                  strip_dir=strip_dir) as w:
            for sender, row in vf.items():
                w.write_row(sender, row)
        streamed = load_vf_matrix_json(str(tmp_path / f"stream_{strip_dir}.json"))
        assert streamed == load_vf_matrix_json(ref_path)


def test_stream_writer_rejects_duplicates_and_bad_rows(tmp_path):
    with VFMatrixStreamWriter(str(tmp_path / "vf")) as w:
        w.write_row("a", {"b": 0.5})
        with pytest.raises(ValueError, match="duplicate"):
            w.write_row("a", {"c": 0.1})
        with pytest.raises(TypeError):
            w.write_row("c", {"d": "not a number"})
        w.write_row("c", {"d": 0.1})
    assert load_vf_matrix_json(str(tmp_path / "vf.json")) == {"a": {"b": 0.5}, "c": {"d": 0.1}}


def test_stream_writer_abort_leaves_no_output(tmp_path):
    target = tmp_path / "partial.json"
    with pytest.raises(RuntimeError):
        with VFMatrixStreamWriter(str(target)) as w:
            w.write_row("a", {"b": 0.5})
            raise RuntimeError("interrupted")
    assert not target.exists()
    assert not list(tmp_path.glob("*.tmp"))


def test_stream_writer_empty_matrix(tmp_path):
    with VFMatrixStreamWriter(str(tmp_path / "empty")):
        pass
    assert load_vf_matrix_json(str(tmp_path / "empty.json")) == {}


# ---------------------------------------------------------------------------
# tests/test_ply.py
# ---------------------------------------------------------------------------

VERTS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 1]], np.float32)


def _ascii_ply(tmp_path, *, faces, extra_vertex_prop=False, fmt="ascii"):
    lines = ["ply", f"format {fmt} 1.0", "comment made by tests",
             f"element vertex {len(VERTS)}",
             "property float x", "property float y", "property float z"]
    if extra_vertex_prop:
        lines.append("property uchar red")
    lines += [f"element face {len(faces)}",
              "property list uchar int vertex_indices", "end_header"]
    for v in VERTS:
        row = f"{v[0]} {v[1]} {v[2]}"
        if extra_vertex_prop:
            row += " 255"
        lines.append(row)
    for f in faces:
        lines.append(f"{len(f)} " + " ".join(str(i) for i in f))
    path = tmp_path / "scene.ply"
    path.write_text("\n".join(lines) + "\n", encoding="ascii")
    return str(path)


def _binary_ply(tmp_path, *, faces):
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(VERTS)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(faces)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    blob = header.encode("ascii")
    for v in VERTS:
        blob += struct.pack("<fff", *v)
    for f in faces:
        blob += struct.pack("<B", len(f)) + struct.pack(f"<{len(f)}i", *f)
    path = tmp_path / "scene_bin.ply"
    path.write_bytes(blob)
    return str(path)


def test_ply_ascii_triangles(tmp_path):
    path = _ascii_ply(tmp_path, faces=[[0, 1, 4], [1, 2, 4]])
    [(name, V, F)] = load_meshes_ply(path)
    assert name == "scene"
    np.testing.assert_allclose(V, VERTS)
    np.testing.assert_array_equal(F, [[0, 1, 4], [1, 2, 4]])
    assert V.dtype == np.float32 and F.dtype == np.int32


def test_ply_ascii_quad_fan_triangulated(tmp_path):
    path = _ascii_ply(tmp_path, faces=[[0, 1, 2, 3]])
    [(_, V, F)] = load_meshes_ply(path)
    np.testing.assert_array_equal(F, [[0, 1, 2], [0, 2, 3]])


def test_ply_ascii_extra_vertex_properties_skipped(tmp_path):
    path = _ascii_ply(tmp_path, faces=[[0, 1, 2]], extra_vertex_prop=True)
    [(_, V, F)] = load_meshes_ply(path)
    np.testing.assert_allclose(V, VERTS)


def test_ply_binary_matches_ascii(tmp_path):
    faces = [[0, 1, 4], [0, 1, 2, 3]]
    [(_, Va, Fa)] = load_meshes_ply(_ascii_ply(tmp_path, faces=faces))
    [(_, Vb, Fb)] = load_meshes_ply(_binary_ply(tmp_path, faces=faces))
    np.testing.assert_array_equal(Va, Vb)
    np.testing.assert_array_equal(Fa, Fb)


def test_ply_custom_name(tmp_path):
    path = _ascii_ply(tmp_path, faces=[[0, 1, 2]])
    [(name, _, _)] = load_meshes_ply(path, name="roof")
    assert name == "roof"


def test_ply_solvable_geometry(tmp_path):
    """A PLY quad facing another plate solves to a sane view factor."""
    path = _ascii_ply(tmp_path, faces=[[0, 1, 2, 3]])
    [mesh] = load_meshes_ply(path, name="bottom")
    top = ("top", np.array([[0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32),
           np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    vf = raystrack_tpu_torch.view_factor_matrix([mesh, top], params=raystrack_tpu_torch.MatrixParams(
        samples=4, rays=64, seed=3, device="cpu", max_iters=6, min_iters=3, tol=1e-3))
    assert 0.05 < vf["bottom"]["top_front"] < 0.6


def test_ply_rejects_big_endian(tmp_path):
    path = tmp_path / "bad.ply"
    path.write_text("ply\nformat binary_big_endian 1.0\n"
                    "element vertex 0\nelement face 0\nend_header\n")
    with pytest.raises(ValueError, match="unsupported PLY format"):
        load_meshes_ply(str(path))


def test_ply_rejects_out_of_range_index(tmp_path):
    path = _ascii_ply(tmp_path, faces=[[0, 1, 9]])
    with pytest.raises(ValueError, match="undefined vertex"):
        load_meshes_ply(path)


def test_ply_rejects_missing_elements(tmp_path):
    path = tmp_path / "noface.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 0\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "end_header\n")
    with pytest.raises(ValueError, match="'vertex' and 'face'"):
        load_meshes_ply(str(path))


def test_ply_missing_file():
    with pytest.raises(FileNotFoundError):
        load_meshes_ply("/nonexistent/scene.ply")


def test_ply_writer_roundtrip(tmp_path):
    F = np.array([[0, 1, 2], [0, 2, 4], [1, 3, 2]], np.int32)
    path = save_mesh_ply(("panel", VERTS, F), str(tmp_path / "panel"))
    assert path.endswith(".ply")
    [(name, V2, F2)] = load_meshes_ply(path)
    assert name == "panel"
    np.testing.assert_array_equal(V2, VERTS)
    np.testing.assert_array_equal(F2, F)


def test_ply_writer_validates(tmp_path):
    with pytest.raises(ValueError, match="must be"):
        save_mesh_ply(("bad", VERTS[:, :2], np.zeros((1, 3), np.int32)), str(tmp_path / "bad"))


# ---------------------------------------------------------------------------
# the OBJ cases of tests/test_cli_obj.py
# ---------------------------------------------------------------------------

OBJ_TEXT = """\
# two parallel unit squares
o bottom
v -0.5 -0.5 0.0
v  0.5 -0.5 0.0
v  0.5  0.5 0.0
v -0.5  0.5 0.0
f 1 2 3 4
o top
v -0.5 -0.5 1.0
v  0.5 -0.5 1.0
v  0.5  0.5 1.0
v -0.5  0.5 1.0
f 5//1 8//1 7//1 6//1
"""


def test_obj_loader_groups_and_triangulation(tmp_path):
    path = tmp_path / "scene.obj"
    path.write_text(OBJ_TEXT)
    meshes = load_meshes_obj(str(path))
    assert [m[0] for m in meshes] == ["bottom", "top"]
    for name, V, F in meshes:
        assert V.shape == (4, 3) and V.dtype == np.float32
        assert F.shape == (2, 3) and F.dtype == np.int32  # quad fan -> 2 tris
    # bottom winding gives +Z normal, top (reversed) gives -Z
    for name, want_z in (("bottom", 1.0), ("top", -1.0)):
        V, F = dict((m[0], (m[1], m[2])) for m in meshes)[name]
        n = np.cross(V[F[0, 1]] - V[F[0, 0]], V[F[0, 2]] - V[F[0, 0]])
        assert np.sign(n[2]) == want_z


def test_obj_loader_negative_indices(tmp_path):
    path = tmp_path / "neg.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    (name, V, F), = load_meshes_obj(str(path))
    assert name == "mesh" and F.tolist() == [[0, 1, 2]]


def test_obj_loader_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_meshes_obj(str(tmp_path / "missing.obj"))
    empty = tmp_path / "empty.obj"
    empty.write_text("v 0 0 0\n")
    with pytest.raises(ValueError):
        load_meshes_obj(str(empty))
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nf 1 2 9\n")
    with pytest.raises(ValueError):
        load_meshes_obj(str(bad))


def test_obj_writer_roundtrip(tmp_path):
    V1 = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    F1 = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    V2 = (V1 + np.float32([0, 0, 2.5]))[:3]
    F2 = np.array([[0, 2, 1]], np.int32)
    meshes = [("floor", V1, F1), ("tilted", V2, F2)]
    path = save_meshes_obj(meshes, str(tmp_path / "scene"))
    assert path.endswith(".obj")
    loaded = load_meshes_obj(path)
    assert [m[0] for m in loaded] == ["floor", "tilted"]
    for (n0, Va, Fa), (n1, Vb, Fb) in zip(meshes, loaded):
        np.testing.assert_array_equal(Va, Vb)
        np.testing.assert_array_equal(Fa, Fb)


# ---------------------------------------------------------------------------
# utils/geometry: the flip_meshes case of tests/test_solver.py
# ---------------------------------------------------------------------------


def _square(name, size, z, normal=1):
    h = size / 2.0
    V = np.array([[-h, -h, z], [h, -h, z], [h, h, z], [-h, h, z]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]] if normal >= 0 else [[0, 2, 1], [0, 3, 2]], np.int32)
    return name, V, F


def test_flip_meshes_helper_matches_flip_faces():
    meshes = [_square("floor", 1.0, 0.0, normal=-1), _square("ceil", 1.0, 1.0, normal=+1)]
    params = dict(samples=8, rays=64, seed=4, device="cpu", bvh="off", max_iters=6,
                  min_iters=3, tol=1e-3, reciprocity=False)
    vf_param = raystrack_tpu_torch.view_factor_matrix(
        meshes, params=raystrack_tpu_torch.MatrixParams(**params, flip_faces=True))
    # flipping geometry and emitting normally samples the same emission side
    flipped = flip_meshes(meshes)
    vf_geom = raystrack_tpu_torch.view_factor_matrix(
        flipped, params=raystrack_tpu_torch.MatrixParams(**params))
    f1 = sum(vf_param["floor"].values())
    f2 = sum(vf_geom["floor"].values())
    assert abs(f1 - f2) < 8e-3
    assert meshes[0][2].tolist() == [[0, 2, 1], [0, 3, 2]]  # the input is not touched


def test_flatten_receivers_equals_the_jax_package():
    rng = np.random.default_rng(2)
    meshes = [(f"m{i}", rng.normal(size=(6, 3)).astype(np.float32),
               rng.integers(0, 6, (5, 3)).astype(np.int32)) for i in range(3)]
    meshes = [(n, V, F[np.linalg.norm(np.cross(V[F[:, 1]] - V[F[:, 0]],
                                               V[F[:, 2]] - V[F[:, 0]]), axis=1) > 1e-3])
              for n, V, F in meshes]
    for skip in ((), (1,), (0, 1, 2)):
        got = flatten_receivers(meshes, 0, skip=skip)
        want = jax_flatten_receivers(meshes, 0, skip=skip)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# one file format for both packages
# ---------------------------------------------------------------------------


def _seeded_meshes(seed=11):
    """Three meshes of random triangles and vertices (including values with
    long decimal expansions) from a NumPy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (nv, nf) in enumerate(((7, 9), (4, 2), (12, 20))):
        V = (rng.normal(size=(nv, 3)) * 10.0 ** rng.integers(-3, 4)).astype(np.float32)
        F = rng.integers(0, nv, (nf, 3)).astype(np.int32)
        out.append((f"mesh_{i}", V, F))
    return out


def _seeded_matrix(seed=12):
    rng = np.random.default_rng(seed)
    names = ["a", "b", "c_1"]
    vf = {}
    for s in names:
        row = {}
        for r in names:
            for side in ("front", "back"):
                row[f"{r}_{side}"] = float(rng.random()) if rng.random() > 0.3 else 0.0
        vf[s] = row
    return vf


WRITERS = {
    "matrix_json": lambda m, path: m.save_vf_matrix_json(_seeded_matrix(), path),
    "matrix_json_strip_dir": lambda m, path: m.save_vf_matrix_json(
        _seeded_matrix(), path, strip_dir=True),
    "matrix_stream": lambda m, path: _stream(m, path),
    "meshes_json": lambda m, path: m.save_meshes_json(_seeded_meshes(), path),
    "meshes_obj": lambda m, path: m.save_meshes_obj(_seeded_meshes(), path),
    "mesh_ply": lambda m, path: m.save_mesh_ply(_seeded_meshes()[2], path),
}
READERS = {
    "matrix_json": "load_vf_matrix_json", "matrix_json_strip_dir": "load_vf_matrix_json",
    "matrix_stream": "load_vf_matrix_json", "meshes_json": "load_meshes_json",
    "meshes_obj": "load_meshes_obj", "mesh_ply": "load_meshes_ply",
}


def _stream(m, path):
    with m.VFMatrixStreamWriter(path, strip_dir=True) as w:
        for sender, row in _seeded_matrix().items():
            w.write_row(sender, row)
        return w.close()


class _Jax:
    """The JAX package's file functions under one namespace."""
    save_vf_matrix_json = staticmethod(jio.save_vf_matrix_json)
    load_vf_matrix_json = staticmethod(jio.load_vf_matrix_json)
    VFMatrixStreamWriter = jio.VFMatrixStreamWriter
    save_meshes_json = staticmethod(jio.save_meshes_json)
    load_meshes_json = staticmethod(jio.load_meshes_json)
    save_meshes_obj = staticmethod(jobj.save_meshes_obj)
    load_meshes_obj = staticmethod(jobj.load_meshes_obj)
    save_mesh_ply = staticmethod(jply.save_mesh_ply)
    load_meshes_ply = staticmethod(jply.load_meshes_ply)


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_files_byte_equal_and_loads_equal_across_packages(tmp_path, fmt):
    port_path = WRITERS[fmt](raystrack_tpu_torch, str(tmp_path / "port" / "out"))
    jax_path = WRITERS[fmt](_Jax, str(tmp_path / "jax" / "out"))
    assert open(port_path, "rb").read() == open(jax_path, "rb").read()
    got = getattr(raystrack_tpu_torch, READERS[fmt])(jax_path)
    want = getattr(_Jax, READERS[fmt])(port_path)
    if fmt.startswith("matrix"):
        assert got == want
        return
    assert [m[0] for m in got] == [m[0] for m in want]
    for (_, Va, Fa), (_, Vb, Fb) in zip(got, want):
        assert Va.dtype == Vb.dtype == np.float32 and Fa.dtype == Fb.dtype == np.int32
        assert np.array_equal(Va, Vb) and np.array_equal(Fa, Fb)
    if fmt == "meshes_json":  # JSON and OBJ round-trip float32 exactly
        for (_, V0, F0), (_, V1, F1) in zip(_seeded_meshes(), got):
            assert np.array_equal(V0, V1) and np.array_equal(F0, F1)


@pytest.mark.parametrize("kind", ["obj", "ply_ascii", "ply_binary"])
def test_loaders_equal_the_jax_package(tmp_path, kind):
    """Hand-written files with polygons, negative indices, groups and extra
    properties load to the same arrays in both packages."""
    if kind == "obj":
        path = tmp_path / "poly.obj"
        path.write_text(OBJ_TEXT + "g pent\nv 0 0 3\nv 1 0 3\nv 1.5 1 3\nv 0.5 2 3\n"
                        "v -0.5 1 3\nvt 0 0\nf -5/1 -4/1 -3/1 -2/1 -1/1\nusemtl x\n")
        load, jload = load_meshes_obj, jobj.load_meshes_obj
    else:
        path = (_ascii_ply(tmp_path, faces=[[0, 1, 2, 3], [0, 1, 4]], extra_vertex_prop=True)
                if kind == "ply_ascii" else _binary_ply(tmp_path, faces=[[0, 1, 2, 3, 4]]))
        load, jload = load_meshes_ply, jply.load_meshes_ply
    got, want = load(str(path)), jload(str(path))
    assert [m[0] for m in got] == [m[0] for m in want]
    for (_, Va, Fa), (_, Vb, Fb) in zip(got, want):
        assert np.array_equal(Va, Vb) and np.array_equal(Fa, Fb)
        assert Va.dtype == Vb.dtype and Fa.dtype == Fb.dtype


def test_the_port_reads_the_jax_packages_committed_files():
    """The scene and matrices the JAX package's examples committed load the
    same in both packages."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "examples"
    scene = load_meshes_json(str(root / "street_canyon.json"))
    jscene = raystrack_tpu.load_meshes_json(str(root / "street_canyon.json"))
    assert [m[0] for m in scene] == [m[0] for m in jscene]
    for (_, Va, Fa), (_, Vb, Fb) in zip(scene, jscene):
        assert np.array_equal(Va, Vb) and np.array_equal(Fa, Fb)
    for name in ("vf_matrix.json", "vf_streamed.json", "sky_vf_workflow.json"):
        assert load_vf_matrix_json(str(root / name)) == raystrack_tpu.load_vf_matrix_json(
            str(root / name))
