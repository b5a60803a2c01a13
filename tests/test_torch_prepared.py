"""Port parity: host preparation, device packs and state carried across.

The PyTorch port copies the JAX package's host-side preparation, so every
table and pack it builds must equal the JAX package's BITWISE, on the
street canyon and on a >= 512-face scene whose Morton order decides the
triangle (and so the tie) order.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raystrack_tpu.ops.halton as jhalton
import raystrack_tpu.prepared as jprep
from raystrack_tpu.solver import _cp_rows as j_cp_rows

import raystrack_tpu_torch.ops.halton as thalton
import raystrack_tpu_torch.prepared as tprep
from raystrack_tpu_torch.interop import emitter_pack_from_arrays, scene_pack_from_arrays
from raystrack_tpu_torch.solver import _cp_rows as t_cp_rows

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from examples.ex00_street_canyon_geometry import build_street_canyon  # noqa: E402

CPU = torch.device("cpu")


def _cloud_scene(n_cloud=600, seed=4):
    """A plate emitter under a random triangle cloud (> 512 faces)."""
    rng = np.random.default_rng(seed)
    V = np.array([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    centers = rng.uniform([-2, -2, 0.5], [2, 2, 3], size=(n_cloud, 3))
    spans = rng.normal(scale=0.3, size=(n_cloud, 2, 3))
    Vc = np.concatenate(
        [centers, centers + spans[:, 0], centers + spans[:, 1]], axis=1
    ).reshape(-1, 3).astype(np.float32)
    Fc = np.arange(n_cloud * 3, dtype=np.int32).reshape(-1, 3)
    return [("plate", V, F), ("cloud", Vc, Fc)]


SCENES = {"canyon": build_street_canyon, "cloud": _cloud_scene}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_fields_equal(a, b, names):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, (int, float, bool, np.integer, np.floating)):
            assert x == y, name
        else:
            np.testing.assert_array_equal(_np(x), _np(y), err_msg=name)
            assert _np(x).dtype == _np(y).dtype, name


@pytest.mark.parametrize("g", [4, 7, 18])
def test_halton_grid_bitwise(g):
    for a, b in zip(jhalton.cached_halton(g), thalton.cached_halton(g)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.float32


@pytest.mark.parametrize("n", [1000, 40_000])
def test_halton_dims_bitwise(n):
    for a, b in zip(jhalton.cached_halton_dims(n), thalton.cached_halton_dims(n)):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert b.dtype == np.float32


def test_cp_rows_bitwise():
    for seed, idx, start, chunk in ((1, 0, 0, 4), (11, 3, 17, 16), (31, 10, 5, 1)):
        np.testing.assert_array_equal(
            j_cp_rows(seed, idx, start, chunk), t_cp_rows(seed, idx, start, chunk)
        )


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("use_accel", [False, True])
def test_prepare_and_pack_scene_bitwise(scene, use_accel):
    meshes = SCENES[scene]()
    jps, tps = jprep.PreparedSolver(meshes), tprep.PreparedSolver(meshes)
    js, ts = jps.get_scene(use_accel=use_accel), tps.get_scene(use_accel=use_accel)
    _assert_fields_equal(js, ts, ["v0", "e1", "e2", "normals", "sid", "use_accel"])

    jp = jps.get_scene_pack(use_accel=use_accel)
    tp = tps.get_scene_pack(use_accel=use_accel, device=CPU)
    _assert_fields_equal(jp, tp, [f.name for f in dataclasses.fields(tprep.ScenePack)])
    if use_accel and scene == "cloud":  # Morton order really permuted the soup
        assert not np.array_equal(_np(tp.v0)[: tp.n_tri], js.v0)

    mb_j, mb_t = jps.get_mesh_bounds(), tps.get_mesh_bounds()
    for a, b in zip(mb_j, mb_t):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("flip_faces", [False, True])
def test_prepare_and_pack_emitters_bitwise(scene, flip_faces):
    meshes = SCENES[scene]()
    kw = dict(samples=2, rays=16, flip_faces=flip_faces)
    jps, tps = jprep.PreparedSolver(meshes), tprep.PreparedSolver(meshes)
    host_fields = [
        f.name for f in dataclasses.fields(tprep.PreparedEmitter)
    ] + ["u_grid", "v_grid", "halton_tri", "halton_u", "halton_v",
         "halton_r1", "halton_r2"]
    pack_fields = [f.name for f in dataclasses.fields(tprep.EmitterPack)]
    for idx in range(len(meshes)):
        _assert_fields_equal(
            jps.get_emitter(idx, **kw), tps.get_emitter(idx, **kw), host_fields
        )
        _assert_fields_equal(
            jps.get_emitter_pack(idx, **kw),
            tps.get_emitter_pack(idx, device=CPU, **kw),
            pack_fields,
        )


def _as_arrays(pack):
    return {
        f.name: (getattr(pack, f.name) if isinstance(getattr(pack, f.name), int)
                 else None if getattr(pack, f.name) is None
                 else np.asarray(getattr(pack, f.name)))
        for f in dataclasses.fields(pack)
    }


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_interop_carries_jax_packs(scene):
    """JAX packs carried across through interop equal the port's own packs."""
    meshes = SCENES[scene]()
    jps, tps = jprep.PreparedSolver(meshes), tprep.PreparedSolver(meshes)
    scene_t = scene_pack_from_arrays(
        _as_arrays(jps.get_scene_pack(use_accel=True)), CPU
    )
    own = tps.get_scene_pack(use_accel=True, device=CPU)
    for f in dataclasses.fields(tprep.ScenePack):
        a, b = getattr(scene_t, f.name), getattr(own, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name

    kw = dict(samples=2, rays=16, flip_faces=False)
    em_t = emitter_pack_from_arrays(_as_arrays(jps.get_emitter_pack(0, **kw)), CPU)
    own = tps.get_emitter_pack(0, device=CPU, **kw)
    for f in dataclasses.fields(tprep.EmitterPack):
        a, b = getattr(em_t, f.name), getattr(own, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name


def test_interop_rejects_what_it_cannot_carry():
    """A slim pack carries across (``tri_pack`` set, the per-triangle
    fields None) and equals the port's own; a dict without ``tri_pack`` is
    a full pack; unknown and missing fields are refused."""
    meshes = _cloud_scene()
    jscene = jprep.PreparedSolver(meshes).get_scene(use_accel=True)
    slim = scene_pack_from_arrays(
        _as_arrays(jprep.pack_scene(jscene, len(meshes), slim=True)), CPU)
    own = tprep.pack_scene(tprep.PreparedSolver(meshes).get_scene(use_accel=True),
                           len(meshes), device=CPU, slim=True)
    assert slim.slim and slim.v0 is None and slim.tri_pack.shape == (24, own.n_tri_pad)
    for f in dataclasses.fields(tprep.ScenePack):
        a, b = getattr(slim, f.name), getattr(own, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
    arrays = _as_arrays(jprep.PreparedSolver(meshes).get_scene_pack())
    assert arrays.pop("tri_pack") is None
    assert not scene_pack_from_arrays(arrays, CPU).slim
    with pytest.raises(KeyError):
        scene_pack_from_arrays(dict(arrays, bogus=1), CPU)
    del arrays["d0"]
    with pytest.raises(KeyError):
        scene_pack_from_arrays(arrays, CPU)
