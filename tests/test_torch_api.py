"""The port's public surface against the JAX package's, and its packaging.

- The package data ships every kernel source and header under
  ``raystrack_tpu_torch/csrc``, so an installed package can build its
  kernels; the build directory falls back to a user cache directory where
  the one beside the package cannot be written, and a failed build raises.
- ``PreparedSolver.get_scene_pack``, ``get_flat_tables`` and
  ``get_emitter_pack`` take ``device=None``, the default device, cached
  under that device's own key, and ``clear_device_cache`` drops the device
  state, as the JAX package's do; the packs built so are bitwise the JAX
  package's.
- ``MatrixParams.from_dict`` takes the dict the JAX package's takes, field
  for field, and refuses an unknown key the same way.
- ``__version__`` is the JAX package's.
"""
import dataclasses
import fnmatch
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

import raystrack_tpu
import raystrack_tpu.prepared as jprep
from raystrack_tpu.params import MatrixParams as JMatrixParams

import raystrack_tpu_torch
import raystrack_tpu_torch.prepared as tprep
from raystrack_tpu_torch.ops import build as tbuild
from raystrack_tpu_torch.params import MatrixParams as TMatrixParams
from raystrack_tpu_torch.solver import _resolve_device

ROOT = Path(__file__).resolve().parents[1]


def _plate_and_cloud(n_cloud=40, seed=2):
    rng = np.random.default_rng(seed)
    V = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    centers = rng.uniform([-1, -1, 0.5], [1, 1, 2], size=(n_cloud, 3))
    Vc = (centers[:, None, :] + rng.normal(scale=0.2, size=(n_cloud, 3, 3))).reshape(-1, 3)
    Fc = np.arange(3 * n_cloud, dtype=np.int32).reshape(-1, 3)
    return [("plate", V, F), ("cloud", Vc.astype(np.float32), Fc)]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# packaging and the build directory
# ---------------------------------------------------------------------------


def test_package_data_ships_every_kernel_source():
    """Every file under raystrack_tpu_torch/csrc (the .cu sources and the
    .cuh headers they include) matches a package-data pattern."""
    with open(ROOT / "pyproject.toml", "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"]["raystrack_tpu_torch"]
    csrc = ROOT / "raystrack_tpu_torch" / "csrc"
    files = sorted(p.relative_to(csrc.parent).as_posix() for p in csrc.iterdir() if p.is_file())
    assert any(f.endswith(".cuh") for f in files) and any(f.endswith(".cu") for f in files)
    missing = [f for f in files if not any(fnmatch.fnmatch(f, p) for p in patterns)]
    assert not missing, f"not shipped: {missing}"


def _unwritable(tmp_path):
    """A build directory that cannot be made: its parent is a file."""
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    return blocker / "build" / "raystrack_tpu_torch"


def test_build_dir_is_beside_the_package_when_writable(monkeypatch, tmp_path):
    monkeypatch.setattr(tbuild, "SOURCE_BUILD_DIR", tmp_path / "build" / "raystrack_tpu_torch")
    assert tbuild.build_dir() == tmp_path / "build" / "raystrack_tpu_torch"
    assert tbuild.build_dir().is_dir()


@pytest.mark.parametrize("xdg", [True, False], ids=["xdg_cache_home", "home_cache"])
def test_build_dir_falls_back_to_the_user_cache(monkeypatch, tmp_path, xdg):
    """Where build/ beside the package cannot be written (an installed
    package), the library goes under $XDG_CACHE_HOME, else ~/.cache."""
    monkeypatch.setattr(tbuild, "SOURCE_BUILD_DIR", _unwritable(tmp_path))
    if xdg:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        want = tmp_path / "xdg" / "raystrack_tpu_torch"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        want = tmp_path / "home" / ".cache" / "raystrack_tpu_torch"
    assert tbuild.build_dir() == want
    assert want.is_dir()


def test_build_raises_when_nothing_can_be_written(monkeypatch, tmp_path):
    monkeypatch.setattr(tbuild, "SOURCE_BUILD_DIR", _unwritable(tmp_path))
    (tmp_path / "x").mkdir()
    monkeypatch.setenv("XDG_CACHE_HOME", str(_unwritable(tmp_path / "x")))
    with pytest.raises(RuntimeError, match="build directory"):
        tbuild.build_dir()


def test_failed_build_in_the_fallback_directory_still_raises(monkeypatch, tmp_path):
    """The fallback hides no failure: an nvcc that fails makes build() raise
    with its output and the directory, and leaves no library behind."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'this compiler always fails'\nexit 3\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(tbuild, "SOURCE_BUILD_DIR", _unwritable(tmp_path))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    with pytest.raises(RuntimeError, match="always fails") as err:
        tbuild.build()
    out_dir = tmp_path / "xdg" / "raystrack_tpu_torch"
    assert str(out_dir) in str(err.value)
    assert not list(out_dir.glob("*.so")) and not list(out_dir.glob("*.o"))


# ---------------------------------------------------------------------------
# PreparedSolver: the default device and clear_device_cache
# ---------------------------------------------------------------------------

KW = dict(samples=2, rays=16, flip_faces=False)


def test_bare_pack_calls_take_the_default_device():
    """With no ``device`` the packs and flat tables are those of the device
    a solve with ``device="auto"`` takes (the CPU here): the same objects,
    under one cache key."""
    ps = tprep.PreparedSolver(_plate_and_cloud())
    dev = _resolve_device("auto")
    assert tprep._device_key(None) == tprep._device_key(dev)
    for use_accel in (False, True):
        assert ps.get_scene_pack(use_accel=use_accel) is ps.get_scene_pack(
            use_accel=use_accel, device=dev)
    assert ps.get_emitter_pack(1, **KW) is ps.get_emitter_pack(1, device=dev, **KW)
    assert ps.get_flat_tables(**KW) is ps.get_flat_tables(device=dev, **KW)
    assert len(ps._scene_pack_cache) == 2 and len(ps._emitter_pack_cache) == 1
    assert len(ps._flat_cache) == 1


def test_bare_packs_equal_the_jax_packages():
    """Bare calls of both packages build bitwise-equal packs and tables."""
    meshes = _plate_and_cloud()
    jps, tps = jprep.PreparedSolver(meshes), tprep.PreparedSolver(meshes)
    jp, tp = jps.get_scene_pack(use_accel=True), tps.get_scene_pack(use_accel=True)
    for f in dataclasses.fields(tprep.ScenePack):
        x, y = getattr(jp, f.name), getattr(tp, f.name)
        if x is None or isinstance(x, (bool, int, float)):
            assert x == y, f.name
        else:
            np.testing.assert_array_equal(_np(x), _np(y), err_msg=f.name)
    je, te = jps.get_emitter_pack(0, **KW), tps.get_emitter_pack(0, **KW)
    for f in dataclasses.fields(tprep.EmitterPack):
        np.testing.assert_array_equal(_np(getattr(je, f.name)), _np(getattr(te, f.name)),
                                      err_msg=f.name)
    jt, jg, joff, jpad = jps.get_flat_tables(**KW)
    tt, tg, toff, tpad = tps.get_flat_tables(**KW)
    for a, b in zip(jt + jg, tt + tg):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(joff, toff)
    np.testing.assert_array_equal(jpad, tpad)


@pytest.mark.parametrize("package", [jprep, tprep], ids=["jax", "torch"])
def test_clear_device_cache_drops_device_state_only(package):
    """Both packages: after ``clear_device_cache`` the packs and tables are
    built anew; the host state (scene, emitters) is kept."""
    ps = package.PreparedSolver(_plate_and_cloud())
    scene, emitters = ps.get_scene(use_accel=False), ps.get_emitters(**KW)
    packs = (ps.get_scene_pack(), ps.get_emitter_pack(0, **KW), ps.get_flat_tables(**KW))
    ps.clear_device_cache()
    again = (ps.get_scene_pack(), ps.get_emitter_pack(0, **KW), ps.get_flat_tables(**KW))
    assert all(a is not b for a, b in zip(packs, again))
    assert ps.get_scene(use_accel=False) is scene and ps.get_emitters(**KW) is emitters


# ---------------------------------------------------------------------------
# MatrixParams.from_dict
# ---------------------------------------------------------------------------


def test_matrix_params_from_dict_field_for_field():
    """One dict through both packages' ``from_dict``: the same fields; and
    ``as_dict`` round-trips."""
    data = dict(samples=8, rays=64, seed=5, bvh="off", device="cpu", max_iters=7,
                tol=2e-4, tol_mode="delta", min_iters=2, convergence_interval=3,
                reciprocity=False, enforce_reciprocity_rowsum=True, flip_faces=True)
    j, t = JMatrixParams.from_dict(dict(data)), TMatrixParams.from_dict(dict(data))
    assert isinstance(t, TMatrixParams)
    assert t.as_dict() == j.as_dict()
    assert TMatrixParams.from_dict(t.as_dict()) == t
    assert TMatrixParams.from_dict({}) == TMatrixParams()


def test_matrix_params_from_dict_refuses_what_the_jax_package_refuses():
    with pytest.raises(TypeError):
        JMatrixParams.from_dict({"samples": 4, "not_a_field": 1})
    with pytest.raises(TypeError):
        TMatrixParams.from_dict({"samples": 4, "not_a_field": 1})
    with pytest.raises(ValueError, match="device"):  # the port's own device check
        TMatrixParams.from_dict({"device": "tpu"})



def test_version_equals_the_jax_packages():
    assert raystrack_tpu_torch.__version__ == raystrack_tpu.__version__ == "0.1.0"
