"""Port parity: view_factor_matrix end to end, and the port's boundaries.

Both packages solve the same scenes with ``min_iters == max_iters`` (so
neither stops on a noisy convergence check); the JAX package runs its CPU
route (grouped driver, XLA sweep), the port its per-emitter driver with
the sweep's plain version.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raystrack_tpu
import raystrack_tpu_torch
import raystrack_tpu_torch.solver as tsolver
from raystrack_tpu_torch.ops.trace_cuda import sweep_rays

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from examples.ex00_street_canyon_geometry import build_street_canyon  # noqa: E402


def _square(name, size, z, normal=1, center=(0.0, 0.0)):
    cx, cy = center
    h = size / 2.0
    V = np.array(
        [[cx - h, cy - h, z], [cx + h, cy - h, z], [cx + h, cy + h, z],
         [cx - h, cy + h, z]],
        dtype=np.float32,
    )
    F = np.array([[0, 1, 2], [0, 2, 3]] if normal >= 0 else [[0, 2, 1], [0, 3, 2]],
                 dtype=np.int32)
    return name, V, F


def _three_squares():
    return [
        _square("emitter", 1.0, 0.0),
        _square("mid", 1.5, 0.7, normal=-1, center=(0.3, -0.2)),
        _square("top", 3.0, 1.3, normal=+1, center=(-0.4, 0.1)),
    ]


# samples/rays per scene: enough rays per emitter that the few rays whose
# ulp-level raygen differences flip an edge test stay far below 1e-4
SCENES = {
    "squares": (_three_squares, dict(samples=64, rays=256)),
    "canyon": (build_street_canyon, dict(samples=1, rays=256)),
}


def _solve(pkg, meshes, **kw):
    params = pkg.MatrixParams(seed=5, min_iters=4, max_iters=4, device="cpu", **kw)
    return pkg.view_factor_matrix(meshes, params=params, return_stats=True)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize(
    "reciprocity,enforce", [(True, False), (False, False), (True, True)],
    ids=["reciprocity", "full", "enforced"],
)
def test_view_factor_matrix_matches_jax(scene, reciprocity, enforce):
    """Same key sets and |dF| <= 1e-4 per entry, back-fill included."""
    build, sampling = SCENES[scene]
    meshes = build()
    kw = dict(sampling, reciprocity=reciprocity, enforce_reciprocity_rowsum=enforce)
    want, want_se = _solve(raystrack_tpu, meshes, **kw)
    got, got_se = _solve(raystrack_tpu_torch, meshes, **kw)
    assert set(got) == set(want)
    for sender in want:
        assert set(got[sender]) == set(want[sender]), sender
        for key, value in want[sender].items():
            assert abs(got[sender][key] - value) <= 1e-4, (sender, key)
    assert set(got_se) == set(want_se)
    n_entries = sum(len(row) for row in got.values())
    assert n_entries >= (3 if scene == "squares" else 40)
    if reciprocity and not enforce:  # the back-fill filled rows it never traced
        assert any(got[s] and not got_se[s] for s in got)


def test_progress_lines_keep_their_format(monkeypatch):
    lines = []
    monkeypatch.setattr(tsolver, "_log", lines.append)
    meshes = _three_squares()
    raystrack_tpu_torch.view_factor_matrix(
        meshes, raystrack_tpu_torch.MatrixParams(
            samples=4, rays=16, min_iters=2, max_iters=2, reciprocity=False,
            device="cpu")
    )
    pattern = re.compile(
        r"^\((\d+)/3\) \[(\w+)\] (\d+) iter, ([\d,]+) rays -> \d+\.\d{3}s  "
        r"\(BVH=off, device=cpu\)$"
    )
    parsed = [pattern.match(line) for line in lines]
    assert all(parsed) and len(parsed) == 3, lines
    iters = {m.group(2): int(m.group(3)) for m in parsed}
    assert iters == {"emitter": 2, "mid": 2, "top": 0}  # top: nothing above it


def test_view_factor_sender_receiver():
    meshes = _three_squares()
    params = raystrack_tpu_torch.MatrixParams(samples=8, rays=32, min_iters=3,
                                              max_iters=3, device="cpu")
    pair = raystrack_tpu_torch.view_factor(meshes[0], meshes[1:], params)
    full = raystrack_tpu_torch.view_factor_matrix(meshes, params)
    assert set(pair) == {"emitter"}
    assert pair["emitter"] == full["emitter"] and pair["emitter"]


def test_solve_launches_no_kernel_on_cpu():
    before = sweep_rays.launches
    _solve(raystrack_tpu_torch, _three_squares(), samples=4, rays=16)
    assert sweep_rays.launches == before == 0


@pytest.mark.parametrize(
    "kwargs,error",
    [
        (dict(mesh=object()), TypeError),
        (dict(prepared=object()), TypeError),
    ],
)
def test_unported_options_raise(kwargs, error):
    params = raystrack_tpu_torch.MatrixParams(device="cpu")
    with pytest.raises(error):
        raystrack_tpu_torch.view_factor_matrix(_three_squares(), params, **kwargs)


def test_mesh_refusal_names_its_roadmap_item():
    """A mesh that is not a RayMesh raises TypeError naming the function
    that makes one (``mesh=`` itself is ported: tests/test_torch_sharding.py)."""
    with pytest.raises(TypeError, match=r"parallel\.ray_mesh\(\)"):
        raystrack_tpu_torch.view_factor_matrix(
            _three_squares(), raystrack_tpu_torch.MatrixParams(device="cpu"), mesh=object())


@pytest.mark.parametrize("option", ["checkpoint_dir", "row_sink"])
def test_retired_refusals_now_work(tmp_path, option):
    """``checkpoint_dir=`` and ``row_sink=`` no longer raise: the solve with
    either equals the plain solve (tests/test_torch_checkpoint.py holds the
    resume and the streaming against the JAX package's cases)."""
    meshes = _three_squares()
    params = raystrack_tpu_torch.MatrixParams(samples=4, rays=16, min_iters=2, max_iters=2,
                                              device="cpu")
    plain = raystrack_tpu_torch.view_factor_matrix(meshes, params)
    rows = {}
    kwargs = {"checkpoint_dir": dict(checkpoint_dir=str(tmp_path / "ckpt")),
              "row_sink": dict(row_sink=rows.__setitem__)}[option]
    assert raystrack_tpu_torch.view_factor_matrix(meshes, params, **kwargs) == plain
    if option == "row_sink":
        assert rows == plain
    else:
        assert len(list((tmp_path / "ckpt").glob("emitter_*.json"))) == 3


def test_params_reject_bad_values():
    with pytest.raises(ValueError, match="device"):
        raystrack_tpu_torch.MatrixParams(device="tpu")
    with pytest.raises(TypeError):
        raystrack_tpu_torch.view_factor_matrix(
            _three_squares(), raystrack_tpu.MatrixParams()
        )
    with pytest.raises(ValueError, match="bvh"):
        raystrack_tpu_torch.view_factor_matrix(
            _three_squares(), raystrack_tpu_torch.MatrixParams(bvh="kd", device="cpu")
        )


def test_gpu_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        raystrack_tpu_torch.view_factor_matrix(
            _three_squares(), raystrack_tpu_torch.MatrixParams(device="gpu")
        )


def test_import_pulls_in_no_jax():
    # jax, jaxlib and the JAX package are blocked: importing one would fail
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'raystrack_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import raystrack_tpu_torch, raystrack_tpu_torch.solver, "
        "raystrack_tpu_torch.interop, raystrack_tpu_torch.ops.trace, "
        "raystrack_tpu_torch.ops.trace_cuda, raystrack_tpu_torch.ops.build, "
        "raystrack_tpu_torch.api, raystrack_tpu_torch.ops.tregenza, "
        "raystrack_tpu_torch.ops.count_cuda, raystrack_tpu_torch.cli, "
        "raystrack_tpu_torch.io, raystrack_tpu_torch.obj, raystrack_tpu_torch.ply, "
        "raystrack_tpu_torch.utils.geometry, raystrack_tpu_torch.__main__, "
        "raystrack_tpu_torch.parallel.sharding, raystrack_tpu_torch.parallel.distribute, "
        "raystrack_tpu_torch.parallel.multihost\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'raystrack_tpu', 'triton'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
