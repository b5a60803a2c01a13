"""Port parity of the shared-ray workflow: ``view_factor_matrix_and_sky``,
``view_factor_outside_workflow``, ``outside_workflow_shareable`` and
``enforce_reciprocity_only``.

The JAX side runs on its CPU backend (its CPU route), the port the kernels'
plain versions. Models: ``tests/test_workflow.py`` and the shared-ray cases
of ``tests/test_solver.py``.
"""
import re

import numpy as np
import pytest
import torch

import raystrack_tpu
from raystrack_tpu.utils.helpers import enforce_reciprocity_only as jax_reciprocity_only

import raystrack_tpu_torch
import raystrack_tpu_torch.solver as tsolver
from raystrack_tpu_torch import config as tconfig
from raystrack_tpu_torch.ops.count_cuda import count_bins
from raystrack_tpu_torch.ops.trace_cuda import sweep_rays
from raystrack_tpu_torch.utils.helpers import enforce_reciprocity_only


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


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


MESHES = [
    _square("ground", 2.0, 0.0, normal=+1),
    _square("panel", 1.0, 0.8, normal=-1, center=(0.2, 0.0)),
]

THREE = [
    _square("ground", 2.0, 0.0, normal=+1),
    _square("mid", 1.5, 0.6, normal=-1, center=(0.4, 0.1)),
    _square("top", 3.0, 1.2, normal=-1),
]


def _params(pkg, **kw):
    """(MatrixParams, SkyParams) of ``pkg``, shareable unless ``kw`` says
    otherwise (keys prefixed ``m_`` / ``s_`` go to one side only)."""
    base = dict(samples=8, rays=128, seed=7, device="cpu", bvh="off", max_iters=8,
                min_iters=3, tol=1e-3)
    m = dict(base, **{k[2:]: v for k, v in kw.items() if k.startswith("m_")})
    s = dict(base, **{k[2:]: v for k, v in kw.items() if k.startswith("s_")})
    return pkg.MatrixParams(**m), pkg.SkyParams(**s)


def _row_total(scene, sky, rest, name):
    return (sum(scene.get(name, {}).values()) + sum(sky.get(name, {}).values())
            + rest[name]["Rest"])


def _close(got, want, tol):
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for key, value in want[name].items():
            assert abs(got[name][key] - value) <= tol, (name, key, got[name][key], value)


def test_shareable_predicate():
    mp, sp = _params(raystrack_tpu_torch)
    share = raystrack_tpu_torch.outside_workflow_shareable
    assert share(mp, sp)
    for kw in (dict(m_samples=16), dict(m_seed=1), dict(m_flip_faces=True), dict(s_rays=64),
               dict(s_bvh="builtin")):
        assert not share(*_params(raystrack_tpu_torch, **kw)), kw
    # tolerances and iteration limits may differ: each monitor has its own
    assert share(*_params(raystrack_tpu_torch, m_tol=1e-6, s_max_iters=3))


@pytest.mark.parametrize("discrete", [False, True], ids=["merged", "discrete"])
@pytest.mark.parametrize("reciprocity", [True, False], ids=["reciprocity", "full"])
def test_shared_solve_equals_separate_solves(discrete, reciprocity):
    """One ray set for both outputs gives exactly the dicts of the two
    separate solves with the same parameters (tests/test_solver.py:203),
    stats included, on scenes where one side stops before the other."""
    mp, sp = _params(raystrack_tpu_torch, m_reciprocity=reciprocity, m_max_iters=9,
                     s_discrete=discrete, s_tol=2e-3)
    vf, sky, stats = raystrack_tpu_torch.view_factor_matrix_and_sky(
        THREE, matrix_params=mp, sky_params=sp, return_stats=True)
    vf_sep, m_stats = raystrack_tpu_torch.view_factor_matrix(THREE, mp, return_stats=True)
    sky_sep, s_stats = raystrack_tpu_torch.view_factor_to_tregenza_sky(
        THREE, sp, return_stats=True)
    assert vf == vf_sep and sky == sky_sep
    for name, _, _ in THREE:
        assert stats[name] == {**m_stats.get(name, {}), **s_stats.get(name, {})}
    assert vf["ground"] and sum(sky["ground"].values()) > 0.1


def test_independent_convergence_from_log_lines(monkeypatch):
    """One side converging early must not stop the other side's iterations
    (tests/test_workflow.py:123): the sky stops at min_iters, the matrix
    runs to max_iters, and the emitter traces max_iters."""
    lines = []
    monkeypatch.setattr(tsolver, "_log", lines.append)
    mp, sp = _params(raystrack_tpu_torch, m_tol=1e-9, m_max_iters=10, m_min_iters=2,
                     m_reciprocity=False, s_tol=1.0, s_max_iters=10, s_min_iters=2)
    raystrack_tpu_torch.view_factor_matrix_and_sky(MESHES, matrix_params=mp, sky_params=sp)
    stats = {}
    for line in lines:
        m = re.search(r"\[(\w+)\] traced (\d+) iter.*scene=(\d+) iter, sky=(\d+) iter", line)
        if m:
            stats[m.group(1)] = tuple(int(m.group(k)) for k in (2, 3, 4))
    assert set(stats) == {"ground", "panel"}
    for name, (traced, scene_iters, sky_iters) in stats.items():
        assert (traced, scene_iters, sky_iters) == (10, 10, 2), name


@pytest.mark.parametrize("discrete", [False, True], ids=["merged", "discrete"])
def test_matrix_and_sky_matches_jax(discrete):
    """Same key sets and |dF| <= 1e-4 per entry of both dicts; same stats
    keys; min_iters == max_iters, so neither package stops on a noisy
    check."""
    kw = dict(m_min_iters=4, m_max_iters=4, s_min_iters=4, s_max_iters=4, m_samples=32,
              s_samples=32, m_rays=256, s_rays=256, s_discrete=discrete)
    outs = []
    for pkg in (raystrack_tpu, raystrack_tpu_torch):
        mp, sp = _params(pkg, **kw)
        outs.append(pkg.view_factor_matrix_and_sky(THREE, matrix_params=mp, sky_params=sp,
                                                   return_stats=True))
    (jvf, jsky, jstats), (vf, sky, stats) = outs
    _close(vf, jvf, 1e-4)
    _close(sky, jsky, 1e-4)
    assert {k: set(v) for k, v in stats.items()} == {k: set(v) for k, v in jstats.items()}


@pytest.mark.parametrize(
    "case",
    ["shared", "fallback", "discrete", "enforced", "no_reciprocity"],
)
def test_outside_workflow_matches_jax(case):
    """The port's outside workflow against the JAX package's: |dF| <= 1e-4
    per entry of the scene, sky and rest dicts, stats key sets equal, and
    scene + sky + rest == 1 per emitter within 1e-9 (1e-6 with enforced
    rows, as tests/test_workflow.py holds them)."""
    kw = {
        "shared": {},
        "fallback": dict(s_samples=4),  # not shareable: two separate solves
        "discrete": dict(s_discrete=True),
        "enforced": dict(m_enforce_reciprocity_rowsum=True),
        "no_reciprocity": dict(m_reciprocity=False),
    }[case]
    outs = []
    for pkg in (raystrack_tpu, raystrack_tpu_torch):
        mp, sp = _params(pkg, **kw)
        assert pkg.outside_workflow_shareable(mp, sp) == (case != "fallback")
        outs.append(pkg.view_factor_outside_workflow(THREE, matrix_params=mp, sky_params=sp,
                                                     return_stats=True))
    (jscene, jsky, jrest, jstats), (scene, sky, rest, stats) = outs
    _close(scene, jscene, 1e-4)
    _close(sky, jsky, 1e-4)
    _close(rest, jrest, 1e-4)
    assert {k: set(v) for k, v in stats.items()} == {k: set(v) for k, v in jstats.items()}
    for name, _, _ in THREE:
        total = _row_total(scene, sky, rest, name)
        assert abs(total - 1.0) < (1e-6 if case == "enforced" else 1e-9), name
    assert len(sky["ground"]) == (145 if case == "discrete" else 1)


def test_outside_workflow_sums_to_one_two_surfaces():
    """tests/test_workflow.py's scene on both paths: scene + sky + rest == 1
    within 1e-9, and the shared path's stats hold both outputs' keys."""
    for kw in ({}, dict(s_samples=16)):
        mp, sp = _params(raystrack_tpu_torch, **kw)
        scene, sky, rest, stats = raystrack_tpu_torch.view_factor_outside_workflow(
            MESHES, matrix_params=mp, sky_params=sp, return_stats=True)
        for name, _, _ in MESHES:
            assert abs(_row_total(scene, sky, rest, name) - 1.0) < 1e-9
        assert "Sky" in stats["ground"] and "panel_front" in stats["ground"]


@pytest.mark.parametrize("discrete", [False, True], ids=["merged", "discrete"])
def test_workflow_scheduled_equals_per_emitter(monkeypatch, discrete):
    """config.SCHEDULER forced: the scheduled route's shared-ray dicts and
    stats == the per-emitter route's (tests/test_solver.py:313's model),
    with the sky converging before the matrix on some emitters."""
    mp, sp = _params(raystrack_tpu_torch, m_max_iters=9, s_tol=2e-3, s_discrete=discrete)
    outs = {}
    for route in ("grouped", "scheduled"):
        monkeypatch.setattr(tconfig, "SCHEDULER", route)
        outs[route] = raystrack_tpu_torch.view_factor_matrix_and_sky(
            THREE, matrix_params=mp, sky_params=sp, return_stats=True)
    assert outs["scheduled"] == outs["grouped"]
    assert outs["grouped"][0]["ground"]


def test_enforce_reciprocity_only_equals_jax():
    """On a seeded dict (front/back splits, a missing reverse entry, a pair
    below the tolerance, an undirected key) the port's helper leaves
    exactly the JAX helper's dict."""
    rng = np.random.default_rng(23)
    meshes = [_square(f"s{i}", float(rng.uniform(0.5, 3.0)), float(i)) for i in range(5)]
    names = [m[0] for m in meshes]
    result = {}
    for i, a in enumerate(names):
        row = {}
        for j, b in enumerate(names):
            if i == j or rng.uniform() < 0.25:
                continue
            row[f"{b}_front"] = float(rng.uniform(0, 0.2))
            if rng.uniform() < 0.5:
                row[f"{b}_back"] = float(rng.uniform(0, 0.05))
        result[a] = row
    result["s0"]["s1_front"] = 1e-14
    result["s1"].pop("s0_front", None)
    result["s1"].pop("s0_back", None)
    result["s2"]["s3"] = 0.03
    want = {k: dict(v) for k, v in result.items()}
    got = {k: dict(v) for k, v in result.items()}
    jax_reciprocity_only(want, meshes)
    enforce_reciprocity_only(got, meshes)
    assert got == want
    assert got != result


@pytest.mark.parametrize(
    "call,error",
    [
        (lambda: raystrack_tpu_torch.view_factor_matrix_and_sky(
            MESHES, matrix_params=_params(raystrack_tpu_torch)[1],
            sky_params=_params(raystrack_tpu_torch)[1]), TypeError),
        (lambda: raystrack_tpu_torch.view_factor_matrix_and_sky(
            MESHES, matrix_params=_params(raystrack_tpu_torch)[0],
            sky_params=_params(raystrack_tpu)[1]), TypeError),
        (lambda: raystrack_tpu_torch.view_factor_matrix_and_sky(
            MESHES, *(), **dict(zip(("matrix_params", "sky_params"),
                                    _params(raystrack_tpu_torch, m_seed=2)))), ValueError),
        (lambda: raystrack_tpu_torch.view_factor_matrix_and_sky(
            MESHES, **dict(zip(("matrix_params", "sky_params"), _params(raystrack_tpu_torch))),
            mesh=object()), NotImplementedError),
        (lambda: raystrack_tpu_torch.view_factor_outside_workflow(
            MESHES, matrix_params=_params(raystrack_tpu_torch)[0],
            sky_params=_params(raystrack_tpu_torch)[0]), TypeError),
    ],
    ids=["matrix_params", "sky_params", "not_shareable", "mesh", "workflow_sky_params"],
)
def test_workflow_rejects(call, error):
    with pytest.raises(error):
        call()


@pytest.mark.parametrize("solve", ["checkpoint_dir", "workflow_checkpoint_dir"])
def test_workflow_checkpoint_dir_works(tmp_path, solve):
    """``checkpoint_dir=`` no longer raises in the shared-ray solve or the
    outside workflow: each equals its plain solve, first and on a resume
    that restores every emitter (tests/test_torch_checkpoint.py holds the
    resume cases)."""
    mp, sp = _params(raystrack_tpu_torch, m_max_iters=3, s_max_iters=3)
    fn = {"checkpoint_dir": raystrack_tpu_torch.view_factor_matrix_and_sky,
          "workflow_checkpoint_dir": raystrack_tpu_torch.view_factor_outside_workflow}[solve]
    plain = fn(MESHES, matrix_params=mp, sky_params=sp)
    for _ in range(2):
        got = fn(MESHES, matrix_params=mp, sky_params=sp,
                 checkpoint_dir=str(tmp_path / "ckpt"))
        assert got == plain
    assert len(list((tmp_path / "ckpt").glob("emitter_*.json"))) == len(MESHES)


def test_workflow_launches_no_kernel_on_cpu():
    before = (sweep_rays.launches, count_bins.launches)
    mp, sp = _params(raystrack_tpu_torch, m_max_iters=3, s_max_iters=3)
    raystrack_tpu_torch.view_factor_outside_workflow(MESHES, matrix_params=mp, sky_params=sp)
    assert (sweep_rays.launches, count_bins.launches) == before == (0, 0)


def test_exports_the_solver_names():
    """The port exports the JAX package's 20 public names: the solvers and,
    since the I/O port, the mesh and matrix files and the stream writer."""
    names = {"MatrixParams", "SkyParams", "PreparedSolver", "view_factor_matrix",
             "view_factor", "view_factor_to_tregenza_sky", "view_factor_matrix_and_sky",
             "view_factor_outside_workflow", "outside_workflow_shareable",
             "clear_prepared_cache", "save_vf_matrix_json", "VFMatrixStreamWriter",
             "load_vf_matrix_json", "save_meshes_json", "load_meshes_json",
             "load_meshes_obj", "save_meshes_obj", "load_meshes_ply", "save_mesh_ply",
             "merge_vf_matrix"}
    assert set(raystrack_tpu_torch.__all__) == names == set(raystrack_tpu.__all__)
    assert len(raystrack_tpu_torch.__all__) == 20
    for name in names:
        assert getattr(raystrack_tpu_torch, name).__module__.startswith("raystrack_tpu_torch")
