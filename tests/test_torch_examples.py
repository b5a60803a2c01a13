"""The examples through the port (``examples_torch/``) on the CPU.

Modelled on ``tests/test_examples.py``: each port script imports without
JAX, runs end to end at tiny settings with ``device="cpu"`` under the
assertions that file makes, and agrees with the JAX package at the same
settings. For ex01, ex03 and ex07 the JAX example's own ``main`` runs
beside the port's; ex02, ex04, ex05, ex06 and ex08, whose JAX ``main``
takes no settings, are held against ``raystrack_tpu``'s API called with
the example's scene and parameters, shrunk. The JAX package runs its CPU
route (grouped driver, XLA sweep), the port its per-emitter driver with the
sweep's plain version.

Parity settings take ``min_iters == max_iters`` (neither package stops on a
noisy check) and enough rays that one ray is worth less than 1e-4 of an
entry, as ``tests/test_torch_solver.py`` chooses them: the few rays whose
ulp-level raygen differences flip an edge test stay below it. ex02's
89,458,688-ray ground makes that too slow here; its settings shrink (not
its scene) and its tolerance is stated in rays.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raystrack_tpu
from raystrack_tpu.parallel.distribute import (
    view_factor_matrix_partition as jax_partition,
)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from examples import ex01_compute_vf as jax_ex01  # noqa: E402
from examples import ex03_workflow as jax_ex03  # noqa: E402
from examples import ex07_resumable_pipeline as jax_ex07  # noqa: E402
from examples.ex00_street_canyon_geometry import build_street_canyon  # noqa: E402
from examples.ex02_compare_sky_vf import ground_plane as jax_ground_plane  # noqa: E402
from examples.ex04_inside_enclosure import make_box_unit_cube as jax_cube  # noqa: E402
from examples.ex06_city_block import build_city  # noqa: E402
from examples_torch import (  # noqa: E402
    ex00_street_canyon_geometry as ex00,
    ex01_compute_vf as ex01,
    ex02_compare_sky_vf as ex02,
    ex03_workflow as ex03,
    ex04_inside_enclosure as ex04,
    ex05_prepared_seed_compare as ex05,
    ex06_city_block as ex06,
    ex07_resumable_pipeline as ex07,
    ex08_uncertainty as ex08,
)
import raystrack_tpu_torch  # noqa: E402
import raystrack_tpu_torch.solver as tsolver  # noqa: E402

MODULES = [
    "examples_torch.ex00_street_canyon_geometry",
    "examples_torch.ex01_compute_vf",
    "examples_torch.ex02_compare_sky_vf",
    "examples_torch.ex03_workflow",
    "examples_torch.ex04_inside_enclosure",
    "examples_torch.ex05_prepared_seed_compare",
    "examples_torch.ex06_city_block",
    "examples_torch.ex07_resumable_pipeline",
    "examples_torch.ex08_uncertainty",
]

# tests/test_examples.py's end-to-end settings
TINY = dict(samples=2, rays=16, max_iters=3, min_iters=2, tol=1e-2)
# the canyon at samples 1, rays 256, 2 iterations: 25,088 rays a facade,
# one ray 4.0e-5 of an entry
PARITY = dict(samples=1, rays=256, min_iters=2, max_iters=2)
# a cheaper end-to-end run where tests/test_examples.py has none
SMALL = dict(samples=1, rays=4, max_iters=2, min_iters=2, tol=1e-2)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def _assert_close(got, want, tol=1e-4):
    """Same senders and keys; |dF| <= ``tol`` per entry (a float, or a
    ``{sender: float}``)."""
    assert set(got) == set(want)
    for sender, row in want.items():
        assert set(got[sender]) == set(row), sender
        bound = tol[sender] if isinstance(tol, dict) else tol
        for key, value in row.items():
            assert abs(got[sender][key] - value) <= bound, (sender, key, got[sender][key], value)


def _assert_rows_in_range(vf):
    for name, row in vf.items():
        total = sum(row.values())
        assert 0.0 <= total <= 1.0 + 1e-6, (name, total)


# (a) imports


@pytest.fixture(scope="module")
def jax_modules_pulled_in():
    """``{module: the jax / raystrack_tpu modules its import added}``, the
    examples imported one after another in one child process (one
    interpreter start, not nine)."""
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "jaxy = lambda: {m for m in sys.modules if m.split('.')[0] in ('jax', 'raystrack_tpu')}\n"
        "before = jaxy()\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "    after = jaxy()\n"
        "    print(json.dumps([name, sorted(after - before)]))\n"
        "    before = after\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return dict(json.loads(line) for line in out.stdout.splitlines())


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_neither_jax_nor_the_jax_package(module, jax_modules_pulled_in):
    assert jax_modules_pulled_in[module] == []


def test_examples_default_to_the_card(tmp_path):
    """Each example asks for the card unless told otherwise: without one it
    raises."""
    for mod in (ex01, ex02, ex03, ex04, ex05, ex06, ex08):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(out_dir=None, **TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex07.main(str(tmp_path), **TINY)


# (b) ex00


def test_ex00_json_equals_the_committed_file(tmp_path):
    path = ex00.main(str(tmp_path))
    assert Path(path).parent == tmp_path
    committed = json.loads((ROOT / "examples" / "street_canyon.json").read_text())
    assert json.loads(Path(path).read_text()) == committed


def test_borrowed_builders_equal_the_jax_examples():
    """The port's one copy of ex02's ground plane and ex04's cube, bitwise."""
    canyon = build_street_canyon()
    pairs = [(ex02.ground_plane(canyon), jax_ground_plane(canyon))]
    pairs += zip(ex04.make_box_unit_cube(), jax_cube())
    for (n1, v1, f1), (n2, v2, f2) in pairs:
        assert n1 == n2 and np.array_equal(v1, v2) and np.array_equal(f1, f2)
        assert v1.dtype == v2.dtype and f1.dtype == f2.dtype


# (c) end to end on the CPU, with tests/test_examples.py's assertions


def test_ex01_runs_end_to_end(tmp_path, capsys):
    path = ex01.main(out_dir=str(tmp_path), **TINY, **CPU)
    data = json.loads(Path(path).read_text())
    assert len(data) == 11
    _assert_rows_in_range(data)
    assert "Saved view-factor matrix" in capsys.readouterr().out


def test_ex03_runs_end_to_end(tmp_path):
    vf_scene, sky_vf, rest_vf = ex03.main(out_dir=str(tmp_path), **TINY, **CPU)
    scene_file = json.loads((tmp_path / "vf_scene_workflow.json").read_text())
    sky_file = json.loads((tmp_path / "sky_vf_workflow.json").read_text())
    assert set(scene_file) == set(sky_file)
    for name in rest_vf:
        total = (sum(vf_scene.get(name, {}).values())
                 + sum(sky_vf.get(name, {}).values())
                 + rest_vf[name]["Rest"])
        assert abs(total - 1.0) < 1e-9, (name, total)


def test_ex04_runs_end_to_end(tmp_path):
    vf = ex04.main(str(tmp_path), **TINY, **CPU)
    assert json.loads((tmp_path / "inside_vf_matrix.json").read_text()) == vf
    assert set(vf) == {"Bottom", "Top", "Front", "Back", "Left", "Right"}
    for name, row in vf.items():  # a closed box: every inward ray hits a wall
        assert abs(sum(row.values()) - 1.0) <= 1e-6, name


def _cache_ids(prepared):
    return {name: {key: id(value) for key, value in getattr(prepared, name).items()}
            for name in ("_scene_cache", "_emitter_cache", "_scene_pack_cache",
                         "_emitter_pack_cache", "_flat_cache")}


def test_ex05_builds_its_packs_once(monkeypatch):
    """The second and third seeds reuse every prepared object the first built."""
    seen = []
    real = ex05.solve

    def solve(meshes, prepared, seed, **overrides):
        out = real(meshes, prepared, seed, **overrides)
        seen.append(_cache_ids(prepared))
        return out

    monkeypatch.setattr(ex05, "solve", solve)
    results, prepared = ex05.main(None, **TINY, **CPU)
    assert sorted(results) == list(ex05.SEEDS)
    assert seen[0]["_scene_pack_cache"] and seen[0]["_emitter_pack_cache"]
    assert seen[1] == seen[0] and seen[2] == seen[0]
    for vf in results.values():
        assert len(vf) == 11
        _assert_rows_in_range(vf)


def test_ex06_runs_end_to_end():
    target, row, sky = ex06.main(None, grid=3, **SMALL, **CPU)
    assert target == "b11_south" and row
    assert 0.0 < sum(row.values()) <= 1.0 + 1e-6
    assert len(sky) == 3 * 3 * 5 + 1
    for name, values in sky.items():
        assert set(values) == {"Sky"} and 0.0 <= values["Sky"] <= 1.0, name


def test_ex06_partition_row_equals_the_full_matrix_row():
    """The partition's per-emitter row == the same emitter's row of the
    port's full matrix (reciprocity off), on the same rays."""
    tiny = dict(ex06.SETTINGS, **SMALL, **CPU)
    target, row, _ = ex06.main(None, grid=3, **tiny)
    full = raystrack_tpu_torch.view_factor_matrix(
        build_city(3), params=raystrack_tpu_torch.MatrixParams(**tiny, reciprocity=False))
    assert row and row == full[target]


def test_ex07_runs_end_to_end(tmp_path):
    path = ex07.main(out_dir=str(tmp_path), **SMALL, device="cpu")
    data = json.loads(Path(path).read_text())
    assert "terrain" in data and any(k.startswith("tower") for k in data)
    _assert_rows_in_range(data)


def test_ex08_runs_end_to_end():
    out = ex08.main(None, **TINY, **CPU)
    for vf, stats in (out["matrix"], out["matrix_seed12"]):
        assert len(vf) == 11 and set(stats) == set(vf)
        for sender, row in vf.items():  # reciprocity off: every row traced
            assert set(stats[sender]) == set(row), sender
            assert all(np.isfinite(v) and v >= 0.0 for v in stats[sender].values())
    vf_s, sky, rest, wstats = out["workflow"]
    assert set(wstats) == set(vf_s)
    for sender in vf_s:
        assert set(wstats[sender]) == set(vf_s[sender]) | set(sky[sender]), sender
    road = sorted(out["matrix"][0]["road"].items(), key=lambda kv: -kv[1])[:6]
    assert list(out["flags"]) == [key for key, _ in road]
    assert set(out["flags"].values()) <= {"ok", ex08.UNEXPECTED}


# (d) parity against the JAX package at the same settings


def test_ex01_matches_the_jax_example(tmp_path):
    want = json.loads(Path(jax_ex01.main(out_dir=str(tmp_path / "jax"), **PARITY, **CPU))
                      .read_text())
    got = json.loads(Path(ex01.main(out_dir=str(tmp_path / "port"), **PARITY, **CPU))
                     .read_text())
    _assert_close(got, want)


def test_ex03_matches_the_jax_example(tmp_path):
    want = jax_ex03.main(out_dir=str(tmp_path / "jax"), **PARITY, **CPU)
    got = ex03.main(out_dir=str(tmp_path / "port"), **PARITY, **CPU)
    for g, w in zip(got, want):  # scene, sky, rest
        _assert_close(g, w)


def test_ex07_matches_the_jax_example(tmp_path):
    # the terrain's 3,600 cells and each tower's 625 at 16 rays and 2
    # iterations: 20,000 rays or more an emitter
    kw = dict(samples=1, rays=16, min_iters=2, max_iters=2, tol=1e-3)
    want = json.loads(Path(jax_ex07.main(out_dir=str(tmp_path / "jax"), **kw)).read_text())
    got = json.loads(Path(ex07.main(out_dir=str(tmp_path / "port"), **kw, device="cpu"))
                     .read_text())
    _assert_close(got, want)


def test_ex02_matches_the_jax_package():
    """The matrix with the ground and the canyon's merged sky, at samples 1,
    4 rays a cell and 2 iterations: the ground's 43,681 cells give 349,448
    rays, a facade's 49 only 392, so each entry is held to two rays of its
    emitter (2 / rays traced), or 1e-4 where that is larger."""
    kw = dict(samples=1, rays=4, min_iters=2, max_iters=2, **CPU)
    derived, sky, scene = ex02.main(None, **kw)
    canyon = build_street_canyon()
    meshes = canyon + [jax_ground_plane(canyon)]
    shared = dict(ex02.SHARED, **kw)
    want_scene = raystrack_tpu.view_factor_matrix(
        meshes, params=raystrack_tpu.MatrixParams(**shared, reciprocity=False))
    want_sky = raystrack_tpu.view_factor_to_tregenza_sky(
        canyon, params=raystrack_tpu.SkyParams(**shared, discrete=False))
    ps = raystrack_tpu_torch.PreparedSolver(meshes)
    two_rays = {
        name: max(1e-4, 2.0 / (ps.get_emitter(i, samples=1, rays=4, flip_faces=False).n_cells
                               * 4 * 2))
        for i, (name, _, _) in enumerate(meshes)}
    assert two_rays[ex02.GROUND_NAME] == 1e-4
    _assert_close(scene, want_scene, two_rays)
    _assert_close(sky, want_sky, two_rays)
    for name, value in derived.items():
        want = max(0.0, 1.0 - sum(want_scene[name].values()))
        assert abs(value - want) <= two_rays[name], name


def test_ex04_matches_the_jax_package(tmp_path):
    # 16 cells a face at 1,024 rays and 4 iterations: 65,536 rays a face
    kw = dict(samples=16, rays=1024, min_iters=4, max_iters=4, **CPU)
    got = ex04.main(str(tmp_path), **kw)
    want = raystrack_tpu.view_factor_matrix(jax_cube(), params=raystrack_tpu.MatrixParams(
        seed=42, bvh="auto", flip_faces=True, reciprocity=False, tol=1e-3, tol_mode="stderr",
        **kw))
    _assert_close(got, want)


def test_ex05_matches_the_jax_package():
    results, _ = ex05.main(None, **PARITY, **CPU)
    meshes = build_street_canyon()
    prepared = raystrack_tpu.PreparedSolver(meshes)
    for seed in ex05.SEEDS:
        params = raystrack_tpu.MatrixParams(
            seed=seed, bvh="auto", tol=1e-4, tol_mode="stderr", reciprocity=True,
            **PARITY, **CPU)
        want = raystrack_tpu.view_factor_matrix(meshes, params=params, prepared=prepared)
        _assert_close(results[seed], want)


def test_ex06_matches_the_jax_package():
    """The 3 x 3 city: the partition row (b11_south's 256 cells at 24 rays
    and 4 iterations: 24,576 rays) and every surface's merged sky (a roof's
    144 cells: 13,824 rays)."""
    kw = dict(samples=1, rays=24, min_iters=4, max_iters=4, **CPU)
    target, row, sky = ex06.main(None, grid=3, **kw)
    meshes = build_city(3)
    settings = dict(ex06.SETTINGS, **kw)
    want_row = jax_partition(
        meshes, raystrack_tpu.MatrixParams(**settings, reciprocity=False),
        n_parts=len(meshes), part=[m[0] for m in meshes].index(target))[target]
    want_sky = raystrack_tpu.view_factor_to_tregenza_sky(
        meshes, params=raystrack_tpu.SkyParams(**settings))
    _assert_close({target: row}, {target: want_row})
    _assert_close(sky, want_sky)


def test_ex08_matches_the_jax_package():
    """Values and stderrs of the three solves, seeds 11 and 12."""
    out = ex08.main(None, **PARITY, **CPU)
    meshes = build_street_canyon()
    mp = dict(seed=11, tol=1e-4, tol_mode="stderr", reciprocity=False, **PARITY, **CPU)
    sp = {k: v for k, v in mp.items() if k != "reciprocity"}
    want = raystrack_tpu.view_factor_matrix(
        meshes, params=raystrack_tpu.MatrixParams(**mp), return_stats=True)
    want12 = raystrack_tpu.view_factor_matrix(
        meshes, params=raystrack_tpu.MatrixParams(**dict(mp, seed=12)), return_stats=True)
    want_wf = raystrack_tpu.view_factor_outside_workflow(
        meshes, matrix_params=raystrack_tpu.MatrixParams(**mp),
        sky_params=raystrack_tpu.SkyParams(**sp, discrete=True), return_stats=True)
    for got_pair, want_pair in ((out["matrix"], want), (out["matrix_seed12"], want12)):
        for g, w in zip(got_pair, want_pair):
            _assert_close(g, w)
    for g, w in zip(out["workflow"], want_wf):
        _assert_close(g, w)


# (e) ex07 run twice


def test_ex07_second_run_restores_every_emitter(tmp_path, monkeypatch):
    kw = dict(SMALL, device="cpu")
    first = Path(ex07.main(str(tmp_path), **kw)).read_text()

    def traced(*args, **kwargs):
        raise AssertionError("the second run traced a chunk")

    monkeypatch.setattr(tsolver._EmitterRun, "dispatch_chunk", traced)
    assert Path(ex07.main(str(tmp_path), **kw)).read_text() == first
