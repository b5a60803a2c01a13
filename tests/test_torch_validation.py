"""The port's validation runner (``validate_torch.py``) on the CPU.

Each of the nine cases runs through the runner at reduced iterations (and,
for the canyon's, reduced samples), and the JAX package solves the same
meshes with the same parameters: the raw rows must agree within 1e-4 per
entry, the tolerance of ``tests/test_torch_solver.py``. The committed TPU
results are parsed as the runner prints them; the runner runs in a
process that never imports JAX or the JAX package, and leaves
``validation/results/`` as it found it.
"""
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raystrack_tpu

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import validate_torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def _jax_solve(run):
    params = dict(run.params, device="cpu")
    if run.kind == "matrix":
        return raystrack_tpu.view_factor_matrix(
            run.meshes, params=raystrack_tpu.MatrixParams(**params))
    return raystrack_tpu.view_factor_to_tregenza_sky(
        run.meshes, params=raystrack_tpu.SkyParams(**params))


@pytest.mark.parametrize("case_id", sorted(validate_torch.CASES))
def test_case_rows_match_the_jax_package(case_id):
    result = validate_torch.CASES[case_id]("cpu", validate_torch.reduced_overrides(case_id))
    assert result.runs and result.case.startswith(case_id)
    for run in result.runs:
        assert run.params["max_iters"] == 3 and run.params["device"] == "cpu"
        assert run.iterations and max(run.iterations.values()) <= 3
        want = _jax_solve(run)
        assert set(run.vf) == set(want)
        for sender, row in want.items():
            assert set(run.vf[sender]) == set(row), sender
            for key, value in row.items():
                assert abs(run.vf[sender][key] - value) <= 1e-4, (sender, key)
    assert np.isfinite(result.value) and np.isfinite(result.err)
    if case_id <= "06":  # one measure against one tolerance
        assert result.passed == (result.err <= result.tol)


class _Stop(Exception):
    pass


def test_runner_settings_are_the_cases_own(monkeypatch):
    """Full settings: what validation/validate_0N_*.py and common.run_solver state."""
    seen = {}

    def record(kind, meshes, params):
        seen.setdefault(case, []).append((kind, params))
        raise _Stop

    monkeypatch.setattr(validate_torch, "_solve", record)
    for case in validate_torch.CASES:
        with pytest.raises(_Stop):
            validate_torch.CASES[case]("gpu", {})
    fixed = dict(bvh="builtin", convergence_interval=1, reciprocity=False,
                 enforce_reciprocity_rowsum=False, flip_faces=False, tol=1e-4,
                 tol_mode="stderr", min_iters=40, max_iters=500, device="gpu")
    sampling = {"01": (32, 1024, 11), "02": (16, 512, 11), "03": (16, 512, 11),
                "04": (8, 1024, 11), "05": (32, 512, 11), "06": (8, 512, 31),
                "09": (8, 512, 31)}
    for case, (samples, rays, seed) in sampling.items():
        ((kind, params),) = seen[case]
        assert kind == "matrix"
        assert params == dict(fixed, samples=samples, rays=rays, seed=seed)
    ((kind, sky),) = seen["07"]  # the merged solve; the discrete one follows it
    assert kind == "sky" and sky == dict(samples=8, rays=512, seed=17, bvh="builtin",
                                         device="gpu", tol=1e-4, tol_mode="stderr",
                                         min_iters=40, max_iters=500)
    ((kind, cube),) = seen["08"]
    assert kind == "matrix" and cube == dict(
        samples=32, rays=512, seed=23, bvh="builtin", device="gpu", flip_faces=True,
        reciprocity=False, tol=5e-5, tol_mode="stderr", min_iters=40, max_iters=4000)


# value, |err|, iterations (min, max) and pair of each committed TPU result
COMMITTED = {
    "01_parallel_equal_square": (0.1998818169, 0.0000569212, (93, 97), None),
    "02_parallel_equal_rectangle": (0.2859215095, 0.0000461247, (266, 270), None),
    "03_equal_coaxial_discs": (0.3820428287, 0.0000768175, (58, 68), None),
    "04_patch_to_disc": (0.4999679565, 0.0000320435, (40, 40), None),
    "05_perpendicular_square_rectangle": (0.2001173231, 0.0000735471, (118, 144), None),
    "06_canyon_analytic": (0.0261794593, 0.0000618615, (40, 40), ("road", "east_side_2")),
    "07_canyon_sky": (0.4794765856, 0.0000514415, None, None),
    "08_cube_interior": (0.0000739644, 0.0000739644, None, None),
    "09_canyon_view3d": (0.0261794593, 0.0000614593, (40, 40), ("road", "east_side_2")),
}


@pytest.mark.parametrize("case", sorted(COMMITTED))
def test_committed_results_parse(case):
    value, err, iters, pair = COMMITTED[case]
    got = validate_torch.read_committed(case)
    assert got["value"] == value and got["err"] == err and got["passed"] is True
    if iters is None:
        assert got["iterations"] == {}
    else:
        assert (min(got["iterations"].values()), max(got["iterations"].values())) == iters
    assert got.get("pair") == pair


def test_pass_fail_and_the_exit_code(monkeypatch, tmp_path, capsys):
    """A case outside its tolerance prints FAIL and makes the runner exit 1;
    the difference from the committed value is printed, not judged."""
    committed = validate_torch.read_committed("01_parallel_equal_square")

    def fake(value):
        def case(device, overrides):
            err = abs(value - 0.1998248957)
            return validate_torch.CaseResult(
                "01_parallel_equal_square", "F(plate_1 -> plate_2)", value, 0.1998248957,
                err, 1e-4, err <= 1e-4, [validate_torch.Run("matrix", [], {}, {}, {"p": 7})],
                value_as_committed=value)
        return case

    for value, rc, verdict in ((0.19985, 0, "PASS"), (0.1996, 1, "FAIL")):
        monkeypatch.setitem(validate_torch.CASES, "01", fake(value))
        assert validate_torch.main(["--device", "cpu", "--cases", "1", "--out",
                                    str(tmp_path)]) == rc
        out = capsys.readouterr().out
        assert f"iters 7: {verdict}" in out
        assert f"difference {value - committed['value']:+.4e}" in out
        saved = json.loads((tmp_path / "results.json").read_text())
        assert saved["cases"][0]["passed"] is (rc == 0)


def _results_digest():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((ROOT / "validation" / "results").iterdir())}


@pytest.fixture(scope="module")
def runner_process(tmp_path_factory):
    """The runner in a fresh process at reduced settings, with the modules it
    loaded; ``validation/results/`` hashed before and after."""
    out = tmp_path_factory.mktemp("validate_torch")
    before = _results_digest()
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = ['validate_torch.py', '--device', 'cpu', '--reduced', '--cases', "
        f"'04,08', '--out', {str(out)!r}]\n"
        "try:\n"
        "    runpy.run_path('validate_torch.py', run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    rc = exc.code\n"
        "print('MODULES', json.dumps(sorted(sys.modules)))\n"
        "print('RC', rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    return proc, out, before


def test_runner_imports_no_jax(runner_process):
    proc, out, _ = runner_process
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    modules = json.loads(next(l for l in lines if l.startswith("MODULES "))[8:])
    assert "raystrack_tpu_torch" in modules
    leaked = [m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "raystrack_tpu")]
    assert not leaked
    assert any(l.startswith("04_patch_to_disc:") for l in lines)
    assert any(l.startswith("08_cube_interior:") for l in lines)
    assert (out / "results.json").exists()


def test_runner_leaves_validation_results_unchanged(runner_process):
    proc, _, before = runner_process
    assert proc.returncode == 0, proc.stderr
    assert _results_digest() == before
    git = subprocess.run(["git", "status", "--porcelain", "validation/results/"], cwd=ROOT,
                         capture_output=True, text=True)
    if git.returncode == 0:  # a checkout without git metadata has only the hashes
        assert git.stdout == ""
