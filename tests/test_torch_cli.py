"""Port parity of the command line: ``raystrack_tpu_torch.cli`` and
``python -m raystrack_tpu_torch``.

The CLI cases of ``tests/test_cli_obj.py`` and ``tests/test_ply.py`` run
through the port with ``--device cpu``. Beside them:
``python -m raystrack_tpu_torch matrix|sky|workflow ... --device cpu`` on
``examples/street_canyon.json`` agrees with the JAX package's CLI run
in-process within ``tests/test_torch_solver.py``'s |dF| <= 1e-4 (same key
sets); ``--stream-out`` writes what the plain run writes, under
reciprocity too; ``--checkpoint-dir`` resumes; the subcommands and flags
are the JAX CLI's; and without ``--device`` the CLI needs a card, so on a
machine without one it stops before it loads the scene.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raystrack_tpu.cli as jcli
from raystrack_tpu.io import save_meshes_json

import raystrack_tpu_torch.cli as tcli
import raystrack_tpu_torch.solver as tsolver
from raystrack_tpu_torch.cli import main as cli_main

ROOT = Path(__file__).resolve().parents[1]
CANYON = str(ROOT / "examples" / "street_canyon.json")
# test_torch_solver.py's canyon sampling: min_iters == max_iters, so neither
# package stops on a noisy convergence check
CANYON_FLAGS = ["--samples", "1", "--rays", "256", "--seed", "5", "--min-iters", "4",
                "--max-iters", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


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


def _square(name, z, flip):
    V = np.array([[-0.5, -0.5, z], [0.5, -0.5, z], [0.5, 0.5, z], [-0.5, 0.5, z]],
                 np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return name, V, (F[:, [0, 2, 1]].copy() if flip else F)


def _plates_json(tmp_path):
    path = tmp_path / "plates.json"
    save_meshes_json([_square("bottom", 0.0, False), _square("top", 1.0, True)], str(path))
    return str(path)


# ---------------------------------------------------------------------------
# the CLI cases of tests/test_cli_obj.py and tests/test_ply.py
# ---------------------------------------------------------------------------


def test_cli_matrix(tmp_path):
    out = tmp_path / "vf.json"
    rc = cli_main(["matrix", _plates_json(tmp_path), "--out", str(out), "--device", "cpu",
                   "--samples", "8", "--rays", "64", "--max-iters", "5",
                   "--min-iters", "2", "--tol", "1e-2"])
    assert rc == 0
    vf = json.loads(out.read_text())
    assert 0.1 < vf["bottom"]["top_front"] < 0.3


def test_cli_workflow_obj_input(tmp_path):
    scene = tmp_path / "scene.obj"
    scene.write_text(OBJ_TEXT)
    rc = cli_main(["workflow", str(scene), "--out-prefix", str(tmp_path / "w_"),
                   "--device", "cpu", "--samples", "8", "--rays", "64",
                   "--max-iters", "5", "--min-iters", "2", "--tol", "1e-2"])
    assert rc == 0
    scene_vf = json.loads((tmp_path / "w_vf_scene.json").read_text())
    sky_vf = json.loads((tmp_path / "w_sky_vf.json").read_text())
    rest_vf = json.loads((tmp_path / "w_rest_vf.json").read_text())
    total = (sum(scene_vf.get("bottom", {}).values())
             + sum(sky_vf.get("bottom", {}).values())
             # zero-valued Rest entries are pruned from the JSON by design
             + rest_vf.get("bottom", {}).get("Rest", 0.0))
    assert abs(total - 1.0) < 1e-9


def test_cli_matrix_stream_out(tmp_path, capsys):
    """--stream-out writes the matrix row by row; the file equals a
    non-streamed solve's with reciprocity off."""
    scene_path = _plates_json(tmp_path)
    common = [scene_path, "--samples", "2", "--rays", "16", "--max-iters", "3",
              "--min-iters", "2", "--device", "cpu", "--no-reciprocity"]
    cli_main(["matrix", *common, "--out", str(tmp_path / "plain.json")])
    cli_main(["matrix", *common, "--stream-out", "--out", str(tmp_path / "streamed.json")])
    plain = json.loads((tmp_path / "plain.json").read_text())
    streamed = json.loads((tmp_path / "streamed.json").read_text())
    assert streamed == {k: v for k, v in plain.items() if v} or streamed == plain
    assert "(streamed)" in capsys.readouterr().out


def test_cli_accepts_ply(tmp_path):
    from raystrack_tpu_torch.ply import save_mesh_ply

    path = save_mesh_ply(_square("quad", 0.0, False), str(tmp_path / "scene.ply"))
    out = tmp_path / "vf.json"
    cli_main(["matrix", path, "--out", str(out), "--samples", "2", "--rays", "8",
              "--max-iters", "2", "--min-iters", "1", "--device", "cpu"])
    assert out.exists()


# ---------------------------------------------------------------------------
# against the JAX package's CLI
# ---------------------------------------------------------------------------


def _run_module(args, cwd, **env):
    """``python -m raystrack_tpu_torch`` in a child process."""
    full_env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **env)
    return subprocess.run([sys.executable, "-m", "raystrack_tpu_torch", *args], cwd=cwd,
                          env=full_env, capture_output=True, text=True, timeout=300)


def _close(got, want, tol=1e-4):
    assert set(got) == set(want)
    for sender in want:
        assert set(got[sender]) == set(want[sender]), sender
        for key, value in want[sender].items():
            assert abs(got[sender][key] - value) <= tol, (sender, key, got[sender][key], value)


OUTPUTS = {
    "matrix": (["--out", "{d}/vf.json"], ["vf.json"]),
    "sky": (["--out", "{d}/sky.json"], ["sky.json"]),
    "workflow": (["--out-prefix", "{d}/w_"], ["w_vf_scene.json", "w_sky_vf.json",
                                             "w_rest_vf.json"]),
}


@pytest.mark.parametrize("command", sorted(OUTPUTS))
def test_module_cli_agrees_with_the_jax_cli(tmp_path, monkeypatch, command):
    out_args, files = OUTPUTS[command]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.setattr(jcli.sys, "stdout", open(os.devnull, "w"))
    assert jcli.main([command, CANYON, "--device", "cpu", *CANYON_FLAGS,
                      *[a.format(d=tmp_path / "jax") for a in out_args]]) == 0
    monkeypatch.undo()
    proc = _run_module([command, CANYON, "--device", "cpu", *CANYON_FLAGS,
                        *[a.format(d=tmp_path / "port") for a in out_args]], cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("Loaded 11 meshes (22 triangles)")
    for name in files:
        got = json.loads((tmp_path / "port" / name).read_text())
        want = json.loads((tmp_path / "jax" / name).read_text())
        _close(got, want)
        assert sum(len(row) for row in got.values()) >= 10


def test_stream_out_equals_the_plain_output_under_reciprocity(tmp_path):
    """Under reciprocity (the CLI's default) the streamed file holds every
    row, back-fill included: it loads ``==`` the plain run's file."""
    from raystrack_tpu_torch.io import load_vf_matrix_json

    common = ["matrix", CANYON, "--device", "cpu", *CANYON_FLAGS]
    assert cli_main([*common, "--out", str(tmp_path / "plain.json")]) == 0
    assert cli_main([*common, "--stream-out", "--out", str(tmp_path / "stream.json")]) == 0
    plain = load_vf_matrix_json(str(tmp_path / "plain.json"))
    assert load_vf_matrix_json(str(tmp_path / "stream.json")) == plain
    assert len(plain) == 11


def test_stream_out_refuses_enforce_rowsum(tmp_path):
    with pytest.raises(SystemExit) as err:
        cli_main(["matrix", _plates_json(tmp_path), "--device", "cpu", "--stream-out",
                  "--enforce-rowsum", "--out", str(tmp_path / "x.json")])
    assert err.value.code == 2


def test_cli_checkpoint_dir_resumes(tmp_path, monkeypatch):
    """A second run on the same --checkpoint-dir restores every emitter and
    streams the same matrix: the first run's stream is not there to keep
    the rows it wrote, so the restored rows stream again."""
    common = ["matrix", CANYON, "--device", "cpu", *CANYON_FLAGS, "--checkpoint-dir",
              str(tmp_path / "ckpt")]
    assert cli_main([*common, "--out", str(tmp_path / "first.json")]) == 0
    lines = []
    monkeypatch.setattr(tsolver, "_log", lines.append)
    assert cli_main([*common, "--stream-out", "--out", str(tmp_path / "second.json")]) == 0
    assert any(l.startswith("11/11 emitters restored") for l in lines)
    assert len(list((tmp_path / "ckpt").glob("emitter_*.json"))) == 11
    first = json.loads((tmp_path / "first.json").read_text())
    assert len(first) == 11
    assert json.loads((tmp_path / "second.json").read_text()) == first


@pytest.mark.parametrize("scheduler", ["grouped", "scheduled"])
def test_cli_stream_out_resumes_after_finished_emitters(tmp_path, monkeypatch, scheduler):
    """A ``--stream-out`` run stopped once emitter 0 has finished (its row
    streamed, the stream not yet published), then the same command again:
    the resumed stream holds every row, == the plain run's file."""
    from raystrack_tpu_torch import config
    from raystrack_tpu_torch.io import load_vf_matrix_json

    monkeypatch.setattr(config, "SCHEDULER", scheduler)
    monkeypatch.setattr(config, "CHECKPOINT_PROGRESS_S", 0.0)
    common = ["matrix", CANYON, "--device", "cpu", *CANYON_FLAGS]
    assert cli_main([*common, "--out", str(tmp_path / "plain.json")]) == 0
    ckpt, stream = tmp_path / "ckpt", tmp_path / "stream.json"
    argv = [*common, "--checkpoint-dir", str(ckpt), "--stream-out", "--out", str(stream)]
    real_done, finished = tsolver._entry_done, []

    def stop_after_emitter_0(entry):
        if 0 in finished:
            raise RuntimeError("killed mid-solve")
        real_done(entry)
        finished.append(entry["idx"])

    monkeypatch.setattr(tsolver, "_entry_done", stop_after_emitter_0)
    with pytest.raises(RuntimeError):
        cli_main(argv)
    monkeypatch.setattr(tsolver, "_entry_done", real_done)
    assert (ckpt / "emitter_00000.json").exists() and not stream.exists()
    lines = []
    monkeypatch.setattr(tsolver, "_log", lines.append)
    assert cli_main(argv) == 0
    assert any("[east_side_0] restored from checkpoint" in line for line in lines)
    assert load_vf_matrix_json(str(stream)) == load_vf_matrix_json(str(tmp_path / "plain.json"))


def _actions(parser):
    """{subcommand: {flag: (default, choices)}} of an argparse parser."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (a.default, a.choices) for a in p._actions}
            for name, p in sub.choices.items()}


def test_subcommands_and_flags_are_the_jax_clis(monkeypatch):
    """Same subcommands, flags and defaults as ``raystrack-tpu``, but for
    ``--device``: auto | gpu | cpu, default gpu."""
    parsers = {}
    for mod in (jcli, tcli):
        captured = []
        real = argparse.ArgumentParser.parse_args

        def grab(self, *a, **kw):
            captured.append(self)
            raise SystemExit(0)

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            mod.main(["matrix", "x.json"])
        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
        parsers[mod] = _actions(captured[0])
    port, jax_ = parsers[tcli], parsers[jcli]
    assert set(port) == set(jax_) == {"matrix", "sky", "workflow"}
    for name in jax_:
        assert set(port[name]) == set(jax_[name])
        for dest, spec in jax_[name].items():
            if dest == "device":
                assert spec == ("auto", ["auto", "tpu", "gpu", "cpu"])
                assert port[name][dest] == ("gpu", ["auto", "gpu", "cpu"])
            else:
                assert port[name][dest] == spec, (name, dest)


def test_cli_without_device_needs_a_card(tmp_path, capsys):
    """No ``--device``: the card or an error, before the scene loads (the
    Python API's ``device="auto"`` would carry on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA card")
    with pytest.raises(SystemExit) as err:
        cli_main(["matrix", str(tmp_path / "no_such_scene.json"), "--out",
                  str(tmp_path / "vf.json")])
    assert err.value.code == 2
    assert "needs a CUDA card" in capsys.readouterr().err
    assert not (tmp_path / "vf.json").exists()
    proc = _run_module(["matrix", CANYON, "--out", str(tmp_path / "vf.json")], cwd=tmp_path)
    assert proc.returncode == 2 and "needs a CUDA card" in proc.stderr
    assert "Loaded" not in proc.stdout and not (tmp_path / "vf.json").exists()


def test_module_help_names_the_port():
    proc = _run_module(["--help"], cwd=ROOT)
    assert proc.returncode == 0
    assert proc.stdout.startswith("usage: raystrack-tpu-torch")
