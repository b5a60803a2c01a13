"""Port parity of resumable solves: ``checkpoint_dir=`` and ``row_sink=``.

Every case of ``tests/test_checkpoint.py`` runs through the port on the
CPU, on the per-emitter driver and on the scheduled driver (forced through
``config.SCHEDULER`` as ``tests/test_torch_scheduled.py`` forces it): a
resumed dict is ``==`` to an uninterrupted one. Also held here:

- the checkpoint directory is one format for both packages: a directory
  the JAX package writes on the CPU is restored whole by the port (the port
  returns exactly the rows the JAX package wrote) and the other way round,
  progress snapshots included; the two stores' fingerprints are equal and
  the monitors' ``state_dict`` s are ``==`` after the same counts;
- the ``row_sink`` cases of ``tests/test_solver.py`` (rows streamed once,
  complete under reciprocity), with one rule of the port's own: a resumed
  solve streams its restored rows again, since the stream of a stopped
  solve is lost with it (the JAX package re-sinks no restored row), so a
  resumed stream written by ``VFMatrixStreamWriter`` equals the plain dict
  wherever the stop fell;
- stray ``*.tmp`` files of a killed writer do not disturb a resume, the
  progress hook writes nothing without a store, and the profile hook.
"""
import json
import re

import numpy as np
import pytest
import torch

import raystrack_tpu
import raystrack_tpu.convergence as jconv
import raystrack_tpu.solver as jsolver

import raystrack_tpu_torch
import raystrack_tpu_torch.convergence as tconv
import raystrack_tpu_torch.solver as solver_mod
from raystrack_tpu_torch import (
    MatrixParams, SkyParams, config, view_factor_matrix, view_factor_matrix_and_sky,
    view_factor_outside_workflow, view_factor_to_tregenza_sky,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


@pytest.fixture(params=["grouped", "scheduled"])
def route(request, monkeypatch):
    """Each case on the per-emitter driver and on the scheduled one."""
    monkeypatch.setattr(config, "SCHEDULER", request.param)
    return request.param


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
    _square("mid", 1.5, 0.6, normal=-1, center=(0.4, 0.1)),
    _square("top", 3.0, 1.2, normal=-1),
]

BASE = dict(samples=8, rays=64, seed=4, device="cpu", bvh="off", tol=1e-3)
PARAMS = MatrixParams(**BASE, max_iters=6, min_iters=3, reciprocity=True)


def _workflow_params(pkg=raystrack_tpu_torch, m_max=6, s_max=6):
    return (pkg.MatrixParams(**BASE, max_iters=m_max, min_iters=2, reciprocity=True),
            pkg.SkyParams(**BASE, max_iters=s_max, min_iters=2))


def _crash_on_completion(monkeypatch, module=solver_mod):
    """Make the first emitter that finishes raise before it is assembled:
    a solve killed mid-way, with only its progress snapshots on disk."""
    boom = RuntimeError("killed mid-solve")

    def crash(entry):
        raise boom

    monkeypatch.setattr(module, "_entry_done", crash)
    return boom


# ---------------------------------------------------------------------------
# the cases of tests/test_checkpoint.py, on both drivers
# ---------------------------------------------------------------------------


def test_checkpoint_resume_identical(tmp_path, monkeypatch, route):
    ckpt = str(tmp_path / "ckpt")
    plain = view_factor_matrix(MESHES, params=PARAMS)
    first = view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=ckpt)
    assert first == plain

    lines = []
    monkeypatch.setattr(solver_mod, "_log", lines.append)
    second = view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=ckpt)
    assert second == plain
    # every emitter restored, nothing re-traced
    assert all("restored from checkpoint" in l or "0 iter" in l for l in lines)


def test_checkpoint_partial_resume(tmp_path, monkeypatch, route):
    ckpt = tmp_path / "ckpt"
    full = view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=str(ckpt))
    # simulate a crash that lost the middle emitter's checkpoint
    (ckpt / "emitter_00001.json").unlink()

    lines = []
    monkeypatch.setattr(solver_mod, "_log", lines.append)
    resumed = view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=str(ckpt))
    assert resumed == full
    restored = [l for l in lines if "] restored from checkpoint" in l]
    solved = [l for l in lines if re.search(r"\d+ iter,", l)]
    assert len(restored) == 2 and len(solved) == 1
    assert "[mid]" in solved[0]
    # the final summary notes how many emitters were restored
    assert any(l.startswith("2/3 emitters restored") for l in lines)


def test_checkpoint_invalidated_by_config_change(tmp_path, route):
    ckpt = str(tmp_path / "ckpt")
    view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=ckpt)
    other = MatrixParams(**{**PARAMS.as_dict(), "seed": 99})
    fresh = view_factor_matrix(MESHES, params=other, checkpoint_dir=ckpt)
    plain = view_factor_matrix(MESHES, params=other)
    # stale checkpoints (different fingerprint) are ignored, results correct
    assert fresh == plain


def test_checkpoint_invalidated_by_geometry_change(tmp_path, route):
    """Same names and topology but moved vertices must not reuse stale
    results."""
    ckpt = str(tmp_path / "ckpt")
    view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=ckpt)
    moved = [MESHES[0], MESHES[1], _square("top", 3.0, 3.0, normal=-1)]
    got = view_factor_matrix(moved, params=PARAMS, checkpoint_dir=ckpt)
    plain = view_factor_matrix(moved, params=PARAMS)
    assert got == plain  # re-solved, not restored


def test_checkpoints_written_before_assembly(tmp_path, monkeypatch, route):
    """Each emitter's checkpoint lands on disk the moment it converges, so a
    crash after tracing but before result assembly loses nothing."""
    ckpt = tmp_path / "ckpt"
    # reciprocity off so every emitter traces and _progress_line is reached
    # only in the assembly loop
    params = MatrixParams(**{**PARAMS.as_dict(), "reciprocity": False})
    boom = RuntimeError("simulated crash before assembly")

    def crash(*a, **kw):
        raise boom

    monkeypatch.setattr(solver_mod, "_progress_line", crash)
    with pytest.raises(RuntimeError) as err:
        view_factor_matrix(MESHES, params=params, checkpoint_dir=str(ckpt))
    assert err.value is boom
    files = sorted(f.name for f in ckpt.glob("emitter_*.json"))
    assert files == ["emitter_00000.json", "emitter_00001.json", "emitter_00002.json"]

    monkeypatch.undo()
    monkeypatch.setattr(config, "SCHEDULER", route)
    resumed = view_factor_matrix(MESHES, params=params, checkpoint_dir=str(ckpt))
    assert resumed == view_factor_matrix(MESHES, params=params)


def test_sky_checkpoint_resume(tmp_path, monkeypatch, route):
    sp = SkyParams(**BASE, max_iters=5, min_iters=2)
    ckpt = str(tmp_path / "sky_ckpt")
    plain = view_factor_to_tregenza_sky(MESHES, params=sp)
    first = view_factor_to_tregenza_sky(MESHES, params=sp, checkpoint_dir=ckpt)
    assert first == plain

    lines = []
    monkeypatch.setattr(solver_mod, "_log", lines.append)
    second = view_factor_to_tregenza_sky(MESHES, params=sp, checkpoint_dir=ckpt)
    assert second == plain
    assert all("restored from checkpoint" in l for l in lines)


def test_workflow_checkpoint_resume(tmp_path, monkeypatch, route):
    """The shared-ray workflow resumes per emitter: matrix row, back-fill and
    sky row all restore, and the result matches an uninterrupted run."""
    mp, sp = _workflow_params()
    ckpt = tmp_path / "wf_ckpt"
    plain = view_factor_matrix_and_sky(MESHES, matrix_params=mp, sky_params=sp)
    first = view_factor_matrix_and_sky(
        MESHES, matrix_params=mp, sky_params=sp, checkpoint_dir=str(ckpt))
    assert first == plain

    # simulate a crash that lost the middle emitter's checkpoint
    (ckpt / "emitter_00001.json").unlink()
    lines = []
    monkeypatch.setattr(solver_mod, "_log", lines.append)
    resumed = view_factor_matrix_and_sky(
        MESHES, matrix_params=mp, sky_params=sp, checkpoint_dir=str(ckpt))
    assert resumed == plain
    restored = [l for l in lines if "] restored from checkpoint" in l]
    traced = [l for l in lines if "] traced" in l]
    assert len(restored) == 2 and len(traced) == 1 and "[mid]" in traced[0]
    assert any(l.startswith("2/3 emitters restored") for l in lines)

    # the top-level workflow accepts checkpoint_dir on the shared path
    base3 = view_factor_outside_workflow(MESHES, matrix_params=mp, sky_params=sp)
    got3 = view_factor_outside_workflow(
        MESHES, matrix_params=mp, sky_params=sp, checkpoint_dir=str(ckpt))
    assert got3 == base3


def test_workflow_checkpoint_invalidated_by_sky_change(tmp_path, route):
    """Changing only the sky's convergence setup invalidates workflow
    checkpoints (the fingerprint covers both parameter sets)."""
    mp, sp = _workflow_params()
    ckpt = str(tmp_path / "wf_ckpt")
    view_factor_matrix_and_sky(MESHES, matrix_params=mp, sky_params=sp, checkpoint_dir=ckpt)
    sp2 = SkyParams(**{**sp.as_dict(), "max_iters": 3})
    got = view_factor_matrix_and_sky(MESHES, matrix_params=mp, sky_params=sp2,
                                     checkpoint_dir=ckpt)
    plain = view_factor_matrix_and_sky(MESHES, matrix_params=mp, sky_params=sp2)
    assert got == plain


def test_workflow_fallback_checkpoint_dirs(tmp_path, route):
    """Non-shareable workflow params checkpoint into <dir>/matrix, <dir>/sky."""
    mp = MatrixParams(**{**BASE, "samples": 16}, max_iters=4, min_iters=2)
    sp = SkyParams(**BASE, max_iters=4, min_iters=2)
    ckpt = tmp_path / "wf2"
    base = view_factor_outside_workflow(MESHES, matrix_params=mp, sky_params=sp)
    got = view_factor_outside_workflow(
        MESHES, matrix_params=mp, sky_params=sp, checkpoint_dir=str(ckpt))
    assert got == base
    assert sorted(p.name for p in ckpt.iterdir()) == ["matrix", "sky"]
    resumed = view_factor_outside_workflow(
        MESHES, matrix_params=mp, sky_params=sp, checkpoint_dir=str(ckpt))
    assert resumed == base


def test_mid_emitter_progress_resume(tmp_path, monkeypatch, route):
    """A solve killed while emitters are still converging resumes from the
    per-emitter progress snapshots (exact monitor state, absolute-indexed
    RNG stream) and finishes bit-identical to an uninterrupted solve."""
    ckpt = str(tmp_path / "ckpt")
    plain = view_factor_matrix(MESHES, params=PARAMS)

    monkeypatch.setattr(config, "CHECKPOINT_PROGRESS_S", 0.0)
    real_done = solver_mod._entry_done
    boom = _crash_on_completion(monkeypatch)
    with pytest.raises(RuntimeError) as err:
        view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=ckpt)
    assert err.value is boom
    monkeypatch.setattr(solver_mod, "_entry_done", real_done)
    assert list((tmp_path / "ckpt").glob("*.progress.json")), "no mid-emitter snapshots"

    lines = []
    monkeypatch.setattr(solver_mod, "_log", lines.append)
    resumed = view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=ckpt)
    assert resumed == plain
    assert any("resuming from iteration" in l for l in lines)
    # finished emitters clear their snapshots
    assert not list((tmp_path / "ckpt").glob("*.progress.json"))


def test_mid_emitter_progress_cleared_on_completion(tmp_path, monkeypatch, route):
    monkeypatch.setattr(config, "CHECKPOINT_PROGRESS_S", 0.0)
    ckpt = tmp_path / "ckpt"
    out = view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=str(ckpt))
    assert out == view_factor_matrix(MESHES, params=PARAMS)
    assert not list(ckpt.glob("*.progress.json"))
    assert len(list(ckpt.glob("emitter_*.json"))) == 3


def test_mid_emitter_progress_resume_workflow(tmp_path, monkeypatch, route):
    """The shared-ray workflow resumes mid-emitter with BOTH monitors' state
    (matrix and sky iteration counts may differ at the kill point)."""
    mp, sp = _workflow_params(m_max=8, s_max=4)
    plain = view_factor_matrix_and_sky(MESHES, matrix_params=mp, sky_params=sp)

    ckpt = str(tmp_path / "wf_ckpt")
    monkeypatch.setattr(config, "CHECKPOINT_PROGRESS_S", 0.0)
    real_done = solver_mod._entry_done
    boom = _crash_on_completion(monkeypatch)
    with pytest.raises(RuntimeError) as err:
        view_factor_matrix_and_sky(MESHES, matrix_params=mp, sky_params=sp,
                                   checkpoint_dir=ckpt)
    assert err.value is boom
    monkeypatch.setattr(solver_mod, "_entry_done", real_done)
    assert list((tmp_path / "wf_ckpt").glob("*.progress.json"))

    lines = []
    monkeypatch.setattr(solver_mod, "_log", lines.append)
    resumed = view_factor_matrix_and_sky(MESHES, matrix_params=mp, sky_params=sp,
                                         checkpoint_dir=ckpt)
    assert resumed == plain
    assert any("resuming from iteration" in l for l in lines)


def test_mid_emitter_progress_invalidated_by_config_change(tmp_path, monkeypatch, route):
    """Progress snapshots carry the solve fingerprint: a changed seed must
    not resume from another configuration's mid-solve state."""
    ckpt = str(tmp_path / "ckpt")
    monkeypatch.setattr(config, "CHECKPOINT_PROGRESS_S", 0.0)
    _crash_on_completion(monkeypatch)
    with pytest.raises(RuntimeError):
        view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=ckpt)
    monkeypatch.undo()
    monkeypatch.setattr(config, "SCHEDULER", route)
    assert list((tmp_path / "ckpt").glob("*.progress.json"))

    other = MatrixParams(**{**PARAMS.as_dict(), "seed": 99})
    lines = []
    monkeypatch.setattr(solver_mod, "_log", lines.append)
    got = view_factor_matrix(MESHES, params=other, checkpoint_dir=ckpt)
    assert got == view_factor_matrix(MESHES, params=other)
    assert not any("resuming from iteration" in l for l in lines)


def test_workflow_checkpoint_sky_schema_and_stats(tmp_path, monkeypatch, route):
    """Workflow checkpoints store the sky row under its own ``sky`` key (the
    ``stats`` slot carries stderr rows and a duplicate of the sky row for
    older readers), older checkpoints that parked the sky row inside
    ``stats`` still restore, and ``return_stats=True`` reports one merged
    stderr row per emitter."""
    mp, sp = _workflow_params()
    ckpt = tmp_path / "wf_ckpt"
    vf, sky, stats = view_factor_matrix_and_sky(
        MESHES, matrix_params=mp, sky_params=sp, checkpoint_dir=str(ckpt),
        return_stats=True)

    payload = json.loads((ckpt / "emitter_00000.json").read_text())
    assert payload["sky"] == sky["ground"]
    assert payload["stats"]["sky"] == sky["ground"]
    assert set(payload["stats"]) == set(vf["ground"]) | {"Sky", "sky"}
    assert all(isinstance(v, float) for k, v in payload["stats"].items() if k != "sky")
    for name, _, _ in MESHES:
        traced = set(vf[name]) & set(stats[name])
        assert set(stats[name]) == traced | {"Sky"}
        assert stats[name]["Sky"] >= 0.0

    lines = []
    monkeypatch.setattr(solver_mod, "_log", lines.append)
    vf2, sky2, stats2 = view_factor_matrix_and_sky(
        MESHES, matrix_params=mp, sky_params=sp, checkpoint_dir=str(ckpt),
        return_stats=True)
    assert (vf2, sky2, stats2) == (vf, sky, stats)
    assert all("restored from checkpoint" in l for l in lines)

    # the older layout: sky row parked in the stats slot, no sky key
    for p in sorted(ckpt.glob("emitter_*.json")):
        data = json.loads(p.read_text())
        old = {k: v for k, v in data.items() if k not in ("sky", "stats")}
        old["stats"] = {"sky": data["sky"]}
        p.write_text(json.dumps(old))
    vf3, sky3, stats3 = view_factor_matrix_and_sky(
        MESHES, matrix_params=mp, sky_params=sp, checkpoint_dir=str(ckpt),
        return_stats=True)
    assert (vf3, sky3) == (vf, sky)
    assert all(stats3[name] == {} for name, _, _ in MESHES)


# ---------------------------------------------------------------------------
# beyond tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def test_sky_mid_emitter_progress_resume(tmp_path, monkeypatch, route):
    """The sky resumes mid-emitter from its SkyMonitor snapshots, merged
    and discrete."""
    for discrete in (False, True):
        sp = SkyParams(**BASE, max_iters=6, min_iters=2, discrete=discrete)
        plain = view_factor_to_tregenza_sky(MESHES, params=sp)
        ckpt = str(tmp_path / f"sky_{discrete}")
        monkeypatch.setattr(config, "CHECKPOINT_PROGRESS_S", 0.0)
        real_done = solver_mod._entry_done
        _crash_on_completion(monkeypatch)
        with pytest.raises(RuntimeError):
            view_factor_to_tregenza_sky(MESHES, params=sp, checkpoint_dir=ckpt)
        monkeypatch.setattr(solver_mod, "_entry_done", real_done)
        lines = []
        monkeypatch.setattr(solver_mod, "_log", lines.append)
        assert view_factor_to_tregenza_sky(MESHES, params=sp, checkpoint_dir=ckpt) == plain
        assert any("resuming from iteration" in l for l in lines)


def test_stray_tmp_files_do_not_disturb_a_resume(tmp_path, monkeypatch, route):
    """A writer killed between its tmp write and the rename leaves
    ``*.<pid>.tmp`` files (and may leave a torn file behind): the resume
    ignores them and still equals the uninterrupted solve."""
    ckpt = tmp_path / "ckpt"
    plain = view_factor_matrix(MESHES, params=PARAMS)
    monkeypatch.setattr(config, "CHECKPOINT_PROGRESS_S", 0.0)
    real_done = solver_mod._entry_done
    _crash_on_completion(monkeypatch)
    with pytest.raises(RuntimeError):
        view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=str(ckpt))
    monkeypatch.setattr(solver_mod, "_entry_done", real_done)
    (ckpt / "emitter_00000.99999.tmp").write_text('{"fingerprint": "torn')
    (ckpt / "emitter_00001.progress.99999.tmp").write_text("")
    (ckpt / "emitter_00002.json").write_text('{"fingerprint": ')  # torn publish
    assert view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=str(ckpt)) == plain


def test_progress_hook_writes_nothing_without_a_store(tmp_path, monkeypatch):
    """Without ``checkpoint_dir`` the hooks attach no callback: the solve
    writes no file and equals itself, snapshots at every chunk or not."""
    monkeypatch.chdir(tmp_path)
    plain = view_factor_matrix(MESHES, params=PARAMS)
    monkeypatch.setattr(config, "CHECKPOINT_PROGRESS_S", 0.0)
    assert view_factor_matrix(MESHES, params=PARAMS) == plain
    assert not list(tmp_path.iterdir())
    entry = {"_finished": False}
    solver_mod._entry_progress(entry)  # no on_progress: a no-op
    assert entry == {"_finished": False}


def test_progress_hook_never_fires_after_completion(monkeypatch):
    monkeypatch.setattr(config, "CHECKPOINT_PROGRESS_S", 0.0)
    calls = []
    entry = {"on_progress": calls.append, "_finished": True}
    solver_mod._entry_progress(entry)
    assert calls == []
    entry["_finished"] = False
    solver_mod._entry_progress(entry)
    assert calls == [entry]
    monkeypatch.setattr(config, "CHECKPOINT_PROGRESS_S", -1.0)
    solver_mod._entry_progress(entry)
    assert calls == [entry]


def test_row_sink_streams_converged_rows(tmp_path, route):
    """``row_sink`` receives every traced row once; paired with the stream
    writer it produces a file equal to saving the returned dict
    (``tests/test_solver.py``'s case)."""
    from raystrack_tpu_torch import (
        VFMatrixStreamWriter, load_vf_matrix_json, save_vf_matrix_json,
    )

    params = MatrixParams(**BASE, max_iters=6, min_iters=3, reciprocity=False)
    sunk = {}
    with VFMatrixStreamWriter(str(tmp_path / "stream")) as w:
        def sink(name, row):
            assert name not in sunk
            sunk[name] = row
            w.write_row(name, row)

        vf = view_factor_matrix(MESHES, params=params, row_sink=sink)
    assert sunk == {k: v for k, v in vf.items() if v}
    ref = save_vf_matrix_json(vf, str(tmp_path / "ref"))
    assert load_vf_matrix_json(str(tmp_path / "stream.json")) == load_vf_matrix_json(ref)


def test_row_sink_complete_rows_under_reciprocity(tmp_path, route):
    """With reciprocity the sink streams rows in emitter order, each carrying
    its transpose back-fill: streamed output == returned matrix."""
    from raystrack_tpu_torch import (
        VFMatrixStreamWriter, load_vf_matrix_json, save_vf_matrix_json,
    )

    order = []
    with VFMatrixStreamWriter(str(tmp_path / "stream")) as w:
        def sink(name, row):
            order.append(name)
            w.write_row(name, row)

        vf = view_factor_matrix(MESHES, params=PARAMS, row_sink=sink)
    assert order == ["ground", "mid", "top"]
    assert vf["top"]  # back-fill only, must still stream non-empty
    ref = save_vf_matrix_json(vf, str(tmp_path / "ref"))
    assert load_vf_matrix_json(str(tmp_path / "stream.json")) == load_vf_matrix_json(ref)


def test_row_sink_reciprocity_resume_streams_new_rows(tmp_path, route):
    """A resumed reciprocity solve sinks every row, each complete: the
    re-traced ``top`` and the restored ``ground`` and ``mid`` too. (This is
    where the port leaves the JAX rule, under which only ``top`` streams:
    the port's sink, ``VFMatrixStreamWriter``, publishes on close, so the
    rows a stopped solve streamed do not outlive it.)"""
    ckpt = tmp_path / "ckpt"
    full = view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=str(ckpt))
    sorted(ckpt.glob("emitter_*.json"))[-1].unlink()
    sunk = {}
    resumed = view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=str(ckpt),
                                 row_sink=lambda n, r: sunk.setdefault(n, r))
    assert resumed == full
    assert list(sunk) == ["ground", "mid", "top"]
    assert sunk == full


@pytest.mark.parametrize("reciprocity", [True, False])
def test_row_sink_resume_after_finished_emitters(tmp_path, monkeypatch, route, reciprocity):
    """A solve stopped once emitter 0 has finished and streamed its row,
    before the writer published the stream, then resumed into a new
    writer: the resumed stream holds every row, == the plain dict."""
    from raystrack_tpu_torch import VFMatrixStreamWriter, load_vf_matrix_json

    # a step under ``mid`` gives emitter 1 a receiver under reciprocity too,
    # so a second emitter finishes after emitter 0
    meshes = MESHES + [_square("step", 0.5, 0.3, normal=+1, center=(0.4, 0.1))]
    params = MatrixParams(**BASE, max_iters=6, min_iters=3, reciprocity=reciprocity)
    plain = view_factor_matrix(meshes, params=params)
    ckpt, stream = tmp_path / "ckpt", tmp_path / "stream.json"
    monkeypatch.setattr(config, "CHECKPOINT_PROGRESS_S", 0.0)
    real_done, finished, sunk = solver_mod._entry_done, [], []

    def stop_after_emitter_0(entry):
        if 0 in finished:
            raise RuntimeError("killed mid-solve")
        real_done(entry)
        finished.append(entry["idx"])

    monkeypatch.setattr(solver_mod, "_entry_done", stop_after_emitter_0)
    with pytest.raises(RuntimeError):
        with VFMatrixStreamWriter(str(stream)) as w:
            view_factor_matrix(meshes, params=params, checkpoint_dir=str(ckpt),
                               row_sink=lambda n, r: (sunk.append(n), w.write_row(n, r)))
    monkeypatch.setattr(solver_mod, "_entry_done", real_done)
    assert "ground" in sunk and (ckpt / "emitter_00000.json").exists()
    assert not stream.exists() and list(ckpt.glob("*.progress.json"))
    with VFMatrixStreamWriter(str(stream)) as w:
        resumed = view_factor_matrix(meshes, params=params, checkpoint_dir=str(ckpt),
                                     row_sink=w.write_row)
    assert resumed == plain
    assert load_vf_matrix_json(str(stream)) == {k: v for k, v in plain.items() if v}


def test_row_sink_resume_streams_rows_never_streamed(tmp_path, monkeypatch, route):
    """A solve killed before any emitter finished streamed no row, though
    it checkpointed the last emitter (no receivers under reciprocity) in
    its set-up. The resume streams every row, that one too: its row is the
    others' back-fill, complete only now. (The JAX package does not re-sink
    any restored row, and would drop it.)"""
    from raystrack_tpu_torch import VFMatrixStreamWriter, load_vf_matrix_json

    ckpt = tmp_path / "ckpt"
    plain = view_factor_matrix(MESHES, params=PARAMS)
    monkeypatch.setattr(config, "CHECKPOINT_PROGRESS_S", 0.0)
    real_done = solver_mod._entry_done
    _crash_on_completion(monkeypatch)
    sunk = []
    with pytest.raises(RuntimeError):
        view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=str(ckpt),
                           row_sink=lambda n, r: sunk.append(n))
    monkeypatch.setattr(solver_mod, "_entry_done", real_done)
    assert sunk == [] and (ckpt / "emitter_00002.json").exists()
    with VFMatrixStreamWriter(str(tmp_path / "stream")) as w:
        resumed = view_factor_matrix(MESHES, params=PARAMS, checkpoint_dir=str(ckpt),
                                     row_sink=w.write_row)
    assert resumed == plain
    assert load_vf_matrix_json(str(tmp_path / "stream.json")) == plain


def test_profile_hook(tmp_path, monkeypatch):
    """``RAYSTRACK_TPU_PROFILE=<dir>`` writes a Chrome trace of the solve
    holding its ``matrix_solve`` span; unset, the hook is a null context."""
    monkeypatch.delenv("RAYSTRACK_TPU_PROFILE", raising=False)
    hook = solver_mod._maybe_profiler()
    with hook("matrix_solve") as ctx:
        assert ctx is None
    plain = view_factor_matrix(MESHES, params=PARAMS)
    trace_dir = tmp_path / "prof"
    monkeypatch.setenv("RAYSTRACK_TPU_PROFILE", str(trace_dir))
    assert view_factor_matrix(MESHES, params=PARAMS) == plain
    traces = list(trace_dir.glob("matrix_solve.*.json"))
    assert len(traces) >= 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "matrix_solve" for e in events)


# ---------------------------------------------------------------------------
# one checkpoint format for both packages
# ---------------------------------------------------------------------------


def _jax_quiet(monkeypatch):
    monkeypatch.setattr(jsolver, "_log", lambda line: None)


SOLVES = {
    "matrix": (
        lambda pkg, ckpt: pkg.view_factor_matrix(MESHES, params=pkg.MatrixParams(
            **PARAMS.as_dict()), checkpoint_dir=ckpt)),
    "sky": (
        lambda pkg, ckpt: pkg.view_factor_to_tregenza_sky(MESHES, params=pkg.SkyParams(
            **BASE, max_iters=5, min_iters=2, discrete=True), checkpoint_dir=ckpt)),
    "workflow": (
        lambda pkg, ckpt: pkg.view_factor_matrix_and_sky(
            MESHES, **dict(zip(("matrix_params", "sky_params"), _workflow_params(pkg))),
            checkpoint_dir=ckpt)),
}


@pytest.mark.parametrize("kind", sorted(SOLVES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_dir_restored_whole_by_the_other_package(tmp_path, monkeypatch, kind,
                                                            writer):
    """A directory one package writes on the CPU is restored whole by the
    other: every emitter restored, nothing traced, and exactly the rows the
    writer returned."""
    _jax_quiet(monkeypatch)
    solve = SOLVES[kind]
    pkgs = {"jax": raystrack_tpu, "port": raystrack_tpu_torch}
    reader = "port" if writer == "jax" else "jax"
    ckpt = str(tmp_path / "ckpt")
    written = solve(pkgs[writer], ckpt)
    lines = []
    monkeypatch.setattr(solver_mod if reader == "port" else jsolver, "_log", lines.append)
    restored = solve(pkgs[reader], ckpt)
    assert restored == written
    assert lines and all("restored from checkpoint" in l for l in lines)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_progress_snapshots_resumed_by_the_other_package(tmp_path, monkeypatch, writer):
    """Progress snapshots cross too: the reader resumes each emitter at the
    snapshot's iteration with the writer's exact monitor state, and its
    result equals its own uninterrupted solve within the port's parity
    tolerance."""
    _jax_quiet(monkeypatch)
    pkgs = {"jax": (raystrack_tpu, jsolver, raystrack_tpu.config),
            "port": (raystrack_tpu_torch, solver_mod, config)}
    reader = "port" if writer == "jax" else "jax"
    w_pkg, w_solver, w_cfg = pkgs[writer]
    r_pkg, r_solver, _ = pkgs[reader]
    params = dict(PARAMS.as_dict(), max_iters=8, min_iters=2)
    ckpt = tmp_path / "ckpt"
    monkeypatch.setattr(w_cfg, "CHECKPOINT_PROGRESS_S", 0.0)
    _crash_on_completion(monkeypatch, w_solver)
    with pytest.raises(RuntimeError):
        w_pkg.view_factor_matrix(MESHES, params=w_pkg.MatrixParams(**params),
                                 checkpoint_dir=str(ckpt))
    monkeypatch.undo()
    _jax_quiet(monkeypatch)
    snaps = {int(p.name[8:13]): json.loads(p.read_text())
             for p in ckpt.glob("*.progress.json")}
    assert snaps
    loaded = []
    real_load = r_solver.MatrixMonitor.load_state

    def spy(self, state):
        real_load(self, state)
        loaded.append(self.state_dict())

    monkeypatch.setattr(r_solver.MatrixMonitor, "load_state", spy)
    lines = []
    monkeypatch.setattr(r_solver, "_log", lines.append)
    got = r_pkg.view_factor_matrix(MESHES, params=r_pkg.MatrixParams(**params),
                                   checkpoint_dir=str(ckpt))
    monkeypatch.setattr(r_solver, "_log", lambda line: None)
    want = r_pkg.view_factor_matrix(MESHES, params=r_pkg.MatrixParams(**params))
    assert sorted(json.dumps(s, sort_keys=True) for s in loaded) == sorted(
        json.dumps(s["monitor"], sort_keys=True) for s in snaps.values())
    resumed = {int(m.group(1)) - 1: int(m.group(2)) for m in
               (re.search(r"\((\d+)/3\) \[\w+\] resuming from iteration (\d+)", l)
                for l in lines) if m}
    assert resumed == {i: s["monitor"]["iters_done"] for i, s in snaps.items()}
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name])
        for key, value in want[name].items():
            assert abs(got[name][key] - value) <= 1e-4, (name, key)


def test_store_fingerprints_equal_across_packages(tmp_path):
    mp, sp = _workflow_params()
    jmp, jsp = _workflow_params(raystrack_tpu)
    assert mp.as_dict() == jmp.as_dict() and sp.as_dict() == jsp.as_dict()
    for params in (mp.as_dict(), {**{f"m.{k}": v for k, v in mp.as_dict().items()},
                                  **{f"s.{k}": v for k, v in sp.as_dict().items()}}):
        port = solver_mod._CheckpointStore(str(tmp_path / "a"), params, MESHES)
        jax_ = jsolver._CheckpointStore(str(tmp_path / "b"), params, MESHES)
        assert port.fingerprint == jax_.fingerprint


@pytest.mark.parametrize("kind", ["matrix", "sky_merged", "sky_discrete"])
def test_monitor_state_equals_the_jax_package_and_round_trips(kind):
    """After the same seeded counts both packages' monitors hold the same
    ``state_dict``; through JSON it loads back ``==`` (float64 Welford state
    round-trips exactly), and the loaded monitor then continues exactly as
    the original."""
    rng = np.random.default_rng(5)
    n_surf, recv = 4, np.array([1, 3])
    kw = dict(n_rays_once=512, tol=1e-9, tol_mode="stderr", min_iters=2, interval=1,
              max_iters=50)

    def make(mod):
        if kind == "matrix":
            return mod.MatrixMonitor(n_surf, recv, **kw)
        return mod.SkyMonitor(discrete=kind == "sky_discrete", **kw)

    def counts():
        if kind == "matrix":
            return (rng.integers(0, 200, n_surf), rng.integers(0, 50, n_surf))
        if kind == "sky_discrete":
            return (rng.integers(0, 4, 145),)
        return (int(rng.integers(0, 512)),)

    port, jax_ = make(tconv), make(jconv)
    steps = [counts() for _ in range(7)]
    for c in steps:
        port.consume_iteration(*c)
        jax_.consume_iteration(*c)
    state = port.state_dict()
    assert state == jax_.state_dict()
    again = make(tconv)
    again.load_state(json.loads(json.dumps(state)))
    assert again.state_dict() == state
    for c in [counts() for _ in range(3)]:
        port.consume_iteration(*c)
        again.consume_iteration(*c)
    assert again.state_dict() == port.state_dict()
