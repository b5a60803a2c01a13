"""The port's headline benchmark (``bench_torch.py``) against the JAX
package's ``bench.py``, on the CPU at small sizes:

- the scene builders: ``soup_meshes`` and ``district_meshes`` bitwise
  ``bench._bench_soup`` and ``bench._district``; the city is the one shared
  copy, ``city_100m_torch.city_meshes``;
- ``run_chunk`` on a small city (``city_meshes(2_000, extent=20)``) and a
  small soup (4,096 triangles), brute and accel packs, against
  ``bench._run_chunk`` run as the JAX tests run Pallas on the CPU
  (``trace_chunk(..., interpret=True)``): per surface and iteration at most
  max(2, 0.001 n_rays) flipped rays (torch's and XLA's sin/cos differ by
  ulps); these scenes give exact equality;
- the honesty checks: brute == gated hit counts with the gate pruning
  (sweep tiles of 128), a gated run that changes a count raises, and the
  calibrated checksum round trip (``--calibrate`` writes it, the next run
  holds the gated counts to it, a wrong one raises);
- the calibration file: keyed by the card's name, read from
  ``bench_expected_torch.json`` only, never ``bench_expected.json``;
- ``main``: without a card it exits 2 and names the card; a stage that
  raises makes it exit 1 after the enriched line, a skipped stage is a note;
- an import guard: ``bench_torch`` and ``head_to_head_torch`` load nothing
  of JAX, of the JAX package or of ``bench.py``.
"""
import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import raystrack_tpu.ops.trace as jtrace
from raystrack_tpu.prepared import PreparedSolver as JPreparedSolver

import raystrack_tpu_torch.ops.trace as ttrace
from raystrack_tpu_torch import PreparedSolver

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench_torch  # noqa: E402
import city_100m_torch  # noqa: E402

_spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)

CPU = torch.device("cpu")
CITY = dict(n_tri=2_000, extent=20.0)  # a 40 x 40 ground: 3,200 rays an iteration at rays=2
SCENES = {"city": lambda: bench_torch.city_meshes(CITY["n_tri"], CITY["extent"]),
          "soup": lambda: bench_torch.soup_meshes(4096)}
CARD_NAME = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def _same_meshes(got, want):
    assert [m[0] for m in got] == [m[0] for m in want]
    for (_, gv, gf), (_, wv, wf) in zip(got, want):
        assert gv.dtype == wv.dtype == np.float32 and gf.dtype == wf.dtype == np.int32
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gf, wf)


# ---------------------------------------------------------------------------
# the scene builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["soup", "district"])
def test_builders_equal_bench_bitwise(name):
    got, want = {"soup": (bench_torch.soup_meshes, bench._bench_soup),
                 "district": (bench_torch.district_meshes, bench._district)}[name]
    _same_meshes(got(), want())
    if name == "soup":
        assert sum(F.shape[0] for _, _, F in got()) == bench.N_TRI == bench_torch.N_TRI
    else:
        assert len(got()) == 97


def test_city_is_the_shared_copy():
    """bench_torch takes the city from ``city_100m_torch`` (no third copy),
    and it is ``bench._city`` at the calibrated size's scale-down."""
    assert bench_torch.city_meshes is city_100m_torch.city_meshes
    _same_meshes(bench_torch.city_meshes(CITY["n_tri"], CITY["extent"]),
                 bench._city(CITY["n_tri"], CITY["extent"]))


# ---------------------------------------------------------------------------
# run_chunk against bench._run_chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accel", [False, True], ids=["brute", "accel"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_run_chunk_matches_bench_run_chunk(monkeypatch, scene, accel):
    monkeypatch.setattr(bench, "trace_chunk",
                        functools.partial(jtrace.trace_chunk, interpret=True))
    meshes = SCENES[scene]()
    kw = dict(accel=accel, seed=3, chunk=2, samples=1, rays=2 if scene == "city" else 8)
    out, em, sc = bench_torch.run_chunk(PreparedSolver(meshes), CPU, **kw)
    jout, jem, jsc = bench._run_chunk(JPreparedSolver(meshes), **kw)
    assert (em.n_rays_pad, em.n_rays_once, sc.n_tri_pad) == (
        jem.n_rays_pad, jem.n_rays_once, jsc.n_tri_pad)
    tol = max(2, int(0.001 * em.n_rays_once))
    for key in ("counts_f", "counts_b"):
        got, want = out[key].numpy(), np.asarray(jout[key])
        assert got.shape == want.shape == (2, len(meshes)), key
        assert int(np.abs(got - want).max()) <= tol, (key, got, want)
    assert bench_torch.force(out) == bench._force(jout)
    assert int(out["counts_f"].sum() + out["counts_b"].sum()) > 100


def test_headline_at_a_small_size():
    """The headline's accounting: tests = CHUNK x padded rays x padded
    triangles over the best dispatch."""
    tests_per_sec, rays_per_sec, n_tri_pad, em, times = bench_torch.headline(
        CPU, n_tri=4096, rays=2, reps=2)
    best = min(times)
    assert n_tri_pad == 4096 and em.n_rays_pad == 2048 and len(times) == 2 and best > 0
    assert tests_per_sec == pytest.approx(bench_torch.CHUNK * 2048 * 4096 / best)
    assert rays_per_sec == pytest.approx(bench_torch.CHUNK * 2048 / best)


# ---------------------------------------------------------------------------
# the honesty checks
# ---------------------------------------------------------------------------


@pytest.fixture
def pruning_gate(monkeypatch):
    """Sweep tiles of 128, so the small city's 2,048 padded triangles are 16
    tiles and the gate prunes; yields the calls of the gate's ray sort."""
    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 128)
    calls = []
    real = ttrace._sorted_for_gate
    monkeypatch.setattr(ttrace, "_sorted_for_gate",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_city_point_brute_equals_gated_with_the_gate_pruning(pruning_gate):
    entry = bench_torch.city_point(CITY["n_tri"], CPU, calibrate=False, expected={},
                                   extent=CITY["extent"])
    assert len(pruning_gate) == 4  # the gated mode's warm-up and 3 timed runs
    assert {"accel", "brute", "speedup", "hits", "hits_back", "rays_per_dispatch",
            "valid_rays_per_dispatch"} <= set(entry)
    assert "brute_anchor" not in entry
    assert entry["rays_per_dispatch"] == 2 * 4096 and entry["valid_rays_per_dispatch"] == 6400
    assert entry["hits_back"] > 1000


def test_city_point_raises_when_the_gate_changes_a_count(monkeypatch):
    real = bench_torch.run_chunk

    def off_by_one(ps, dev, *, accel, **kw):
        out, em, sc = real(ps, dev, accel=accel, **kw)
        if accel:
            out["counts_b"] = out["counts_b"] + torch.eye(*out["counts_b"].shape,
                                                          dtype=torch.int32)
        return out, em, sc

    monkeypatch.setattr(bench_torch, "run_chunk", off_by_one)
    with pytest.raises(RuntimeError, match="acceleration changed the hit counts"):
        bench_torch.city_point(CITY["n_tri"], CPU, calibrate=False, expected={},
                               extent=CITY["extent"])


def test_calibration_round_trip(monkeypatch, tmp_path, capsys):
    """``--calibrate`` at the calibrated size (lowered to the small city)
    writes the gated checksum under the card's name from a live brute run;
    the next run holds the gated counts to it and takes its brute rate; a
    wrong calibration raises."""
    monkeypatch.setattr(bench_torch, "CALIBRATED_TRIS", CITY["n_tri"])
    monkeypatch.setattr(bench_torch, "device_name", lambda dev: CARD_NAME)
    path = tmp_path / "bench_expected_torch.json"
    path.write_text(json.dumps({"Another_Card": {"2000": {"hits": 1}}}))
    budget = bench_torch.Budget(1e9)
    curve = functools.partial(bench_torch.city_curve, CPU, budget, sizes=(CITY["n_tri"],),
                              extent=CITY["extent"], expected_path=path)
    live = curve(calibrate=True)["2000"]
    saved = json.loads(path.read_text())
    assert saved["Another_Card"] == {"2000": {"hits": 1}}
    cal = saved["NVIDIA_H100_80GB_HBM3"]["2000"]
    assert cal == {"hits": live["hits"], "hits_back": live["hits_back"],
                   "brute_rays_per_sec": live["brute"]}
    assert "calibration written to bench_expected_torch.json" in capsys.readouterr().out

    held = curve()["2000"]
    assert held["brute_anchor"] == "calibrated" and held["brute"] == cal["brute_rays_per_sec"]
    assert (held["hits"], held["hits_back"]) == (cal["hits"], cal["hits_back"])

    saved["NVIDIA_H100_80GB_HBM3"]["2000"]["hits_back"] += 1
    path.write_text(json.dumps(saved))
    with pytest.raises(RuntimeError, match="calibrated"):
        curve()


def test_city_curve_skips_a_point_past_the_budget(capsys):
    assert bench_torch.city_curve(CPU, bench_torch.Budget(0.0)) is None
    out = capsys.readouterr().out
    assert "city[10000000] skipped" in out and "city[10000] skipped" in out


def test_expected_file_is_keyed_by_the_card_and_never_bench_expected(monkeypatch):
    """The committed calibration is read from ``bench_expected_torch.json``
    under the card's name (spaces as underscores), with its hits, back hits
    and brute rate at 1e7; ``bench_expected.json`` (the TPU's) is never
    read, nor named in the script."""
    assert bench_torch.EXPECTED_PATH == ROOT / "bench_expected_torch.json"
    monkeypatch.setattr(bench_torch, "device_name", lambda dev: CARD_NAME)
    reads = []
    real = Path.read_text
    monkeypatch.setattr(Path, "read_text",
                        lambda self, *a, **k: reads.append(self.name) or real(self, *a, **k))
    expected = bench_torch.load_expected()
    key = bench_torch.platform_key(CPU)
    assert key == "NVIDIA_H100_80GB_HBM3"
    assert set(expected[key]) == {str(bench_torch.CALIBRATED_TRIS)}
    cal = expected[key][str(bench_torch.CALIBRATED_TRIS)]
    assert set(cal) == {"hits", "hits_back", "brute_rays_per_sec"}
    assert all(isinstance(v, int) and v > 0 for v in cal.values())
    assert "TPU_v5_lite" not in expected
    assert reads == ["bench_expected_torch.json"]
    assert "bench_expected.json" not in (ROOT / "bench_torch.py").read_text()
    monkeypatch.undo()
    assert bench_torch.platform_key(CPU) == "cpu"


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def test_main_without_a_card_exits_nonzero_and_names_it(capsys):
    assert not torch.cuda.is_available()
    assert bench_torch.main([]) == 2
    out, err = capsys.readouterr()
    assert "needs a CUDA card" in err and out == ""


def _boom(*args, **kwargs):
    raise RuntimeError("a kernel failed to launch")


@pytest.mark.parametrize("case", ["none", "district", "city curve", "canyon+plates", "budget"])
def test_main_stages(monkeypatch, capsys, case):
    """``main`` with the card and the stages faked: the headline line first;
    the enriched line reprinted after every stage, the last one with every
    field; a stage that raises is noted (its field None) and main exits 1
    after the enriched line; a stage skipped for lack of budget is a note
    and main exits 0."""
    monkeypatch.setattr(bench_torch, "card_device", lambda: CPU)
    monkeypatch.setattr(bench_torch, "card_line", lambda: "Fake Card, 1.00 W")
    monkeypatch.setattr(bench_torch, "headline", lambda dev: (
        2.5e9, 1.0e5, 4096, SimpleNamespace(n_rays_pad=512), [0.01, 0.02]))
    fakes = {"district": ("district_solve", lambda dev: 0.091),
             "city curve": ("city_curve", lambda dev, budget, calibrate=False: {
                 "10000": {"accel": 5, "brute": 1, "speedup": 5.0}}),
             "canyon+plates": ("canyon_and_plates", lambda dev: (0.125, 5.692e-5))}
    for stage, (name, fn) in fakes.items():
        monkeypatch.setattr(bench_torch, name, _boom if stage == case else fn)
    if case == "budget":
        monkeypatch.setenv(bench_torch.BUDGET_VAR, "0")
    rc = bench_torch.main([])
    out, err = capsys.readouterr()
    lines = out.splitlines()
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    assert json.loads(lines[0]) == rows[0]  # the headline is the first line
    assert rows[0] == {"metric": "ray_triangle_tests_per_sec", "value": 2500000000,
                       "unit": "tests/s", "vs_baseline": 2.5, "rays_per_sec": 100000,
                       "n_tri": 4096, "rays_per_dispatch": 2048, "device": "Fake Card, 1.00 W"}
    assert len(rows) == 4 and json.loads(lines[-1]) == rows[-1]
    last = rows[-1]
    fields = {"district": last["district_97_emitters_solve_s"],
              "city curve": last["occluded_city_rays_per_sec"],
              "canyon+plates": last["canyon_solve_s"]}
    assert set(last["launches"]) == {"headline"} | (set() if case == "budget" else set(fakes))
    if case == "none":
        assert rc == 0 and "failed" not in last
        assert fields == {"district": 0.091, "city curve": {"10000": {
            "accel": 5, "brute": 1, "speedup": 5.0}}, "canyon+plates": 0.125}
        assert last["parallel_plates_abs_err"] == 5.692e-5
    elif case == "budget":
        assert rc == 0 and set(fields.values()) == {None}
        assert all(f"# {stage} skipped" in out for stage in fakes)
    else:
        assert rc == 1 and last["failed"] == [case] and fields[case] is None
        assert all(v is not None for k, v in fields.items() if k != case)
        assert f"# {case} failed: RuntimeError: a kernel failed to launch" in out
        assert "Traceback" in err and f"stages failed: {case}" in err


# ---------------------------------------------------------------------------
# the import guard
# ---------------------------------------------------------------------------


GUARD = """
import sys, torch
sys.path.insert(0, {root!r})
import bench_torch, head_to_head_torch
from raystrack_tpu_torch import PreparedSolver
out, _, _ = bench_torch.run_chunk(PreparedSolver(bench_torch.city_meshes(200, 10.0)),
                                  torch.device("cpu"), accel=True, seed=0, chunk=1,
                                  samples=1, rays=1)
assert int(out["counts_b"].sum()) > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "raystrack_tpu", "bench"))
print("FOREIGN", bad)
"""


def test_the_scripts_import_nothing_of_jax():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", GUARD.format(root=str(ROOT))], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout.splitlines(), out.stdout
