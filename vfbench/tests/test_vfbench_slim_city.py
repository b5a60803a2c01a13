"""The slim city cell, ``slim_city_buildings``, whole on the CPU at a small
size: its scene packs slim and its sweeps take the two-level gate, the
program agrees with the reference and the bfloat16 control does not, a run
is correct unbroken and not correct with each fault of
``test_vfbench_faults.py``; and the readers of the gate's walk on synthetic
counters.

At 12,002 triangles the city pads to 12,032 (47 sweep tiles of 256), far
below ``SLIM_PACK_MIN_TRIS``, so the test lowers that threshold to 1 and
``GATE_MAX_TILES`` to 24: groups of 2 tiles a box over 24 boxes, the last
one real tile and a phantom, as the cell's 14,649 tiles take on the card
(groups of 2 over 7,325 boxes). No knob is added: both are the program's
module constants, read when the scene is packed and the sweep gated.

    python -m pytest vfbench/tests -q
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from test_vfbench_faults import altered, half, stale  # noqa: E402

from vfbench import harness  # noqa: E402

CELL = "slim_city_buildings"
N_TRI = 12_002
FIELDS = dict(rays=8, min_iters=2, max_iters=2)  # 16 cells x 8 rays x 2 iterations a building
TILES, MAX_TILES = 47, 24
SEED = 2147483777


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def slim(monkeypatch):
    """The program packs the small city slim and gates it in groups of 2."""
    from raystrack_tpu_torch import config

    monkeypatch.setattr(config, "SLIM_PACK_MIN_TRIS", 1)
    monkeypatch.setattr(config, "GATE_MAX_TILES", MAX_TILES)


def small_cell():
    cell = harness.Cell.load(CELL)
    cell.config = {**cell.config, "triangles": N_TRI}
    cell.traffic = {**cell.traffic, "matrix": {**cell.traffic["matrix"], **FIELDS}}
    return cell


def test_the_scene_packs_slim_and_the_solve_takes_the_two_level_gate(slim, monkeypatch):
    """The pack is slim; every sweep of a solve is in code mode and gated
    in groups of 2 tiles a box, with no early-exit window."""
    import raystrack_tpu_torch as rt
    from raystrack_tpu_torch.ops import trace_cuda

    cell = small_cell()
    meshes = cell.meshes(SEED)
    assert [m[0] for m in meshes] == [f"bld_{k}" for k in range(10)] + ["city"]
    assert sum(m[2].shape[0] for m in meshes) == 12 * ((N_TRI - 2) // 12) + 2
    pack = rt.PreparedSolver(meshes).get_scene_pack(use_accel=True, device=torch.device("cpu"))
    assert pack.slim and pack.n_tri_pad // trace_cuda.sweep_tile_width(pack.n_tri_pad,
                                                                      2048) == TILES
    assert trace_cuda.gate_group_size(TILES) == 2 and trace_cuda._resolve_gate_window(2) == 0

    gates, modes = [], []
    gate_for, reference = trace_cuda._gate_for, trace_cuda.sweep_rays_reference

    def spy_gate(*args, **kwargs):
        gate = gate_for(*args, **kwargs)
        gates.append(None if gate is None else (gate.group, gate.window, gate.boxes.shape[0]))
        return gate

    def spy_sweep(*args, **kwargs):
        modes.append(kwargs.get("code_bounds") is not None)
        return reference(*args, **kwargs)

    monkeypatch.setattr(trace_cuda, "_gate_for", spy_gate)
    monkeypatch.setattr(trace_cuda, "sweep_rays_reference", spy_sweep)
    harness.program_solver(cell.traffic, meshes, "cpu")(harness.solve_seed(7, 1))
    assert gates and set(gates) == {(2, 0, MAX_TILES)}
    assert modes and all(modes) and len(modes) == len(gates)


# The buildings, 5 m apart, see each other, so reciprocity derives entries
# of up to about 0.2: F(j -> i)_front = F(i -> j)_front A_i / A_j. Both
# sides take each emitter's area as a float32 sum, in different orders, so
# a derived entry may differ by a few float32 ulps of its value (measured:
# 1.6e-8 on 0.2019, 1.2e-8 on 0.0865); a ray weighs 1 / 512 here.
DERIVED_REL = 2.0 ** -20


def assert_agrees(got, want, names):
    """Every entry a row traces within 1e-9 of the reference, every entry
    reciprocity derives (receiver listed before the emitter) within 1e-9
    plus ``DERIVED_REL`` of its value."""
    assert set(got) == set(want)
    for row in want:
        i = names.index(row)
        for key in set(got[row]) | set(want[row]):
            a, b = float(got[row].get(key, 0.0)), float(want[row].get(key, 0.0))
            derived = names.index(key.rsplit("_", 1)[0]) < i
            assert abs(a - b) <= 1e-9 + (DERIVED_REL * abs(b) if derived else 0.0), (row, key)


def test_reference_agrees_with_the_port_and_the_control_fails(slim):
    cell = small_cell()
    meshes = cell.meshes(2147483901)
    names = [m[0] for m in meshes]
    solve = harness.program_solver(cell.traffic, meshes, "cpu")
    limit = float(cell.limits["gap"])
    for qmc in (harness.solve_seed(7, 1), harness.solve_seed(7, 2)):
        got = solve(qmc)
        want = harness.reference_solve(cell.traffic, meshes, qmc, "cpu")
        assert list(got) == names
        assert_agrees(got, want, names)
        control = harness.reference_solve(cell.traffic, meshes, qmc, "cpu", torch.bfloat16)
        assert harness.widest_gap(control, want) > limit
        run = harness.Run(cell=cell, seed=7, walls=[0.0])  # as control.py judges it
        harness.check(run, meshes, [control], [qmc], "cpu")
        assert run.checks["gap"]["value"] > limit and not run.correct


def run_small():
    return harness.measure(small_cell(), SEED, 0.01, trace=False,
                           t_start=time.perf_counter(), device="cpu")


def test_unbroken_run_is_correct(slim):
    """Correct, and its widest gap no more than the derived entries'
    rounding (:data:`DERIVED_REL` of an entry of at most 1)."""
    run = run_small()
    assert run.failed == 0 and run.checks["gap"]["value"] <= DERIVED_REL and run.correct


@pytest.mark.parametrize("fault", [stale, half, altered], ids=lambda f: f.__name__)
def test_broken_run_is_not_correct(slim, fault, monkeypatch):
    from raystrack_tpu_torch.ops import trace as trace_mod

    fault(trace_mod, monkeypatch)
    run = run_small()
    assert not run.correct, run.checks


# The readers of the gate's walk.

READERS = ("gate_walk_share", "gate_mboxes_per_solve")


def _read(name, run):
    return harness._module(harness.HERE / "metrics" / f"{name}.py").read(run)


def _run(trace):
    return harness.Run(cell=None, seed=0, trace=trace)


def _trace(solves=4):
    from vfbench.tracing import Trace

    return Trace(window_s=1.0, device=[], host=[], solves=solves)


@pytest.mark.parametrize("listed,walked,share,mboxes", [
    (8_000_000, 8_000_000, 100.0, 2.0),  # the two-level gate: no window
    (8_000_000, 6_000_000, 75.0, 1.5),  # windows stopped a quarter of the walk
])
def test_readers_read_synthetic_counters(monkeypatch, listed, walked, share, mboxes):
    from raystrack_tpu_torch import tracing

    monkeypatch.setattr(tracing, "counts", lambda: {"boxes_listed": listed,
                                                    "boxes_walked": walked})
    assert _read("gate_walk_share", _run(_trace())) == pytest.approx(share, rel=1e-12)
    assert _read("gate_mboxes_per_solve", _run(_trace())) == pytest.approx(mboxes, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_a_trace_or_a_listed_box(name, monkeypatch):
    from raystrack_tpu_torch import tracing

    monkeypatch.setattr(tracing, "counts", lambda: {"boxes_listed": 5, "boxes_walked": 5})
    assert _read(name, _run(None)) is None
    monkeypatch.setattr(tracing, "counts", lambda: {"boxes_listed": 0, "boxes_walked": 0})
    assert _read(name, _run(_trace())) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_on_a_program_without_the_counters(name, monkeypatch):
    """The parent of the gate's counters counts tiles and pairs but no
    boxes; a program without tracing has no module to import."""
    import raystrack_tpu_torch
    from raystrack_tpu_torch import tracing

    monkeypatch.setattr(tracing, "counts", lambda: {"tiles_swept": 3, "pairs_tested": 9})
    assert _read(name, _run(_trace())) is None
    monkeypatch.delattr(raystrack_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "raystrack_tpu_torch.tracing", None)
    assert _read(name, _run(_trace())) is None


def test_the_gate_metrics_are_declared_with_the_gated_cells():
    bench = harness._json(harness.ROOT / "BENCHMARK.json")
    declared = {m["name"]: m for m in bench["per_layer"]}
    cells = ["city_building", "city_buildings", "city_building_x4", CELL]
    for name in READERS:
        m = declared[name]
        assert m["moves"] == "solve_s" and m["layer"] == "ops.trace_cuda gate"
        assert m["source"] == "program_counter" and m["workloads"] == cells
        assert (harness.HERE / "metrics" / f"{name}.py").is_file()
