"""The readers of the metrics that read the program's own spans and counters
(``raystrack_tpu_torch.tracing``): each on a synthetic trace and counters,
on a run without a trace, and on a program that has no such spans or
counters (the trace then holds none, or the module is missing), where each
returns None.

    python -m pytest vfbench/tests -q
"""
from __future__ import annotations

import sys

import pytest

from vfbench import harness
from vfbench.tracing import Trace

READERS = ("solver_host_ms_per_solve", "solver_idle_ms_per_solve", "sweep_gpairs_per_solve",
           "sweep_gpairs_per_s", "sweep_tile_share", "padded_ray_share")
SWEEP = "void raystrack::(anonymous namespace)::sweep_sched_kernel<true, false, true, 16, 64, 4>"


def _read(name, run):
    return harness._module(harness.HERE / "metrics" / f"{name}.py").read(run)


def _trace():
    """Two solves in a window of 1 s. Device: a sweep kernel 0.10-0.30 and
    0.50-0.60, a torch kernel 0.62-0.70. Host: a round's build 0.05-0.12
    (a span inside it at 0.06-0.08 is its op), its wait and consume
    0.30-0.45 (consume 0.36-0.45), a second build 0.45-0.50 and a chunk
    dispatch 0.70-0.80, all under the solve span 0.0-0.9."""
    device = [(SWEEP, 0.10, 0.30), (SWEEP, 0.50, 0.60), ("elementwise_kernel", 0.62, 0.70)]
    host = [("raystrack.solve.matrix", 0.0, 0.9),
            ("raystrack.round.build", 0.05, 0.12), ("raystrack.ops.raygen", 0.06, 0.08),
            ("raystrack.round.wait", 0.30, 0.36), ("raystrack.round.consume", 0.36, 0.45),
            ("raystrack.round.build", 0.45, 0.50), ("raystrack.chunk.dispatch", 0.70, 0.80),
            ("aten::add", 0.71, 0.72)]
    return Trace(window_s=1.0, device=device, host=host, solves=2)


COUNTS = {"rays_real": 300, "rays_padded": 400, "tiles_offered": 50, "tiles_swept": 8,
          "pairs_tested": 6_000_000_000}


@pytest.fixture
def counts(monkeypatch):
    from raystrack_tpu_torch import tracing

    monkeypatch.setattr(tracing, "counts", lambda: dict(COUNTS))


def _run(trace):
    return harness.Run(cell=None, seed=0, trace=trace)


EXPECTED = {
    # host in build (0.07 + 0.05), consume 0.09, dispatch 0.10 = 0.31 s over 2 solves
    "solver_host_ms_per_solve": 155.0,
    # idle gaps 0.30-0.50 (mid 0.40, in consume), 0.60-0.62 (mid 0.61, in none):
    # 0.20 s over 2 solves
    "solver_idle_ms_per_solve": 100.0,
    "sweep_gpairs_per_solve": 3.0,
    "sweep_gpairs_per_s": 20.0,  # 6 Gpairs over the sweep's 0.3 device seconds
    "sweep_tile_share": 16.0,
    "padded_ray_share": 25.0,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_synthetic_trace_and_counters(name, counts):
    assert _read(name, _run(_trace())) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_returns_none_without_a_trace(name, counts):
    assert _read(name, _run(None)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_returns_none_on_a_program_without_tracing(name, monkeypatch):
    """The parent of the tracing change: its trace holds no program span and
    it has no ``raystrack_tpu_torch.tracing`` to import."""
    import raystrack_tpu_torch

    monkeypatch.delattr(raystrack_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "raystrack_tpu_torch.tracing", None)
    trace = _trace()
    trace.host = [ev for ev in trace.host if not ev[0].startswith("raystrack.")]
    assert _read(name, _run(trace)) is None


def test_span_readers_take_outermost_spans_once(counts):
    """A round's build nested in another build (as a span left open would
    nest) counts once."""
    trace = _trace()
    trace.host.append(("raystrack.round.build", 0.07, 0.10))
    assert _read("solver_host_ms_per_solve", _run(trace)) == pytest.approx(155.0)


def test_the_metrics_are_declared_with_their_cells():
    bench = harness._json(harness.ROOT / "BENCHMARK.json")
    declared = {m["name"]: m for m in bench["per_layer"]}
    cities = ["city_building", "city_buildings"]
    for name in READERS:
        m = declared[name]
        assert m["moves"] == "solve_s" and (harness.HERE / "metrics" / f"{name}.py").is_file()
        cells = cities if name == "sweep_tile_share" else [w["name"] for w in bench["workloads"]]
        assert sorted(m["workloads"]) == sorted(cells)
        assert "roofline" not in name and "mfu" not in name
