"""The readers of the metrics that read the program's own spans and counters
(``raystrack_tpu_torch.tracing``): each on a synthetic trace and counters,
on a run without a trace, and on a program that has no such spans or
counters (the trace then holds none, or the module is missing), where each
returns None.

    python -m pytest vfbench/tests -q
"""
from __future__ import annotations

import sys

import numpy as np
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
    device = [(SWEEP, 0.10, 0.30, 0), (SWEEP, 0.50, 0.60, 0), ("elementwise_kernel", 0.62, 0.70, 0)]
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
    cities = ["city_building", "city_buildings", "city_building_x4"]
    for name in READERS:
        m = declared[name]
        assert m["moves"] == "solve_s" and (harness.HERE / "metrics" / f"{name}.py").is_file()
        cells = cities if name == "sweep_tile_share" else [w["name"] for w in bench["workloads"]]
        assert sorted(m["workloads"]) == sorted(cells)
        assert "roofline" not in name and "mfu" not in name


# The per-card readings, on synthetic traces of one and of more cards.

def _cards_trace(device, cards):
    return Trace(window_s=1.0, device=device, host=[], cards=cards, solves=2)


def test_one_card_busy_and_idle_are_the_union_of_its_events():
    """On one card ``busy_s`` and ``device_idle_share`` read, bit for bit,
    the union of every device event over the window, as before cards were
    told apart."""
    trace = _trace()
    trace.device.append(("Memcpy HtoD (Pinned -> Device)", 0.25, 0.35, 0))  # overlaps
    trace = _cards_trace(trace.device, 1)
    union = sorted((s, e) for _, s, e, _ in trace.device)
    merged = [list(union[0])]
    for s, e in union[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    iv = np.asarray(merged, dtype=np.float64)
    busy = float((iv[:, 1] - iv[:, 0]).sum())
    assert trace.busy_s == busy
    assert _read("device_idle_share", _run(trace)) == 100.0 * (1.0 - busy / 1.0)


def test_a_card_left_idle_shows_in_the_mean_and_not_in_the_union():
    """Card 0 busy the whole window, card 1 its first half: 25% idle a
    card on the mean, 0% in the union, whose gaps (no card busy) stay the
    breakdown's and the idle readers'."""
    trace = _cards_trace([(SWEEP, 0.0, 1.0, 0), (SWEEP, 0.0, 0.5, 1)], 2)
    assert trace.card_busy_s() == [1.0, 0.5] and trace.busy_s == 0.75
    assert _read("device_idle_share", _run(trace)) == pytest.approx(25.0)
    assert float((trace.busy_intervals[:, 1] - trace.busy_intervals[:, 0]).sum()) == 1.0
    assert trace.breakdown()["idle_gaps"] == []


def test_shard_sweep_skew():
    equal = _cards_trace([(SWEEP, 0.1, 0.3, c) for c in range(4)], 4)
    assert _read("shard_sweep_skew", _run(equal)) == 0.0
    uneven = _cards_trace([(SWEEP, 0.1, 0.4, 0), (SWEEP, 0.1, 0.2, 1),
                           ("elementwise_kernel", 0.2, 0.9, 1)], 2)
    assert _read("shard_sweep_skew", _run(uneven)) == pytest.approx(50.0)  # 0.3 / 0.2 - 1
    assert _read("shard_sweep_skew", _run(_cards_trace(equal.device[:1], 1))) is None
    assert _read("shard_sweep_skew", _run(_cards_trace([("fill", 0.1, 0.2, 0)] * 2, 2))) is None
    assert _read("shard_sweep_skew", _run(None)) is None


def test_the_card_metric_is_declared_with_the_cells_of_more_than_one_chip():
    bench = harness._json(harness.ROOT / "BENCHMARK.json")
    m = {m["name"]: m for m in bench["per_layer"]}["shard_sweep_skew"]
    across = sorted(w["name"] for w in bench["workloads"] if w["chips"] > 1)
    assert m["moves"] == "solve_s" and m["layer"] == "parallel.sharding"
    assert m["source"] == "device_trace" and sorted(m["workloads"]) == across
