"""The per-emitter driver's in-flight slots (``solver._Slots``) on the CPU.

A chunk takes the lowest free slot and gives it back at its harvest, so
slot 0 serves every chunk of a solve that never has two in flight; the
matrix, sky and workflow drives over several emitters return the dicts of
a drive that keeps one chunk in flight; ``chunks_dispatched`` and
``chunks_overlapped`` count what the plan says; the fence and the streams
are held to their order on stand-in streams (the card's own run is
``tests/test_torch_card.py``); and the benchmark's ``chunk_overlap_share``
reads the two counters.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_slots.py -q
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import raystrack_tpu_torch as rt
import raystrack_tpu_torch.solver as solver_mod
from raystrack_tpu_torch import tracing

N_PLATES = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setattr(solver_mod, "_log", lambda line: None)


def _quad(x0, x1, y0, y1, z, up):
    v = np.array([[x0, y0, z], [x1, y0, z], [x1, y1, z], [x0, y1, z]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]] if up else [[0, 2, 1], [0, 3, 2]], np.int32)
    return v, f


def _plates(n=N_PLATES):
    """``n`` plates side by side at z = 1 facing down, then a ground facing
    up: under reciprocity each plate's one receiver is the ground (the other
    plates lie in its plane), and the ground, last, traces nothing."""
    meshes = [(f"plate{i}", *_quad(2.0 * i, 2.0 * i + 1.5, 0.0, 1.5, 1.0, up=False))
              for i in range(n)]
    return meshes + [("ground", *_quad(-1.0, 2.0 * n + 1.0, -1.0, 2.5, 0.0, up=True))]


BASE = dict(samples=2, rays=8, seed=7, device="cpu", bvh="off")


def _solve(kind, meshes, **iters):
    iters = {"min_iters": 2, "max_iters": 5, **iters}
    matrix = rt.MatrixParams(**BASE, **iters, tol=1e-3, reciprocity=True)
    sky = rt.SkyParams(**BASE, **iters, tol=1e-3)
    if kind == "matrix":
        return rt.view_factor_matrix(meshes, matrix)
    if kind == "sky":
        return rt.view_factor_to_tregenza_sky(meshes, sky)
    return rt.view_factor_outside_workflow(meshes, matrix_params=matrix, sky_params=sky)


def _slot_log(monkeypatch):
    """Record each dispatched chunk's (emitter, slot index)."""
    log = []
    dispatch = solver_mod._EmitterRun.dispatch_chunk

    def logged(self, chunk, **kw):
        log.append((self.idx_emit, kw["slot"].index))
        return dispatch(self, chunk, **kw)

    monkeypatch.setattr(solver_mod._EmitterRun, "dispatch_chunk", logged)
    return log


def _one_in_flight(monkeypatch):
    """The per-emitter driver with ``depth`` 1: one chunk in flight, slot 0."""
    pipelined = solver_mod._drive_pipelined
    monkeypatch.setattr(solver_mod, "_drive_pipelined",
                        lambda *a, **k: pipelined(*a, **{**k, "depth": 1}))


@pytest.mark.parametrize("kind", ["matrix", "sky", "workflow"])
def test_drives_over_several_emitters_equal_one_chunk_in_flight(kind, monkeypatch):
    """Ten plates' per-emitter solve: the same dicts with three slots as
    with one chunk in flight; with three, chunks take slots 1 and 2."""
    meshes = _plates()
    log = _slot_log(monkeypatch)
    slotted = _solve(kind, meshes)
    assert {k for _, k in log} == {0, 1, 2}
    del log[:]
    with monkeypatch.context() as m:
        _one_in_flight(m)
        alone = _solve(kind, meshes)
    assert {k for _, k in log} == {0}
    assert slotted == alone


def test_slots_rotate_and_one_emitter_keeps_slot_0(monkeypatch):
    """At depth 3 the first three chunks take slots 0, 1, 2 and each later
    chunk the slot its harvest freed (the oldest chunk's): 0, 1, 2, 0, ...;
    a single emitter's every chunk takes slot 0."""
    log = _slot_log(monkeypatch)
    _solve("matrix", _plates(), min_iters=6, max_iters=6)
    assert len(log) == 3 * N_PLATES
    assert [k for _, k in log] == [i % 3 for i in range(len(log))]
    del log[:]
    _solve("matrix", _plates(1), min_iters=6, max_iters=6)
    assert [k for _, k in log] == [0, 0, 0]


def _counted(fn):
    before = tracing.counts()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return tracing.since(before)


@pytest.mark.parametrize("n,overlapped", [(N_PLATES, 29), (1, 0)],
                         ids=["ten_emitters", "one_emitter"])
def test_chunk_counters(n, overlapped):
    """Exactly 6 iterations plan chunks of 4, 1 and 1 a plate: ten plates
    dispatch 30 chunks at depth 3, all but the first while another is in
    flight; one plate dispatches 3 and none overlaps. Untraced, neither
    counter moves."""
    kw = dict(min_iters=6, max_iters=6)
    moved = _counted(lambda: _solve("matrix", _plates(n), **kw))
    assert (moved["chunks_dispatched"], moved["chunks_overlapped"]) == (3 * n, overlapped)
    before = tracing.counts()
    _solve("matrix", _plates(n), **kw)
    after = tracing.since(before)
    assert after["chunks_dispatched"] == after["chunks_overlapped"] == 0


def test_scheduled_solve_dispatches_no_chunk(monkeypatch):
    """The scheduled driver finishes every emitter: the per-emitter drive
    after it takes no slot."""
    from raystrack_tpu_torch import config

    monkeypatch.setattr(config, "SCHEDULER", "scheduled")
    moved = _counted(lambda: _solve("matrix", _plates(3)))
    assert moved["chunks_dispatched"] == 0


class _Stream:
    """A stand-in CUDA stream that logs what is asked of it."""

    def __init__(self, name, log):
        self.name, self.log = name, log

    def record_event(self):
        self.log.append(("record", self.name))
        return f"event@{self.name}#{sum(1 for e in self.log if e[0] == 'record')}"

    def wait_event(self, event):
        self.log.append(("wait", self.name, event))

    def wait_stream(self, other):
        self.log.append(("wait_stream", self.name, other.name))

    def __repr__(self):
        return self.name


@pytest.fixture
def stand_in_cards(monkeypatch):
    """Two stand-in cards: the caller's current streams ``caller0`` and
    ``caller1``, and each slot's side streams ``s<k>.<card>``; the stream
    contexts entered are logged as ("enter", name)."""
    log = []
    caller = {i: _Stream(f"caller{i}", log) for i in range(2)}
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: caller[d.index])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(solver_mod, "_SIDE_STREAMS", {})
    monkeypatch.setattr(solver_mod, "_side_stream",
                        lambda d, k: _Stream(f"s{k}.{d.index}", log))

    @contextlib.contextmanager
    def stream(s):
        log.append(("enter", s.name))
        yield

    monkeypatch.setattr(torch.cuda, "stream", stream)
    monkeypatch.setattr(torch.cuda, "device", lambda i: contextlib.nullcontext())
    cards = [torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cuda", 0)]
    return cards, log


def test_fence_orders_the_slots_streams(stand_in_cards):
    """Slot 0 is the caller's stream and enters no context; a side slot
    waits on the fence last recorded on another slot's streams, on every
    card, before it enqueues; a slot skips the wait on its own fence; the
    join waits on the side streams used, and on no other."""
    cards, log = stand_in_cards
    slots = solver_mod._Slots(cards, 3)
    assert log == [("record", "caller0"), ("record", "caller1")]  # the drive's start
    del log[:]
    first = slots.take()
    with first.streams():  # slot 0 behind its own fence: nothing to wait on
        first.fence()
    assert first.index == 0 and log == [("record", "caller0"), ("record", "caller1")]
    del log[:]
    second = slots.take()
    with second.streams():
        log.append(("body",))
        second.fence()
    assert second.index == 1
    assert log[:2] == [("wait", "s1.0", "event@caller0#1"), ("wait", "s1.1", "event@caller1#2")]
    assert log[2:] == [("enter", "s1.0"), ("enter", "s1.1"), ("body",),
                       ("record", "s1.0"), ("record", "s1.1")]
    del log[:]
    slots.give(first)
    third = slots.take()  # the freed slot 0, behind slot 1's fence
    with third.streams():
        pass
    assert third.index == 0
    assert log == [("wait", "caller0", "event@s1.0#1"), ("wait", "caller1", "event@s1.1#2")]
    del log[:]
    slots.join()
    assert log == [("wait_stream", "caller0", "s1.0"), ("wait_stream", "caller1", "s1.1")]


def test_cpu_slots_hold_no_stream():
    slots = solver_mod._Slots([torch.device("cpu")] * 4, 3)
    taken = [slots.take() for _ in range(3)]
    assert [s.index for s in taken] == [0, 1, 2]
    for s in taken:
        with s.streams():
            s.fence()
    slots.join()


# The benchmark's reader of the two counters


def _read(counts, monkeypatch, trace=True):
    from vfbench import harness

    monkeypatch.setattr(tracing, "counts", lambda: dict(counts))
    run = harness.Run(cell=None, seed=0, trace=object() if trace else None)
    return harness._module(harness.HERE / "metrics" / "chunk_overlap_share.py").read(run)


@pytest.mark.parametrize("counts,share", [
    ({"chunks_dispatched": 30, "chunks_overlapped": 29}, 100.0 * 29 / 30),
    ({"chunks_dispatched": 3, "chunks_overlapped": 0}, 0.0),
    ({"chunks_dispatched": 0, "chunks_overlapped": 0}, None),
    ({"pairs_tested": 5}, None),
], ids=["ten_emitters", "one_emitter", "no_chunk", "no_counter"])
def test_chunk_overlap_share_reader(counts, share, monkeypatch):
    assert _read(counts, monkeypatch) == (pytest.approx(share) if share is not None else None)


def test_chunk_overlap_share_reader_without_a_trace(monkeypatch):
    assert _read({"chunks_dispatched": 3, "chunks_overlapped": 2}, monkeypatch,
                 trace=False) is None


def test_chunk_overlap_share_is_declared_with_the_per_emitter_cells():
    from vfbench import harness

    bench = harness._json(harness.ROOT / "BENCHMARK.json")
    m = {m["name"]: m for m in bench["per_layer"]}["chunk_overlap_share"]
    assert (m["source"], m["layer"], m["moves"], m["unit"], m["better"]) == (
        "program_counter", "solver", "solve_s", "%", "higher")
    assert m["workloads"] == ["city_building", "city_building_x4", "slim_city_buildings"]
