"""A whole run of each cell on the CPU at a small size, past the look for a
card, with the timed path broken underneath: ``correct`` has to come out
false for each fault a cell can have, and true unbroken. The faults:

- ``stale``: every third dispatch's counts come back as zeros, the step's
  state unchanged;
- ``half``: each odd ray of an iteration repeats the even one before it, so
  half of the batch is left out and the estimate is the mean of the rest;
- ``altered``: one hit in five reports the other side of its triangle, an
  answer altered where the sweep produces it;
- ``dropped_shard``: in a cell of more than one chip, shard 1's counts come
  back as zeros before the sum on the mesh's first device, the exchange
  between chips left out for one of them.

A cell of more than one chip runs here over a logical mesh of the CPU
(``harness.cards``): the same split of the rays and sum of the counts as on
the cards.

    python -m pytest vfbench/tests -q
"""
from __future__ import annotations

import time

import pytest
import torch

from test_vfbench_reference import SMALL, small_cell

from vfbench import harness


def stale(trace_mod, monkeypatch):
    real, calls = trace_mod.count_codes, []

    def count_codes(*args, **kwargs):
        calls.append(1)
        f, b = real(*args, **kwargs)
        return (torch.zeros_like(f), torch.zeros_like(b)) if len(calls) % 3 == 0 else (f, b)

    monkeypatch.setattr(trace_mod, "count_codes", count_codes)
    if "count_bins" in vars(trace_mod):  # the sky's counts
        real_bins = trace_mod.count_bins

        def count_bins(*args, **kwargs):
            calls.append(1)
            out = real_bins(*args, **kwargs)
            return torch.zeros_like(out) if len(calls) % 3 == 0 else out

        monkeypatch.setattr(trace_mod, "count_bins", count_bins)


def half(trace_mod, monkeypatch):
    real = trace_mod.generate_rays

    def generate_rays(*args, **kwargs):
        o, d = real(*args, **kwargs)
        o, d = o.clone(), d.clone()
        h = o.shape[1] // 2
        o[:, 1:2 * h:2], d[:, 1:2 * h:2] = o[:, 0:2 * h:2], d[:, 0:2 * h:2]
        return o, d

    monkeypatch.setattr(trace_mod, "generate_rays", generate_rays)


def altered(trace_mod, monkeypatch):
    real = trace_mod.sweep_rays

    def sweep_rays(*args, **kwargs):
        codes, any_hit = real(*args, **kwargs)
        flip = (torch.arange(codes.numel()) % 5 == 0).view_as(codes) & (codes >= 0)
        return torch.where(flip, codes ^ 1, codes), any_hit

    monkeypatch.setattr(trace_mod, "sweep_rays", sweep_rays)


def dropped_shard(trace_mod, monkeypatch):
    real = trace_mod.chunk_body

    def chunk_body(tri_pack, sweep_mask, tables, *args, ray_index_base=0, **kwargs):
        out = real(tri_pack, sweep_mask, tables, *args, ray_index_base=ray_index_base,
                   **kwargs)
        if ray_index_base == tables[0].shape[0]:  # shard 1 of the chunk's slices
            out = {k: torch.zeros_like(v) for k, v in out.items()}
        return out

    monkeypatch.setattr(trace_mod, "chunk_body", chunk_body)


FAULTS = {"stale": stale, "half": half, "altered": altered, "dropped_shard": dropped_shard}
ACROSS_CHIPS = {"dropped_shard"}  # faults only a cell of more than one chip can have


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_small(name):
    return harness.measure(small_cell(name), 2147483777, 0.01, trace=False,
                           t_start=time.perf_counter(), device="cpu")


@pytest.mark.parametrize("name", list(SMALL))
def test_unbroken_run_is_correct(name):
    run = run_small(name)
    assert run.failed == 0 and run.checks["gap"]["value"] <= 1e-9 and run.correct


def _faults_of(name):
    across = harness.Cell.load(name).chips > 1
    return [(name, f) for f in FAULTS if across or f not in ACROSS_CHIPS]


@pytest.mark.parametrize("name,fault", [nf for name in SMALL for nf in _faults_of(name)])
def test_broken_run_is_not_correct(name, fault, monkeypatch):
    from raystrack_tpu_torch.ops import trace as trace_mod

    FAULTS[fault](trace_mod, monkeypatch)
    run = run_small(name)
    assert not run.correct, run.checks


SOLVES = {"matrix": "view_factor_matrix", "sky": "view_factor_to_tregenza_sky",
          "workflow": "view_factor_outside_workflow"}


@pytest.mark.parametrize("name", list(SMALL))
def test_only_a_cell_of_more_than_one_chip_passes_a_mesh(name, monkeypatch):
    """A cell of one chip calls the public solve as a user with no mesh
    does, with no ``mesh=``; a cell of more chips passes ``ray_mesh()`` of
    its ``chips`` devices."""
    import raystrack_tpu_torch as rt

    cell = small_cell(name)
    calls = []
    monkeypatch.setattr(rt, SOLVES[cell.traffic["solve"]],
                        lambda *args, **kwargs: calls.append(kwargs) or {})
    solve = harness.program_solver(cell.traffic, cell.meshes(2147483901), "cpu", cell.chips)
    solve(harness.solve_seed(7, 1))
    assert len(calls) == 1
    if cell.chips == 1:
        assert "mesh" not in calls[0]
    else:
        assert calls[0]["mesh"].devices == (torch.device("cpu"),) * cell.chips


@pytest.mark.parametrize("name", [n for n in SMALL if harness.Cell.load(n).chips > 1])
def test_mesh_solve_equals_the_one_shard_solve(name):
    cell = small_cell(name)
    meshes = cell.meshes(2147483901)
    on_mesh = harness.program_solver(cell.traffic, meshes, "cpu", cell.chips)
    alone = harness.program_solver(cell.traffic, meshes, "cpu")
    for k in (1, 2):
        qmc = harness.solve_seed(2147483901, k)
        assert on_mesh(qmc) == alone(qmc)
