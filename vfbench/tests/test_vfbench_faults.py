"""A whole run of each cell on the CPU at a small size, past the look for a
card, with the timed path broken underneath: ``correct`` has to come out
false for each fault a cell can have, and true unbroken. The faults:

- ``stale``: every third dispatch's counts come back as zeros, the step's
  state unchanged;
- ``half``: each odd ray of an iteration repeats the even one before it, so
  half of the batch is left out and the estimate is the mean of the rest;
- ``altered``: one hit in five reports the other side of its triangle, an
  answer altered where the sweep produces it.

(One chip a cell: no exchange between chips to leave out.)

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


FAULTS = {"stale": stale, "half": half, "altered": altered}


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


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", list(SMALL))
def test_broken_run_is_not_correct(name, fault, monkeypatch):
    from raystrack_tpu_torch.ops import trace as trace_mod

    FAULTS[fault](trace_mod, monkeypatch)
    run = run_small(name)
    assert not run.correct, run.checks
