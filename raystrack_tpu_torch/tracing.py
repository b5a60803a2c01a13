"""The port's tracing: named spans of what the host does inside a solve, and
counters of the work each sweep launch does.

**The switch.** Tracing is on while a ``torch.profiler`` records on the
calling thread (``torch._C._autograd._profiler_enabled()``) and off
otherwise: no variable, field or parameter turns it on. Off, a span is a
shared null context behind that one check, no counter moves and the sweep
kernels get a null counter pointer. ``RAYSTRACK_TPU_PROFILE=<dir>`` starts
such a profiler around each public solve (:func:`solve`).

**Spans** (:func:`span`) are host ``cpu_op`` events
(``torch._C._profiler._RecordFunctionFast``), never user annotations, so
the profiler gives them no device-side shadow. They nest on the host
thread; a solve's spans all lie under its public span:

- ``raystrack.solve.matrix`` / ``.sky`` / ``.workflow``: a public solve end
  to end (an inner public solve, as the workflow's, lies under the outer
  one's span and opens none); under it ``raystrack.solve.entries`` (the
  solve's set-up: packs, emitters, monitors, checkpoints read) and
  ``raystrack.solve.rows`` (the rows merged, logged, enforced and clamped);
- the scheduled driver: ``raystrack.round.setup`` (the solve's scene pack
  and flat tables on each device), then per round ``raystrack.round.build``
  (planning, schedule assembly, the upload and the enqueue of the round),
  ``raystrack.round.wait`` (the wait for its counts) and
  ``raystrack.round.consume`` (unpacking them, the monitors' replay, the
  finished emitters' rows);
- the per-emitter driver: ``raystrack.chunk.dispatch`` (a chunk's planning,
  enqueue and copy), ``raystrack.chunk.wait`` and ``raystrack.chunk.consume``;
- the ops: ``raystrack.ops.raygen`` (``generate_rays``, ``scheduled_rays``),
  ``raystrack.ops.masks`` (``emitter_operands``, ``slim_operands``,
  ``combined_masks``), ``raystrack.ops.gate`` (the coherence sort and the
  gate's tables with the crossing kernel), ``raystrack.ops.sweep`` (the
  sweep wrappers' checks and launch) and ``raystrack.ops.count`` (the
  per-row counts of a sweep's codes and flags).

**Counters** (:func:`counts`) advance only while the switch is on:

- ``rays_real``: rays of real emitter iterations handed to a sweep (a
  chunk's iterations times the emitter's rays an iteration; a round's, summed
  over its plan);
- ``rays_padded``: the rays the sweep launches cover (each launch's N);
- ``tiles_offered``: each launch's CTAs of rays times its sweep tiles (a CTA
  of a launch cut into tile segments is counted once: its segments share
  the tiles);
- ``tiles_swept``: the tiles the CTAs swept, summed (``visits=``' per-CTA
  rows, summed);
- ``pairs_tested``: each CTA's swept tiles times the tile's triangles times
  the launch's rays the CTA holds (padding rays included);
- ``boxes_listed``: over every CTA of a gated launch that walks a visit
  list, the boxes on its gate block's list (the gate's ``counts``);
- ``boxes_walked``: over the same CTAs, the list positions each walked
  before the list ended or an early-exit window stopped it (the two-level
  gate has no window, so there it walks every listed box);
- ``chunks_dispatched``: the per-emitter driver's chunks (the host's
  count, on the CPU as on the card);
- ``chunks_overlapped``: those of them dispatched while another slot's
  chunk was still unharvested (``solver._Slots``: on a card such a chunk
  can run beside the others on a stream of its own).

``tiles_swept`` to ``boxes_walked`` are counted on the card by kernels #1
and #2 (one atomic add of each a CTA, into an int64 buffer a device, made
at its first use; a per-emitter chunk makes it before its slot's fence,
as the other slots' kernels add to it too) and on the CPU by their plain
versions from the same walk; they are read only by :func:`counts`, which
synchronises the devices.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

# the kernels' buffer, in its order
_DEVICE_COUNTERS = ("tiles_swept", "pairs_tested", "boxes_listed", "boxes_walked")
COUNTERS = ("rays_real", "rays_padded", "tiles_offered", *_DEVICE_COUNTERS,
            "chunks_dispatched", "chunks_overlapped")

on = torch._C._autograd._profiler_enabled  # the switch: a profiler records this thread
_Span = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()

_host: collections.Counter = collections.Counter()
_device_work: Dict[torch.device, torch.Tensor] = {}  # int64, _DEVICE_COUNTERS
_solving = threading.local()  # depth: public solves open on this thread


def span(name: str):
    """A context that records ``name`` as a host span while tracing is on,
    and does nothing otherwise."""
    return _Span(name) if on() else _OFF


def spanned(name: str):
    """Decorate a function to run under :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not on():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def add(**counts: int) -> None:
    """Advance host counters (callers check :data:`on` first)."""
    _host.update(counts)


def device_work(device: torch.device) -> torch.Tensor:
    """The sweep kernels' counter buffer on ``device``: four int64, the tiles
    swept, the pairs tested, the boxes listed and the boxes walked, made
    zero at first use."""
    buf = _device_work.get(device)
    if buf is None:
        buf = _device_work[device] = torch.zeros(len(_DEVICE_COUNTERS), dtype=torch.int64,
                                                 device=device)
    return buf


def counts() -> Dict[str, int]:
    """Every counter since the process started: :data:`COUNTERS` and the
    launch counters where they live (``sweep_rays.launches``, ``.gated_launches``,
    ``.code_launches`` and ``.geometries`` by name; ``sweep_rays_scheduled``'s;
    ``gate_cross.launches``, ``count_bins.launches``, ``fma_peak.launches``,
    ``mask_rows.launches``).
    Synchronises every device that holds a counter buffer."""
    from .ops.count_cuda import count_bins
    from .ops.masks_cuda import mask_rows
    from .ops.peak_cuda import fma_peak
    from .ops.trace_cuda import gate_cross, sweep_rays, sweep_rays_scheduled

    out = {k: int(_host[k]) for k in COUNTERS}
    for device, buf in _device_work.items():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for key, value in zip(_DEVICE_COUNTERS, buf.tolist()):
            out[key] += value
    for fn in (sweep_rays, sweep_rays_scheduled):
        for attr in ("launches", "gated_launches", "code_launches"):
            if hasattr(fn, attr):
                out[f"{fn.__name__}.{attr}"] = int(getattr(fn, attr))
        for geo, n in fn.geometries.items():
            out[f"{fn.__name__}.geometries.{geo}"] = int(n)
    for fn in (gate_cross, count_bins, fma_peak, mask_rows):
        out[f"{fn.__name__}.launches"] = int(fn.launches)
    return out


def since(before: Dict[str, int], after: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """``after`` (default: :func:`counts` now) less ``before``, key by key."""
    after = counts() if after is None else after
    return {k: v - before.get(k, 0) for k, v in after.items()}


@contextlib.contextmanager
def solve(kind: str):
    """The span ``raystrack.solve.<kind>`` around a public solve; a public
    solve called inside another lies under the outer span and opens none.
    With ``RAYSTRACK_TPU_PROFILE=<dir>`` and no profiler already recording,
    the outermost solve runs under a ``torch.profiler`` of the host and
    (with a card) the CUDA device, which writes a Chrome trace
    ``<dir>/raystrack.solve.<kind>.<pid>.<ns>.json`` and, beside it as
    ``....counts.json``, the change of :func:`counts` over the solve."""
    depth = getattr(_solving, "depth", 0)
    if depth:
        yield
        return
    name = f"raystrack.solve.{kind}"
    trace_dir = os.environ.get("RAYSTRACK_TPU_PROFILE")
    _solving.depth = depth + 1
    try:
        with (_profiled(trace_dir, name) if trace_dir and not on() else _OFF):
            with span(name):
                yield
    finally:
        _solving.depth = depth


@contextlib.contextmanager
def _profiled(trace_dir: str, name: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = counts()
    with profile(activities=activities) as prof:
        yield
    moved = since(before)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    stem = out / f"{name}.{os.getpid()}.{time.time_ns()}"
    prof.export_chrome_trace(f"{stem}.json")
    Path(f"{stem}.counts.json").write_text(json.dumps(moved, indent=1, sort_keys=True))


__all__ = ["COUNTERS", "counts", "on", "since", "solve", "span", "spanned"]
