"""The traced part of a run: ``torch.profiler`` over the device and the host,
read in memory (no trace file is written) into a :class:`Trace`."""
from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

SPAN_PREFIX = "vfbench."  # the harness's own record_function spans
NAME_CHARS = 160  # a kernel's name is cut to this many characters in a breakdown


@dataclass
class Trace:
    """Device events ``(name, start_s, end_s)`` (kernels, copies and fills),
    host events likewise, the traced window's seconds, the solves completed
    in it and the program's launch counters' change over it."""

    window_s: float
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    solves: int = 0
    launches: int = 0
    busy_intervals: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        self.busy_intervals = _union([(s, e) for _, s, e in self.device])

    @property
    def busy_s(self) -> float:
        iv = self.busy_intervals
        return float((iv[:, 1] - iv[:, 0]).sum()) if iv.size else 0.0

    def device_seconds(self, pattern: str, *, invert: bool = False) -> float:
        """Summed durations of the device events whose name matches
        ``pattern`` (a regular expression), or with ``invert`` of the others."""
        rx = re.compile(pattern)
        return float(sum(e - s for n, s, e in self.device if bool(rx.search(n)) != invert))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host event under each gap's middle."""
        by_op = {}
        for n, s, e in self.device:
            key = n[:NAME_CHARS]
            by_op[key] = by_op.get(key, 0.0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = _gaps(self.busy_intervals)
        labels = _innermost(self.host, [(a + b) / 2 for a, b in gaps])
        by_label = {}
        for (a, b), lab in zip(gaps, labels):
            by_label[lab] = by_label.get(lab, 0.0) + (b - a)
        idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def _union(intervals) -> np.ndarray:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def _gaps(busy: np.ndarray) -> List[Tuple[float, float]]:
    return [(float(busy[i, 1]), float(busy[i + 1, 0])) for i in range(len(busy) - 1)
            if busy[i + 1, 0] > busy[i, 1]]


def _innermost(host, points) -> List[str]:
    """Name of the latest-starting host event that covers each point
    ("host" where none does); host events of one thread nest."""
    events = sorted(host, key=lambda x: (x[1], -x[2]))
    order = np.argsort(points)
    labels = ["host"] * len(points)
    stack, i = [], 0
    for j in order:
        p = points[j]
        while i < len(events) and events[i][1] <= p:
            stack.append(events[i])
            i += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        for ev in reversed(stack):
            if ev[2] >= p:
                labels[j] = ev[0]
                break
    return labels


WINDOW = SPAN_PREFIX + "traced"


@contextlib.contextmanager
def profiled():
    """Profile the block on the host and the CUDA device inside a span
    ``vfbench.traced``; yields a list that holds the :class:`Trace` of that
    span once the block has ended (``solves`` and ``launches`` are the
    caller's to fill in). Device events are clipped to the span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out: list = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
            torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        rec = (name, ev.start_ns() * 1e-9, ev.end_ns() * 1e-9)
        if ev.device_type() == cpu:
            if name == WINDOW:
                window = rec
            host.append(rec)
        elif not name.startswith(SPAN_PREFIX):  # not a span's shadow on the device
            device.append(rec)
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW} span")
    _, a, b = window
    device = [(n, max(s, a), min(e, b)) for n, s, e in device if e > a and s < b]
    out.append(Trace(window_s=b - a, device=device, host=host))
