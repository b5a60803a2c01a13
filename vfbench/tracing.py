"""The traced part of a run: ``torch.profiler`` over the devices and the
host, read in memory (no trace file is written) into a :class:`Trace`."""
from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

SPAN_PREFIX = "vfbench."  # the harness's own record_function spans
NAME_CHARS = 160  # a kernel's name is cut to this many characters in a breakdown


@dataclass
class Trace:
    """Device events ``(name, start_s, end_s, card)`` (kernels, copies and
    fills; ``card`` is the CUDA device index), host events ``(name, start_s,
    end_s)``, the traced window's seconds, the cell's cards (0 .. cards-1),
    the solves completed in the window and the program's launch counters'
    change over it. ``busy_intervals`` is the union over every card: a gap
    in it is a time when no card works."""

    window_s: float
    device: List[Tuple[str, float, float, int]]
    host: List[Tuple[str, float, float]]
    cards: int = 1
    solves: int = 0
    launches: int = 0
    busy_intervals: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        self.busy_intervals = _union([(s, e) for _, s, e, _ in self.device])

    def card_busy_s(self) -> List[float]:
        """Each card's own busy seconds: the length of the union of its
        events' intervals."""
        return [_length(_union([(s, e) for _, s, e, c in self.device if c == card]))
                for card in range(self.cards)]

    @property
    def busy_s(self) -> float:
        """The mean over the cell's cards of each card's busy seconds (on
        one card, the union's)."""
        per_card = self.card_busy_s()
        return sum(per_card) / len(per_card)

    def device_seconds(self, pattern: str, *, invert: bool = False,
                       card: Optional[int] = None) -> float:
        """Summed durations of the device events whose name matches
        ``pattern`` (a regular expression), or with ``invert`` of the others,
        on every card or on ``card`` alone."""
        rx = re.compile(pattern)
        return float(sum(e - s for n, s, e, c in self.device
                         if bool(rx.search(n)) != invert and card in (None, c)))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host event under each gap's middle."""
        by_op = {}
        for n, s, e, _ in self.device:
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


def _length(intervals: np.ndarray) -> float:
    return float((intervals[:, 1] - intervals[:, 0]).sum()) if intervals.size else 0.0


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
def profiled(cards: int):
    """Profile the block on the host and CUDA devices 0 .. ``cards``-1
    inside a span ``vfbench.traced``; yields a list that holds the
    :class:`Trace` of that span once the block has ended (``solves`` and
    ``launches`` are the caller's to fill in). Device events are clipped to
    the span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync():
        for card in range(cards):
            torch.cuda.synchronize(card)

    out: list = []
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
            sync()
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
            device.append((*rec, ev.device_index()))
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW} span")
    _, a, b = window
    device = [(n, max(s, a), min(e, b), c) for n, s, e, c in device if e > a and s < b]
    out.append(Trace(window_s=b - a, device=device, host=host, cards=cards))
