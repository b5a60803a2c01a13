# Copied from raystrack_tpu/convergence.py: the chunk planner and the matrix and sky monitors (host-only NumPy).
"""Host-side convergence monitors and the iteration-chunk planner.

The device solves fixed-size *chunks* of Monte-Carlo iterations and returns
per-iteration count vectors; the monitors replay them one iteration at a
time in float64 NumPy (Welford mean/M2 per surface, stderr or delta
tolerance, min_iters / convergence_interval / max_iters checkpointing). A
chunk may overshoot the stopping iteration; the surplus iterations are
discarded, so the converged estimate is identical to a strictly sequential
solve.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .config import MAX_CHUNK, SPECULATION_PCT, TARGET_CHUNK_RAYS


def convergence_checkpoint(
    iters_done: int,
    *,
    min_iters: int,
    interval: int,
    max_iters: int,
    needs_variance: bool = False,
) -> bool:
    """True when a convergence check should run after ``iters_done`` iterations."""
    if iters_done < max(1, int(min_iters)):
        return False
    if needs_variance and iters_done <= 1:
        return False
    if iters_done >= int(max_iters):
        return True
    span = max(1, int(interval))
    if span <= 1:
        return True
    start = max(1, int(min_iters))
    return ((iters_done - start) % span) == 0


def plan_chunk(
    iters_done: int,
    *,
    min_iters: int,
    interval: int,
    max_iters: int,
    rays_per_iter: int,
    projected_total: Optional[int] = None,
    pow4: bool = True,
) -> int:
    """Pick the next speculative chunk size (power of four, bounded).

    Sized to reach the next convergence checkpoint — or, when the monitor
    can project how many iterations stderr convergence still needs
    (se ~ 1/sqrt(n)), straight to that projection — plus a margin of
    ``SPECULATION_PCT`` percent of completed iterations. Overshoot
    iterations are discarded by the replay, so speculation trades cheap
    device compute for host/device round trips.

    ``pow4=False`` returns the exact bounded size instead: the scheduled
    driver plans exact chunks, so a round reaches each checkpoint at once
    (min_iters=5 takes one 5-iteration round instead of 4-then-1). Results
    are identical either way: the replay discards overshoot iterations.
    """
    remaining = int(max_iters) - int(iters_done)
    if remaining <= 0:
        return 0
    if iters_done < max(1, int(min_iters)):
        need = max(1, int(min_iters)) - iters_done
    else:
        need = max(1, int(interval))
    if projected_total is not None:
        need = max(need, int(projected_total) - iters_done)
    desired = min(need + (iters_done * SPECULATION_PCT) // 100, remaining)
    ray_cap = max(1, TARGET_CHUNK_RAYS // max(1, int(rays_per_iter)))
    bound = min(desired, ray_cap, MAX_CHUNK, remaining)
    if not pow4:
        return max(1, bound)
    chunk = 1
    while chunk * 4 <= bound:
        chunk *= 4
    return chunk


class _Welford:
    """Per-component running mean / M2 over iteration fractions (float64)."""

    def __init__(self, shape):
        self.mean = np.zeros(shape, dtype=np.float64)
        self.m2 = np.zeros(shape, dtype=np.float64)
        self.count = 0

    def update(self, x: np.ndarray) -> None:
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self.m2 += delta * (x - self.mean)

    def stderr(self) -> np.ndarray:
        if self.count > 1:
            return np.sqrt(
                np.maximum(self.m2 / (self.count - 1), 0.0) / self.count
            )
        return np.full_like(self.mean, np.inf)


class MatrixMonitor:
    """Convergence state for one emitter's view-factor row."""

    def __init__(
        self,
        n_surf: int,
        recv_idx: np.ndarray,
        *,
        n_rays_once: int,
        tol: float,
        tol_mode: str,
        min_iters: int,
        interval: int,
        max_iters: int,
    ):
        if tol_mode not in ("delta", "stderr"):
            raise ValueError(f"Unknown tol_mode: {tol_mode}")
        self.recv_idx = np.asarray(recv_idx, dtype=np.int64)
        self.n_rays_once = int(n_rays_once)
        self.tol = float(tol)
        self.tol_mode = tol_mode
        self.min_iters = int(min_iters)
        self.interval = max(1, int(interval))
        self.max_iters = int(max_iters)

        self.hits_f = np.zeros(n_surf, dtype=np.int64)
        self.hits_b = np.zeros(n_surf, dtype=np.int64)
        self.wf = _Welford(n_surf)
        self.wb = _Welford(n_surf)
        self.prev_f: Optional[np.ndarray] = None
        self.prev_b: Optional[np.ndarray] = None
        self.total_rays = 0
        self.iters_done = 0
        self.done = False

    def consume_iteration(self, counts_f: np.ndarray, counts_b: np.ndarray) -> None:
        """Fold in one iteration's per-surface hit counts; may set ``done``."""
        if self.done:
            return
        self.hits_f += counts_f.astype(np.int64)
        self.hits_b += counts_b.astype(np.int64)
        self.total_rays += self.n_rays_once
        self.iters_done += 1

        inv = 1.0 / float(self.n_rays_once)
        self.wf.update(counts_f.astype(np.float64) * inv)
        self.wb.update(counts_b.astype(np.float64) * inv)

        check = convergence_checkpoint(
            self.iters_done,
            min_iters=self.min_iters,
            interval=self.interval,
            max_iters=self.max_iters,
            needs_variance=(self.tol_mode == "stderr"),
        )
        if self.tol_mode == "delta":
            if check:
                curr_f = self.hits_f / float(self.total_rays)
                curr_b = self.hits_b / float(self.total_rays)
                if self.prev_f is not None:
                    if np.all(np.abs(curr_f - self.prev_f) < self.tol) and np.all(
                        np.abs(curr_b - self.prev_b) < self.tol
                    ):
                        self.done = True
                self.prev_f = curr_f
                self.prev_b = curr_b
        else:
            if check:
                se_f = self.wf.stderr()
                se_b = self.wb.stderr()
                if np.all(se_f[self.recv_idx] <= self.tol) and np.all(
                    se_b[self.recv_idx] <= self.tol
                ):
                    self.done = True
        if self.iters_done >= self.max_iters:
            self.done = True

    def projected_total(self) -> Optional[int]:
        """Estimated iterations until stderr convergence (se ~ 1/sqrt(n))."""
        if self.tol_mode != "stderr" or self.iters_done < 2:
            return None
        worst = 0.0
        if self.recv_idx.size:
            worst = max(
                float(np.max(self.wf.stderr()[self.recv_idx])),
                float(np.max(self.wb.stderr()[self.recv_idx])),
            )
        if worst <= self.tol:
            return self.iters_done
        return int(np.ceil(self.iters_done * (worst / self.tol) ** 2))


class SkyMonitor:
    """Convergence state for one emitter's sky fraction (merged or 145-bin)."""

    def __init__(
        self,
        *,
        discrete: bool,
        n_rays_once: int,
        tol: float,
        tol_mode: str,
        min_iters: int,
        interval: int,
        max_iters: int,
    ):
        if tol_mode not in ("delta", "stderr"):
            raise ValueError(f"Unknown tol_mode: {tol_mode}")
        self.discrete = bool(discrete)
        self.n_rays_once = int(n_rays_once)
        self.tol = float(tol)
        self.tol_mode = tol_mode
        self.min_iters = int(min_iters)
        self.interval = max(1, int(interval))
        self.max_iters = int(max_iters)

        self.counts_total = np.zeros(145, dtype=np.int64) if discrete else None
        self.bins_w = _Welford(145) if discrete else None
        self.upward_total = 0
        self.sky_w = _Welford(())
        self.prev: Optional[np.ndarray | float] = None
        self.total_rays = 0
        self.iters_done = 0
        self.done = False

    def consume_iteration(self, value) -> None:
        """Fold in one iteration: (145,) bin counts if discrete else a scalar."""
        if self.done:
            return
        self.total_rays += self.n_rays_once
        self.iters_done += 1
        check = convergence_checkpoint(
            self.iters_done,
            min_iters=self.min_iters,
            interval=self.interval,
            max_iters=self.max_iters,
            needs_variance=(self.tol_mode == "stderr"),
        )

        if self.discrete:
            counts = np.asarray(value, dtype=np.int64)
            self.counts_total += counts
            frac = counts.astype(np.float64) / float(self.n_rays_once)
            self.bins_w.update(frac)
            self.sky_w.update(float(frac.sum()))
            if self.tol_mode == "delta":
                if check:
                    curr = self.counts_total.astype(np.float64) / float(self.total_rays)
                    if self.prev is not None and np.all(np.abs(curr - self.prev) < self.tol):
                        self.done = True
                    if not self.done:
                        self.prev = curr
            else:
                if check and np.all(self.bins_w.stderr() <= self.tol):
                    self.done = True
        else:
            upward = int(value)
            self.upward_total += upward
            frac = upward / float(self.n_rays_once)
            self.sky_w.update(frac)
            if self.tol_mode == "delta":
                if check:
                    curr = self.upward_total / float(self.total_rays)
                    if self.prev is not None and abs(curr - self.prev) < self.tol:
                        self.done = True
                    if not self.done:
                        self.prev = curr
            else:
                if check and float(self.sky_w.stderr()) <= self.tol:
                    self.done = True

        if self.iters_done >= self.max_iters:
            self.done = True

    def projected_total(self) -> Optional[int]:
        """Estimated iterations until stderr convergence (se ~ 1/sqrt(n))."""
        if self.tol_mode != "stderr" or self.iters_done < 2:
            return None
        if self.discrete:
            worst = float(np.max(self.bins_w.stderr()))
        else:
            worst = float(self.sky_w.stderr())
        if worst <= self.tol:
            return self.iters_done
        return int(np.ceil(self.iters_done * (worst / self.tol) ** 2))


__all__ = ["convergence_checkpoint", "plan_chunk", "MatrixMonitor", "SkyMonitor"]
