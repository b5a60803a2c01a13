"""Device ms of the sweep kernels #1 and #2 (and the fold of their tile
segments) per solve of the traced window, by kernel name."""
SWEEP = r"\b(sweep_kernel|sweep_code_kernel|sweep_sched_kernel|sweep_fold_kernel)\b"


def read(run):
    t = run.trace
    if t is None or not t.solves:
        return None
    ms = 1e3 * t.device_seconds(SWEEP)
    return ms / t.solves if ms > 0 else None
