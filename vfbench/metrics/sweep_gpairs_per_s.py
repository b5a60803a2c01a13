"""The sweep kernels' own rate: the program's ``pairs_tested`` over the
traced window, in 1e9, over the device seconds of the kernels
``sweep_ms_per_solve`` times by name. Apart from how much work the gate
leaves. None where the program counts no pairs or no sweep ran."""
from vfbench.metrics.sweep_gpairs_per_solve import program_counts
from vfbench.metrics.sweep_ms_per_solve import SWEEP


def read(run):
    t = run.trace
    if t is None:
        return None
    counts = program_counts()
    seconds = t.device_seconds(SWEEP)
    if not counts or not counts.get("pairs_tested") or seconds <= 0:
        return None
    return counts["pairs_tested"] / 1e9 / seconds
