"""Gate boxes the gated sweeps' CTAs walked per traced solve, in 1e6: the
program's ``boxes_walked`` over the traced window (each box read, tested
against the CTA's rays and voted on), the gate's own work as
``sweep_gpairs_per_solve`` is the sweep's. None where the program has no
such counters or listed no box."""
from vfbench.metrics.sweep_gpairs_per_solve import program_counts


def read(run):
    t = run.trace
    if t is None or not t.solves:
        return None
    counts = program_counts()
    if not counts or not counts.get("boxes_listed"):
        return None
    return counts["boxes_walked"] / 1e6 / t.solves
