"""Share of the gate's listed boxes that the gated sweeps' CTAs walked, in
%: the program's ``boxes_walked`` over ``boxes_listed`` over the traced
window. A CTA lists the boxes some ray of its 256-ray block crosses and
walks them nearest first until the list ends or an early-exit window
finds every ray settled; the two-level gate has no window, so there it
reads 100. None where the program has no such counters or listed no box."""
from vfbench.metrics.sweep_gpairs_per_solve import program_counts


def read(run):
    if run.trace is None:
        return None
    counts = program_counts()
    if not counts or not counts.get("boxes_listed"):
        return None
    return 100.0 * counts["boxes_walked"] / counts["boxes_listed"]
