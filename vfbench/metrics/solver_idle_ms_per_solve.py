"""Device-idle ms per traced solve that the solver's own host work leaves:
the idle gaps between the device's busy intervals whose midpoint lies
inside one of ``solver_host_ms_per_solve``'s spans. Its host ms less this is
what the round pipelining already hides. None where the trace holds none of
those spans."""
import numpy as np

from vfbench.metrics.solver_host_ms_per_solve import program_spans
from vfbench.tracing import _gaps


def read(run):
    t = run.trace
    if t is None or not t.solves or not t.device:
        return None
    spans = program_spans(t.host)
    if not spans.size:
        return None
    idle = 0.0
    for a, b in _gaps(t.busy_intervals):
        mid = (a + b) / 2
        i = int(np.searchsorted(spans[:, 0], mid, side="right")) - 1
        if i >= 0 and mid <= spans[i, 1]:
            idle += b - a
    return 1e3 * idle / t.solves
