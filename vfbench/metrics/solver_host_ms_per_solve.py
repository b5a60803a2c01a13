"""Host ms per traced solve inside the solver's own round and chunk work:
the program's spans ``raystrack.round.build`` and ``.consume`` (a scheduled
round's planning, assembly, upload and enqueue; its unpacking and the
monitors' replay) and ``raystrack.chunk.dispatch`` and ``.consume`` (the
per-emitter driver's), outermost occurrences only. None where the trace
holds none of them (a program without its tracing spans)."""
import numpy as np

SPANS = ("raystrack.round.build", "raystrack.round.consume", "raystrack.chunk.dispatch",
         "raystrack.chunk.consume")


def program_spans(host) -> np.ndarray:
    """(start, end) of the host events named in SPANS that lie inside no
    other of them, sorted by start."""
    spans = sorted(((s, e) for n, s, e in host if n in SPANS), key=lambda x: (x[0], -x[1]))
    out = []
    for s, e in spans:
        if out and s >= out[-1][0] and e <= out[-1][1]:
            continue
        out.append((s, e))
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def read(run):
    t = run.trace
    if t is None or not t.solves:
        return None
    spans = program_spans(t.host)
    if not spans.size:
        return None
    return 1e3 * float((spans[:, 1] - spans[:, 0]).sum()) / t.solves
