"""Ray-triangle pairs the sweep kernels #1 and #2 tested per traced solve,
in 1e9: each CTA's swept tiles times the tile's triangles times its rays,
the program's ``pairs_tested`` counter (``raystrack_tpu_torch.tracing``),
which advances only while a profiler records: over the traced window. It
moves with the work the gate leaves and the rays padded, not the sweep's
speed. None where the program counts no pairs."""


def program_counts():
    """The program's tracing counters, or None where it has none."""
    try:
        from raystrack_tpu_torch import tracing
    except ImportError:
        return None
    counts = getattr(tracing, "counts", None)
    return counts() if counts is not None else None


def read(run):
    t = run.trace
    if t is None or not t.solves:
        return None
    counts = program_counts()
    if not counts or not counts.get("pairs_tested"):
        return None
    return counts["pairs_tested"] / 1e9 / t.solves
