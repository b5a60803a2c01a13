"""Share of the per-emitter driver's chunks dispatched while another of its
chunks was still in flight, in %: 100 x the program's ``chunks_overlapped``
over ``chunks_dispatched`` over the traced window. On the card each chunk
in flight holds a stream of its own, so such a chunk can run beside the
others. None where the program dispatched no chunk or counts none."""
from vfbench.metrics.sweep_gpairs_per_solve import program_counts


def read(run):
    if run.trace is None:
        return None
    counts = program_counts()
    if not counts or not counts.get("chunks_dispatched"):
        return None
    return 100.0 * counts["chunks_overlapped"] / counts["chunks_dispatched"]
