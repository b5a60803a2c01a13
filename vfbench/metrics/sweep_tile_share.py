"""Share of the tiles offered to the gated sweeps that their CTAs swept,
in %: the program's ``tiles_swept`` over ``tiles_offered`` (each launch's
CTAs of rays times its tiles) over the traced window. The work the AABB
gate leaves. None where the program counts no tiles."""
from vfbench.metrics.sweep_gpairs_per_solve import program_counts


def read(run):
    if run.trace is None:
        return None
    counts = program_counts()
    if not counts or not counts.get("tiles_offered"):
        return None
    return 100.0 * counts["tiles_swept"] / counts["tiles_offered"]
