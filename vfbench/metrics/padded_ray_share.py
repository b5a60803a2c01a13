"""Share of the rays the sweep launches covered that are padding, in %:
1 - the program's ``rays_real`` (the rays of real emitter iterations) over
``rays_padded`` (each launch's rays), over the traced window. None where
the program counts no rays."""
from vfbench.metrics.sweep_gpairs_per_solve import program_counts


def read(run):
    if run.trace is None:
        return None
    counts = program_counts()
    if not counts or not counts.get("rays_padded"):
        return None
    return 100.0 * (1.0 - counts["rays_real"] / counts["rays_padded"])
