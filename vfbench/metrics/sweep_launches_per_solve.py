"""Launches of sweep kernels #1 and #2 per solve of the traced window, from
the port's public counters ``sweep_rays.launches`` and
``sweep_rays_scheduled.launches``: chunks and rounds."""


def read(run):
    t = run.trace
    if t is None or not t.solves or not t.launches:
        return None
    return t.launches / t.solves
