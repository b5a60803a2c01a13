"""The measured window's seconds over the solves it completed: the time to
a converged answer, every stall included (host clock)."""


def read(run):
    return run.window_s / len(run.walls) if run.walls else None
