"""Process start to the first timed solve: imports, CUDA start, the kernels'
load, the scene, the PreparedSolver and the warm-up solve (host clock)."""


def read(run):
    return run.setup_s
