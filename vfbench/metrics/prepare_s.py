"""Host seconds of the PreparedSolver's construction and of the warm-up
solve, which builds the packs and tables lazily (the harness's spans)."""


def read(run):
    if "prepare" not in run.spans or "warmup" not in run.spans:
        return None
    return run.spans["prepare"] + run.spans["warmup"]
