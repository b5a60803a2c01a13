"""Device ms per solve of the traced window of everything but the port's
hand-written kernels: ray generation, masks, the coherence sort, the gate's
tables, the sky's bins, copies and fills (PyTorch's own kernels)."""
HAND_WRITTEN = (r"\b(sweep_kernel|sweep_code_kernel|sweep_sched_kernel|sweep_fold_kernel"
                r"|gate_cross_kernel|count_codes_kernel)\b")


def read(run):
    t = run.trace
    if t is None or not t.solves:
        return None
    ms = 1e3 * t.device_seconds(HAND_WRITTEN, invert=True)
    return ms / t.solves if ms > 0 else None
