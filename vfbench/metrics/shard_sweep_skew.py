"""How far the slowest card's sweep work lies above the mean card's, in %:
100 x (the largest card's device seconds of the kernels
``sweep_ms_per_solve`` times by name / the mean over the cell's cards - 1),
over the traced window. A trace split over the cards of a ray mesh lasts
as long as its slowest shard; 0 when every card sweeps alike. None on one
card or where no sweep ran."""
from vfbench.metrics.sweep_ms_per_solve import SWEEP


def read(run):
    t = run.trace
    if t is None or t.cards < 2:
        return None
    per_card = [t.device_seconds(SWEEP, card=c) for c in range(t.cards)]
    mean = sum(per_card) / len(per_card)
    return 100.0 * (max(per_card) / mean - 1.0) if mean > 0 else None
