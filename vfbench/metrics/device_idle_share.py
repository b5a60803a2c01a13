"""Share of the traced window in which no operation ran on a card, in %:
the mean over the cell's cards of each card's 1 - (union of its device
events' intervals) / window. On one card, 1 - the union / window."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
