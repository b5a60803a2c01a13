"""``torch.cuda.max_memory_allocated(card)`` over set-up and window, GiB,
of the cell's fullest card: how large a scene one card holds."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
