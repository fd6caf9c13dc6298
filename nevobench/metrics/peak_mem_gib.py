"""Device memory allocated at the peak, over set-up and the window
(``torch.cuda.max_memory_allocated`` after a reset at process start)."""

UNIT = "GiB"


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
