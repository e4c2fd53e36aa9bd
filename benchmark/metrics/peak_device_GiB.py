"""The allocator's peak over the window on the fullest card, GiB."""


def read(run):
    return run.peak_bytes / (1 << 30) if run.peak_bytes else None
