"""Device time of the copies (host to card, card to host) in the plain
encode calls, ms a GiB of their input (traced run)."""

from benchmark.readers import copies_ms_per_gib


def read(run):
    return copies_ms_per_gib(run, "enc")
