"""Device time of the copies (host to card, card to host) in the plain
decode calls, ms a GiB of their output (traced run)."""

from benchmark.readers import copies_ms_per_gib


def read(run):
    return copies_ms_per_gib(run, "dec")
