"""Bytes the timed decode calls moved over the bus (host to card and card
to host, as the program counts them) a byte of their output (traced run)."""

from benchmark.program_records import bus_bytes_per_byte


def read(run):
    return bus_bytes_per_byte(run, "dec")
