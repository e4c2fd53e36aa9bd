"""Bytes the timed encode calls moved over the bus (host to card and card
to host, as the program counts them) a byte of their input (traced run)."""

from benchmark.program_records import bus_bytes_per_byte


def read(run):
    return bus_bytes_per_byte(run, "enc")
