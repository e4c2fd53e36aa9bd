"""What the program records of a traced run's timed calls: the calls made
with ``_timings`` (``redux_tpu_torch.api.recorded_calls``), matched to the
run's timed calls, and the readers of its counters.

A program that records nothing (no ``recorded_calls``), or whose last
records do not match the run's timed calls one to one, gives None."""

from __future__ import annotations

from typing import Optional

# The record's count of a call's bytes that the run keeps as the call's
# "bytes": encode's input, decode's output.
_BYTES = {"enc": "bytes_in", "dec": "bytes_out"}


def timed_records(run, kind: str) -> Optional[list]:
    """The program's records of the run's timed ``kind`` calls, in order:
    the last recorded ``kind`` calls, one a timed call, each of the same
    bytes; else None."""
    try:
        from redux_tpu_torch.api import recorded_calls
    except ImportError:
        return None
    timed = [c for c in run.calls if c["kind"] == kind and c["mode"] == "timed"]
    if not timed:
        return None
    recs = [r for r in recorded_calls() if r["kind"] == kind][-len(timed):]
    if len(recs) != len(timed) or any(r[_BYTES[kind]] != c["bytes"]
                                      for r, c in zip(recs, timed)):
        return None
    return recs


def bus_bytes_per_byte(run, kind: str) -> Optional[float]:
    """The bytes the timed ``kind`` calls moved to and from the cards over
    their bytes (encode's input, decode's output)."""
    recs = timed_records(run, kind)
    nbytes = sum(r[_BYTES[kind]] for r in recs or ())
    if not nbytes:
        return None
    return sum(r["h2d"] + r["d2h"] for r in recs) / nbytes
