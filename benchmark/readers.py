"""What the metric readers (``benchmark/metrics/<name>.py``) share: each
takes a run's record (:class:`benchmark.run.Run`) and returns a number, or
None where the run holds nothing to read."""

from __future__ import annotations

from typing import Callable, Optional

from benchmark import trace

GIB = 1 << 30
COPIES = r"^Memcpy"


def card_ms_per_gib(run) -> Optional[float]:
    """The cards' busy milliseconds over the window, summed over the cards,
    a GiB of the plain round trips' input."""
    nbytes = sum(c["bytes"] for c in run.plain("enc"))
    if not run.card_busy_ns or nbytes == 0:
        return None
    return sum(run.card_busy_ns.values()) / 1e6 / (nbytes / GIB)


def _traced_plain(run, kind: str) -> Optional[list]:
    """The plain ``kind`` calls of a traced run, where the trace holds
    each of them; else None."""
    tr = run.trace
    calls = run.plain(kind)
    if tr is None or not calls or len(calls) != len(trace.plain(tr, kind)):
        return None
    return calls


def copies_ms_per_gib(run, kind: str) -> Optional[float]:
    """Device milliseconds of the copies in the plain ``kind`` calls a GiB
    of their bytes."""
    calls = _traced_plain(run, kind)
    nbytes = sum(c["bytes"] for c in calls or ())
    if not nbytes:
        return None
    return 1e3 * trace.op_seconds(run.trace, kind, COPIES) / (nbytes / GIB)


def roofline_pct(run, kind: str, pattern: str, least: Callable) -> Optional[float]:
    """The least time of the plain ``kind`` calls' work (``least`` of each
    call's archive work) over the device time of the ops matching
    ``pattern`` in them, in percent."""
    calls = _traced_plain(run, kind)
    busy = trace.op_seconds(run.trace, kind, pattern) if calls else 0.0
    if busy <= 0:
        return None
    return 100.0 * sum(least(run.work[c["file"]]) for c in calls) / busy
