"""The device list's balance of bus traffic (traced run): over the timed
calls of both kinds, the bytes the largest entry of the list moved to and
from its card (the program's ``h2d_by_card`` + ``d2h_by_card``) over the
mean entry's.  1.0 where each card moves only its own shares; up to the
number of entries where one card stages for all.  None for a one-entry
list, or where the records do not count bytes by entry."""

from benchmark.program_records import timed_records


def read(run):
    moved = None
    for kind in ("enc", "dec"):
        recs = timed_records(run, kind)
        if not recs or any("h2d_by_card" not in r or "d2h_by_card" not in r for r in recs):
            return None
        for r in recs:
            call = [h + d for h, d in zip(r["h2d_by_card"], r["d2h_by_card"])]
            moved = call if moved is None else [a + b for a, b in zip(moved, call)]
    if len(moved) < 2 or not sum(moved):
        return None
    return max(moved) / (sum(moved) / len(moved))
