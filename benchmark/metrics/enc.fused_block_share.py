"""The share of the timed encode calls' blocks that the fused encoder K4
coded (traced run): the program's ``fused_blocks`` over ``fused_blocks +
split_blocks`` (``split_blocks``: K1 -> K2) of each record.  1.0 where
every block took K4.  None where the records do not count blocks by
encode route, or count none."""

from benchmark.program_records import timed_records


def read(run):
    recs = timed_records(run, "enc")
    if not recs or any("fused_blocks" not in r or "split_blocks" not in r for r in recs):
        return None
    fused = sum(r["fused_blocks"] for r in recs)
    total = fused + sum(r["split_blocks"] for r in recs)
    return fused / total if total else None
