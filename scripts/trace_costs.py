"""What a traced benchmark run costs the calls it times, and the clock its records share.

    python3 scripts/trace_costs.py --workload NAME --seed N [--seed M ...] [--seconds 10]
        [--out build/trace_costs.jsonl]

For each seed, one ``--trace 1`` run of the benchmark cell
(``benchmark.run.run_cell``, as ``python3 -m benchmark.run`` makes it),
then, from what that run kept:

- ``cost``: wall seconds a GiB of the timed calls (made with
  ``_timings``, so recorded) and of the plain ones, each way, and their
  ratio;
- ``marks``: spans a recorded call, each way (min, median, max), and
  ``spans``: the timed calls' spans by phase and part over the window
  (each span after a mark carries that mark's cost);
- ``clock``: each span's end of the window's recorded calls against the
  ``mark:<phase>`` range its ``_timings`` write opened in the profiler's
  trace (the least, 99th percentile and largest lead, in ms; how many lie
  outside 0-0.2 ms, and the ten farthest by phase and part);
- ``idle``: the device's idle seconds of the timed calls by phase and
  part, all of them (the result line's ``breakdown`` keeps ten);
- the run's result line (``correct``, the metrics, the device).

Prints the card's name and power limit, then one JSON line a run, also
appended to ``--out``.  Run it from a checkout's root on the card.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import program_records, run as bench_run, trace  # noqa: E402

GIB = 1 << 30


def traced_run(manifest, workload: str, seed: int, seconds: float) -> dict:
    """One traced run, with its ``Run`` and its profiler events kept."""
    from redux_tpu_torch import api

    kept = {}
    real_events, real_run = trace.events, bench_run.Run

    def events(prof):
        kept["events"] = real_events(prof)
        return kept["events"]

    class Run(real_run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept["run"] = self

    first = (api.recorded_calls() or [{"id": -1}])[-1]["id"]
    trace.events, bench_run.Run = events, Run
    try:
        result = bench_run.run_cell(manifest, workload, seed, seconds, True)
    finally:
        trace.events, bench_run.Run = real_events, real_run
    recs = [r for r in api.recorded_calls() if r["id"] > first]
    return dict(result=result, run=kept["run"], events=kept["events"], records=recs)


def cost(run, kind: str) -> dict:
    """Wall seconds a GiB of the timed and the plain ``kind`` calls."""
    out = {}
    for mode in ("timed", "plain"):
        calls = [c for c in run.calls if c["kind"] == kind and c["mode"] == mode]
        nbytes = sum(c["bytes"] for c in calls)
        out[mode] = sum(c["seconds"] for c in calls) / (nbytes / GIB) if nbytes else None
        out[f"{mode}_calls"] = len(calls)
    if out["timed"] and out["plain"]:
        out["ratio"] = out["timed"] / out["plain"]
    return out


def clock(records: list, evs: list) -> dict:
    """Each span's end against the first ``mark:`` range its mark opened:
    the records' spans in order, two ranges a span (the phase's key, then
    the part's)."""
    marks = sorted((e.start, e.name) for e in evs if e.card is None and e.name.startswith("mark:"))
    spans = [s for r in sorted(records, key=lambda r: r["id"]) for s in r["spans"]]
    if len(marks) != 2 * len(spans):
        return {"error": f"{len(marks)} mark ranges for {len(spans)} spans"}
    leads, wrong = [], 0
    for j, (phase, part, _, end) in enumerate(spans):
        if (marks[2 * j][1], marks[2 * j + 1][1]) != (f"mark:{phase}", f"mark:{phase} {part}"):
            wrong += 1
        leads.append((marks[2 * j][0] - end) / 1e6)
    outside = [(f"{s[0]} {s[1]}", x) for s, x in zip(spans, leads) if not 0 <= x <= 0.2]
    return {"spans": len(spans), "names_wrong": wrong, "least_ms": min(leads, default=None),
            "p99_ms": statistics.quantiles(leads, n=100)[-1] if len(leads) > 1 else None,
            "largest_ms": max(leads, default=None), "outside_0_0.2_ms": len(outside),
            "outside": sorted(outside, key=lambda o: -o[1])[:10]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default="build/trace_costs.jsonl")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    manifest = bench_run.Manifest(ROOT)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seed:
        got = traced_run(manifest, args.workload, seed, args.seconds)
        run, result = got["run"], got["result"]
        marks, spans = {}, collections.Counter()
        for kind in ("enc", "dec"):
            recs = program_records.timed_records(run, kind) or ()
            n = [len(r["spans"]) for r in recs]
            marks[kind] = [min(n), statistics.median(n), max(n)] if n else None
            spans.update(f"{kind} {s[0]} {s[1]}" for r in recs for s in r["spans"])
        tr = trace.reduce(got["events"])
        line = {"workload": args.workload, "seed": seed, "correct": result["correct"],
                "cost": {kind: cost(run, kind) for kind in ("enc", "dec")}, "marks": marks,
                "spans": dict(spans.most_common()),
                "clock": clock(got["records"], got["events"]),
                "idle": dict(sorted(((k, v / 1e9) for k, v in tr.idle_by_phase.items()),
                                    key=lambda kv: -kv[1])),
                "result": result}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
