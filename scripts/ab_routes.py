"""Wall clock of the port's default route for two checkouts, in turns on one card.

    python3 scripts/ab_routes.py A_DIR B_DIR [--reps 5] [--mib 64]

Each checkout runs as a fresh process, in the order A, B, B, A: it builds
its kernels, warms up on 4 MiB, then runs ``--reps`` times two round trips
of ``redux_tpu_torch.api.encode`` -> ``decode`` on ``--mib`` MiB of
``testdata.mixed`` (seed 2024, the input of ``chip_smoke.py``) on
``cuda:0``, each verified byte for byte: one for the wall clock, one with
``_timings`` for the host phases (each phase's mark waits for the card,
which serializes work that otherwise overlaps).  Prints one JSON line a
process, then per checkout the median over all its round trips of the
encode and decode wall clock and of each host phase, in seconds, and of
each way's peak device memory (the allocator's), in GiB.  Compare
two versions only within one call: the host's noise between calls exceeds
the differences this measures.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def worker(root: Path, reps: int, mib: int) -> None:
    sys.path.insert(0, str(root))
    import torch

    import redux_tpu_torch
    from redux_tpu_torch import api, testdata

    if not Path(redux_tpu_torch.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {redux_tpu_torch.__file__}, not the one under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda", 0)
    data = testdata.mixed(mib << 20, 2024)
    api.encode(data[: 4 << 20], device=dev)  # build, first launches, allocator
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        arch = api.encode(data, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        peak_enc = torch.cuda.max_memory_allocated(dev) / (1 << 30)
        torch.cuda.reset_peak_memory_stats(dev)
        back = api.decode(arch, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak_dec = torch.cuda.max_memory_allocated(dev) / (1 << 30)
        if back != data:
            raise AssertionError("round trip is not byte-equal")
        del back
        t_enc, t_dec = {}, {}
        if api.encode(data, device=dev, _timings=t_enc) != arch:
            raise AssertionError("the archive differs between two calls")
        if api.decode(arch, device=dev, _timings=t_dec) != data:
            raise AssertionError("round trip (with _timings) is not byte-equal")
        runs.append({"encode": t1 - t0, "decode": t2 - t1, "peak GiB encode": peak_enc,
                     "peak GiB decode": peak_dec,
                     **{f"encode {k}": v for k, v in t_enc.items()},
                     **{f"decode {k}": v for k, v in t_dec.items()},
                     "archive": len(arch)})
    print(json.dumps({"root": str(root), "device": torch.cuda.get_device_name(0), "runs": runs}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.a, args.reps, args.mib)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    runs = {"A": [], "B": []}
    for label in ("A", "B", "B", "A"):
        root = args.a if label == "A" else args.b
        out = subprocess.run(
            [sys.executable, __file__, str(root), str(root), "--worker", "--reps", str(args.reps),
             "--mib", str(args.mib)], check=True, capture_output=True, text=True).stdout
        line = out.strip().splitlines()[-1]
        print(f"{label} {line}")
        runs[label] += json.loads(line)["runs"]
    if {r["archive"] for r in runs["A"]} != {r["archive"] for r in runs["B"]}:
        raise AssertionError("the two checkouts wrote archives of different sizes")
    for label, root in (("A", args.a), ("B", args.b)):
        keys = [k for k in runs[label][0] if k != "archive"]
        med = {k: statistics.median(r[k] for r in runs[label]) for k in keys}
        print(f"median {label} ({root}, {len(runs[label])} round trips): {json.dumps(med)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
