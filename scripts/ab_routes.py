"""Wall clock of the port's default route for two or more checkouts, in turns on one card.

    python3 scripts/ab_routes.py A_DIR B_DIR [C_DIR ...] [--reps 5] [--mib 64]

Each checkout runs as a fresh process, in the order A, B, ..., then the
reverse (A, B, B, A for two): it builds its kernels, warms up on 4 MiB,
then runs ``--reps`` times two round trips of
``redux_tpu_torch.api.encode`` -> ``decode`` on ``--mib`` MiB of
``testdata.mixed`` (seed 2024, the input of ``chip_smoke.py``; made once,
by the first checkout's ``testdata``, into a file under ``build/`` that
every process reads and that is deleted at the end) on ``cuda:0``, each
verified byte for byte: one for the wall clock, one with ``_timings`` for
the host phases (each phase's mark waits for the card, which serializes
work that otherwise overlaps).  Prints one JSON line a process, then per
checkout the median over all its round trips of the encode and decode
wall clock and of each host phase, in seconds, and of each way's peak
device memory (the allocator's), in GiB.  Compare versions only within
one call: the host's noise between calls exceeds the differences this
measures.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def worker(root: Path, reps: int, data_file: Path) -> None:
    sys.path.insert(0, str(root))
    import torch

    import redux_tpu_torch
    from redux_tpu_torch import api

    if not Path(redux_tpu_torch.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {redux_tpu_torch.__file__}, not the one under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda", 0)
    data = data_file.read_bytes()
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
    ap.add_argument("dirs", type=Path, nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.dirs[0], args.reps, args.worker)
        return 0
    if len(args.dirs) < 2:
        ap.error("give two checkouts or more")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    data_file = Path(__file__).resolve().parent.parent / "build" / f"ab_routes_{args.mib}.bin"
    data_file.parent.mkdir(exist_ok=True)
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                    "from redux_tpu_torch import testdata; "
                    "open(sys.argv[2], 'wb').write(testdata.mixed(int(sys.argv[3]) << 20, 2024))",
                    str(args.dirs[0]), str(data_file), str(args.mib)], check=True)
    labels = [chr(ord("A") + i) for i in range(len(args.dirs))]
    runs = {label: [] for label in labels}
    try:
        for label in labels + labels[::-1]:
            root = args.dirs[labels.index(label)]
            out = subprocess.run(
                [sys.executable, __file__, str(root), "--worker", str(data_file), "--reps",
                 str(args.reps)], check=True, capture_output=True, text=True).stdout
            line = out.strip().splitlines()[-1]
            print(f"{label} {line}")
            runs[label] += json.loads(line)["runs"]
    finally:
        data_file.unlink()
    if len({r["archive"] for rs in runs.values() for r in rs}) != 1:
        raise AssertionError("the checkouts wrote archives of different sizes")
    for label, root in zip(labels, args.dirs):
        keys = [k for k in runs[label][0] if k != "archive"]
        med = {k: statistics.median(r[k] for r in runs[label]) for k in keys}
        print(f"median {label} ({root}, {len(runs[label])} round trips): {json.dumps(med)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
