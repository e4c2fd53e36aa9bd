"""Wall clock of the port's default route for two or more checkouts, in turns, on device lists.

    python3 scripts/ab_routes.py A_DIR B_DIR [C_DIR ...] [--reps 5] [--mib 64]
        [--devices 0 --devices 0,0 --devices 0,1,2,3] [--weak MIB]

Each checkout runs as a fresh process, in the order A, B, ..., then the
reverse (A, B, B, A for two): it builds its kernels, warms up on 4 MiB on
every card of the lists, then runs ``--reps`` times, for each device list
of ``--devices`` (default ``0``: card 0 alone; ``0,0`` is two shares on
card 0; a list of one card passes that card alone, the one-card route),
two round trips of ``redux_tpu_torch.api.encode`` -> ``decode`` on
``--mib`` MiB of ``testdata.mixed`` (seed 2024, the input of
``chip_smoke.py``; made once, by the first checkout's ``testdata``, into a
file under ``build/`` that every process reads and that is deleted at the
end), each verified byte for byte and each list's archive against the
first list's: one for the wall clock, each card's peak device memory (the
allocator's) each way and the host RSS at each call's end, one with
``_timings`` for the host phases and their parts (no mark waits for the
cards).  With ``--weak MIB``
each rep also times encode + decode of ``MIB x n`` MiB (the input's
first bytes) over cards ``0 .. n-1`` for n = 1, 2, 4 as far as there are
cards and input: weak scaling, with the efficiency ``t(1) / t(n)`` of the
medians.  Prints the card's name and power limit, one JSON line a
process, then per checkout the median over all its round trips of every
number, in seconds and GiB.  Compare versions only within one call: the
host's noise between calls exceeds the differences this measures.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _rss_gib() -> float:
    """This process's resident set now, GiB (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / (1 << 30)


def worker(root: Path, reps: int, data_file: Path, lists: list, weak: int) -> None:
    sys.path.insert(0, str(root))
    import torch

    import redux_tpu_torch
    from redux_tpu_torch import api

    if not Path(redux_tpu_torch.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {redux_tpu_torch.__file__}, not the one under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    n_cards = torch.cuda.device_count()
    data = data_file.read_bytes()
    weak_n = [n for n in (1, 2, 4) if n <= n_cards and weak * n << 20 <= len(data)] if weak else []

    def devices(spec):
        devs = [torch.device("cuda", int(i)) for i in spec.split(",")]
        return devs[0] if len(devs) == 1 else devs

    cards = sorted({int(i) for spec in lists for i in spec.split(",")} | set(range(max(weak_n,
                                                                                     default=0))))
    for c in cards:
        api.encode(data[: 4 << 20], device=torch.device("cuda", c))  # build, launches, allocator
        torch.cuda.synchronize(c)

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    def peaks(way):
        """Each card's peak since the last call, GiB, and a new reset."""
        out = {}
        for c in cards:
            out[f"peak GiB {way} cuda:{c}"] = torch.cuda.max_memory_allocated(c) / (1 << 30)
            torch.cuda.reset_peak_memory_stats(c)
        return out

    runs = []
    first = None
    for _ in range(reps):
        run = {}
        for spec in lists:
            dev = devices(spec)
            peaks("before")
            t0 = time.perf_counter()
            arch = api.encode(data, device=dev)
            sync()
            t1 = time.perf_counter()
            rec = {"encode": t1 - t0, "rss GiB encode": _rss_gib(), **peaks("encode")}
            t1 = time.perf_counter()
            back = api.decode(arch, device=dev)
            sync()
            rec |= {"decode": time.perf_counter() - t1, "rss GiB decode": _rss_gib(),
                    **peaks("decode")}
            if back != data:
                raise AssertionError(f"[{spec}]: round trip is not byte-equal")
            del back
            first = first or arch
            if arch != first:
                raise AssertionError(f"[{spec}]: the archive differs from [{lists[0]}]'s")
            t_enc, t_dec = {}, {}
            if api.encode(data, device=dev, _timings=t_enc) != arch:
                raise AssertionError(f"[{spec}]: the archive differs between two calls")
            if api.decode(arch, device=dev, _timings=t_dec) != data:
                raise AssertionError(f"[{spec}]: round trip (with _timings) is not byte-equal")
            rec |= {f"encode {k}": v for k, v in t_enc.items()}
            rec |= {f"decode {k}": v for k, v in t_dec.items()}
            rec["archive"] = len(arch)
            del arch
            run |= {f"[{spec}] {k}": v for k, v in rec.items()}
        for n in weak_n:
            part = data[: weak * n << 20]
            dev = devices(",".join(map(str, range(n))))
            t0 = time.perf_counter()
            arch = api.encode(part, device=dev)
            sync()
            t1 = time.perf_counter()
            back = api.decode(arch, device=dev)
            sync()
            t2 = time.perf_counter()
            if back != part:
                raise AssertionError(f"weak n={n}: round trip is not byte-equal")
            del back, arch
            run |= {f"weak {n} encode": t1 - t0, f"weak {n} decode": t2 - t1,
                    f"weak {n} encode+decode": t2 - t0}
        runs.append(run)
    print(json.dumps({"root": str(root), "device": torch.cuda.get_device_name(0),
                      "cards": n_cards, "runs": runs}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", type=Path, nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--devices", action="append",
                    help="a device list, card indices joined by commas; repeat for more lists")
    ap.add_argument("--weak", type=int, default=0, help="MiB a card for the weak-scaling line")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    lists = args.devices or ["0"]
    if args.worker:
        worker(args.dirs[0], args.reps, args.worker, lists, args.weak)
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
                 str(args.reps), "--weak", str(args.weak),
                 *[a for spec in lists for a in ("--devices", spec)]],
                check=True, capture_output=True, text=True).stdout
            line = out.strip().splitlines()[-1]
            print(f"{label} {line}")
            runs[label] += json.loads(line)["runs"]
    finally:
        data_file.unlink()
    if len({v for rs in runs.values() for r in rs for k, v in r.items()
            if k.endswith(" archive")}) != 1:
        raise AssertionError("the checkouts or device lists wrote archives of different sizes")
    for label, root in zip(labels, args.dirs):
        keys = [k for k in runs[label][0] if not k.endswith(" archive")]
        med = {k: statistics.median(r[k] for r in runs[label]) for k in keys}
        for n in (2, 4):
            if f"weak {n} encode+decode" in med:
                med[f"weak {n} efficiency"] = (med["weak 1 encode+decode"]
                                               / med[f"weak {n} encode+decode"])
        print(f"median {label} ({root}, {len(runs[label])} reps): {json.dumps(med)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
