"""What the first touch of a new result costs on this host, and what takes it off the copy.

    python3 scripts/host_pages.py [--mib 1024] [--piece-mib 256]

``api.decode`` copies each range of its output from a pinned slot into
the returned ``bytes`` (``api._Output``), whose pages are new: each is
faulted in and zeroed on its first write.  This script times, for a
result of ``--mib`` MiB filled ``--piece-mib`` MiB at a time from a
pinned slot (a pageable one without CUDA):

- ``copy``: ``Tensor.copy_`` into new pages at 1, 2, 4 and
  ``torch.get_num_threads()`` intra-op threads, into the same pages
  again (touched), and into new pages advised ``MADV_HUGEPAGE``;
- ``populate``: ``madvise(MADV_POPULATE_WRITE)`` of the whole result by
  1, 2 and 4 threads over disjoint pieces, with and without
  ``MADV_HUGEPAGE`` (None where the kernel refuses it);
- ``prefault``: ``api._Output.prefault`` of the whole result (threads
  writing a byte a page) at 1, 2, 4 and 8 threads, until ``ready``, and
  the copy into the prefaulted pages;
- with CUDA, the D2H of one piece into the pinned slot.

Prints the host (cores, the machine's transparent huge page mode, the
kernel) and one JSON line of GB/s a case.  Every number is this host's:
run it where the card is.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import platform
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from redux_tpu_torch import api  # noqa: E402

MADV_HUGEPAGE = 14
MADV_POPULATE_WRITE = 23
HUGE = 2 << 20
_libc = ctypes.CDLL(None, use_errno=True)
_libc.madvise.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]


def _madvise(a: int, b: int, advice: int) -> bool:
    return _libc.madvise(a, b - a, advice) == 0


def _thp() -> dict:
    out = {}
    for key in ("enabled", "defrag"):
        try:
            out[key] = Path(f"/sys/kernel/mm/transparent_hugepage/{key}").read_text().strip()
        except OSError:
            out[key] = "absent"
    return out


def _fill(out: api._Output, src: torch.Tensor, piece: int) -> float:
    """Seconds to copy ``src`` into ``out`` one piece at a time."""
    t0 = time.perf_counter()
    for a in range(0, out.n, piece):
        b = min(a + piece, out.n)
        out.view[a:b].copy_(src[: b - a])
    return time.perf_counter() - t0


def _populate(out: api._Output, threads: int, huge: bool) -> tuple[float, bool]:
    addr = out.view.data_ptr()
    if huge:
        _madvise((addr + HUGE - 1) & ~(HUGE - 1), (addr + out.n) & ~(HUGE - 1), MADV_HUGEPAGE)
    lo, hi = addr & ~4095, (addr + out.n + 4095) & ~4095
    step = -(-(hi - lo) // threads + 4095) // 4096 * 4096
    ok = []

    def run(a):
        ok.append(_madvise(a, min(a + step, hi), MADV_POPULATE_WRITE))

    workers = [threading.Thread(target=run, args=(a,)) for a in range(lo, hi, step)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    return time.perf_counter() - t0, all(ok)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=1024)
    ap.add_argument("--piece-mib", type=int, default=256)
    args = ap.parse_args()
    n, piece = args.mib << 20, args.piece_mib << 20
    cuda = torch.cuda.is_available()
    if cuda:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    host = {"cpus": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads(), "kernel": platform.release(),
            "thp": _thp()}
    print("host " + json.dumps(host))
    src = torch.empty(piece, dtype=torch.uint8, pin_memory=cuda)
    src.fill_(7)
    gbs = {}
    full = torch.get_num_threads()
    for threads in sorted({1, 2, 4, full}):
        torch.set_num_threads(threads)
        with api._Output(n) as out:
            gbs[f"copy new t{threads}"] = n / _fill(out, src, piece) / 1e9
            gbs[f"copy touched t{threads}"] = n / _fill(out, src, piece) / 1e9
        with api._Output(n) as out:
            addr = out.view.data_ptr()
            _madvise((addr + HUGE - 1) & ~(HUGE - 1), (addr + n) & ~(HUGE - 1), MADV_HUGEPAGE)
            gbs[f"copy new huge t{threads}"] = n / _fill(out, src, piece) / 1e9
    torch.set_num_threads(full)
    for threads in (1, 2, 4):
        for huge in (False, True):
            with api._Output(n) as out:
                s, ok = _populate(out, threads, huge)
                gbs[f"populate{' huge' if huge else ''} x{threads}"] = n / s / 1e9 if ok else None
                if huge and threads == 4:
                    gbs["copy populated huge"] = n / _fill(out, src, piece) / 1e9
    for threads in (1, 2, 4, 8):
        with api._Output(n) as out:
            out.TOUCH_THREADS = threads
            t0 = time.perf_counter()
            out.prefault(0, n)
            out.ready(0, n)
            gbs[f"prefault x{threads}"] = n / (time.perf_counter() - t0) / 1e9
            if threads == api._Output.TOUCH_THREADS:
                gbs["copy prefaulted"] = n / _fill(out, src, piece) / 1e9
    if cuda:
        dev_buf = torch.empty(piece, dtype=torch.uint8, device="cuda")
        dev_buf.fill_(3)
        src.copy_(dev_buf, non_blocking=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            src.copy_(dev_buf, non_blocking=True)
        torch.cuda.synchronize()
        gbs["d2h pinned"] = 4 * piece / (time.perf_counter() - t0) / 1e9
    print("GB/s " + json.dumps({k: (round(v, 3) if v else v) for k, v in gbs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
