"""Device time of the port's kernels for several checkouts, in turns on one card.

    python3 scripts/ab_kernels.py DIR [DIR ...] [--reps 5]

Each checkout runs as a fresh process, in the order given and then in
reverse (A, B, B, A for two): it builds its kernels and prints ptxas's
registers, shared memory and spills a kernel, then times each kernel's
wrapper on ``cuda:0`` with CUDA events (the mean of ``--reps`` launches
after one warm-up) at the two shapes ``chip_smoke.py`` reads: 1024 blocks
of 4096 (``cuda_checks.phase3_data``, seed 7, its phase 3) and the main
path's 16384 blocks of 4096 (64 MiB of ``testdata.mixed``, seed 2024);
tpu_wide, delta 16, the warm-start prior.  K1 feeds K2, K2's streams feed
K3 on lanes sorted by coded length (the main path's staging), and K4 and
K5 code the symbols.  The staging kernels S1 (``gather_rows``: the
archive's streams as K3's words, and its raw blocks' bytes, ``_bytes``),
S2 (``splice_payload``) and S3 (``crc32``) run through each checkout's
own ``cuda_checks.compare_staging`` (which holds them to their plain
versions) at the main path's 16384 blocks and at an encode chunk's 65536
blocks of 4096 (256 MiB of ``testdata.mixed``, seed 2024): the kernel's
launch alone and a call of its wrapper with its checks (``_call``).  Both
checkouts are timed alike by this script's own timers, put in place of
their ``cuda_checks`` timers: a kernel on the card's clock after a sleep
kernel that lets the host queue its runs (so a kernel shorter than its
launch's host work is timed back to back), a wrapper call by the wall
clock until its result is on the card.  Every
process prints one JSON line with the times and a digest of each kernel's
outputs (for S2 and S3 the archive of the input, which holds the payload
and the CRC); every checkout's digests must equal the first one's (the
same bytes).  Then per checkout the median time of each kernel at each
shape, in milliseconds.  Compare versions only within one call: cards and
hosts differ between calls.

    python3 scripts/ab_kernels.py DIR [DIR ...] --routes [--blocks 1,188] [--reps 5]

times K3's two routes instead (``decode_blocks``' private ``_route``; a
checkout without it times its one route as ``thread``): at each block
count B of ``--blocks`` (:data:`ROUTE_BLOCKS` by default), the first B
blocks of ``cuda_checks.phase3_data`` (4096 bytes, seed 7) coded by K1 ->
K2 and staged sorted by coded length as ``api.decode`` stages them, in
both instantiations
(tpu_wide and the reference CLI's (8,30,32), delta 16, the prior).  The
two routes' symbols must be equal.  Then per checkout the median ms of
each route at each B, and the crossover: the least B at which the thread
route is faster.

    python3 scripts/ab_kernels.py DIR [DIR ...] --histogram [--reps 5]

times pass 1's byte histogram instead: S4 (``ops.staging``'s
``launch_byte_histogram``, the kernel alone, and ``byte_histogram``, a
call and a wait, ``_call``) where the checkout has it, ``torch.bincount``
(CUDA events around a call, its host read of the largest byte inside, and
the wall clock of a call, ``_call``) and the plain version on the host
(``byte_histogram_plain``, else ``torch.bincount``, on a CPU tensor), over
21,504 and 768,771 bytes (the Calgary corpus's smallest and largest
files), 64 MiB and 256 MiB (a lane chunk) of ``text_like``, ``mixed`` and
``incompressible`` (seed 2024) and of one byte value (0x61), each beside
its bound: the bytes read once at 3.35 TB/s.  Every count must equal
``np.bincount``'s.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SHAPES = ("1024x4096", "16384x4096", "65536x4096")
STAGING = ("gather_rows", "splice_payload", "crc32")
ROUTE_BLOCKS = (1, 6, 48, 188, 512, 1024, 2048, 3072, 4096, 8192, 16384)
ROUTE_PARAMS = {"tpu_wide": (8, 20, 22), "ref30": (8, 30, 32)}
HIST_SIZES = {"21504": 21_504, "768771": 768_771, "64MiB": 64 << 20, "256MiB": 256 << 20}
HIST_KINDS = ("text_like", "mixed", "incompressible", "run_61")
PEAK_BYTES_PER_S = 3.35e12


def device_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device ms of ``fn()``: CUDA events around ``reps`` runs queued
    behind a sleep kernel."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000 * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean wall ms of ``fn()`` and a wait for the card."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def time_alike(cuda_checks) -> None:
    """Put one timer in place of a checkout's ``cuda_checks.cuda_ms`` (and
    ``call_ms``, where it has one): a run through one of its ``launch_*``
    entries (a kernel alone) is timed by :func:`device_ms`, any other (a
    wrapper call) by :func:`wall_ms`."""
    alone = {"hit": False}
    for name in ("launch_crc32", "launch_splice_payload", "launch_gather_rows"):
        def marked(*args, _f=getattr(cuda_checks, name)):
            alone["hit"] = True
            return _f(*args)
        setattr(cuda_checks, name, marked)

    def timer(fn, reps=3, warmup=1):
        alone["hit"] = False
        fn()  # the warm-up run tells which
        return (device_ms if alone["hit"] else wall_ms)(fn, reps, warmup=0)

    cuda_checks.cuda_ms = cuda_checks.call_ms = timer


def worker(root: Path, reps: int) -> None:
    sys.path.insert(0, str(root))
    import torch

    import redux_tpu_torch
    from redux_tpu_torch import _build, api, cuda_checks, testdata
    from redux_tpu_torch.ops.decode import decode_blocks
    from redux_tpu_torch.ops.encode import encode_blocks, encode_blocks_fused
    from redux_tpu_torch.ops.encode_m import encode_blocks_m
    from redux_tpu_torch.ops.model import model_lohi

    if not Path(redux_tpu_torch.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {redux_tpu_torch.__file__}, not the one under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda", 0)
    _build.lib()
    params, delta, k = api.Parameters.tpu_wide(), 16, 4096
    inputs = {"1024x4096": cuda_checks.phase3_data(1024, k, 7),
              "16384x4096": testdata.mixed(64 << 20, 2024)}
    times, digests = {}, {}
    for shape, data in inputs.items():
        x = cuda_checks.KernelInputs(data, params, delta, k, dev)
        sym = (x.syms, x.lens, x.init_cum, params, x.n_words, delta)
        lo, hi = model_lohi(x.syms, x.lens, x.init_cum, params, delta)
        enc = (lo, hi, x.lens, x.init_total, params, x.n_words, delta)
        words, bl, ovf = encode_blocks(*enc)
        raw = ovf | (bl >= x.lens)
        order = torch.argsort(torch.where(raw, 0, bl), stable=True)
        klens = torch.where(raw, 0, x.lens).to(torch.int32)[order].contiguous()
        staged = torch.nn.functional.pad(words, (0, 2))[order].contiguous()
        dec = (staged, klens, x.init_cum, params, k, delta)
        runs = {
            "model_values": lambda: model_lohi(x.syms, x.lens, x.init_cum, params, delta),
            "encode": lambda: encode_blocks(*enc),
            "decode": lambda: decode_blocks(*dec),
            "encode_fused": lambda: encode_blocks_fused(*sym),
            "encode_m": lambda: encode_blocks_m(*sym),
        }
        times[shape] = {name: device_ms(fn, reps) for name, fn in runs.items()}
        h = {}
        for name, fn in runs.items():
            out = fn()
            h[name] = hashlib.sha256(b"".join(
                t.cpu().numpy().tobytes() for t in (out if isinstance(out, tuple) else (out,))
            )).hexdigest()[:16]
        digests[shape] = h
    inputs["65536x4096"] = testdata.mixed(256 << 20, 2024)
    time_alike(cuda_checks)
    for shape in SHAPES[1:]:
        res = cuda_checks.compare_staging(inputs[shape], dev, k, time_plain=False, reps=reps)
        times.setdefault(shape, {})
        for name in STAGING:
            times[shape][name] = res[name]["ms"]
            times[shape][name + "_call"] = res[name]["ms_call"]
        times[shape]["gather_rows_bytes"] = res["gather_rows"]["ms_bytes"]
        arch = api.encode(inputs[shape], block_size=k, device=dev)
        digests.setdefault(shape, {})["archive"] = hashlib.sha256(arch).hexdigest()[:16]
    print(json.dumps({"root": str(root), "device": torch.cuda.get_device_name(0),
                      "ptxas": _build.resource_usage(), "ms": times, "digests": digests}))


def route_worker(root: Path, reps: int, blocks: tuple) -> None:
    """K3's routes at each B of ``blocks`` (module docstring)."""
    sys.path.insert(0, str(root))
    import inspect

    import torch

    import redux_tpu_torch
    from redux_tpu_torch import _build, cuda_checks
    from redux_tpu_torch.ops.decode import decode_blocks
    from redux_tpu_torch.ops.encode import encode_blocks
    from redux_tpu_torch.ops.model import model_lohi
    from redux_tpu_torch.params import Parameters

    if not Path(redux_tpu_torch.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {redux_tpu_torch.__file__}, not the one under {root}")
    dev = torch.device("cuda", 0)
    _build.lib()
    routes = ("warp", "thread") if "_route" in inspect.signature(decode_blocks).parameters else (
        None,)
    delta, k, n = 16, 4096, max(blocks)
    data = cuda_checks.phase3_data(n, k, 7)
    times, digests = {}, {}
    for name, cfg in ROUTE_PARAMS.items():
        params = Parameters(*cfg)
        x = cuda_checks.KernelInputs(data, params, delta, k, dev)
        lo, hi = model_lohi(x.syms, x.lens, x.init_cum, params, delta)
        words, bl, ovf = encode_blocks(lo, hi, x.lens, x.init_total, params, x.n_words, delta)
        del lo, hi
        raw = ovf | (bl >= x.lens)
        wire = torch.where(raw, 0, bl)
        klens_all = torch.where(raw, 0, x.lens).to(torch.int32)
        padded = torch.nn.functional.pad(words, (0, 2))
        for b in blocks:
            order = torch.argsort(wire[:b], stable=True)
            dec = (padded[:b][order].contiguous(), klens_all[:b][order].contiguous(), x.init_cum,
                   params, k, delta)
            outs = {}
            for route in routes:
                kw = {} if route is None else {"_route": route}
                outs[route or "thread"] = (device_ms(lambda: decode_blocks(*dec, **kw), reps),
                                           decode_blocks(*dec, **kw))
            syms = [o for _, o in outs.values()]
            if any(not torch.equal(syms[0], o) for o in syms[1:]):
                raise AssertionError(f"{name} B={b}: the routes' symbols differ")
            times[f"{name}/{b}"] = {r: ms for r, (ms, _) in outs.items()}
            digests[f"{name}/{b}"] = hashlib.sha256(syms[0].cpu().numpy().tobytes()).hexdigest()[:16]
    print(json.dumps({"root": str(root), "device": torch.cuda.get_device_name(0),
                      "ptxas": _build.resource_usage(), "ms": times, "digests": digests}))


def event_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` between CUDA events recorded around each call:
    for a call that waits for the card inside (``torch.bincount``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def histogram_worker(root: Path, reps: int) -> None:
    """Pass 1's byte histogram over :data:`HIST_SIZES` of each of
    :data:`HIST_KINDS` (module docstring)."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import redux_tpu_torch
    from redux_tpu_torch import _build, testdata
    from redux_tpu_torch.ops import staging

    if not Path(redux_tpu_torch.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {redux_tpu_torch.__file__}, not the one under {root}")
    dev = torch.device("cuda", 0)
    own = hasattr(staging, "launch_byte_histogram")
    if own:
        _build.lib()
    plain = getattr(staging, "byte_histogram_plain",
                    lambda u8, out: out.add_(torch.bincount(u8, minlength=256)))
    times, digests = {}, {}
    for kind in HIST_KINDS:
        n_max = max(HIST_SIZES.values())
        if kind == "run_61":
            host = np.full(n_max, 0x61, dtype=np.uint8)
        else:
            host = np.frombuffer(getattr(testdata, kind)(n_max, 2024), np.uint8)
        full = torch.from_numpy(host).to(dev)
        for label, n in HIST_SIZES.items():
            t, t_host = full[:n], torch.from_numpy(host[:n])
            want = np.bincount(host[:n], minlength=256)
            row = torch.zeros(256, dtype=torch.int64, device=dev)
            res = {"bound": n / PEAK_BYTES_PER_S * 1e3}
            if own:
                res["s4"] = device_ms(lambda: staging.launch_byte_histogram(t, row), reps)
                res["s4_call"] = wall_ms(lambda: staging.byte_histogram(t, row), reps)
                got = staging.byte_histogram(t, row.zero_()).cpu().numpy()
            else:
                got = torch.bincount(t, minlength=256).cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"{kind}/{label}: counts differ from np.bincount")
            res["bincount"] = event_ms(lambda: torch.bincount(t, minlength=256), reps)
            res["bincount_call"] = wall_ms(lambda: torch.bincount(t, minlength=256), reps)
            res["plain"] = wall_ms(lambda: plain(t_host, torch.zeros(256, dtype=torch.int64)),
                                   reps)
            times[f"{kind}/{label}"] = res
            digests[f"{kind}/{label}"] = hashlib.sha256(got.tobytes()).hexdigest()[:16]
    print(json.dumps({"root": str(root), "device": torch.cuda.get_device_name(0),
                      "ptxas": _build.resource_usage() if own else [], "ms": times,
                      "digests": digests}))


def crossover(med: dict, name: str, blocks: tuple):
    """The least B of ``blocks`` at which the thread route beats the warp
    route in ``med`` (None if it never does)."""
    return next((b for b in blocks
                 if med[f"{name}/{b}"].get("warp", 0) > med[f"{name}/{b}"]["thread"]), None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", type=Path, nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--routes", action="store_true", help="time K3's two routes over B")
    ap.add_argument("--blocks", default=",".join(map(str, ROUTE_BLOCKS)),
                    help="the block counts of --routes, comma-separated")
    ap.add_argument("--histogram", action="store_true",
                    help="time S4 against torch.bincount over sizes and kinds")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    blocks = tuple(int(b) for b in args.blocks.split(","))
    if args.worker:
        if args.routes:
            route_worker(args.dirs[0], args.reps, blocks)
        elif args.histogram:
            histogram_worker(args.dirs[0], args.reps)
        else:
            worker(args.dirs[0], args.reps)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    runs = {d: [] for d in args.dirs}
    first = None
    for d in [*args.dirs, *reversed(args.dirs)]:
        out = subprocess.run([sys.executable, __file__, str(d), "--worker", "--reps",
                              str(args.reps), *(["--routes", "--blocks", args.blocks]
                                                if args.routes else []),
                              *(["--histogram"] if args.histogram else [])],
                             check=True, capture_output=True, text=True).stdout
        res = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({k: res[k] for k in ("root", "ptxas", "ms")}))
        first = first or res["digests"]
        if res["digests"] != first:
            raise AssertionError(f"{d}: outputs differ from {args.dirs[0]}'s: {res['digests']}")
        runs[d].append(res["ms"])
    for d, rs in runs.items():
        med = {s: {name: round(statistics.median(r[s][name] for r in rs), 4) for name in rs[0][s]}
               for s in rs[0]}
        print(f"median {d} ({len(rs)} runs): {json.dumps(med)}")
        if args.routes:
            print(f"crossover {d}: "
                  + json.dumps({n: crossover(med, n, blocks) for n in ROUTE_PARAMS}))
    print("outputs equal in every run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
