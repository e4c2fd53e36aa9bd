"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``redux_tpu_torch/csrc/``, checks each
against its plain PyTorch version on the card (and the fused K4 and the
model-in-kernel K5 against K2's streams; the staging kernels S1-S3 also
against zlib's crc32, K2's words and the archive's payload; S4 against its
plain version on the same bytes on the host), checks the
golden archives of ``tests/golden_torch/``, then drives
``redux_tpu_torch.api.encode`` -> ``decode`` over 64 MiB of generated
data three ways: the default route (K1 -> K2, K3, with S1 row gather, S2
payload splice, S3 crc32 and S4 byte histogram around them: the data
crosses the bus once each way), the fused route (``REDUX_TPU_ENC_FUSED=1``: K4), and over the
device lists ``data_parallel_mesh()`` and ``[dev, dev]`` (each card
uploads, codes, splices, checks and fetches its own shares: its launches
must be what the share plan ``api._shares`` gives it, its peak device
memory under one card's reckoning), plus the sharded K5 entry at the
main path's shapes.  Each route's archive must equal the default route's,
each round trip must be byte-equal, and each route must have launched
its kernels (counts reset just before it, read just after).  Phase 8 drives the other routes: the
CLI at its defaults ((8,30,32), K1 -> K2 and K3 in their u64
instantiations) over the same 64 MiB through files, those kernels against
their plain versions at the main shape, ``api.encode_auto`` ->
``decode_auto`` at 64 MiB and at 256 KiB (the compact range), and the
native serial codec through ``--format redux``.  Phase 9 runs the device
bench (``redux_tpu_torch.bench``) on the same 64 MiB, the generic-model
coders at 256 x 4096 of it against K1 + the reference-format coder, K3 and
the oracle, and the multi-host workers (``parallel.multihost``, two
processes over gloo, then the scaling worker at 1 and 2 processes; NCCL
too with two cards or more).  Phase 10 runs the randomized differential
campaign (``redux_tpu_torch.fuzz``) for a fixed seed: random configs of
every instantiation class, deltas, block sizes, contents and priors, K1-K5
against their plain versions and the native serial coder, the ``api``
route over several lane chunks and the generic coders.  Phase 11 runs at
multi-GB size: 2 GiB + 1 MiB of ``testdata.mixed`` through ``api.encode``
-> ``decode`` (nine lane chunks each way, one launch each of K1 and K2 a
chunk and of K3 a range of blocks, the encode's device memory held under
its reckoning from one chunk's shapes and the decode's under two ranges'
worth, two chunks held to the plain versions, S1-S4 held to
theirs on one 65,536-lane chunk), the same input over ``[dev, dev]`` and
over every card where there are two or more (archives byte-equal to the
one-card archive, launches a card as the share plan gives them, each
card's peak device memory printed), the bench on 256 MiB of
``text_like`` and on the first 1 GiB of the big input, the CLI over 512
MiB (two chunks each way at (8,30,32), one held to the plain versions),
and the container corruption sweep through K3, then phase 5's round trip
again.  Phases print one
line each; the line
before the last is the kernels' JSON summary (each kernel's time at the
main shapes beside its bound, ``cuda_checks.kernel_bounds`` and
``compare_staging``; ``library_ms`` is S4's ``torch.bincount`` on the
card, and null for the others, which no single PyTorch call computes) and the
last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero and prints no result; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import pathlib
import platform
import resource
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
MAIN_BYTES = 64 << 20
SEED = 2024
# Kernels of the default route: K1 -> K2, K3, and the staging kernels around them.
MAIN_PATH = ("model_values", "encode", "decode", "gather_rows", "splice_payload", "crc32",
             "histogram")
# Phase 10's campaign: a fixed seed, bounded by trials and by wall clock.
FUZZ_SEED, FUZZ_TRIALS, FUZZ_MINUTES = 17, 200, 1.25
# Phase 11, at size: past 2**31 bytes (where an int32 byte offset would
# wrap), 524,544 blocks of 4 KiB, nine lane chunks each way; the CLI at
# (8,30,32) over two chunks each way; the bench at two of PERF.md's cells
# (256 MiB of text_like, the first 1 GiB of the big input); the corruption
# sweep on a 1 MiB archive.
BIG_BYTES = (1 << 31) + (1 << 20)
CLI_BYTES = 512 << 20
BENCH_BYTES = (256 << 20, 1 << 30)
SWEEP_BYTES = 1 << 20


def _route(name, data, ref_arch, device, launched):
    """Encode and decode ``data`` on ``device`` (one device or a list) with
    the launch counts reset just before and read just after; check the
    archive against the default route's and the round trip, and which
    kernels ``launched``; print the wall clock and host phases."""
    import redux_tpu_torch
    from redux_tpu_torch import api

    redux_tpu_torch.reset_launch_counts()
    t_enc, t_dec = {}, {}
    t0 = time.perf_counter()
    arch = api.encode(data, device=device, _timings=t_enc)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = api.decode(arch, device=device, _timings=t_dec)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = redux_tpu_torch.launch_counts()
    if ref_arch is not None and arch != ref_arch:
        raise AssertionError(f"{name}: archive differs from the default route's")
    if back != data:
        raise AssertionError(f"{name}: round trip is not byte-equal")
    for k, must in launched.items():
        if (launches[k] > 0) != must:
            raise AssertionError(f"{name}: {k} launched {launches[k]} times")
    mb = len(data) / 1e6
    print(f"{name}: encode {mb / (t1 - t0):.3f} MB/s ({t1 - t0:.3f} s), decode "
          f"{mb / (t2 - t1):.3f} MB/s ({t2 - t1:.3f} s), wall clock with host work")
    print(f"{name}: encode phases s " + json.dumps({k: round(v, 4) for k, v in t_enc.items()}))
    print(f"{name}: decode phases s " + json.dumps({k: round(v, 4) for k, v in t_dec.items()}))
    print(f"{name}: launches {json.dumps(launches)}")
    return arch, launches


def _thp_mode() -> str:
    """The machine's transparent huge page settings (``enabled``, ``defrag``)."""
    out = []
    for key in ("enabled", "defrag"):
        try:
            mode = (pathlib.Path("/sys/kernel/mm/transparent_hugepage") / key).read_text()
            out.append(f"{key} {mode.strip()!r}")
        except OSError:
            out.append(f"{key} absent")
    return ", ".join(out)


def _cli(argv, dev):
    """``redux_tpu_torch.cli.main(argv)`` in-process (``--device cpu`` added
    off the card); returns its stderr line, raises unless it exits 0."""
    import io

    from redux_tpu_torch import cli

    err, saved = io.StringIO(), sys.stderr
    sys.stderr = err
    try:
        rc = cli.main(argv + ([] if dev.type == "cuda" else ["--device", "cpu"]))
    finally:
        sys.stderr = saved
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)}: exit {rc}: {err.getvalue().strip()}")
    return err.getvalue().strip()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _coders(counts):
    """The launch counts of K1-K5 alone (the staging kernels S1-S4 left out)."""
    from redux_tpu_torch import cuda_checks

    return {k: counts[k] for k in cuda_checks.KERNELS}


def phase8(dev, data, native_build_s, small_bytes=256 << 10, redux_bytes=1 << 20):
    """Phase 8: the routes and the CLI on ``data`` (the main input).

    (a) the CLI at its defaults through files under ``build/``; (b) K1-K3
    at (8,30,32) at the main shape against their plain versions, each
    beside its bound; (c) ``encode_auto`` -> ``decode_auto`` on ``data``
    (three block encodes, one decode); (d) the auto route in the compact
    range; (e) the native library through ``--format redux``.  Files go
    under ``build/chip_smoke/`` and are deleted at the end."""
    import shutil

    import redux_tpu_torch
    from redux_tpu_torch import api, container, cuda_checks, native, oracle, testdata

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        # (a) The CLI at its defaults: (8,30,32), delta 16, the prior, auto blocks.
        src, arch_f, back_f = work / "in.bin", work / "in.rxt", work / "back.bin"
        src.write_bytes(data)
        for mode, argv, must in (
                ("compress", ["-c", "-i", str(src), "-o", str(arch_f)], ("model_values", "encode")),
                ("decompress", ["-d", "-i", str(arch_f), "-o", str(back_f)], ("decode",))):
            redux_tpu_torch.reset_launch_counts()
            t0 = time.perf_counter()
            line = _cli(argv, dev)
            _sync(dev)
            dt = time.perf_counter() - t0
            counts = redux_tpu_torch.launch_counts()
            if not all(counts[k] > 0 for k in must):
                raise AssertionError(f"cli {mode}: launches {counts}")
            print(f"cli {mode}: {dt:.3f} s wall clock with file I/O, {line!r}, "
                  f"launches {json.dumps(counts)}")
        if back_f.read_bytes() != data:
            raise AssertionError("cli: round trip is not byte-equal")
        header, _ = container.parse_archive(arch_f.read_bytes())
        p = header.params
        print(f"cli: archive {arch_f.stat().st_size} bytes, ({p.symbol_bits},{p.freq_bits},"
              f"{p.code_bits}) delta {header.delta}, {header.n_blocks} blocks of "
              f"{header.block_size}, {sum(header.block_raw)} stored raw, round trip byte-equal")

        # (b) K1-K3 at (8,30,32) at the main shape (K2/K3: u64 divisions).
        x = cuda_checks.KernelInputs(data, api.Parameters.default(), 16, header.block_size, dev)
        res = cuda_checks.compare_kernels(x, time_plain=dev.type == "cuda")
        _sync(dev)
        for k in cuda_checks.KERNELS:
            r = res[k]
            if r.get("raises"):
                print(f"8_30_32 main-shape {k}: raises {r['raises']} (params off its path)")
                continue
            plain = f"{r['plain_ms']:.3f} ms" if r["plain_ms"] is not None else "not timed"
            print(f"8_30_32 main-shape {k}: kernel {r['ms']:.3f} ms, plain {plain}, bound "
                  f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes']} bytes, {r['ops']} "
                  f"int32 ops) ({x.syms.shape[0]} x {x.k}), equal")
        if not (res["encode_fused"].get("raises") and res["encode_m"].get("raises")):
            raise AssertionError("K4 and K5 must refuse (8,30,32)")

        # (c) encode_auto -> decode_auto at full size, params None.
        redux_tpu_torch.reset_launch_counts()
        t0 = time.perf_counter()
        auto = api.encode_auto(data, device=dev)
        _sync(dev)
        t1 = time.perf_counter()
        back = api.decode_auto(auto, device=dev)
        _sync(dev)
        t2 = time.perf_counter()
        counts = redux_tpu_torch.launch_counts()
        if back != data:
            raise AssertionError("auto: round trip is not byte-equal")
        want = {"model_values": 3, "encode": 3, "decode": 1, "encode_fused": 0, "encode_m": 0}
        if _coders(counts) != want or not all(counts[k] for k in cuda_checks.STAGING):
            raise AssertionError(f"auto: launches {counts}, want {want} and S1-S4")
        cands = {
            "prior": api.encode(data, use_prior=True, device=dev),
            "no prior": api.encode(data, use_prior=False, device=dev),
            "16 KiB blocks": api.encode(data, block_size=1 << 14, use_prior=True, device=dev),
        }
        best = min(cands.values(), key=len)
        if auto != best:
            raise AssertionError("auto: archive is not the smallest block-archive candidate")
        print(f"auto {len(data)} bytes: encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s wall "
              f"clock, archive {len(auto)} bytes, launches {json.dumps(counts)}; candidates "
              + ", ".join(f"{k} {len(v)}" for k, v in cands.items()))

        # (d) The compact range: block archives, compact archives, the bare stream.
        small = testdata.text_like(small_bytes, SEED)
        auto = api.encode_auto(small, device=dev)
        if api.decode_auto(auto, device=dev) != small:
            raise AssertionError("auto (compact range): round trip is not byte-equal")
        cands = {
            "rxt prior": api.encode(small, use_prior=True, device=dev),
            "rxt no prior": api.encode(small, use_prior=False, device=dev),
            **{f"compact cfg {c}": api.encode_compact(small, c) for c in api._COMPACT_AUTO_CFGS},
            "bare stream": native.compress_bytes(small),
        }
        won = [k for k, v in cands.items() if v == auto]
        if not won or len(auto) != min(map(len, cands.values())):
            raise AssertionError("auto (compact range): not the smallest candidate")
        print(f"auto {len(small)} bytes: {won[0]} won at {len(auto)} bytes; candidates "
              + ", ".join(f"{k} {len(v)}" for k, v in cands.items()))

        # (e) The native serial codec through the CLI's --format redux.
        text = testdata.text_like(redux_bytes, SEED + 1)
        src, stream_f, back_f = work / "text.bin", work / "text.rdx", work / "text.back"
        src.write_bytes(text)
        t0 = time.perf_counter()
        _cli(["-c", "--format", "redux", "-i", str(src), "-o", str(stream_f)], dev)
        t1 = time.perf_counter()
        _cli(["-d", "-i", str(stream_f), "-o", str(back_f)], dev)
        t2 = time.perf_counter()
        if back_f.read_bytes() != text:
            raise AssertionError("cli --format redux: round trip is not byte-equal")
        head = text[: 16 << 10]
        if native.compress_bytes(head) != oracle.compress_bytes(head):
            raise AssertionError("native: differs from the oracle on 16 KiB")
        print(f"native: {native.library_path().name} built in {native_build_s:.3f} s; cli "
              f"--format redux {len(text)} -> {stream_f.stat().st_size} bytes in "
              f"{t1 - t0:.3f} s, back in {t2 - t1:.3f} s, byte-equal; 16 KiB equal to the oracle")
        print(f"phase 8: {time.perf_counter() - t_phase:.3f} s wall clock")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase9(dev, data, arch, generic_blocks=256, worker_bytes=32 << 20, worker_timeout=300):
    """Phase 9: the bench, the generic models and multi-host.

    (a) ``bench.run_device_benchmark`` on ``data`` (phase 5's input), its
    dict on one JSON line: verified, and its ratio that of phase 5's
    archive ``arch``; (b) ``cuda_checks.check_generic`` over the first
    ``generic_blocks`` blocks of 4096 of ``data``, with its wall clock and
    launches; (c) two multi-host workers over gloo on the visible card(s),
    then the scaling worker at N = 1 and N = 2, ``worker_bytes`` a process;
    with two cards or more, the same over NCCL, one card a rank.  Any
    worker that fails or times out fails the phase."""
    import redux_tpu_torch
    from redux_tpu_torch import bench, cuda_checks

    t_phase = time.perf_counter()
    # (a) The bench at the shipped defaults, device-resident.
    res = bench.run_device_benchmark(data, device=dev)
    print("bench " + json.dumps(res))
    if not res["verified"]:
        raise AssertionError("bench: round trip not verified")
    if res["ratio"] != len(data) / len(arch):
        raise AssertionError(f"bench: ratio {res['ratio']} is not phase 5's archive's")

    # (b) The generic models on the card.
    redux_tpu_torch.reset_launch_counts()
    t0 = time.perf_counter()
    g = cuda_checks.check_generic(dev, data, n_blocks=generic_blocks)
    _sync(dev)
    dt = time.perf_counter() - t0
    counts = redux_tpu_torch.launch_counts()
    if counts["model_values"] < 1 or counts["decode"] < 1:
        raise AssertionError(f"generic: launches {counts}")
    print(f"generic {g['blocks']} x {g['k']}: dense streams ({g['stream_bytes']} bytes) equal "
          f"K1 + coder.encode_blocks; K3 and decode_blocks_generic give back the input; static "
          f"and two-speed models equal the oracle on {g['oracle_blocks']} blocks; {dt:.3f} s wall "
          f"clock, launches {json.dumps(counts)}; steps s "
          + json.dumps({k: round(v, 4) for k, v in g["seconds"].items()}))

    # (c) Multi-host: worker processes on this machine's card(s).
    phase9_multihost(dev, worker_bytes, worker_timeout)
    print(f"phase 9: {time.perf_counter() - t_phase:.3f} s wall clock")


def phase9_multihost(dev, worker_bytes=32 << 20, worker_timeout=300, sizes=(1, 2)):
    """Phase 9 (c): two multi-host workers over gloo on the visible card(s),
    then the scaling worker at each process count of ``sizes``,
    ``worker_bytes`` a process; with two cards or more the same over NCCL,
    one card a rank.  Efficiency is ``t(1) / t(N)`` of encode plus decode at
    fixed bytes a process.  Any worker that fails or times out fails the
    phase."""
    from redux_tpu_torch.parallel import multihost

    n_cards = torch.cuda.device_count()
    for backend in ["gloo"] + (["nccl"] if n_cards >= 2 else []):
        args = ["--device", dev.type, "--backend", backend]
        t0 = time.perf_counter()
        outs = multihost.run_local(2, args, worker_timeout)
        for rank, out in enumerate(outs):
            if f"MULTIHOST OK p{rank}/2" not in out:
                raise AssertionError(f"multihost[{backend}] rank {rank}: {out!r}")
            print(f"multihost[{backend}] {out.strip()}")
        print(f"multihost[{backend}]: {time.perf_counter() - t0:.3f} s wall clock with process "
              "start")
        scaling = {}
        for n in sizes:
            outs = multihost.run_local(
                n, args + ["--scaling", "--bytes-per-host", str(worker_bytes)], worker_timeout)
            rows = [json.loads(o.strip().splitlines()[-1]) for o in outs]
            if not all(r["verified"] for r in rows):
                raise AssertionError(f"scaling[{backend}] N={n}: not verified: {rows}")
            scaling[n] = rows[0]  # the barriers make every process read the slowest's time
        t1 = scaling[1]["t_enc"] + scaling[1]["t_dec"]
        for n, r in scaling.items():
            shared = n > max(n_cards, 1)
            where = (f"{n} processes share {n_cards} card(s), so this is not scaling evidence"
                     if shared else f"one card a process ({n_cards} cards)")
            print(f"scaling[{backend}] N={n}, {worker_bytes} bytes a process: t_enc "
                  f"{r['t_enc']:.6f} s, t_dec {r['t_dec']:.6f} s, verified, efficiency "
                  f"{t1 / (r['t_enc'] + r['t_dec']):.4f} ({where})")


def phase10(dev, seed=FUZZ_SEED, trials=FUZZ_TRIALS, minutes=FUZZ_MINUTES):
    """Phase 10: the randomized differential campaign
    (``redux_tpu_torch.fuzz``) on ``dev``, trials ``0, 1, ...`` of ``seed``
    until ``trials`` have run or ``minutes`` have passed, launch counts
    reset just before and read just after.  Any mismatch fails the phase
    (the campaign raises); so does a run that did not launch every kernel,
    hit every instantiation class, freeze a model, store a block raw and
    take an ``api`` route over several lane chunks."""
    import redux_tpu_torch
    from redux_tpu_torch import fuzz

    redux_tpu_torch.reset_launch_counts()
    t0 = time.perf_counter()
    s = fuzz.run_campaign(seed, trials, minutes, dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    counts = redux_tpu_torch.launch_counts()
    print("fuzz summary " + json.dumps(s))
    short = [k for k, n in counts.items() if n == 0]
    short += [c for c, n in s["classes"].items() if n == 0]
    short += [k for k in ("frozen", "trials_with_raw", "multi_chunk_routes") if s[k] == 0]
    if short:
        raise AssertionError(f"fuzz: nothing of {short} in {s['trials']} trials")
    print(f"phase 10: {s['trials']} trials of seed {seed}, no mismatch, "
          f"{s['reference_fault_blocks']} reference_fault blocks, launches {json.dumps(counts)}, "
          f"{dt:.3f} s wall clock")


def _peak_rss_gib():
    """This process's peak resident set so far, GiB (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)


def _rss_gib():
    """This process's resident set now, GiB (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / (1 << 30)


def _peak_device_gib(dev):
    """The allocator's peak since its last reset, GiB, and a new reset."""
    peak = torch.cuda.max_memory_allocated(dev) / (1 << 30)
    torch.cuda.reset_peak_memory_stats(dev)
    return peak


def _want_per_card(cards, arch):
    """Each card's launches after ``api.encode`` and after ``api.decode``
    of ``arch`` over the device list ``cards``,
    as the share plan (``api._shares``) gives them: encoding, K1, K2, S2
    and S3 once a share, and S4 once a share of an input of 4096 bytes
    or more (the prior's histogram, by default); decoding, K3 and S1 (words) once a share with
    coded blocks, S1 (bytes) once a share with raw blocks, S3 once a
    share.  Keyed by card (a card the list names twice sums both)."""
    import redux_tpu_torch
    from redux_tpu_torch import api, container

    header = container.parse_table(arch)
    k, n_blocks = header.block_size, header.n_blocks
    zero = dict.fromkeys(redux_tpu_torch.launch_counts(), 0)
    want_enc = {d: dict(zero) for d in cards}
    for step in api._shares(n_blocks, api._lane_chunk(api.ENC_CHUNK_BYTES, k), len(cards)):
        for sh in step:
            for name in ("model_values", "encode", "splice_payload", "crc32"):
                want_enc[cards[sh.card]][name] += 1
            want_enc[cards[sh.card]]["histogram"] += header.orig_len >= 4096
    want_dec = {d: dict(w) for d, w in want_enc.items()}
    for step in api._shares(n_blocks, api._lane_chunk(api.DEC_CHUNK_BYTES, k), len(cards)):
        for sh in step:
            raw, w = header.raw[sh.s0 : sh.s1], want_dec[cards[sh.card]]
            coded = int((~raw).any())
            w["decode"] += coded
            w["gather_rows"] += coded + int(raw.any())
            w["crc32"] += 1
    return want_enc, want_dec


def _dp_route(name, data, ref_arch, devices, one_card_bound):
    """``api.encode`` -> ``decode`` of ``data`` over the device list
    ``devices``, the launch counts reset just before the encode and read
    after each way.  The archive must equal ``ref_arch`` (one card's) and
    the round trip be byte-equal; each card's launches must be what the
    share plan gives it (:func:`_want_per_card`); each card's peak device
    memory each way (its rise over what it held before) must stay under
    the sum, over the list's entries on it, of the one-card reckoning
    from that entry's shares (``cuda_checks.encode_memory_bound`` /
    ``decode_memory_bound``), and with ``one_card_bound`` under the
    one-card reckoning of the whole input, whatever the card; card 0
    holds no more than 16 MiB over any other card.  Prints the wall clock
    each way, each card's peak, launches and the host RSS at the end."""
    import redux_tpu_torch
    from redux_tpu_torch import api, container, cuda_checks

    params = api.Parameters.tpu_wide()
    cards = api._cards(devices)
    phys = list(dict.fromkeys(cards))
    k = api._default_block_size(len(data))
    n_blocks = -(-len(data) // k)
    gib = 1 << 30
    for d in phys:
        _sync(d)
        _peak_device_gib(d)
    before = {d: torch.cuda.memory_allocated(d) / gib for d in phys}
    rss0 = _rss_gib()
    redux_tpu_torch.reset_launch_counts()
    t0 = time.perf_counter()
    arch = api.encode(data, device=devices)
    for d in phys:
        _sync(d)
    t1 = time.perf_counter()
    enc_counts = {d: redux_tpu_torch.launch_counts(d) for d in phys}
    peak_enc = {d: _peak_device_gib(d) for d in phys}
    rss1 = _rss_gib()
    if arch != ref_arch:
        raise AssertionError(f"{name}: archive differs from one card's")
    before_dec = {d: torch.cuda.memory_allocated(d) / gib for d in phys}
    t2 = time.perf_counter()
    back = api.decode(arch, device=devices)
    for d in phys:
        _sync(d)
    t3 = time.perf_counter()
    counts = {d: redux_tpu_torch.launch_counts(d) for d in phys}
    peak_dec = {d: _peak_device_gib(d) for d in phys}
    if back != data:
        raise AssertionError(f"{name}: round trip is not byte-equal")
    del back
    want_enc, want_dec = _want_per_card(cards, arch)
    if enc_counts != want_enc or counts != want_dec:
        raise AssertionError(f"{name}: launches a card {enc_counts} after encode, {counts} after "
                             f"decode; the share plan gives {want_enc}, then {want_dec}")
    header = container.parse_table(arch)
    enc_steps = api._shares(n_blocks, api._lane_chunk(api.ENC_CHUNK_BYTES, k), len(cards))
    dec_steps = api._shares(n_blocks, api._lane_chunk(api.DEC_CHUNK_BYTES, k), len(cards))
    enc_own, dec_own = api._by_card(enc_steps, len(cards)), api._by_card(dec_steps, len(cards))
    rise_enc = {d: peak_enc[d] - before[d] for d in phys}
    rise_dec = {d: peak_dec[d] - before_dec[d] for d in phys}
    for d in phys:
        mine = [j for j, c in enumerate(cards) if c == d]
        b_enc = sum(cuda_checks.encode_memory_bound(
            sum(sh.s1 - sh.s0 for sh in enc_own[j]) * k, k, params) for j in mine if enc_own[j])
        b_dec = sum(cuda_checks.decode_memory_bound(header, dec_own[j]) for j in mine if dec_own[j])
        if one_card_bound:
            b_enc = min(b_enc, cuda_checks.encode_memory_bound(len(data), k, params))
            b_dec = min(b_dec, cuda_checks.decode_memory_bound(header))
        if rise_enc[d] > b_enc / gib or rise_dec[d] > b_dec / gib:
            raise AssertionError(f"{name}: {d} rose {rise_enc[d]:.3f} GiB encoding (bound "
                                 f"{b_enc / gib:.3f}), {rise_dec[d]:.3f} GiB decoding (bound "
                                 f"{b_dec / gib:.3f})")
        print(f"{name}: {d} peak device memory {peak_enc[d]:.3f} GiB encode (a rise of "
              f"{rise_enc[d]:.3f} against {b_enc / gib:.3f}), {peak_dec[d]:.3f} GiB decode (a "
              f"rise of {rise_dec[d]:.3f} against {b_dec / gib:.3f}); launches "
              f"{json.dumps(counts[d])}")
    others = [d for d in phys if d != phys[0]]
    if others and max(rise_enc[phys[0]] - max(rise_enc[d] for d in others),
                      rise_dec[phys[0]] - max(rise_dec[d] for d in others)) > 1 / 64:
        raise AssertionError(f"{name}: card 0 holds more than the others: {rise_enc}, {rise_dec}")
    mb = len(data) / 1e6
    n_enc = sum(len(step) for step in enc_steps)
    print(f"{name}: {len(data)} bytes over {len(cards)} devices ({len(phys)} cards), "
          f"{n_enc} shares in {len(enc_steps)} steps, archive byte-equal to one card's, round "
          f"trip byte-equal, launches a card as the share plan gives them; encode "
          f"{t1 - t0:.3f} s ({mb / (t1 - t0):.3f} MB/s), decode {t3 - t2:.3f} s "
          f"({mb / (t3 - t2):.3f} MB/s), wall clock with host work; host RSS {rss0:.3f} GiB "
          f"before, {rss1:.3f} GiB at the encode's end, {_rss_gib():.3f} GiB at the decode's end")
    return arch


def _at_size(dev, data):
    """Phase 11 (a): ``api.encode`` -> ``decode`` of ``data`` at the shipped
    defaults, launch counts reset just before the encode and read after
    each way: K1 and K2 once a lane chunk, K3 once a range of blocks with
    coded blocks.  Byte-equal (``decode`` verifies the crc); the middle
    and the last chunk are held to the plain versions
    (``cuda_checks.check_chunk_streams``).  The encode's peak device
    memory must stay under its reckoning from one chunk's shapes
    (``cuda_checks.encode_memory_bound``), the decode's under two chunk
    slots (``cuda_checks.decode_memory_bound``) and under the encode's.
    Prints wall clock (the decode's from a call without ``_timings``), host
    phases and their parts (the decode's from a second call, with them),
    peak device memory, the host RSS the encode holds at its end and the
    rise of the peak host RSS each way."""
    import numpy as np

    import redux_tpu_torch
    from redux_tpu_torch import api, container, cuda_checks

    k = api._default_block_size(len(data))
    n_blocks = -(-len(data) // k)
    enc_chunk = api._lane_chunk(api.ENC_CHUNK_BYTES, k)
    dec_chunk = api._lane_chunk(api.DEC_CHUNK_BYTES, k)
    n_enc, n_dec = -(-n_blocks // enc_chunk), -(-n_blocks // dec_chunk)
    _sync(dev)
    _peak_device_gib(dev)
    before_enc = torch.cuda.memory_allocated(dev) / (1 << 30)
    rss0, rss_now0 = _peak_rss_gib(), _rss_gib()
    redux_tpu_torch.reset_launch_counts()
    t_enc, t_dec = {}, {}
    t0 = time.perf_counter()
    arch = api.encode(data, device=dev, _timings=t_enc)
    _sync(dev)
    t1 = time.perf_counter()
    enc_counts = redux_tpu_torch.launch_counts()
    dev_enc, rss1, rss_now1 = _peak_device_gib(dev), _peak_rss_gib(), _rss_gib()
    enc_bound = cuda_checks.encode_memory_bound(len(data), k, api.Parameters.tpu_wide()) / (1 << 30)
    if dev_enc - before_enc > enc_bound:
        raise AssertionError(f"at size: encode's peak device memory {dev_enc:.3f} GiB "
                             f"({before_enc:.3f} GiB before it) passes its bound "
                             f"{enc_bound:.3f} GiB")
    before = torch.cuda.memory_allocated(dev) / (1 << 30)
    t_d = time.perf_counter()
    back = api.decode(arch, device=dev)
    _sync(dev)
    t2 = time.perf_counter()
    counts = redux_tpu_torch.launch_counts()
    dev_dec, rss2 = _peak_device_gib(dev), _peak_rss_gib()
    if back != data:
        raise AssertionError("at size: round trip is not byte-equal")
    del back
    t3 = time.perf_counter()
    back = api.decode(arch, device=dev, _timings=t_dec)
    _sync(dev)
    t_dec_timed = time.perf_counter() - t3
    if back != data:
        raise AssertionError("at size: round trip (with _timings) is not byte-equal")
    del back
    header = container.parse_table(arch)
    ranges = [header.raw[s0 : s0 + dec_chunk] for s0 in range(0, n_blocks, dec_chunk)]
    coded = sum(bool((~r).any()) for r in ranges)
    with_raw = sum(bool(r.any()) for r in ranges)
    want_enc, want_dec = (want[dev] for want in _want_per_card([dev], arch))
    if enc_counts != want_enc or counts != want_dec:
        raise AssertionError(f"at size: launches {enc_counts} after encode, {counts} after "
                             f"decode; want {want_enc}, then {want_dec}")
    bound = cuda_checks.decode_memory_bound(header) / (1 << 30)
    if dev_dec - before > bound or dev_dec > dev_enc:
        raise AssertionError(f"at size: decode's peak device memory {dev_dec:.3f} GiB "
                             f"({before:.3f} GiB before it) passes the two-slot bound "
                             f"{bound:.3f} GiB or the encode's peak {dev_enc:.3f} GiB")
    gib = len(data) / (1 << 30)
    print(f"at size: {len(data)} bytes ({gib:.6f} GiB), {n_blocks} blocks of {k}, {n_enc} "
          f"encode chunks of <= {enc_chunk} blocks, {n_dec} decode chunks of <= {dec_chunk}; "
          f"archive {len(arch)} bytes, ratio {len(arch) / len(data):.6f}; round trip "
          f"byte-equal, crc verified; launches {json.dumps(counts)}")
    print(f"at size: encode {t1 - t0:.3f} s ({len(data) / (t1 - t0) / 1e6:.3f} MB/s), decode "
          f"{t2 - t_d:.3f} s ({len(data) / (t2 - t_d) / 1e6:.3f} MB/s), wall clock with host work "
          f"(the decode without _timings; {t_dec_timed:.3f} s with them, recorded)")
    print("at size: encode phases s " + json.dumps({k: round(v, 4) for k, v in t_enc.items()}))
    print("at size: decode phases s " + json.dumps({k: round(v, 4) for k, v in t_dec.items()}))
    print(f"at size: peak device memory {dev_enc:.3f} GiB encode ({before_enc:.3f} GiB "
          f"allocated before it: a rise of {dev_enc - before_enc:.3f} GiB against its bound "
          f"{enc_bound:.3f} GiB), {dev_dec:.3f} GiB decode "
          f"({before:.3f} GiB allocated before it: a rise of {dev_dec - before:.3f} GiB against "
          f"the two-slot bound {bound:.3f} GiB, {coded} ranges with coded blocks, {with_raw} "
          f"with raw blocks); peak host RSS {rss0:.3f} GiB before, +{rss1 - rss0:.3f} GiB by "
          f"the encode's end, +{rss2 - rss0:.3f} GiB by the decode's end; host RSS "
          f"{rss_now0:.3f} GiB before the encode, {rss_now1:.3f} GiB at its end (+"
          f"{rss_now1 - rss_now0:.3f} GiB with the archive's {len(arch) / (1 << 30):.3f} GiB)")
    _check_chunks("at size", data, arch, dev, [n_enc // 2, n_enc - 1])
    return arch


def _check_chunks(what, data, arch, dev, chunks):
    """``cuda_checks.check_chunk_streams`` on ``chunks`` of ``arch``, one
    line a chunk with the plain versions' times."""
    from redux_tpu_torch import cuda_checks

    t0 = time.perf_counter()
    for s0, n, n_raw, plain_ms in cuda_checks.check_chunk_streams(data, arch, dev, chunks):
        print(f"{what}: chunk of blocks {s0}..{s0 + n - 1} ({n} blocks) held to the plain "
              "versions: K1 -> K2 in one launch equal to model_lohi_plain -> "
              f"encode_blocks_plain, {n_raw} raw blocks and every stream equal to the "
              "archive's, K3 equal to decode_blocks_plain on the archive's streams; plain ms "
              + json.dumps({k: round(v, 3) for k, v in plain_ms.items()}))
    _sync(dev)
    print(f"{what}: chunk checks {time.perf_counter() - t0:.3f} s")


def _print_staging(what, res):
    """One line a staging kernel of ``cuda_checks.compare_staging``'s result."""
    from redux_tpu_torch import cuda_checks

    for k in cuda_checks.STAGING:
        r = res[k]
        ms = f"{r['ms']:.4f} ms" if r["ms"] is not None else "not timed"
        if r["ms"]:
            ms += f" ({r['bound_ms'] / r['ms']:.0%} of its bound)"
        if r.get("ms_bytes") is not None:
            ms += f" (words; bytes {r['ms_bytes']:.4f} ms on {res['raw_rows']} raw rows)"
        if r["ms_call"] is not None:
            ms += f", {r['ms_call']:.4f} ms a call with its checks"
        plain = f"{r['plain_ms']:.3f} ms" if r["plain_ms"] is not None else "not timed"
        if r["library_ms"] is not None:
            plain += f", library {r['library_ms']:.4f} ms"
        print(f"{what} {k}: equal (max |diff| {r['max_abs_err']}), kernel {ms}, plain {plain}, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes']} bytes, {r['ops']} "
              f"int32 ops)")
    edges = ", ".join(map(str, cuda_checks.CRC_EDGES))
    print(f"{what}: {res['raw_rows']} raw blocks, crc32 also equal to zlib.crc32 at {edges} "
          "bytes and from 1, 7 and 15 bytes in; gather_rows also equal to its plain version in "
          f"{res['gather_rows']['edge_cases']} edge cases (offsets at every residue mod 16, rows "
          "ending at the buffer's last byte, empty and full rows, widths off 4 and 16, the "
          "buffer 0, 1, 7 and 15 bytes in); histogram also from 1, 7 and 15 bytes in and "
          "added into a row that held counts")


def phase11(dev):
    """Phase 11: the main path, the bench and the CLI at multi-GB size.

    (a) :func:`_at_size` on ``testdata.mixed(BIG_BYTES)``; (b) the bench on
    the first ``BENCH_BYTES[0]`` bytes of ``testdata.text_like(CLI_BYTES)``
    (``text_like(BENCH_BYTES[0])`` itself) and on the first
    ``BENCH_BYTES[1]`` of the big input, verified, with its peak device
    memory; (c) the CLI at its defaults ((8,30,32)) through files on the
    text input, ``cmp``-equal, launching each of K1-K3 once a chunk, its
    last chunk held to the plain versions in their u64 instantiations;
    (d) the container corruption sweep (``cuda_checks.corruption_sweep``)
    through K3 on a ``SWEEP_BYTES`` archive of ``text_like``, and the
    over-long stream of ``tests/test_torch_fuzz_container.py``."""
    import filecmp
    import shutil
    import struct

    import redux_tpu_torch
    from redux_tpu_torch import api, bench, container, cuda_checks, testdata
    from redux_tpu_torch.errors import InvalidInputError

    t_phase = time.perf_counter()
    rss0 = _peak_rss_gib()
    text = testdata.text_like(CLI_BYTES, SEED)
    t_text = time.perf_counter() - t_phase
    big = testdata.mixed(BIG_BYTES, SEED)
    print(f"phase 11 inputs: text_like {len(text)} bytes and mixed {len(big)} bytes (seed "
          f"{SEED}) in {t_text:.3f} + {time.perf_counter() - t_phase - t_text:.3f} s (one "
          f"thread); peak host RSS {rss0:.3f} GiB "
          f"before, {_peak_rss_gib():.3f} GiB after")

    # (a) The main path at size, on one card, then over two shares a step
    # on it and over every card; S1-S4 on one 65,536-lane chunk of its input.
    big_arch = _at_size(dev, big)
    from redux_tpu_torch.parallel import data_parallel_mesh

    lists = [("dp[dev,dev]", [dev, dev])]
    if torch.cuda.device_count() > 1:
        lists.append((f"dp[{torch.cuda.device_count()} gpu]", data_parallel_mesh()))
    for label, devices in lists:
        _dp_route(f"at size {label}", big, big_arch, devices, one_card_bound=False)
    del big_arch
    t0 = time.perf_counter()
    chunk_bytes = api._lane_chunk(api.ENC_CHUNK_BYTES, 4096) * 4096
    _print_staging(f"at size, one chunk of {chunk_bytes} bytes",
                   cuda_checks.compare_staging(big[:chunk_bytes], dev))
    print(f"at size: staging check {time.perf_counter() - t0:.3f} s")

    # (b) The bench at two sizes.
    for name, whole, n in ((f"text_like {BENCH_BYTES[0]}", text, BENCH_BYTES[0]),
                           (f"mixed {BENCH_BYTES[1]}", big, BENCH_BYTES[1])):
        t0 = time.perf_counter()
        rss0 = _peak_rss_gib()
        res = bench.run_device_benchmark(whole[:n], device=dev)
        _sync(dev)
        print(f"bench[{name}] " + json.dumps(res))
        if not res["verified"]:
            raise AssertionError(f"bench[{name}]: round trip not verified")
        peak = res["peak_device_bytes"] / (1 << 30)
        print(f"bench[{name}]: verified, peak device memory {peak:.3f} GiB, "
              f"peak host RSS +{_peak_rss_gib() - rss0:.3f} GiB, "
              f"{time.perf_counter() - t0:.3f} s wall clock")
    del big, whole

    # (c) The CLI at its defaults through files.
    work = ROOT / "build" / "chip_smoke11"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        src, arch_f, back_f = work / "in.bin", work / "in.rxt", work / "back.bin"
        src.write_bytes(text)
        k = api._default_block_size(len(text))
        n_chunks = -(-len(text) // (k * api._lane_chunk(api.ENC_CHUNK_BYTES, k)))
        for mode, argv, want in (
                ("compress", ["-c", "-i", str(src), "-o", str(arch_f)],
                 {"model_values": n_chunks, "encode": n_chunks}),
                ("decompress", ["-d", "-i", str(arch_f), "-o", str(back_f)],
                 {"decode": n_chunks})):
            redux_tpu_torch.reset_launch_counts()
            t0 = time.perf_counter()
            line = _cli(argv, dev)
            _sync(dev)
            dt = time.perf_counter() - t0
            counts = redux_tpu_torch.launch_counts()
            staged = (("splice_payload", "crc32", "histogram") if mode == "compress"
                      else ("gather_rows", "crc32"))
            if (_coders(counts) != dict.fromkeys(cuda_checks.KERNELS, 0) | want
                    or not all(counts[s] for s in staged)):
                raise AssertionError(f"cli {mode}: launches {counts}, want {want} and {staged}")
            print(f"cli at size {mode}: {dt:.3f} s wall clock with file I/O, {line!r}, "
                  f"launches {json.dumps(counts)}")
        if not filecmp.cmp(src, back_f, shallow=False):
            raise AssertionError("cli at size: output differs from the input")
        cli_arch = arch_f.read_bytes()
        header, _ = container.parse_archive(cli_arch, with_streams=False)
        p = header.params
        print(f"cli at size: {len(text)} bytes, ({p.symbol_bits},{p.freq_bits},{p.code_bits}) "
              f"delta {header.delta}, {header.n_blocks} blocks of {header.block_size} in "
              f"{n_chunks} chunks each way, archive {len(cli_arch)} bytes, output "
              "cmp-equal to the input")
        _check_chunks("cli at size", text, cli_arch, dev, [n_chunks - 1])
        del cli_arch
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (d) The corruption sweep through K3.
    data = text[:SWEEP_BYTES]
    del text
    arch = api.encode(data, device=dev)
    redux_tpu_torch.reset_launch_counts()
    t0 = time.perf_counter()
    sweep = cuda_checks.corruption_sweep(data, arch, dev)
    header, _ = container.parse_archive(arch, with_streams=False)
    lens = list(header.block_byte_lens)
    bad = bytearray(arch)  # block 0's stream longer than the decoder's row can hold
    struct.pack_into(f"<{len(lens)}I", bad, container.HEADER_BYTES, sum(lens),
                     *[0] * (len(lens) - 1))
    try:
        api.decode(bytes(bad), device=dev)
    except InvalidInputError:
        sweep["over-long stream"] = {"raised": 1, "exact": 0}
    else:
        raise AssertionError("an over-long stream decoded without an error")
    _sync(dev)
    counts = redux_tpu_torch.launch_counts()
    n = sum(sum(v.values()) for v in sweep.values())
    print(f"corruption sweep: {n} corrupted archives of a {len(arch)}-byte archive "
          f"({len(data)} bytes of text_like, {header.n_blocks} blocks): "
          + ", ".join(f"{kind} {v['raised']} raised, {v['exact']} exact"
                      for kind, v in sweep.items())
          + f"; no wrong bytes, no CUDA error; launches {json.dumps(counts)}; "
          f"{time.perf_counter() - t0:.3f} s")
    if counts["decode"] == 0:
        raise AssertionError("corruption sweep: K3 never ran")
    print(f"phase 11: {time.perf_counter() - t_phase:.3f} s wall clock")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import redux_tpu_torch
    from redux_tpu_torch import _build, api, cuda_checks, native, testdata

    dev = torch.device("cuda", 0)

    # Phase 1: device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {name}, torch {torch.__version__}, cuda {torch.version.cuda}")
    print(f"host: {os.cpu_count()} cpus, {torch.get_num_threads()} torch threads, kernel "
          f"{platform.release()}, transparent huge pages {_thp_mode()}; the results' pages "
          f"prefaulted by {api._Output.TOUCH_THREADS} threads writing a byte a page")

    # Phase 2: build.
    t0 = time.perf_counter()
    lib = _build.build()
    _build.lib()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.3f} s ({_build.nvcc_version()})")
    for line in _build.resource_usage():
        print(f"ptxas: {line}")
    t0 = time.perf_counter()
    native_lib = native.build()
    native.get_lib()
    native_build_s = time.perf_counter() - t0
    print(f"build: {native_lib.name} (host serial codec, g++) in {native_build_s:.3f} s")

    # Phase 3: kernels against their plain versions.
    res = cuda_checks.check_kernels(dev)
    torch.cuda.synchronize()
    for case, r in res.items():
        for k in cuda_checks.KERNELS:
            if r[k].get("raises"):
                print(f"kernels[{case}] {k}: raises {r[k]['raises']} (params off its path, "
                      "as in the reference)")
                continue
            plain = r[k]["plain_ms"]
            print(f"kernels[{case}] {k}: equal (max |diff| {r[k]['max_abs_err']}), "
                  f"kernel {r[k]['ms']:.3f} ms, plain "
                  + (f"{plain:.3f} ms" if plain is not None else "not timed"))
        print(f"kernels[{case}]: {r['raw_blocks']} blocks stored raw")
    staging = cuda_checks.check_staging(dev)
    torch.cuda.synchronize()
    for case, r in staging.items():
        _print_staging(f"staging[{case}]", r)

    # Phase 4: goldens.
    for fname, fmt, n_in, n_arch in cuda_checks.check_goldens(dev, ROOT / "tests" / "golden_torch"):
        where = "on the card" if fmt == "rxt" else "on the host (native)"
        print(f"golden {fname} ({fmt}, {where}): {n_in} -> {n_arch} bytes, encode and decode "
              "byte-equal")
    torch.cuda.synchronize()

    # Phase 5: the main path at real size.
    data = testdata.mixed(MAIN_BYTES, SEED)
    api.encode(data[: 1 << 22], device=dev)  # warm-up: first launches, allocator
    torch.cuda.synchronize()
    main_on = {k: k in MAIN_PATH for k in redux_tpu_torch.launch_counts()}
    arch, launches = _route("main", data, None, dev, main_on)
    k_auto = api._auto_block_size(len(data))
    n_blocks = -(-len(data) // k_auto)
    print(f"main: {len(data)} bytes, {n_blocks} blocks of {k_auto}, archive {len(arch)} bytes, "
          f"ratio {len(arch) / len(data):.6f}, crc verified")

    # The kernels at the main path's shapes, against their plain versions.
    x = cuda_checks.KernelInputs(data, api.Parameters.tpu_wide(), 16, k_auto, dev)
    main_res = cuda_checks.compare_kernels(x)
    torch.cuda.synchronize()
    for k in cuda_checks.KERNELS:
        r = main_res[k]
        extra = (f", {r['ms_unsorted']:.3f} ms on lanes in block order"
                 if "ms_unsorted" in r else "")
        print(f"main-shape {k}: kernel {r['ms']:.3f} ms{extra}, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes']} bytes, "
              f"{r['ops']} int32 ops) ({n_blocks} x {k_auto}), equal")
    main_staging = cuda_checks.compare_staging(data, dev)
    torch.cuda.synchronize()
    _print_staging(f"main-shape ({n_blocks} x {k_auto})", main_staging)

    # Phase 6: the fused route (K4 in place of K1 -> K2) at real size.
    fused_on = {"model_values": False, "encode": False, "encode_fused": True, "decode": True,
                **dict.fromkeys(cuda_checks.STAGING, True)}
    os.environ["REDUX_TPU_ENC_FUSED"] = "1"
    try:
        _, fused_launches = _route("fused", data, arch, dev, fused_on)
    finally:
        del os.environ["REDUX_TPU_ENC_FUSED"]

    # Phase 7: data parallel at real size: every visible GPU, then two
    # shards on one card; and the sharded K5 entry at the main shapes.
    from redux_tpu_torch.parallel import data_parallel_mesh, encode_blocks_m_sharded

    mesh_all = data_parallel_mesh()
    for label, devices in ((f"dp[{len(mesh_all)} gpu]", mesh_all), ("dp[dev,dev]", [dev, dev])):
        _dp_route(label, data, arch, devices, one_card_bound=True)
    redux_tpu_torch.reset_launch_counts()
    t0 = time.perf_counter()
    sharded = encode_blocks_m_sharded(x.syms, x.lens, x.init_cum, x.params, x.n_words,
                                      [dev, dev], x.delta)
    torch.cuda.synchronize()
    t_m = time.perf_counter() - t0
    m_launches = redux_tpu_torch.launch_counts()
    if m_launches["encode_m"] != 2:
        raise AssertionError(f"sharded encode_m: {m_launches['encode_m']} launches, not 2")
    err = cuda_checks.triple_err(sharded, main_res["k2_triple"], x.n_words)
    if err != 0:
        raise AssertionError(f"sharded encode_m differs from K2 (max |diff| {err})")
    print(f"dp encode_m over [dev, dev]: {n_blocks} x {k_auto} equal to K2's streams, "
          f"{t_m:.3f} s wall clock with host copies, launches {json.dumps(m_launches)}")
    path_launches = dict(launches, encode_fused=fused_launches["encode_fused"],
                         encode_m=m_launches["encode_m"])

    # Phase 8: the CLI, the auto and compact routes and the native codec.
    phase8(dev, data, native_build_s)

    # Phase 9: the bench, the generic models and multi-host.
    phase9(dev, data, arch)

    # Phase 10: the randomized differential campaign.
    phase10(dev)

    # Phase 11: the main path, the bench and the CLI at multi-GB size; then
    # phase 5's round trip again, to show the CUDA context came through the
    # corruption sweep.
    phase11(dev)
    _route("after the sweep", data, arch, dev, main_on)

    kernels = []
    for table, main_r, checks in ((cuda_checks.KERNELS, main_res, res),
                                  (cuda_checks.STAGING, main_staging, staging)):
        for k, (source, replaces) in table.items():
            err = max(main_r[k]["max_abs_err"], *(r[k]["max_abs_err"] for r in checks.values()))
            r = main_r[k]
            kernels.append({
                "name": k, "route": "cuda", "source": source, "replaces": replaces,
                "launches": path_launches[k], "max_abs_err": err,
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "bound": r["bound"], "library_ms": r.get("library_ms"),
            })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
