"""Multi-host data-parallel codec: the round-trip check and the
weak-scaling worker, one process a host (or a card), on
``torch.distributed``.

Counterpart: ``redux_tpu/parallel/multihost.py`` —
``run_multihost_roundtrip`` (:22-112), ``run_scaling_worker``
(:115-249) and ``main`` (:252-277).  Blocks are sharded across processes
in rank order; each process codes its own shard on its device with no
collective, and the per-block outputs come back in block order through an
all-gather of equal-size shards (the reference's
``process_allgather(tiled=True)``).  Under ``gloo`` the shards are gathered
as CPU tensors, under ``nccl`` as CUDA tensors.

Run one process a rank::

    python -m redux_tpu_torch.parallel.multihost --coordinator HOST:PORT \\
        --num-processes N --process-id R [--device cuda|cpu] [--backend gloo|nccl] \\
        [--scaling [--bytes-per-host B] [--block-size K] [--iters I]]

``--device cuda`` (the default) gives rank ``r`` the card
``cuda:(r % device_count)`` and raises without CUDA; ``--backend``
defaults to ``nccl`` on ``cuda`` and ``gloo`` on ``cpu`` (NCCL needs a
card a rank).  A worker that fails exits non-zero.  :func:`run_local`
starts N workers on this machine and collects their output.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import oracle, testdata
from ..models.dense import uniform_init_cum
from ..ops.coder import max_block_words
from ..ops.model import model_lohi
from ..params import Parameters
from .mesh import decode_blocks_sharded, encode_blocks_sharded, initialize_multihost


def default_backend(device: str) -> str:
    """``nccl`` for ``cuda``, ``gloo`` for ``cpu``: the backend a caller
    gets when it names none."""
    return "nccl" if device == "cuda" else "gloo"


def _device(device: str, rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("multihost: device 'cuda' but torch.cuda.is_available() is false; "
                           "pass --device cpu to run the plain versions")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _gather(x: torch.Tensor, backend: str) -> torch.Tensor:
    """Every rank's equal-size shard of ``x``, concatenated in rank order."""
    if backend == "gloo":
        x = x.cpu()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def _setup(coordinator: str, num_processes: int, process_id: int, device: str,
           backend: Optional[str]):
    dev = _device(device, process_id)
    backend = backend or default_backend(device)
    initialize_multihost(coordinator, num_processes, process_id, backend)
    return dev, backend


def run_multihost_roundtrip(
    coordinator: str,
    num_processes: int,
    process_id: int,
    n_blocks_per_host: int = 4,
    k: int = 1024,
    seed: int = 0,
    *,
    device: str = "cuda",
    backend: Optional[str] = None,
) -> str:
    """Join the group, encode this process's shard (K1 -> K2), gather every
    shard, check every block against the oracle, and decode the own shard
    (K3).  Returns ``"MULTIHOST OK ..."``; raises on any mismatch."""
    dev, backend = _setup(coordinator, num_processes, process_id, device, backend)
    params = Parameters.tpu_wide()
    delta = 16
    b = n_blocks_per_host * num_processes
    rng = np.random.default_rng(seed)
    # The same global input on every process (from the seed): mixed entropy.
    data = (rng.integers(0, 256, b * k // 2, dtype=np.uint8).tobytes()
            + (b"multihost block parallel coding " * ((b * k) // 64 + 1)))[: b * k]
    ic = uniform_init_cum(params).astype(np.int32)
    first = process_id * n_blocks_per_host
    mine = np.frombuffer(data, np.uint8).reshape(b, k)[first : first + n_blocks_per_host]
    # Only this process's shard goes to its device.
    syms = torch.from_numpy(mine.copy()).to(dev)
    lens = torch.full((n_blocks_per_host,), k, dtype=torch.int32, device=dev)
    ic_t = torch.from_numpy(ic).to(dev)

    # Worst-case capacity: every block is checked against the oracle, the
    # incompressible ones too (the archive would store those raw).
    n_words = max_block_words(min(257 + delta * k, params.freq_max), params.symbol_count,
                              params, k)
    lo, hi = model_lohi(syms, lens, ic_t, params, delta)
    words, byte_lens, ovf = encode_blocks_sharded(lo, hi, lens, int(ic[-1]), params, n_words,
                                                  [dev], delta)

    words_all = _gather(words, backend).cpu().numpy().view(np.uint32)
    blens = _gather(byte_lens, backend).cpu().numpy()
    if bool(_gather(ovf.to(torch.uint8), backend).any()):
        raise AssertionError(f"a piece overflowed 64 bits on process {process_id}")
    if words_all.shape[0] != b or blens.shape[0] != b:
        raise AssertionError(f"gathered {words_all.shape[0]} blocks, expected {b}")
    for i in range(b):
        exp = oracle.compress_block(data[i * k : (i + 1) * k], params, ic.astype(np.int64), delta)
        got = words_all[i].astype(">u4").tobytes()[: blens[i]]
        if got != exp:
            raise AssertionError(f"block {i} differs from the oracle on process {process_id}")
    back = decode_blocks_sharded(words, lens, ic_t, params, k, [dev], delta)
    if not torch.equal(back, syms):
        raise AssertionError(f"the own shard does not decode on process {process_id}")
    return (f"MULTIHOST OK p{process_id}/{num_processes} blocks={b} devices={num_processes} "
            f"device={dev} backend={backend} compressed={int(blens.sum())}B")


def run_scaling_worker(
    coordinator: str,
    num_processes: int,
    process_id: int,
    bytes_per_host: int = 3 << 20,
    k: int = 4096,
    delta: int = 16,
    iters: int = 3,
    *,
    device: str = "cuda",
    backend: Optional[str] = None,
) -> str:
    """Weak-scaling worker: one process a host, ``bytes_per_host`` of
    ``testdata.text_like`` each (the reference read a corpus file that is
    not part of this repository).

    ``iters`` rounds of encode (K1 -> K2) over the process's whole shard in
    one launch, then of decode (K3), each between global barriers with the
    device synchronised before every timestamp: the time is the slowest
    process's.  (The reference coded 96-block chunks to keep a CPU host's
    cache warm; the card needs no such cut.)  Then, untimed, an ordered
    gather of the decoded shards checked against the input.  Returns one
    JSON line with the reference's keys (:240-249) and the device and
    backend.
    """
    dev, backend = _setup(coordinator, num_processes, process_id, device, backend)
    params = Parameters.tpu_wide()
    bph = max(1, bytes_per_host // k)  # blocks a host
    data = testdata.text_like(bph * num_processes * k, 0)  # the same on every process
    glob = np.frombuffer(data, np.uint8).reshape(num_processes * bph, k)
    mine = torch.from_numpy(glob[process_id * bph : (process_id + 1) * bph].copy()).to(dev)
    lens = torch.full((bph,), k, dtype=torch.int32, device=dev)
    ic = uniform_init_cum(params).astype(np.int32)
    ic_t = torch.from_numpy(ic).to(dev)
    n_words = max_block_words(min(257 + delta * k, params.freq_max), params.symbol_count,
                              params, k)
    mesh = [dev]

    def enc():
        lo, hi = model_lohi(mine, lens, ic_t, params, delta)
        return encode_blocks_sharded(lo, hi, lens, int(ic[-1]), params, n_words, mesh, delta)

    def timed(fn):
        out = fn()  # warm-up
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        _sync(dev)
        dist.barrier()
        return out, (time.perf_counter() - t0) / iters

    (words, _, ovf), t_enc = timed(enc)
    decoded, t_dec = timed(
        lambda: decode_blocks_sharded(words, lens, ic_t, params, k, mesh, delta))
    ok = not bool(ovf.any()) and np.array_equal(_gather(decoded, backend).cpu().numpy(), glob)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return json.dumps({
        "process": process_id,
        "n_procs": num_processes,
        "bytes": len(data),
        "t_enc": t_enc,
        "t_dec": t_dec,
        "verified": bool(ok),
        "device": name,
        "backend": backend,
    })


def run_local(num_processes: int, args: Sequence[str], timeout: float,
              entry: Sequence[str] = ("-m", "redux_tpu_torch.parallel.multihost")) -> list:
    """Run ``num_processes`` workers on this machine, each ``python
    *entry`` (this module's :func:`main`, or code that calls it), ranks
    0..N-1 against a free localhost port, with ``args`` added to each
    command line; return each worker's stdout in rank order.  Waits until
    every worker has exited, one has failed (the others would wait on it
    in a collective) or ``timeout`` seconds have passed, then kills any
    left.  Raises RuntimeError if any worker failed or timed out."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[2])
    # PYTHONPATH replaced, not extended: the workers import this checkout only.
    env = {**os.environ, "PYTHONPATH": root}
    with contextlib.ExitStack() as stack:
        files = [(stack.enter_context(tempfile.TemporaryFile("w+")),
                  stack.enter_context(tempfile.TemporaryFile("w+")))
                 for _ in range(num_processes)]
        procs = [
            subprocess.Popen(
                [sys.executable, *entry, "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(num_processes),
                 "--process-id", str(rank), *args],
                cwd=root, env=env, stdout=out, stderr=err)
            for rank, (out, err) in enumerate(files)
        ]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs, failed = [], []
        for rank, (p, (out, err)) in enumerate(zip(procs, files)):
            out.seek(0)
            err.seek(0)
            outs.append(out.read())
            if p.returncode != 0:
                failed.append(f"rank {rank}: exit {p.returncode}\n{err.read()[-3000:]}")
    if failed:
        raise RuntimeError(f"multihost workers failed (timeout {timeout} s): " + "\n".join(failed))
    return outs


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m redux_tpu_torch.parallel.multihost")
    ap.add_argument("--coordinator", required=True, help="HOST:PORT of rank 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--scaling", action="store_true",
                    help="run the weak-scaling worker instead of the round trip")
    ap.add_argument("--bytes-per-host", type=int, default=3 << 20)
    ap.add_argument("--block-size", type=int, default=4096, help="scaling worker's block size")
    ap.add_argument("--iters", type=int, default=3, help="scaling worker's timed rounds")
    args = ap.parse_args(argv)
    try:
        if args.scaling:
            out = run_scaling_worker(
                args.coordinator, args.num_processes, args.process_id,
                bytes_per_host=args.bytes_per_host, k=args.block_size, iters=args.iters,
                device=args.device, backend=args.backend)
        else:
            out = run_multihost_roundtrip(
                args.coordinator, args.num_processes, args.process_id,
                device=args.device, backend=args.backend)
        print(out, flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
