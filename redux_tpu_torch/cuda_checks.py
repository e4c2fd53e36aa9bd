"""On-card checks of the kernels: each against its plain PyTorch version
(K1-K5, :func:`compare_kernels`; the staging kernels S1-S4,
:func:`compare_staging`), the port against the golden archives, and the
generic-model coders against K1, K3 and the oracle
(:func:`check_generic`, which also runs on CPU tensors).

Used by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.  Every check
compares integers exactly (tolerance 0: the bar is byte equality) and
raises AssertionError on any difference.  Times come from CUDA events.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import time
import zlib

import numpy as np
import torch

from . import api, container, native, oracle
from ._pipeline import _host_u8, _to_device
from .convert import init_cum_from_numpy
from .errors import ReduxError
from .models.base import Model
from .ops import coder
from .ops.bitpack import streams_to_words, words_to_streams
from .ops.decode import decode_blocks, decode_blocks_plain
from .ops.coder import words_to_bytes
from .ops.encode import (encode_blocks, encode_blocks_fused, encode_blocks_fused_plain,
                         encode_blocks_plain, encode_blocks_ranked)
from .ops.encode_m import encode_blocks_m, encode_blocks_m_plain
from .ops.generic import (TorchModel, decode_blocks_generic, dense_torch_model,
                          encode_blocks_generic, make_generic_coders, static_torch_model)
from .ops.model import model_lohi, model_lohi_plain, precompute_encode_model
from .ops.staging import (CRC_SEGMENT, CRC_THREADS, byte_histogram, byte_histogram_plain, crc32,
                          crc32_plain, gather_rows, gather_rows_plain, launch_byte_histogram,
                          launch_crc32, launch_gather_rows, launch_splice_payload, splice_payload,
                          splice_payload_plain, splice_rows)
from .params import Parameters
from .testdata import golden_input, incompressible, text_like

KERNELS = {
    "model_values": ("redux_tpu_torch/csrc/model_values.cu", "redux_tpu/ops/pallas_model.py:63"),
    "encode": ("redux_tpu_torch/csrc/encode.cu", "redux_tpu/ops/pallas_encode.py:86"),
    "decode": ("redux_tpu_torch/csrc/decode.cu", "redux_tpu/ops/pallas_decode.py:109"),
    "encode_fused": ("redux_tpu_torch/csrc/encode_fused.cu", "redux_tpu/ops/pallas_encode.py:86"),
    "encode_m": ("redux_tpu_torch/csrc/encode_m.cu", "redux_tpu/ops/pallas_encode.py:564"),
}
# The staging kernels around K1-K3 (ops/staging.py), keyed by their launch
# counters' names, and the host code of redux_tpu/api.py that each takes over.
STAGING = {
    "gather_rows": ("redux_tpu_torch/csrc/staging.cu",
                    "redux_tpu/api.py:141 (_gather_slices; decode's _stage :460, raw splice :563)"),
    "splice_payload": ("redux_tpu_torch/csrc/staging.cu",
                       "redux_tpu/api.py:357 (encode's payload splice)"),
    "crc32": ("redux_tpu_torch/csrc/staging.cu",
              "redux_tpu/api.py:278 (container.compute_crc; decode's verify_crc :574)"),
    "histogram": ("redux_tpu_torch/csrc/staging.cu",
                  "no TPU kernel: redux_tpu/api.py:271 (the prior's np.bincount on the host)"),
}
# The encoders from symbols (K4, K5): kernel and plain version.
SYMBOL_ENCODERS = {
    "encode_fused": (encode_blocks_fused, encode_blocks_fused_plain),
    "encode_m": (encode_blocks_m, encode_blocks_m_plain),
}
K = 4096  # block size of the phase-3 checks: the main path's auto size at 64 MiB
SEED = 7

# The card's peaks for the bounds (NVIDIA H100 SXM at its 700 W limit):
# device memory 3.35 TB/s (data sheet); int32 arithmetic 64 lanes an SM
# (Hopper white paper) x 132 SMs x 1.98 GHz boost clock.
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# Integer operations a symbol of the plain algorithm, each add, compare,
# shift, multiply or division counted once.  No single PyTorch call
# computes any of these functions (an adaptive model or an interval coder
# is a serial state machine per block), so each kernel's library time is
# None.
OPS_PER_SYMBOL = {
    "model_values": 12,  # two row reads, the freeze test, a 9-node Fenwick update
    "encode": 30,        # count, narrowing (2 mul, 2 div, 4 add), renorm ~12, emission ~8
    "decode": 50,        # value 5, a 9-step search, encode's narrowing and renorm, update, bit read
    "encode_fused": 42,  # model_values + encode
    "encode_m": 42,      # the same function as encode_fused
}
# Integer operations a byte the staging kernels place: an index, a compare
# and a shift or select (S1, S2); the table-driven CRC's xor, mask,
# lookup and shift (S3); the byte's extract, its bin's address and the
# shared-memory add (S4).  S3's prefixes checked against zlib: around its
# segment, a warp's 32 segments and a CTA's tile.  S1-S3 have no PyTorch
# call that computes them (a ragged gather, the payload splice, CRC-32),
# so their library time is None; S4's is ``torch.bincount`` on the card.
OPS_PER_BYTE = {"gather_rows": 3, "splice_payload": 3, "crc32": 4, "histogram": 3}
CRC_EDGES = (0, 1, CRC_SEGMENT - 1, CRC_SEGMENT, CRC_SEGMENT + 1, 32 * CRC_SEGMENT + 1,
             CRC_THREADS * CRC_SEGMENT - 1, CRC_THREADS * CRC_SEGMENT + 1)
ROW_BYTES = 4 * 258  # the int32 initial row


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def plain_run(fn, timed: bool):
    """``fn()`` once; returns its result and its device milliseconds (CUDA
    events), or None for the time when ``timed`` is false."""
    if not timed:
        return fn(), None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


# Cycles the card sleeps a timed run before its first event: the host
# queues the runs meanwhile, so a kernel shorter than its launch's host
# work is timed back to back, not at the host's pace.
SLEEP_CYCLES_PER_RUN = 400_000


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA events
    after a sleep kernel that lets the host queue them; a ``fn`` that waits
    for the card is timed at its own pace)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_RUN * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean wall milliseconds of ``fn()`` and a wait for the card, over
    ``reps`` runs: a wrapper call with its host work, until its result is
    there."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _blocks(data, s0: int, s1: int, block_size: int, device: torch.device) -> torch.Tensor:
    """Blocks ``s0 .. s1`` of ``data`` as a ``(s1 - s0, block_size)`` uint8
    tensor on ``device``, zero past the end of ``data``: one copy from
    ``data``, the last block's tail zeroed on the device."""
    a, b = s0 * block_size, min(s1 * block_size, len(data))
    out = torch.empty((s1 - s0) * block_size, dtype=torch.uint8, device=device)
    out[: b - a].copy_(_host_u8(data)[a:b])
    out[b - a :].zero_()
    return out.view(s1 - s0, block_size)


def _byte_histogram(u8: torch.Tensor) -> torch.Tensor:
    """(256,) int64 counts of the bytes of a uint8 tensor, on its device
    (the reference's ``np.bincount``): S4 into a zeroed row, no wait."""
    return byte_histogram(u8, torch.zeros(256, dtype=torch.int64, device=u8.device))


class KernelInputs:
    """What the main path hands the kernels for ``data``: its blocks, the
    initial row (with the warm-start prior) and the word capacity."""

    def __init__(self, data: bytes, params: Parameters, delta: int, block_size: int,
                 device: torch.device):
        lens = api._block_lens(len(data), block_size)
        syms = _blocks(data, 0, lens.size, block_size, device)
        hist = _byte_histogram(syms.view(-1)[: len(data)]).cpu().numpy()
        ic = api._init_cum(params, api._prior_extra(hist, params, api.DEFAULT_PRIOR_BUDGET))
        self._place(syms, lens, ic, params, delta, device)

    @classmethod
    def of_blocks(cls, syms, lens, init_cum: np.ndarray, params: Parameters, delta: int,
                  device: torch.device) -> "KernelInputs":
        """The kernels' inputs for given ``(B, K)`` uint8 blocks, their
        ``(B,)`` int32 lengths (arrays or tensors) and an initial row of
        one's own."""
        x = cls.__new__(cls)
        x._place(syms, lens, init_cum, params, delta, device)
        return x

    def _place(self, syms, lens, ic, params, delta, device) -> None:
        self.params, self.delta, self.k = params, delta, syms.shape[1]
        self.syms = torch.as_tensor(syms).to(device)
        self.lens = torch.as_tensor(lens).to(device)
        self.init_cum = init_cum_from_numpy(ic, params, device)
        self.init_total = int(ic[-1])
        self.n_words = api._encode_words(params, self.k, delta)


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the int32 rate, and which bounds."""
    mem_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    by_bytes = mem_ms >= ops_ms
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(mem_ms, ops_ms),
            "bound_by": "bytes" if by_bytes else "operations",
            "bound": "memory" if by_bytes else "ops"}


def kernel_bounds(x: KernelInputs, staged: torch.Tensor, klens: torch.Tensor) -> dict:
    """Each kernel's bytes (every input read once, every output written
    once), operations and bound at the shapes it runs on ``x``; K3 reads
    the ``staged`` words and decodes ``klens`` symbols a block."""
    b, k = x.syms.shape
    n = b * k
    coded = int(x.lens.clamp(0, k).sum())
    decoded = int(klens.clamp(0, k).sum())
    lens_b = 4 * b
    triple = 4 * b * x.n_words + 4 * b + b  # words, byte_lens, ovf
    from_syms = bound(n + lens_b + ROW_BYTES + triple, OPS_PER_SYMBOL["encode_m"] * coded)
    return {
        "model_values": bound(n + lens_b + ROW_BYTES + 8 * n, OPS_PER_SYMBOL["model_values"] * n),
        "encode": bound(8 * n + lens_b + triple, OPS_PER_SYMBOL["encode"] * coded),
        "decode": bound(4 * staged.numel() + lens_b + ROW_BYTES + b * x.k,
                        OPS_PER_SYMBOL["decode"] * decoded),
        "encode_fused": from_syms,
        "encode_m": from_syms,
    }


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def triple_rows(a, b, n_words: int) -> torch.Tensor:
    """``(B,)`` bool: the blocks where two ``(words, byte_lens, ovf)``
    triples differ (byte lengths and ovf exactly, the words up to each byte
    length)."""
    words, bl, ovf = a
    wvalid = torch.arange(n_words, device=words.device)[None, :] * 4 < bl[:, None]
    return (bl != b[1]) | (ovf != b[2]) | ((words != b[0]) & wvalid).any(1)


def triple_err(a, b, n_words: int) -> int:
    """Largest difference of two ``(words, byte_lens, ovf)`` triples: byte
    lengths and ovf exactly, the words up to each byte length."""
    words, bl, ovf = a
    err = max(_max_abs(bl, b[1]), _max_abs(ovf, b[2]))
    wvalid = torch.arange(n_words, device=words.device)[None, :] * 4 < bl[:, None]
    return max(err, _max_abs(words[wvalid], b[0][wvalid]))


def _require_rows(bad: torch.Tensor, msg: str) -> None:
    """Raise AssertionError naming the first block of ``bad`` ((B,) bool)
    and how many there are, unless none is set."""
    rows = torch.nonzero(bad).flatten().tolist()
    _require(not rows, f"{msg}: block {rows[0]} first, {len(rows)} blocks" if rows else msg)


def compare_kernels(x: KernelInputs, time_plain: bool = True, reps: int = 3,
                    lossy: torch.Tensor | None = None, decode_raw: bool = False) -> dict:
    """Run every kernel and its plain version on ``x``; assert exact
    equality; return per kernel ``max_abs_err``, ``ms`` and ``plain_ms``
    (each plain version runs once, timed in that run when ``time_plain``;
    each kernel's ``ms`` is the mean of ``reps`` timed launches, None for
    ``reps=0``) and its bound (:func:`kernel_bounds`).  A difference raises
    AssertionError naming the kernel and the first block that differs.

    K4 and K5 must also give K2's triple on the same input; where the
    parameters are off their path (not ``fits_u32`` or ``fits_wide32``)
    both wrappers must raise ValueError, and their entry says so.
    K3 decodes K2's streams as the main path stages them: blocks stored
    raw (ovf, or not smaller than raw) get no symbols, the rest must come
    back as their input bytes, but for the blocks set in ``lossy`` ((B,)
    bool: streams that the reference's own decoder does not give back).
    With ``decode_raw`` it also decodes the streams not smaller than raw,
    as ``mesh.decode_blocks_sharded``'s callers do: then only the
    incomplete streams (ovf, or past the word buffer) get no symbols.
    It runs on the lanes in block order and sorted by coded length (the
    main path's order, ``api.decode``); its ``ms`` is the sorted lanes'
    time and ``ms_unsorted`` the other.  ``k2_triple`` and ``k3_syms`` are
    K2's and K3's outputs (K3's in block order).
    """
    p, d = x.params, x.delta
    out = {}
    valid = torch.arange(x.k, device=x.syms.device)[None, :] < x.lens[:, None]

    def kernel_ms(fn):
        return cuda_ms(fn, reps) if reps else None

    lo, hi = model_lohi(x.syms, x.lens, x.init_cum, p, d)
    (lo_p, hi_p), plain_ms = plain_run(
        lambda: model_lohi_plain(x.syms, x.lens, x.init_cum, p, d), time_plain)
    err = max(_max_abs(lo[valid], lo_p[valid]), _max_abs(hi[valid], hi_p[valid]))
    _require_rows((((lo != lo_p) | (hi != hi_p)) & valid).any(1),
                  f"model_values differs from its plain version (max |diff| {err})")
    out["model_values"] = {
        "max_abs_err": err,
        "ms": kernel_ms(lambda: model_lohi(x.syms, x.lens, x.init_cum, p, d)),
        "plain_ms": plain_ms,
    }

    enc = (lo, hi, x.lens, x.init_total, p, x.n_words, d)
    coded = encode_blocks(*enc)
    coded_p, plain_ms = plain_run(lambda: encode_blocks_plain(*enc), time_plain)
    err = triple_err(coded, coded_p, x.n_words)
    _require_rows(triple_rows(coded, coded_p, x.n_words),
                  f"encode differs from its plain version (max |diff| {err})")
    out["encode"] = {
        "max_abs_err": err,
        "ms": kernel_ms(lambda: encode_blocks(*enc)),
        "plain_ms": plain_ms,
    }

    sym_args = (x.syms, x.lens, x.init_cum, p, x.n_words, d)
    for name, (kernel, plain) in SYMBOL_ENCODERS.items():
        if not (p.fits_u32 or p.fits_wide32):
            try:
                kernel(*sym_args)
            except ValueError:
                pass
            else:
                raise AssertionError(f"{name} took parameters off its path: {p}")
            out[name] = {"max_abs_err": 0, "ms": None, "plain_ms": None, "raises": "ValueError"}
            continue
        mine = kernel(*sym_args)
        mine_p, plain_ms = plain_run(lambda: plain(*sym_args), time_plain)
        err = triple_err(mine, mine_p, x.n_words)
        _require_rows(triple_rows(mine, mine_p, x.n_words),
                      f"{name} differs from its plain version (max |diff| {err})")
        err_k2 = triple_err(mine, coded, x.n_words)
        _require_rows(triple_rows(mine, coded, x.n_words),
                      f"{name} differs from K1 -> K2 (max |diff| {err_k2})")
        out[name] = {
            "max_abs_err": max(err, err_k2),
            "ms": kernel_ms(lambda: kernel(*sym_args)),
            "plain_ms": plain_ms,
        }

    words, bl, ovf = coded
    raw = ovf | (bl >= x.lens)
    skip = ovf | (bl > 4 * x.n_words) if decode_raw else raw
    klens = torch.where(skip, 0, x.lens).to(torch.int32)
    coded_max = int(torch.where(skip, 0, bl).max())
    wcap = min(max(4, -(-coded_max // 4) + 2), x.n_words + 2)
    # The coder leaves zeros past each stream; two zero words follow the longest.
    staged = torch.nn.functional.pad(words, (0, 2))[:, :wcap].contiguous()
    dec = (staged, klens, x.init_cum, p, x.k, d)
    syms = decode_blocks(*dec)
    syms_p, plain_ms = plain_run(lambda: decode_blocks_plain(*dec), time_plain)
    err = _max_abs(syms, syms_p)
    _require_rows((syms != syms_p).any(1),
                  f"decode differs from its plain version (max |diff| {err})")
    order = torch.argsort(torch.where(skip, 0, bl), stable=True)
    dec_sorted = (staged[order].contiguous(), klens[order].contiguous(), x.init_cum, p, x.k, d)
    syms_sorted = decode_blocks(*dec_sorted)
    err_sorted = _max_abs(syms_sorted, syms_p[order])
    bad = torch.zeros_like(skip)
    bad[order] = (syms_sorted != syms_p[order]).any(1)
    _require_rows(bad, "decode on sorted lanes differs from its plain version "
                  f"(max |diff| {err_sorted})")
    must = ~skip if lossy is None else ~skip & ~lossy
    _require_rows(must & ((syms != x.syms) & valid).any(1), "decode lost the input")
    out["decode"] = {
        "max_abs_err": max(err, err_sorted),
        "ms": kernel_ms(lambda: decode_blocks(*dec_sorted)),
        "ms_unsorted": kernel_ms(lambda: decode_blocks(*dec)),
        "plain_ms": plain_ms,
    }
    for name, b in kernel_bounds(x, staged, klens).items():
        out[name].update(b)
    out["raw_blocks"] = int(raw.sum())
    out["k2_triple"] = coded
    out["k3_syms"] = syms
    return out


def check_chunk_streams(data: bytes, archive: bytes, device, chunks) -> list:
    """Hold lane chunks of ``archive`` to the plain versions: each of
    ``chunks`` (indices of ``api.encode``'s chunks of ``data``) is
    re-encoded with the archive's own initial row and word capacity in one
    ``encode_blocks_ranked`` launch (K1 -> K2, as ``encode`` ran it) and by
    ``model_lohi_plain`` -> ``encode_blocks_plain``.  The two must agree,
    and the archive must store the same blocks raw and each coded block's
    stream byte for byte.  Then K3 and ``decode_blocks_plain`` decode the
    archive's streams of those blocks, staged and sorted by length as
    ``decode`` stages them: they must agree and give back the blocks.
    Returns ``(first block, blocks, raw blocks, plain ms)`` a chunk, the
    plain versions' ms keyed by kernel (CUDA events; None off the card)."""
    device = torch.device(device)
    timed = device.type == "cuda"
    header = container.parse_table(archive)
    p, k, d = header.params, header.block_size, header.delta
    ic = api._init_cum(p, header.prior_extra)
    arch = _host_u8(archive).to(device)
    lens = api._block_lens(len(data), k)
    lanes = api._decode_lanes(header)
    chunk = api._lane_chunk(api.ENC_CHUNK_BYTES, k)
    out = []
    for c in chunks:
        s0, s1 = c * chunk, min((c + 1) * chunk, lens.size)
        x = KernelInputs.of_blocks(_blocks(data, s0, s1, k, device), lens[s0:s1], ic, p, d,
                                   device)
        mine = encode_blocks_ranked(x.syms, x.lens, x.init_cum, p, x.n_words, d)
        (lo, hi), ms_model = plain_run(
            lambda: model_lohi_plain(x.syms, x.lens, x.init_cum, p, d), timed)
        plain, ms_enc = plain_run(
            lambda: encode_blocks_plain(lo, hi, x.lens, x.init_total, p, x.n_words, d), timed)
        del lo, hi
        _require_rows(triple_rows(mine, plain, x.n_words),
                      f"chunk {c}: K1 -> K2 differs from the plain versions")
        del mine
        words, bl, ovf = plain
        raw_c = (ovf | (bl >= x.lens)).cpu().numpy()
        _require(np.array_equal(raw_c, lanes.raw[s0:s1]), f"chunk {c}: other blocks stored raw")
        bl = bl.cpu().numpy()
        coded = np.flatnonzero(~raw_c)
        _require(np.array_equal(bl[coded], lanes.coded_lens[s0:s1][coded]),
                 f"chunk {c}: stream lengths differ from the archive's")
        coded_t = torch.from_numpy(coded).to(device)
        byts = words_to_bytes(words)[coded_t]
        del words, plain
        bl_c = bl[coded].astype(np.int64)
        keep = (torch.arange(byts.shape[1], device=device)[None, :]
                < torch.from_numpy(bl_c).to(device)[:, None])
        stored = gather_rows(arch, header.stream_offs[s0:s1][coded], bl_c, byts.shape[1])
        _require(torch.equal(torch.where(keep, byts, 0), stored),
                 f"chunk {c}: streams differ from the archive's")
        del byts, keep, stored

        sel = s0 + np.argsort(lanes.coded_lens[s0:s1], kind="stable")
        staged, klens = api._stage_lanes(arch, header, lanes, sel)
        syms = decode_blocks(staged, klens, x.init_cum, p, k, d)
        syms_p, ms_dec = plain_run(
            lambda: decode_blocks_plain(staged, klens, x.init_cum, p, k, d), timed)
        _require_rows((syms != syms_p).any(1), f"chunk {c}: K3 differs from its plain version")
        valid = torch.arange(k, device=device)[None, :] < klens[:, None]
        want = x.syms[torch.from_numpy(sel - s0).to(device)]
        _require_rows(((syms_p != want) & valid).any(1), f"chunk {c}: K3 lost the input")
        out.append((s0, s1 - s0, int(raw_c.sum()),
                    {"model_values": ms_model, "encode": ms_enc, "decode": ms_dec}))
    return out


def decode_memory_bound(header: container.BlockTable, shares=None) -> int:
    """Bytes of device memory ``api.decode`` may hold at once on one
    device for the archive of ``header`` (:func:`container.parse_table`)
    and that device's ``shares`` (``api._Share``s; default: one device's,
    every lane chunk), reckoned from its widest share's shapes: two
    slots, each the largest share's slice of the archive (two are held:
    the next share's goes up while one decodes), its staged words
    (``rows x (n_words + 2)`` int32, the widest K3's input can be), K3's
    symbols and the share's output (``rows x k`` bytes each).  None of it
    grows with the input past one chunk."""
    k = header.block_size
    if shares is None:
        shares = api._shares(header.n_blocks, api._lane_chunk(api.DEC_CHUNK_BYTES, k), 1)
        shares = [sh for step in shares for sh in step]
    ends = api._stream_ends(header, api._decode_lanes(header))
    rows = max(sh.s1 - sh.s0 for sh in shares)
    piece = max(int(ends[sh.s1 - 1]) - int(header.stream_offs[sh.s0]) for sh in shares)
    n_words = api._static_words(header.params, k, header.delta)
    return 2 * (piece + 4 * rows * (n_words + 2) + 2 * rows * k)


def encode_memory_bound(n_bytes: int, block_size: int, params: Parameters,
                        delta: int = container.DEFAULT_DELTA) -> int:
    """Bytes of device memory ``api.encode`` may hold at once for an input
    of ``n_bytes``, reckoned from one chunk's shapes (``rows`` blocks of
    ``block_size``): two input slots (one for an input of one chunk), K1's
    lo/hi planes (``rows x k`` int32 each), K2's words (``rows x n_words``
    int32) and one payload (at most ``rows x k`` bytes), 64 bytes a row
    for the lengths, flags and row table, and 1 MiB for the tensors of a
    call (histogram, CRCs, the initial row) as the allocator rounds them.
    None of it grows with the input past one chunk."""
    k = block_size
    n_blocks = -(-n_bytes // k)
    rows = min(api._lane_chunk(api.ENC_CHUNK_BYTES, k), n_blocks)
    slots = 1 if n_blocks <= rows else 2
    n_words = api._encode_words(params, k, delta)
    return (slots * rows * k + 8 * rows * k + 4 * rows * n_words + rows * k + 64 * rows
            + (1 << 20))


def compare_staging(data: bytes, device, block_size: int | None = None,
                    time_plain: bool = True, reps: int = 3) -> dict:
    """S1-S4 against their plain versions at the shapes ``api`` gives them
    for ``data`` at the shipped defaults (tpu_wide, delta 16, the prior),
    in one lane chunk each way; tolerance 0.

    S3 (``crc32``): the input, its prefixes of ``CRC_EDGES`` bytes and
    its tail from 1, 7 and 15 bytes in, each also equal to
    ``zlib.crc32``.  S2 (``splice_payload``): K1 -> K2 over the input's
    blocks in one launch, the raw rule, and the payload, which must also
    be the archive's.  S1 (``gather_rows``):
    every lane of the archive sorted by coded length, as ``decode``
    stages them (words; they must also be K2's words), and the raw
    blocks' rows (bytes; they must also be the input's blocks).  S4
    (``histogram``): the input on the card as pass 1 counts it, and from
    1, 7 and 15 bytes in, each into a zeroed row and once more into a row
    that already holds counts, equal to the plain version on the same
    bytes on the host.  Returns
    per kernel ``max_abs_err``, ``ms`` (the kernel's launch alone, the
    mean of ``reps``, CUDA events, :func:`cuda_ms`; S1's in word mode,
    ``ms_bytes`` in byte mode, None without raw blocks), ``ms_call`` (the
    wrapper with its checks until its result is on the card, wall clock,
    :func:`call_ms`), ``plain_ms`` (one run,
    timed when ``time_plain`` on the card; S4's on the host, wall clock),
    ``library_ms`` (S4's ``torch.bincount`` on the card, :func:`cuda_ms`;
    None for S1-S3) and the bound of what it moves
    (:func:`bound`); and ``raw_rows``, the raw blocks."""
    dev = torch.device(device)
    timed = time_plain and dev.type == "cuda"
    p, d = Parameters.tpu_wide(), container.DEFAULT_DELTA
    k = block_size or api._default_block_size(len(data))
    x = KernelInputs(data, p, d, k, dev)
    b = x.syms.shape[0]
    chunk = min(api._lane_chunk(api.ENC_CHUNK_BYTES, k), api._lane_chunk(api.DEC_CHUNK_BYTES, k))
    _require(b <= chunk, "compare_staging takes one lane chunk")
    archive = api.encode(data, block_size=k, device=dev)
    header = container.parse_table(archive)
    lanes = api._decode_lanes(header)
    arch = _host_u8(archive).to(dev)
    out = {}

    def kernel_ms(fn, timer=cuda_ms):
        return timer(fn, reps) if reps and dev.type == "cuda" else None

    flat = x.syms.view(-1)[: len(data)]
    for m in CRC_EDGES:
        m = min(m, len(data))
        want = zlib.crc32(data[:m])
        _require(crc32(flat[:m]) == crc32_plain(flat[:m]) == want, f"crc32 differs at {m} bytes")
    for a in (1, 7, 15):
        _require(crc32(flat[a:]) == zlib.crc32(data[a:]), f"crc32 differs {a} bytes in")
    got = crc32(flat)
    plain, plain_ms = plain_run(lambda: crc32_plain(flat), timed)
    _require(got == plain == header.crc32,
             f"crc32 {got:#x}, plain {plain:#x}, archive {header.crc32:#x}")
    scratch = torch.empty(1, dtype=torch.int32, device=dev)
    out["crc32"] = {"max_abs_err": abs(got - plain),
                    "ms": kernel_ms(lambda: launch_crc32(flat, scratch)),
                    "ms_call": kernel_ms(lambda: crc32(flat), call_ms), "plain_ms": plain_ms,
                    "library_ms": None,
                    **bound(len(data) + 4, OPS_PER_BYTE["crc32"] * len(data))}
    out["histogram"] = _compare_histogram(data, flat, timed, kernel_ms)

    words, bl, ovf = encode_blocks_ranked(x.syms, x.lens, x.init_cum, p, x.n_words, d)
    raw = ovf | (bl >= x.lens)
    head = torch.stack([torch.where(raw, x.lens, bl), raw.to(torch.int32)]).cpu()
    args = (words, x.syms, head[1].bool(), head[0])
    total = int(args[3].sum(dtype=torch.int64))
    pay = splice_payload(*args)
    rows = splice_rows(*args[2:], dev)
    pay_p, plain_ms = plain_run(lambda: splice_payload_plain(*args), timed)
    err = _max_abs(pay, pay_p)
    _require(err == 0, f"splice_payload differs from its plain version (max |diff| {err})")
    stored = torch.frombuffer(bytearray(archive[len(archive) - total :]), dtype=torch.uint8)
    _require(torch.equal(pay.cpu(), stored), "splice_payload differs from the archive's payload")
    out["splice_payload"] = {"max_abs_err": err,
                             "ms": kernel_ms(lambda: launch_splice_payload(words, x.syms, *rows,
                                                                           pay_p)),
                             "ms_call": kernel_ms(lambda: splice_payload(*args), call_ms),
                             "plain_ms": plain_ms, "library_ms": None,
                             **bound(2 * total + 9 * b, OPS_PER_BYTE["splice_payload"] * total)}
    del pay, pay_p, stored, rows

    sel = api._by_length(lanes.coded_lens)
    staged, _ = api._stage_lanes(arch, header, lanes, sel)
    wcap = staged.shape[1]
    sel_t = torch.from_numpy(sel).to(dev)
    offs, lens = header.stream_offs[sel], lanes.coded_lens[sel]
    table = _to_device(np.stack([offs, lens]), dev)  # what the wrapper uploads
    staged_p, plain_ms = plain_run(lambda: gather_rows_plain(arch, *table, wcap, True), timed)
    err = _max_abs(staged, staged_p)
    _require_rows((staged != staged_p).any(1),
                  f"gather_rows (words) differs from its plain version (max |diff| {err})")
    k2 = torch.nn.functional.pad(words, (0, 2))[sel_t, :wcap]
    _require_rows(((staged != k2) & (table[1] > 0)[:, None]).any(1),
                  "gather_rows (words) differs from K2's streams")
    moved = int(lens.sum())
    out["gather_rows"] = {"max_abs_err": err,
                          "ms": kernel_ms(lambda: launch_gather_rows(arch, *table, staged_p, True)),
                          "ms_call": kernel_ms(lambda: gather_rows(arch, offs, lens, wcap, True),
                                               call_ms),
                          "plain_ms": plain_ms, "library_ms": None, "wcap": wcap,
                          **bound(moved + 16 * b + 4 * b * wcap,
                                  OPS_PER_BYTE["gather_rows"] * 4 * b * wcap)}
    del staged, staged_p, k2, words

    ri = np.flatnonzero(lanes.raw)
    ri_t = torch.from_numpy(ri).to(dev)
    offs, lens = header.stream_offs[ri], lanes.block_lens[ri].astype(np.int64)
    table = _to_device(np.stack([offs, lens]), dev)
    rows = gather_rows(arch, offs, lens, k)
    rows_p = gather_rows_plain(arch, *table, k, False)
    err_b = _max_abs(rows, rows_p)
    valid = torch.arange(k, device=dev)[None, :] < x.lens[ri_t][:, None]
    _require(err_b == 0 and torch.equal(rows, torch.where(valid, x.syms[ri_t], 0)),
             f"gather_rows (bytes) differs from its plain version or the blocks ({err_b})")
    out["gather_rows"]["max_abs_err"] = max(err, err_b)
    out["gather_rows"]["ms_bytes"] = (
        kernel_ms(lambda: launch_gather_rows(arch, *table, rows_p, False)) if ri.size else None)
    out["gather_rows"]["edge_cases"] = gather_edge_cases(arch, (k, 1022, 37), (wcap, 13))
    out["raw_rows"] = int(ri.size)
    return out


def _compare_histogram(data: bytes, flat: torch.Tensor, timed: bool, kernel_ms) -> dict:
    """S4 for :func:`compare_staging`: ``flat``, the bytes of ``data`` on
    its device, counted from 0, 1, 7 and 15 bytes in (any alignment),
    each against :func:`byte_histogram_plain` on the same bytes on the
    host; the whole input added once more into the row from 1 byte in
    (a row that already holds counts)."""
    dev = flat.device
    host = torch.frombuffer(bytearray(data), dtype=torch.uint8)

    def zeros(where):
        return torch.zeros(256, dtype=torch.int64, device=where)

    err, want = 0, {}
    for a in (0, 1, 7, 15):
        want[a] = byte_histogram_plain(host[a:], zeros("cpu"))
        got = byte_histogram(flat[a:], zeros(dev)).cpu()
        err = max(err, _max_abs(got, want[a]))
    both = byte_histogram(flat, byte_histogram(flat[1:], zeros(dev))).cpu()
    err = max(err, _max_abs(both, want[0] + want[1]))
    _require(err == 0, f"byte_histogram differs from its plain version (max |diff| {err})")
    plain_ms = None
    if timed:
        t0 = time.perf_counter()
        byte_histogram_plain(host, zeros("cpu"))
        plain_ms = (time.perf_counter() - t0) * 1e3
    row = zeros(dev)
    return {"max_abs_err": err, "ms": kernel_ms(lambda: launch_byte_histogram(flat, row)),
            "ms_call": kernel_ms(lambda: byte_histogram(flat, row), call_ms),
            "plain_ms": plain_ms,
            "library_ms": kernel_ms(lambda: torch.bincount(flat, minlength=256)),
            **bound(len(data), OPS_PER_BYTE["histogram"] * len(data))}


def gather_edge_cases(buf: torch.Tensor, byte_widths, word_widths, seed: int = SEED) -> int:
    """S1 (``gather_rows``) against its plain version on ``buf`` and on views
    of it 1, 7 and 15 bytes in (the buffer itself at any alignment), at
    each width of ``byte_widths`` (bytes) and ``word_widths`` (words):
    rows at offsets of every residue mod 16 and random lengths up to the
    row's capacity, an empty row, a row as wide as its width, rows that
    end at the buffer's last byte (full, one byte, empty at the end).
    Raises AssertionError on any difference; returns the cases run."""
    rng = np.random.default_rng(seed)
    cases = 0
    for a in (0, 1, 7, 15):
        view = buf[a:]
        n = view.shape[0]
        for words, width in [(False, w) for w in byte_widths] + [(True, w) for w in word_widths]:
            cap = 4 * width if words else width
            if n < cap + 16 * 16:
                continue
            q = rng.integers(0, (n - cap) // 16, 64)
            offs = np.concatenate([16 * q + np.arange(64) % 16, [0, 5, n - cap, n - 1, n]])
            lens = np.concatenate([rng.integers(0, cap + 1, 64), [0, cap, cap, 1, 0]])
            got = gather_rows(view, offs, lens, width, words)
            table = _to_device(np.stack([offs, lens]), view.device)
            want = gather_rows_plain(view, *table, width, words)
            _require(torch.equal(got, want),
                     f"gather_rows ({'words' if words else 'bytes'}, width {width}, buffer "
                     f"{a} bytes in) differs from its plain version")
            cases += 1
    return cases


def check_staging(device: torch.device, n_blocks: int = 1024) -> dict:
    """Phase 3 for S1-S4 (:func:`compare_staging`): ``n_blocks`` blocks of
    4096 of :func:`phase3_data` (raw blocks, a short last block, a length
    that is not a multiple of ``CRC_SEGMENT``), and 101 blocks of 1022
    bytes (a block size that is not a multiple of 4)."""
    data = phase3_data(n_blocks, K, SEED)
    return {"tpu_wide": compare_staging(data, device, K),
            "odd_101x1022": compare_staging(data[: 101 * 1022 - 340], device, 1022,
                                            time_plain=False, reps=0)}


def corruptions(archive: bytes):
    """The corrupted archives of the reference's container fuzz
    (``tests/test_fuzz_container.py``) as ``(kind, bytes)``: every
    truncation of the first 64 bytes and every 97th past them; bits 0, 3
    and 7 flipped in each of the first 64 bytes and at 120 random
    positions; random garbage, bare and after the magic."""
    for n in [*range(64), *range(64, len(archive), 97)]:
        yield "truncation", archive[:n]
    rng = np.random.default_rng(11)
    buf = np.frombuffer(archive, dtype=np.uint8)
    for pos in [*range(min(64, len(archive))),
                *rng.integers(0, len(archive), 120).tolist()]:
        for bit in (0, 3, 7):
            c = buf.copy()
            c[pos] ^= 1 << bit
            yield "bit flip", c.tobytes()
    rng = np.random.default_rng(13)
    for n in (0, 1, 4, 31, 32, 33, 200):
        yield "garbage", rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    yield "garbage", b"RXT1" + rng.integers(0, 256, 100, dtype=np.uint8).tobytes()


def corruption_sweep(data: bytes, archive: bytes, device) -> dict:
    """``api.decode`` of every archive of :func:`corruptions` on ``device``:
    each must raise a ReduxError or give back ``data`` exactly.  Returns
    ``{kind: {"raised": n, "exact": m}}``; wrong bytes raise
    AssertionError, and any other exception (a CUDA error too) propagates."""
    out = {}
    for kind, bad in corruptions(archive):
        try:
            got = api.decode(bad, device=device)
        except ReduxError:
            outcome = "raised"
        else:
            _require(got == data, f"{kind}: a corrupted archive decoded to wrong bytes")
            outcome = "exact"
        counts = out.setdefault(kind, {"raised": 0, "exact": 0})
        counts[outcome] += 1
    return out


def phase3_data(n_blocks: int, k: int, seed: int) -> bytes:
    """Skewed text-like blocks, every 32nd block incompressible, and a short
    last block."""
    data = bytearray(text_like(n_blocks * k, seed))
    for b in range(5, n_blocks, 32):
        data[b * k : (b + 1) * k] = incompressible(k, seed + b)
    return bytes(data[: n_blocks * k - k // 3])


def odd_inputs(data: bytes, n_blocks: int, k: int, device: torch.device) -> KernelInputs:
    """tpu_wide inputs off the kernels' even shapes: ``n_blocks`` blocks of
    ``k`` from ``data`` (the last one short), with a pad lane (lens -1), an
    empty and a 1-byte block among them."""
    x = KernelInputs(data[: n_blocks * k - k // 3], Parameters.tpu_wide(), 16, k, device)
    x.lens[3:6] = torch.tensor([-1, 0, 1], dtype=torch.int32)
    return x


def check_kernels(device: torch.device, n_blocks: int = 1024) -> dict:
    """Phase 3: the kernels against their plain versions (and K4, K5
    against K2) at tpu_wide, delta 16 with the prior; at tpu32 with the
    freeze engaged; at the reference CLI's (8,30,32), where K2 takes its
    u64 instantiation, K3 its reciprocal quotients as everywhere, and K4
    and K5 must refuse the parameters; and
    at shapes off the even ones: B not a multiple of 32 (K4's partial last
    group) with K not a multiple of 32 or 4 (K2's scalar loads), K a
    multiple of 4 but not of 8 (K2's last positions after its groups), and
    K under 256 and not a multiple of 16 (K5's byte loads and last
    positions)."""
    data = phase3_data(n_blocks, K, SEED)
    wide = KernelInputs(data, Parameters.tpu_wide(), 16, K, device)
    res = {"tpu_wide": compare_kernels(wide)}
    small = KernelInputs(data[: (n_blocks // 4) * K], Parameters.tpu32(), 16, K, device)
    _require(small.init_total + 16 * K > small.params.freq_max, "tpu32 case must freeze")
    res["tpu32_freeze"] = compare_kernels(small, time_plain=False, reps=1)
    # The reference CLI's (8,30,32): 32-bit code values, 62-bit products.
    cli = KernelInputs(data[: 64 * 1024], Parameters.default(), 7, 1024, device)
    res["default_8_30_32"] = compare_kernels(cli, time_plain=False, reps=1)
    for b, k in ((101, 1022), (70, 1020), (37, 220)):
        res[f"odd_{b}x{k}"] = compare_kernels(odd_inputs(data, b, k, device), time_plain=False,
                                              reps=1)
    return res


def check_goldens(device: torch.device, golden_dir: pathlib.Path) -> list:
    """Phase 4: encode each golden's input and compare with the stored file
    byte for byte, and decode the stored file.  Block archives (``rxt``)
    run on the card; the compact archive and the bare reference stream
    (``redux``) are host code (:mod:`redux_tpu_torch.native`).  Returns
    ``(file, format, input bytes, stored bytes)`` a golden."""
    results = []
    for entry in json.loads((golden_dir / "manifest.json").read_text()):
        data = golden_input(entry["kind"], entry["n"], entry["seed"])
        _require(hashlib.sha256(data).hexdigest() == entry["input_sha256"],
                 f"{entry['file']}: generated input differs from the manifest")
        stored = (golden_dir / entry["file"]).read_bytes()
        params = Parameters(*entry["params"])
        fmt = entry.get("format", "rxt")
        if fmt == "compact":
            mine, back = api.encode_compact(data, entry["cfg"]), api.decode_compact(stored)
        elif fmt == "redux":
            mine = native.compress_bytes(data, params)
            back = native.decompress_bytes(stored, params)
        else:
            mine = api.encode(data, params=params, delta=entry["delta"], device=device)
            back = api.decode(stored, device=device)
        _require(mine == stored, f"{entry['file']}: encode differs from the golden")
        _require(back == data, f"{entry['file']}: decode differs")
        results.append((entry["file"], fmt, len(data), len(stored)))
    return results


# -- generic models (chip_smoke.py phase 9 (b)) -------------------------------
#
# Two user rules the archive's kernels cannot express, each as a TorchModel
# and as a host twin for the oracle (the reference's
# tests/test_generic_model.py:61-109, 142-150, 184-192).


class CumHostModel(Model):
    """Host twin: a cumulative-row model with a pluggable increment and the
    freeze at ``freq_max``, in Python integers."""

    def __init__(self, params: Parameters, cum):
        self.params = params
        self.cum = [int(c) for c in cum]

    def _inc(self, symbol: int) -> int:
        raise NotImplementedError

    def _update(self, symbol: int) -> None:
        if self.total_frequency() < self.params.freq_max:
            d = self._inc(symbol)
            for i in range(symbol + 1, len(self.cum)):
                self.cum[i] += d

    def total_frequency(self) -> int:
        return self.cum[self.params.symbol_count]

    def get_frequency(self, symbol):
        res = (self.cum[symbol], self.cum[symbol + 1])
        self._update(symbol)
        return res

    def get_symbol(self, value):
        for i in range(len(self.cum) - 1):
            if value < self.cum[i + 1]:
                res = (i, self.cum[i], self.cum[i + 1])
                self._update(i)
                return res
        raise AssertionError("value out of range")

    def get_freq_table(self):
        return [(self.cum[i], self.cum[i + 1]) for i in range(self.params.symbol_count)]


class StaticHost(CumHostModel):
    """Host twin of :func:`redux_tpu_torch.ops.generic.static_torch_model`."""

    def _update(self, symbol):
        pass


class TwoSpeedHost(CumHostModel):
    """Per-symbol adaptation speed: +4 for bytes below 128, +1 otherwise."""

    def _inc(self, symbol):
        return 4 if symbol < 128 else 1


def two_speed_torch_model(params: Parameters, init_cum) -> TorchModel:
    """:class:`TwoSpeedHost`'s rule as a :class:`TorchModel`: the dense
    model's lookups with a per-lane increment."""
    base = dense_torch_model(params, init_cum, delta=4)  # the sentinel covers +4
    s, freq_max = params.symbol_count, params.freq_max

    def update(cum, sym, active):
        upd = active & (cum[:, s] < freq_max)
        inc = torch.where(sym < 128, 4, 1)
        above = torch.arange(s + 1, device=cum.device)[None, :] > sym[:, None]
        return cum + (above & upd[:, None]) * inc[:, None]

    return base._replace(update=update)


def skewed_cum(params: Parameters) -> np.ndarray:
    """A non-uniform static distribution (ASCII-heavy), total within ``freq_max``."""
    freqs = np.ones(params.symbol_count, dtype=np.int64)
    freqs[32:127] = 40
    freqs[ord("a") : ord("z") + 1] = 200
    cum = np.zeros(params.symbol_count + 1, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])
    return cum


def check_generic(device: torch.device, data: bytes, n_blocks: int = 256, k: int = K,
                  n_oracle: int = 4) -> dict:
    """Phase 9 (b): the generic-model coders on ``device`` over the first
    ``n_blocks`` blocks of ``k`` bytes of ``data`` (tpu_wide, delta 16, the
    slice's prior).

    The dense model's reference-format streams must equal K1's values
    (:func:`~redux_tpu_torch.ops.model.precompute_encode_model`) through
    :func:`redux_tpu_torch.ops.coder.encode_blocks`; K3 and
    :func:`~redux_tpu_torch.ops.generic.decode_blocks_generic` must both
    give back the input.  On the first ``n_oracle`` blocks the static and
    the two-speed models must give the oracle's streams, and the generic
    decoder must decode the oracle's.  Returns the stream bytes and the
    wall seconds of each step (device synchronised).
    """
    params, delta = Parameters.tpu_wide(), 16
    x = KernelInputs(data[: n_blocks * k], params, delta, k, device)
    # Room for any model: a count up to twice freq_max costs 23 bits a symbol at most.
    n_words = coder.max_block_words(2 * params.freq_max, params.symbol_count, params, k)
    dense = dense_torch_model(params, x.init_cum, delta)
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        secs[name] = time.perf_counter() - t0
        return out

    gw, gl = timed("generic_encode", lambda: encode_blocks_generic(x.syms, x.lens, dense, params,
                                                                   n_words))
    sw, sl = timed("k1_coder_encode", lambda: coder.encode_blocks(
        *precompute_encode_model(x.syms, x.lens, x.init_cum, params, delta), x.lens, params,
        n_words))
    _require(torch.equal(gl, sl) and torch.equal(gw, sw),
             "generic dense streams differ from K1 + coder.encode_blocks")
    back = timed("k3_decode", lambda: decode_blocks(gw, x.lens, x.init_cum, params, k, delta))
    _require(torch.equal(back, x.syms), "K3 does not decode the generic dense streams")
    back = timed("generic_decode", lambda: decode_blocks_generic(gw, x.lens, dense, params, k))
    _require(torch.equal(back.to(torch.uint8), x.syms),
             "decode_blocks_generic does not decode the generic dense streams")

    blocks = [data[i * k : (i + 1) * k] for i in range(min(n_oracle, x.syms.shape[0]))]
    syms, lens = x.syms[: len(blocks)], x.lens[: len(blocks)]
    cum, ic = skewed_cum(params), x.init_cum.cpu().numpy()
    for name, model, host in (
            ("static", static_torch_model(params, cum), lambda: StaticHost(params, cum)),
            ("two_speed", two_speed_torch_model(params, ic), lambda: TwoSpeedHost(params, ic))):
        enc, dec = make_generic_coders(model, params)
        words, byte_lens = timed(f"{name}_encode", lambda: enc(syms, lens, n_words))
        streams = words_to_streams(words.cpu().numpy().view(np.uint32), byte_lens.cpu().tolist())
        refs = [oracle.compress_bytes(b, host()) for b in blocks]
        _require(streams == refs, f"{name} model: generic streams differ from the oracle's")
        ref_words = torch.from_numpy(streams_to_words(refs, n_words).view(np.int32)).to(device)
        back = timed(f"{name}_decode", lambda: dec(ref_words, lens, k))
        _require(torch.equal(back.to(torch.uint8), syms),
                 f"{name} model: the generic decoder does not decode the oracle's streams")
    return {"blocks": x.syms.shape[0], "k": k, "stream_bytes": int(gl.sum()),
            "oracle_blocks": len(blocks), "seconds": secs}
