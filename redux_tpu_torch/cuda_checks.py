"""On-card checks of the kernels: each against its plain PyTorch version,
the port against the golden archives, and the generic-model coders
against K1, K3 and the oracle (:func:`check_generic`, which also runs on
CPU tensors).

Used by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.  Every check
compares integers exactly (tolerance 0: the bar is byte equality) and
raises AssertionError on any difference.  Times come from CUDA events.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import time

import numpy as np
import torch

from . import api, native, oracle
from .convert import init_cum_from_numpy
from .models.base import Model
from .ops import coder
from .ops.bitpack import streams_to_words, words_to_streams
from .ops.decode import decode_blocks, decode_blocks_plain
from .ops.encode import (encode_blocks, encode_blocks_fused, encode_blocks_fused_plain,
                         encode_blocks_plain)
from .ops.encode_m import encode_blocks_m, encode_blocks_m_plain
from .ops.generic import (TorchModel, decode_blocks_generic, dense_torch_model,
                          encode_blocks_generic, make_generic_coders, static_torch_model)
from .ops.model import model_lohi, model_lohi_plain, precompute_encode_model
from .params import Parameters
from .testdata import golden_input, incompressible, text_like

KERNELS = {
    "model_values": ("redux_tpu_torch/csrc/model_values.cu", "redux_tpu/ops/pallas_model.py:63"),
    "encode": ("redux_tpu_torch/csrc/encode.cu", "redux_tpu/ops/pallas_encode.py:86"),
    "decode": ("redux_tpu_torch/csrc/decode.cu", "redux_tpu/ops/pallas_decode.py:109"),
    "encode_fused": ("redux_tpu_torch/csrc/encode_fused.cu", "redux_tpu/ops/pallas_encode.py:86"),
    "encode_m": ("redux_tpu_torch/csrc/encode_m.cu", "redux_tpu/ops/pallas_encode.py:564"),
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


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class KernelInputs:
    """What the main path hands the kernels for ``data``: its blocks, the
    initial row (with the warm-start prior) and the word capacity."""

    def __init__(self, data: bytes, params: Parameters, delta: int, block_size: int,
                 device: torch.device):
        ic = api._init_cum(params, api._prior_extra(data, params, api.DEFAULT_PRIOR_BUDGET))
        syms, lens, _ = api._split_blocks(data, block_size)
        self._place(syms, lens, ic, params, delta, device)

    @classmethod
    def of_blocks(cls, syms: np.ndarray, lens: np.ndarray, init_cum: np.ndarray,
                  params: Parameters, delta: int, device: torch.device) -> "KernelInputs":
        """The kernels' inputs for given ``(B, K)`` uint8 blocks, their
        ``(B,)`` int32 lengths and an initial row of one's own."""
        x = cls.__new__(cls)
        x._place(syms, lens, init_cum, params, delta, device)
        return x

    def _place(self, syms, lens, ic, params, delta, device) -> None:
        self.params, self.delta, self.k = params, delta, syms.shape[1]
        self.syms = torch.from_numpy(syms).to(device)
        self.lens = torch.from_numpy(lens).to(device)
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
    freeze engaged; at the reference CLI's (8,30,32), where K2 and K3 take
    their u64 instantiations and K4 and K5 must refuse the parameters; and
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
