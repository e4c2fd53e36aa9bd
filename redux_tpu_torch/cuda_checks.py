"""On-card checks of the kernels: each against its plain PyTorch version,
and the port against the golden archives.

Used by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.  Every check
compares integers exactly (tolerance 0: the bar is byte equality) and
raises AssertionError on any difference.  Times come from CUDA events.
"""

from __future__ import annotations

import hashlib
import json
import pathlib

import torch

from . import api
from .convert import init_cum_from_numpy
from .ops.decode import decode_blocks, decode_blocks_plain
from .ops.encode import (encode_blocks, encode_blocks_fused, encode_blocks_fused_plain,
                         encode_blocks_plain)
from .ops.encode_m import encode_blocks_m, encode_blocks_m_plain
from .ops.model import model_lohi, model_lohi_plain
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
        self.params, self.delta, self.k = params, delta, block_size
        self.syms = torch.from_numpy(syms).to(device)
        self.lens = torch.from_numpy(lens).to(device)
        self.init_cum = init_cum_from_numpy(ic, params, device)
        self.init_total = int(ic[-1])
        self.n_words = api._encode_words(params, block_size, delta)


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


def triple_err(a, b, n_words: int) -> int:
    """Largest difference of two ``(words, byte_lens, ovf)`` triples: byte
    lengths and ovf exactly, the words up to each byte length."""
    words, bl, ovf = a
    err = max(_max_abs(bl, b[1]), _max_abs(ovf, b[2]))
    wvalid = torch.arange(n_words, device=words.device)[None, :] * 4 < bl[:, None]
    return max(err, _max_abs(words[wvalid], b[0][wvalid]))


def compare_kernels(x: KernelInputs, time_plain: bool = True, reps: int = 3) -> dict:
    """Run every kernel and its plain version on ``x``; assert exact
    equality; return per kernel ``max_abs_err``, ``ms`` and ``plain_ms``
    (each plain version runs once, timed in that run when ``time_plain``)
    and its bound (:func:`kernel_bounds`).

    K4 and K5 must also give K2's triple on the same input; where the
    parameters are off their path (not ``fits_u32`` or ``fits_wide32``)
    both wrappers must raise ValueError, and their entry says so.
    K3 decodes K2's streams as the main path stages them: blocks stored
    raw (ovf, or not smaller than raw) get no symbols, the rest must come
    back as their input bytes.  It runs on the lanes in block order and
    sorted by coded length (the main path's order, ``api.decode``); its
    ``ms`` is the sorted lanes' time and ``ms_unsorted`` the other.
    """
    p, d = x.params, x.delta
    out = {}
    valid = torch.arange(x.k, device=x.syms.device)[None, :] < x.lens[:, None]

    lo, hi = model_lohi(x.syms, x.lens, x.init_cum, p, d)
    (lo_p, hi_p), plain_ms = plain_run(
        lambda: model_lohi_plain(x.syms, x.lens, x.init_cum, p, d), time_plain)
    err = max(_max_abs(lo[valid], lo_p[valid]), _max_abs(hi[valid], hi_p[valid]))
    _require(err == 0, f"model_values differs from its plain version (max |diff| {err})")
    out["model_values"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: model_lohi(x.syms, x.lens, x.init_cum, p, d), reps),
        "plain_ms": plain_ms,
    }

    enc = (lo, hi, x.lens, x.init_total, p, x.n_words, d)
    coded = encode_blocks(*enc)
    coded_p, plain_ms = plain_run(lambda: encode_blocks_plain(*enc), time_plain)
    err = triple_err(coded, coded_p, x.n_words)
    _require(err == 0, f"encode differs from its plain version (max |diff| {err})")
    out["encode"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: encode_blocks(*enc), reps),
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
        _require(err == 0, f"{name} differs from its plain version (max |diff| {err})")
        err_k2 = triple_err(mine, coded, x.n_words)
        _require(err_k2 == 0, f"{name} differs from K1 -> K2 (max |diff| {err_k2})")
        out[name] = {
            "max_abs_err": max(err, err_k2),
            "ms": cuda_ms(lambda: kernel(*sym_args), reps),
            "plain_ms": plain_ms,
        }

    words, bl, ovf = coded
    raw = ovf | (bl >= x.lens)
    klens = torch.where(raw, 0, x.lens).to(torch.int32)
    coded_max = int(torch.where(raw, 0, bl).max())
    wcap = min(max(4, -(-coded_max // 4) + 2), x.n_words + 2)
    # The coder leaves zeros past each stream; two zero words follow the longest.
    staged = torch.nn.functional.pad(words, (0, 2))[:, :wcap].contiguous()
    dec = (staged, klens, x.init_cum, p, x.k, d)
    syms = decode_blocks(*dec)
    syms_p, plain_ms = plain_run(lambda: decode_blocks_plain(*dec), time_plain)
    err = _max_abs(syms, syms_p)
    _require(err == 0, f"decode differs from its plain version (max |diff| {err})")
    order = torch.argsort(torch.where(raw, 0, bl), stable=True)
    dec_sorted = (staged[order].contiguous(), klens[order].contiguous(), x.init_cum, p, x.k, d)
    err_sorted = _max_abs(decode_blocks(*dec_sorted), syms_p[order])
    _require(err_sorted == 0,
             f"decode on sorted lanes differs from its plain version (max |diff| {err_sorted})")
    ok = ~raw
    _require(torch.equal(torch.where(valid[ok], syms[ok], 0),
                         torch.where(valid[ok], x.syms[ok], 0)), "decode lost the input")
    out["decode"] = {
        "max_abs_err": max(err, err_sorted),
        "ms": cuda_ms(lambda: decode_blocks(*dec_sorted), reps),
        "ms_unsorted": cuda_ms(lambda: decode_blocks(*dec), reps),
        "plain_ms": plain_ms,
    }
    for name, b in kernel_bounds(x, staged, klens).items():
        out[name].update(b)
    out["raw_blocks"] = int(raw.sum())
    out["k2_triple"] = coded
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
    """Phase 4: encode each golden's input on the card and compare with the
    stored archive byte for byte; decode each stored archive on the card."""
    results = []
    for entry in json.loads((golden_dir / "manifest.json").read_text()):
        data = golden_input(entry["kind"], entry["n"], entry["seed"])
        _require(hashlib.sha256(data).hexdigest() == entry["input_sha256"],
                 f"{entry['file']}: generated input differs from the manifest")
        stored = (golden_dir / entry["file"]).read_bytes()
        mine = api.encode(data, params=Parameters(*entry["params"]), delta=entry["delta"],
                          device=device)
        _require(mine == stored, f"{entry['file']}: encode differs from the golden archive")
        _require(api.decode(stored, device=device) == data, f"{entry['file']}: decode differs")
        results.append((entry["file"], len(data), len(stored)))
    return results
