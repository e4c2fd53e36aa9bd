"""Word/byte helpers and shared integer arithmetic of the coder.

Counterpart: ``redux_tpu/ops/coder.py`` — ``max_block_words``
(:60-71), ``words_to_bytes_device`` and ``bytes_to_words_device``
(:888-911).  Words are u32 bit patterns held in int32 tensors; streams are
big-endian.

The plain (CPU) versions of the kernels compute in int64 with explicit
32-bit masks, because CPU torch lacks most uint32 arithmetic and has no
count-leading-zeros; :func:`bit_length` emulates it exactly for values
below 2**53.  :class:`PlainCoder` is the coder step and emission of every
plain encoder (K2, K4 and K5), as ``csrc/common.cuh::Coder`` is the
kernels'.

:func:`encode_blocks` is the reference's batched coder of reference-format
streams (``redux_tpu/ops/coder.py::encode_blocks``, :84-274): plain
PyTorch on the tensors' device, which the generic models of
:mod:`redux_tpu_torch.ops.generic` feed.
"""

from __future__ import annotations

import math

import torch

from ..params import Parameters

M32 = 0xFFFFFFFF
MAX_DELTA = 255  # the largest adaptation increment; count overshoots by delta - 1 at most


def max_block_words(max_count: int, n_symbols: int, params: Parameters, k: int) -> int:
    """Upper bound (in u32 words) on one block's compressed size."""
    bps = max(1, math.ceil(math.log2(max(2, max_count)))) + 2
    total_bits = (k + 1) * bps + params.code_bits + 8
    return total_bits // 32 + 2


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 words -> (B, 4W) uint8, big-endian byte order."""
    b, w = words.shape
    le = words.contiguous().view(torch.uint8).view(b, w, 4)  # host order: little-endian
    return le.flip(-1).reshape(b, 4 * w)


def bytes_to_words(byts: torch.Tensor) -> torch.Tensor:
    """(B, 4W) uint8 -> (B, W) int32 words, big-endian byte order."""
    b, n = byts.shape
    return byts.view(b, n // 4, 4).flip(-1).contiguous().view(torch.int32).view(b, n // 4)


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    """Raise ValueError unless ``t`` has this dtype, shape (None = any) and
    device and is contiguous — what the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def kernel_device(device: torch.device) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def expect_symbol_encoder(syms: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                          params: Parameters, n_words: int, delta: int) -> None:
    """Raise ValueError unless the arguments are what the encoders from
    symbols (K4, K5) take: ``(B, K)`` uint8 ``syms``, ``(B,)`` int32
    ``lens``, the int32 initial row, ``n_words >= 1``, ``delta`` in 1..255,
    and parameters on the reference's kernel path (``fits_u32`` or
    ``fits_wide32``)."""
    dev = syms.device
    expect(syms, "syms", torch.uint8, (None, None), dev)
    expect(lens, "lens", torch.int32, (syms.shape[0],), dev)
    expect(init_cum, "init_cum", torch.int32, (params.symbol_count + 1,), dev)
    if not (params.fits_u32 or params.fits_wide32):
        raise ValueError("the encoders from symbols require fits_u32 or fits_wide32 params")
    # Both imply it; the kernels have only the reciprocal-quotient instantiation.
    if not products_fit_53(params):
        raise ValueError("the encoders from symbols require products_fit_53 params")
    if params.symbol_bits != 8 or not 1 <= delta <= 255 or n_words < 1:
        raise ValueError("symbol_bits 8, delta in 1..255 and n_words >= 1 are required")


def products_fit_53(params: Parameters) -> bool:
    """True when every dividend of the coder's quotients (K2-K5) stays below
    ``2**53``: ``range * fhi`` (and the decoder's ``(z + 1) * count``) are
    below ``2**code_bits * (freq_max + MAX_DELTA)``.  Picks K2's
    instantiation: reciprocal quotients, or native u64 divisions.  K3
    takes reciprocal quotients at every parameter set: what they need is
    a small quotient, not a small dividend (``ops/decode.py``)."""
    return params.code_bits + (params.freq_max + MAX_DELTA - 1).bit_length() <= 53


def check_code_bits(params: Parameters) -> None:
    """The kernels keep the interval in 64 bits: ``code_bits <= 32`` and
    products ``range * count < 2**62`` (the reference's own limits)."""
    if params.code_bits > 32 or params.code_bits + params.freq_bits > 62:
        raise ValueError(
            "the coder supports code_bits <= 32 and code_bits + freq_bits <= 62"
        )


def tfreeze(init_total: int, params: Parameters, delta: int) -> int:
    """First position whose update is frozen: ``max(ceil((freq_max - init_total) / delta), 0)``."""
    return max(-(-(params.freq_max - init_total) // delta), 0)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit length of nonnegative int64 values below 2**53 (0 -> 0)."""
    return torch.frexp(x.double()).exponent.to(torch.int64)


def mask(n: torch.Tensor) -> torch.Tensor:
    """``2**n - 1`` for int64 n in [0, 62]."""
    return (torch.ones_like(n) << n) - 1


def renorm_plain(low, high, cb: int, active):
    """Closed-form E1/E2 + E3 renormalisation, vectorised over blocks.

    Returns ``(low, high, n1, n3)``; inactive blocks keep their interval
    and report ``n1 = n3 = 0``.
    """
    cmax = (1 << cb) - 1
    zero = torch.zeros_like(low)
    n1 = torch.where(active, cb - bit_length(low ^ high), zero).clamp(min=0)
    low1 = (low << n1) & cmax
    high1 = ((high << n1) | mask(n1)) & cmax
    a = 32 - bit_length(((low1 << (33 - cb)) & M32) ^ M32)
    b = 32 - bit_length((high1 << (33 - cb)) & M32)
    n3 = torch.where(active, torch.minimum(torch.minimum(a, b), torch.full_like(a, cb - 1)), zero)
    low2 = (low1 << n3) & (cmax >> 1)
    high2 = (((high1 << n3) | mask(n3)) & (cmax >> 1)) | (1 << (cb - 1))
    return torch.where(active, low2, low), torch.where(active, high2, high), n1, n3


class PlainCoder:
    """The v2 coder over all blocks at once, in int64 with 32-bit masks:
    one :meth:`step` a position ``t = 0 .. max(lens)``, then
    :meth:`finish`.  Runs on any device."""

    def __init__(self, lens: torch.Tensor, params: Parameters, n_words: int):
        b, dev = lens.shape[0], lens.device
        self.params, self.n_words = params, n_words
        self.lens = lens.to(torch.int64)
        self.rows = torch.arange(b, device=dev)
        zero = torch.zeros(b, dtype=torch.int64, device=dev)
        self.low, self.high, self.pending = zero.clone(), zero + params.code_max, zero.clone()
        self.acc, self.accbits, self.nw = zero.clone(), zero.clone(), zero.clone()
        self.ovf = torch.zeros(b, dtype=torch.bool, device=dev)
        self.words = torch.zeros(b, n_words + 1, dtype=torch.int64, device=dev)  # last: spill

    def _put(self, v, n):
        acc = (self.acc << n) | v
        accbits = self.accbits + n
        full = accbits >= 32
        left = accbits - 32 * full
        idx = torch.where(full, self.nw.clamp(max=self.n_words), self.n_words)
        self.words[self.rows, idx] = (acc >> left) & M32
        self.nw = self.nw + full
        self.acc = acc & mask(left)
        self.accbits = left

    def step(self, t: int, flo, fhi, count) -> None:
        """Position ``t``: blocks with ``t < lens`` narrow by ``(flo, fhi)``
        over ``count`` (an int or a per-block tensor, >= 1) and emit;
        blocks with ``t == lens`` emit the 2-bit terminator."""
        p = self.params
        cb = p.code_bits
        low, high, pending = self.low, self.high, self.pending
        active = t < self.lens
        is_term = t == self.lens
        rng = high - low + 1
        nlow = low + rng * flo // count
        nhigh = low + rng * fhi // count - 1
        low = torch.where(active, nlow, low)
        high = torch.where(active, nhigh, high)
        low2, high2, n1, n3 = renorm_plain(low, high, cb, active)
        # Data piece [b1][pending x !b1][n1-1 prefix bits], or the terminator.
        rl = (n1 - 1).clamp(min=0)
        prefix = low >> (cb - n1)
        tq = (low + p.code_one_fourth - 1) >> (cb - 2)
        lead = torch.where(is_term, tq >> 1, prefix >> rl)
        rest = torch.where(is_term, tq & 1, prefix & mask(rl))
        rl = torch.where(is_term, 1, rl)
        emit = (active & (n1 > 0)) | is_term
        # Past 64 bits the reference's 64-bit piece keeps its low 64 bits
        # with the run cut to 63 and the lead bit at position 63.
        big = emit & (rl + 1 + pending > 64)
        self.ovf |= big
        first = torch.where(big, lead | (rl >= 1), lead)
        run = torch.where(big, 63 - rl, pending)
        opp = torch.where(lead == 0, mask(run.clamp(max=62)), 0)
        opp = torch.where((lead == 0) & (run == 63), (1 << 63) - 1, opp)
        piece = (first << (run + rl)) | (opp << rl) | rest
        m = torch.where(emit, 1 + run + rl, 0)
        n_hi = (m - 32).clamp(min=0)
        n_lo = m.clamp(max=32)
        self._put((piece >> 32) & mask(n_hi), n_hi)
        self._put(piece & mask(n_lo), n_lo)
        self.pending = torch.where(emit, 0, pending) + n3
        self.low, self.high = low2, high2

    def finish(self):
        """``(words (B, n_words) int32, byte_lens (B,) int32, ovf (B,) bool)``."""
        n_words, accbits = self.n_words, self.accbits
        byte_lens = (self.nw * 32 + accbits + 7) >> 3
        tail = accbits > 0
        idx = torch.where(tail, self.nw.clamp(max=n_words), n_words)
        self.words[self.rows, idx] = (self.acc << (32 - accbits)) & M32
        words = self.words[:, :n_words]
        words = words - ((words >> 31) << 32)  # u32 bit patterns into int32 range
        return words.to(torch.int32), byte_lens.to(torch.int32), self.ovf


def _put_piece(coder: PlainCoder, lead, run, rest, rl, on) -> None:
    """Append ``[lead][run bits opposite to lead][the rl low bits of rest]``
    to the blocks where ``on``: the reference's ``put_bit`` with its
    pending run (codec.rs:39-46).  ``run`` may be any length; ``rl <= 31``."""
    zero = torch.zeros_like(lead)
    coder._put(torch.where(on, lead, zero), on.to(torch.int64))
    left = torch.where(on, run, zero)
    opp = lead == 0
    while bool((left > 0).any()):
        m = left.clamp(max=32)
        coder._put(torch.where(opp, mask(m), zero), m)
        left = left - m
    coder._put(torch.where(on, rest, zero), torch.where(on, rl, zero))


def encode_blocks(lo: torch.Tensor, hi: torch.Tensor, tot: torch.Tensor, eof_lo: torch.Tensor,
                  eof_hi: torch.Tensor, eof_tot: torch.Tensor, lens: torch.Tensor,
                  params: Parameters, n_words: int):
    """Code ``B`` blocks into reference-format streams from their model values.

    Counterpart: ``redux_tpu/ops/coder.py::encode_blocks`` (:84-274).  Per
    block: the data symbols, then the EOF symbol at position ``lens``, then
    the ``code_bits`` drain and zero padding to a byte (codec.rs:91-99,
    the reference's :200-242).  This is not the v2 format of the archives:
    K2, the v2 coder, is :func:`redux_tpu_torch.ops.encode.encode_blocks`.
    The reference's ``encode_blocks_fast`` (:584) is a TPU plan of this
    same function and stream format and has no port of its own.  Its
    ``decode_blocks`` (:278) is K3 (:func:`redux_tpu_torch.ops.decode.decode_blocks`),
    which stops at ``lens`` and so decodes these streams of the dense
    model too.

    Args: ``(B, K)`` integer ``lo``/``hi``/``tot`` (the model's bounds and
    total at each data position), the ``(B,)`` EOF triple, ``(B,)`` ``lens
    <= K`` (negative: no stream) and the capacity ``n_words``, which must
    hold every stream (:func:`max_block_words`).  Plain PyTorch on the
    tensors' device, one step a position, in int64 with 32-bit masks:
    products ``range * bound`` reach ``2**62`` at (8,30,32).

    Returns ``(words (B, n_words) int32, byte_lens (B,) int32)``: each
    block's big-endian stream (u32 bit patterns) and its length in bytes.
    """
    check_code_bits(params)
    b, k = lo.shape
    cb = params.code_bits
    i64 = torch.int64
    lens64 = lens.to(i64)
    # One column past K: the EOF step of a full block reads no data values.
    lo, hi = (torch.nn.functional.pad(x.to(i64), (0, 1)) for x in (lo, hi))
    tot = torch.nn.functional.pad(tot.to(i64), (0, 1), value=1)
    eof_lo, eof_hi, eof_tot = (x.to(i64) for x in (eof_lo, eof_hi, eof_tot))
    coder = PlainCoder(lens, params, n_words)
    eof_steps = set(lens.tolist())  # the drain runs only where some block ends
    t_end = min(max(eof_steps), k) if b else -1
    for t in range(t_end + 1):
        is_eof = t == lens64
        active = t <= lens64
        flo = torch.where(is_eof, eof_lo, lo[:, t])
        fhi = torch.where(is_eof, eof_hi, hi[:, t])
        count = torch.where(active, torch.where(is_eof, eof_tot, tot[:, t]), 1)
        low, high = coder.low, coder.high
        rng = high - low + 1
        high = torch.where(active, low + rng * fhi // count - 1, high)
        low = torch.where(active, low + rng * flo // count, low)
        low2, high2, n1, n3 = renorm_plain(low, high, cb, active)
        # The n1 E1/E2 bits: [b1][pending x !b1][n1 - 1 bits] (codec.rs:62-89).
        emit = active & (n1 > 0)
        rl = (n1 - 1).clamp(min=0)
        prefix = low >> (cb - n1)
        _put_piece(coder, prefix >> rl, coder.pending, prefix & mask(rl), rl, emit)
        pending = torch.where(emit, 0, coder.pending) + n3
        if t in eof_steps:
            # After EOF: drain the code_bits - (n1 + n3) top bits of low.
            ndr = torch.where(is_eof, cb - n1 - n3, 0).clamp(min=0)
            drain = ndr > 0
            dl = (ndr - 1).clamp(min=0)
            dprefix = low2 >> (cb - ndr)
            _put_piece(coder, dprefix >> dl, pending, dprefix & mask(dl), dl, drain)
            pending = torch.where(drain, 0, pending)
        coder.pending = pending
        coder.low, coder.high = low2, high2
    words, byte_lens, _ = coder.finish()
    return words, byte_lens
