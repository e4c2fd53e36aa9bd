"""K2 — the v2 interval coder, and the ranked encode K1 -> K2.

Counterpart: ``redux_tpu/ops/pallas_encode.py`` — ``encode_blocks_pallas``
(:521-561; kernel ``_encode_kernel(model_inline=False)``, launched by
``_encode_pallas_jit``) and ``encode_blocks_ranked`` (:897-1011, its
two-kernel branch :1003-1010).  Kernel: ``csrc/encode.cu``.

Per block the coder narrows the interval by the given ``(lo, hi)`` and the
closed-form total ``max(init_total + delta * min(t, tfreeze), 1)``,
renormalises in closed form, emits ``[b1][pending opposite bits][rest]``
(at most 64 bits; ``ovf`` marks a block whose piece would be longer), and
ends with the 2-bit v2 terminator at ``t == lens``.
"""

from __future__ import annotations

import torch

from .. import _build
from ..params import Parameters
from .coder import M32, check_code_bits, expect, kernel_device, mask, renorm_plain, tfreeze
from .model import model_lohi

launches = 0  # kernel launches of encode_blocks (CUDA tensors only)


def encode_blocks_plain(lo: torch.Tensor, hi: torch.Tensor, lens: torch.Tensor,
                        init_total: int, params: Parameters, n_words: int, delta: int):
    """The plain PyTorch version: the coder over all blocks at once, one
    Python step per position, in int64 with 32-bit masks.  Runs on any
    device.  Returns ``(words, byte_lens, ovf)`` as :func:`encode_blocks`."""
    b, k = lo.shape
    dev = lo.device
    i64 = torch.int64
    cb = params.code_bits
    tf = tfreeze(init_total, params, delta)
    lens = lens.to(i64)
    # One zero column past K: the terminator step t == K reads no values.
    lo = torch.nn.functional.pad(lo.to(i64) & M32, (0, 1))
    hi = torch.nn.functional.pad(hi.to(i64) & M32, (0, 1))
    rows = torch.arange(b, device=dev)
    zero = torch.zeros(b, dtype=i64, device=dev)
    low, high, pending = zero.clone(), torch.full_like(zero, params.code_max), zero.clone()
    acc, accbits, nw = zero.clone(), zero.clone(), zero.clone()
    ovf = torch.zeros(b, dtype=torch.bool, device=dev)
    words = torch.zeros(b, n_words + 1, dtype=i64, device=dev)  # last column: spill

    def put(v, n):
        nonlocal acc, accbits, nw
        acc = (acc << n) | v
        accbits = accbits + n
        full = accbits >= 32
        left = accbits - 32 * full
        idx = torch.where(full, nw.clamp(max=n_words), n_words)
        words[rows, idx] = (acc >> left) & M32
        nw = nw + full
        acc = acc & mask(left)
        accbits = left

    t_end = min(int(lens.max()), k) if b else -1
    for t in range(t_end + 1):
        active = t < lens
        is_term = t == lens
        count = max(init_total + delta * min(t, tf), 1)
        rng = high - low + 1
        nlow = low + rng * lo[:, t] // count
        nhigh = low + rng * hi[:, t] // count - 1
        low = torch.where(active, nlow, low)
        high = torch.where(active, nhigh, high)
        low2, high2, n1, n3 = renorm_plain(low, high, cb, active)
        # Data piece [b1][pending x !b1][n1-1 prefix bits], or the terminator.
        rl = (n1 - 1).clamp(min=0)
        prefix = low >> (cb - n1)
        tq = (low + params.code_one_fourth - 1) >> (cb - 2)
        lead = torch.where(is_term, tq >> 1, prefix >> rl)
        rest = torch.where(is_term, tq & 1, prefix & mask(rl))
        rl = torch.where(is_term, 1, rl)
        emit = (active & (n1 > 0)) | is_term
        # Past 64 bits the reference's 64-bit piece keeps its low 64 bits
        # with the run cut to 63 and the lead bit at position 63.
        big = emit & (rl + 1 + pending > 64)
        ovf |= big
        first = torch.where(big, lead | (rl >= 1), lead)
        run = torch.where(big, 63 - rl, pending)
        opp = torch.where(lead == 0, mask(run.clamp(max=62)), 0)
        opp = torch.where((lead == 0) & (run == 63), (1 << 63) - 1, opp)
        piece = (first << (run + rl)) | (opp << rl) | rest
        m = torch.where(emit, 1 + run + rl, 0)
        n_hi = (m - 32).clamp(min=0)
        n_lo = m.clamp(max=32)
        put((piece >> 32) & mask(n_hi), n_hi)
        put(piece & mask(n_lo), n_lo)
        pending = torch.where(emit, 0, pending) + n3
        low, high = low2, high2
    byte_lens = (nw * 32 + accbits + 7) >> 3
    tail = accbits > 0
    words[rows, torch.where(tail, nw.clamp(max=n_words), n_words)] = (acc << (32 - accbits)) & M32
    words = words[:, :n_words]
    words = words - ((words >> 31) << 32)  # u32 bit patterns into int32 range
    return words.to(torch.int32), byte_lens.to(torch.int32), ovf


def encode_blocks(lo: torch.Tensor, hi: torch.Tensor, lens: torch.Tensor, init_total: int,
                  params: Parameters, n_words: int, delta: int):
    """Code ``B`` blocks from their model values.

    Args: ``(B, K)`` int32 ``lo``/``hi`` (``lo_t = cdf_t[v_t]``,
    ``hi_t = cdf_t[v_t+1]``), ``(B,)`` int32 ``lens <= K`` (negative:
    no stream), the initial model total ``init_total`` (``init_cum[-1]``),
    the output capacity ``n_words`` and the adaptation increment.

    Returns ``(words (B, n_words) int32, byte_lens (B,) int32, ovf (B,)
    bool)``: each block's big-endian stream (u32 bit patterns, zero past
    the stream), its byte length counting every bit even past ``n_words``,
    and whether a piece overflowed 64 bits.  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream.
    """
    global launches
    dev = lo.device
    expect(lo, "lo", torch.int32, (None, None), dev)
    b, k = lo.shape
    expect(hi, "hi", torch.int32, (b, k), dev)
    expect(lens, "lens", torch.int32, (b,), dev)
    check_code_bits(params)
    init_total, n_words, delta = int(init_total), int(n_words), int(delta)
    if n_words < 1 or delta < 1:
        raise ValueError("n_words and delta must be positive")
    if not kernel_device(dev):
        return encode_blocks_plain(lo, hi, lens, init_total, params, n_words, delta)
    words = torch.empty(b, n_words, dtype=torch.int32, device=dev)
    byte_lens = torch.empty(b, dtype=torch.int32, device=dev)
    ovf = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return words, byte_lens, ovf
    lib = _build.lib()
    err = lib.rxt_encode_blocks(
        lo.data_ptr(), hi.data_ptr(), lens.data_ptr(), words.data_ptr(),
        byte_lens.data_ptr(), ovf.data_ptr(), b, k, n_words, init_total,
        tfreeze(init_total, params, delta), delta, params.code_bits, dev.index or 0,
        _build.stream_of(dev),
    )
    _build.check(err, "rxt_encode_blocks")
    launches += 1
    return words, byte_lens, ovf


def encode_blocks_ranked(syms: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                         params: Parameters, n_words: int, delta: int):
    """The production encode: K1 model values feed the K2 coder.

    ``syms`` is ``(B, K)`` uint8, ``lens`` ``(B,)`` int32 (``0 <= lens <=
    K``), ``init_cum`` the int32 initial row.  Returns what
    :func:`encode_blocks` returns.
    """
    lo, hi = model_lohi(syms, lens, init_cum, params, delta)
    init_total = int(init_cum[-1])
    return encode_blocks(lo, hi, lens, init_total, params, n_words, delta)
