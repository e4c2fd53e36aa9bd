"""K2 — the v2 interval coder; K4 — the fused model + coder; and the
ranked encode that runs K1 -> K2, or K4.

Counterpart: ``redux_tpu/ops/pallas_encode.py`` — ``encode_blocks_pallas``
(:521-561; kernel ``_encode_kernel(model_inline=False)``, launched by
``_encode_pallas_jit``), ``_encode_fused_model_jit`` (:451-518; kernel
``_encode_kernel(model_inline=True)``) and ``encode_blocks_ranked``
(:897-1011: the fused branch :991-1001 under ``REDUX_TPU_ENC_FUSED``, the
two-kernel branch :1003-1010).  Kernels: ``csrc/encode.cu`` (K2),
``csrc/encode_fused.cu`` (K4).

Per block the coder narrows the interval by the given ``(lo, hi)`` and the
closed-form total ``max(init_total + delta * min(t, tfreeze), 1)``,
renormalises in closed form, emits ``[b1][pending opposite bits][rest]``
(at most 64 bits; ``ovf`` marks a block whose piece would be longer), and
ends with the 2-bit v2 terminator at ``t == lens``.
"""

from __future__ import annotations

import os

import torch

from .. import _build
from ..params import Parameters
from .coder import (M32, PlainCoder, check_code_bits, expect, expect_symbol_encoder,
                    kernel_device, products_fit_53, tfreeze)
from .model import model_lohi, model_lohi_plain

launches = 0  # kernel launches of encode_blocks (CUDA tensors only)
fused_launches = 0  # kernel launches of encode_blocks_fused (CUDA tensors only)


def encode_blocks_plain(lo: torch.Tensor, hi: torch.Tensor, lens: torch.Tensor,
                        init_total: int, params: Parameters, n_words: int, delta: int = 1):
    """The plain PyTorch version: the coder over all blocks at once, one
    Python step per position, in int64 with 32-bit masks.  Runs on any
    device.  Returns ``(words, byte_lens, ovf)`` as :func:`encode_blocks`."""
    b, k = lo.shape
    tf = tfreeze(init_total, params, delta)
    # One zero column past K: the terminator step t == K reads no values.
    lo = torch.nn.functional.pad(lo.to(torch.int64) & M32, (0, 1))
    hi = torch.nn.functional.pad(hi.to(torch.int64) & M32, (0, 1))
    coder = PlainCoder(lens, params, n_words)
    t_end = min(int(lens.max()), k) if b else -1
    for t in range(t_end + 1):
        coder.step(t, lo[:, t], hi[:, t], max(init_total + delta * min(t, tf), 1))
    return coder.finish()


def encode_blocks(lo: torch.Tensor, hi: torch.Tensor, lens: torch.Tensor, init_total: int,
                  params: Parameters, n_words: int, delta: int = 1):
    """Code ``B`` blocks from their model values.

    Args: ``(B, K)`` int32 ``lo``/``hi`` (``lo_t = cdf_t[v_t]``,
    ``hi_t = cdf_t[v_t+1]``), ``(B,)`` int32 ``lens <= K`` (negative:
    no stream), the initial model total ``init_total`` (``init_cum[-1]``),
    the output capacity ``n_words`` and the adaptation increment.

    Returns ``(words (B, n_words) int32, byte_lens (B,) int32, ovf (B,)
    bool)``: each block's big-endian stream (u32 bit patterns, zero past
    the stream), its byte length counting every bit even past ``n_words``,
    and whether a piece overflowed 64 bits.  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream, in its
    reciprocal-quotient instantiation where :func:`products_fit_53` (tpu_wide,
    tpu32) and with u64 divisions otherwise (the reference CLI's (8,30,32)).
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
        tfreeze(init_total, params, delta), delta, params.code_bits,
        int(products_fit_53(params)), dev.index or 0, _build.stream_of(dev),
    )
    _build.check(err, "rxt_encode_blocks")
    launches += 1
    return words, byte_lens, ovf


def encode_blocks_fused_plain(syms: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                              params: Parameters, n_words: int, delta: int = 1):
    """The plain PyTorch version of K4: K1's plain version feeding K2's."""
    lo, hi = model_lohi_plain(syms, lens, init_cum, params, delta)
    return encode_blocks_plain(lo, hi, lens, int(init_cum[-1]), params, n_words, delta)


def encode_blocks_fused(syms: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                        params: Parameters, n_words: int, delta: int = 1):
    """Code ``B`` blocks straight from their symbols in one kernel (K4).

    Args: ``(B, K)`` uint8 ``syms``, ``(B,)`` int32 ``lens <= K``
    (negative: a pad lane, no stream), the int32 ``(symbol_count + 1,)``
    initial row, the output capacity ``n_words`` and the adaptation
    increment.  Returns what :func:`encode_blocks` returns, bit for bit.
    Raises ValueError unless ``params.fits_u32 or params.fits_wide32``, as
    the reference's kernel does.  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream.
    """
    global fused_launches
    expect_symbol_encoder(syms, lens, init_cum, params, n_words, delta)
    b, k = syms.shape
    dev = syms.device
    n_words, delta = int(n_words), int(delta)
    if not kernel_device(dev):
        return encode_blocks_fused_plain(syms, lens, init_cum, params, n_words, delta)
    words = torch.empty(b, n_words, dtype=torch.int32, device=dev)
    byte_lens = torch.empty(b, dtype=torch.int32, device=dev)
    ovf = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return words, byte_lens, ovf
    err = _build.lib().rxt_encode_fused(
        syms.data_ptr(), lens.data_ptr(), init_cum.data_ptr(), words.data_ptr(),
        byte_lens.data_ptr(), ovf.data_ptr(), b, k, n_words, delta, params.freq_max,
        params.code_bits, dev.index or 0, _build.stream_of(dev),
    )
    _build.check(err, "rxt_encode_fused")
    fused_launches += 1
    return words, byte_lens, ovf


def fused_selected(params: Parameters) -> bool:
    """Whether :func:`encode_blocks_ranked` runs K4: ``REDUX_TPU_ENC_FUSED``
    set to anything but ``"0"`` (read on every call, as the reference
    reads it on every trace), for parameters that K4 takes."""
    return os.environ.get("REDUX_TPU_ENC_FUSED", "0") != "0" and (
        params.fits_u32 or params.fits_wide32)


def encode_blocks_ranked(syms: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                         params: Parameters, n_words: int, delta: int = 1):
    """The production encode: K1 model values feed the K2 coder, or, when
    :func:`fused_selected`, the fused K4 alone (the same bytes).

    ``syms`` is ``(B, K)`` uint8, ``lens`` ``(B,)`` int32 (``lens <= K``;
    negative: a pad lane), ``init_cum`` the int32 initial row.  Returns
    what :func:`encode_blocks` returns.  Parameters that K4 does not take
    go through K1 -> K2 whatever the variable says, as in the reference.
    """
    if fused_selected(params):
        return encode_blocks_fused(syms, lens, init_cum, params, n_words, delta)
    init_total = int(init_cum[-1])  # read before K1 is queued: no wait on it
    lo, hi = model_lohi(syms, lens, init_cum, params, delta)
    return encode_blocks(lo, hi, lens, init_total, params, n_words, delta)
