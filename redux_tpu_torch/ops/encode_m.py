"""K5 — the model-in-kernel encoder, an independent derivation of the
ranked encode's streams.

Counterpart: ``redux_tpu/ops/pallas_encode.py::encode_blocks_pallas_m``
(:866-894; kernel ``_encode_kernel_m``, launched by
``_encode_pallas_m_jit``).  Kernel: ``csrc/encode_m.cu``.

Per block the model is the block's own cumulative row, read by masked
maxima (the row is nondecreasing, so ``cdf[v] = max_{i <= v} cdf[i]``),
with the running total beside it: per coded symbol ``flo = cdf[v]``,
``fhi = cdf[v+1]`` and ``count = tot`` before the update, then ``+delta``
above ``v`` while ``tot < freq_max``.  It shares the coder step with the
other encoders and nothing of K1's or K4's model, so that the two
derivations check each other.
"""

from __future__ import annotations

import torch

from .. import _build
from ..params import Parameters
from .coder import PlainCoder, expect_symbol_encoder, kernel_device


def encode_blocks_m_plain(syms: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                          params: Parameters, n_words: int, delta: int = 1):
    """The plain PyTorch version (``pallas_encode.py:609-632``): a dense
    row per block, masked-max lookups and the running total, one Python
    step per position.  Runs on any device."""
    b, k = syms.shape
    dev = syms.device
    i64 = torch.int64
    cdf = init_cum.to(i64).expand(b, params.symbol_count + 1).clone()
    rows = torch.arange(params.symbol_count + 1, device=dev)
    tot = cdf[:, -1].clone()
    lens64 = lens.to(i64)
    # One zero column past K: the terminator step t == K reads no symbol.
    v_all = torch.nn.functional.pad(syms.to(i64), (0, 1))
    coder = PlainCoder(lens, params, n_words)
    t_end = min(int(lens.max()), k) if b else -1
    for t in range(t_end + 1):
        active = t < lens64
        v = v_all[:, t : t + 1]
        le = rows <= v
        flo = torch.where(le, cdf, 0).amax(1)
        fhi = torch.where(rows <= v + 1, cdf, 0).amax(1)
        count = torch.where(active, tot, 1)
        dv = torch.where(active & (tot < params.freq_max), delta, 0)
        cdf += torch.where(le, 0, dv.unsqueeze(1))
        tot = tot + dv
        coder.step(t, torch.where(active, flo, 0), torch.where(active, fhi, 0), count)
    return coder.finish()


def encode_blocks_m(syms: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                    params: Parameters, n_words: int, delta: int = 1):
    """Code ``B`` blocks from their symbols with the model in the kernel (K5).

    Same arguments and returns as :func:`redux_tpu_torch.ops.encode.encode_blocks_fused`
    and the same bytes.  Raises ValueError unless ``params.fits_u32 or
    params.fits_wide32``, as the reference's kernel does.  CPU tensors
    take the plain version; CUDA tensors launch the kernel on the current
    stream.
    """
    expect_symbol_encoder(syms, lens, init_cum, params, n_words, delta)
    b, k = syms.shape
    dev = syms.device
    n_words, delta = int(n_words), int(delta)
    if not kernel_device(dev):
        return encode_blocks_m_plain(syms, lens, init_cum, params, n_words, delta)
    words = torch.empty(b, n_words, dtype=torch.int32, device=dev)
    byte_lens = torch.empty(b, dtype=torch.int32, device=dev)
    ovf = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return words, byte_lens, ovf
    err = _build.lib().rxt_encode_m(
        syms.data_ptr(), lens.data_ptr(), init_cum.data_ptr(), words.data_ptr(),
        byte_lens.data_ptr(), ovf.data_ptr(), b, k, n_words, delta, params.freq_max,
        params.code_bits, dev.index or 0, _build.stream_of(dev),
    )
    _build.check(err, "rxt_encode_m")
    _build.count_launch("encode_m", dev)
    return words, byte_lens, ovf
