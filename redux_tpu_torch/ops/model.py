"""K1 — per-position model values (lo, hi) of every block.

Counterpart: ``redux_tpu/ops/pallas_model.py::model_lohi_pallas`` (kernel
``_model_kernel``, launched by ``_model_lohi_jit``).  For block ``b`` and
position ``t``, ``lo = cdf_t[v]`` and ``hi = cdf_t[v+1]`` with
``v = syms[b, t]``, read before the position's own update; the update
``cdf[i] += delta`` for ``i > v`` runs while ``t < lens[b]`` and
``t < tfreeze``.  Kernel: ``csrc/model_values.cu``.

:func:`precompute_encode_model` puts K1's planes into the reference's
six-tuple for the reference-format coder (``ops.coder.encode_blocks``).
"""

from __future__ import annotations

import torch

from .. import _build
from ..params import Parameters
from .coder import expect, kernel_device, tfreeze


def model_lohi_plain(syms: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                     params: Parameters, delta: int = 1):
    """The plain PyTorch version: the same state machine over all blocks
    at once, one Python step per position.  Runs on any device."""
    b, k = syms.shape
    dev = syms.device
    n = params.symbol_count + 1
    cdf = init_cum.to(torch.int64).expand(b, n).clone()
    iota = torch.arange(n, device=dev)
    upd_end = torch.clamp(lens.to(torch.int64), max=tfreeze(int(init_cum[-1]), params, delta))
    v_all = syms.to(torch.int64)
    lohi = torch.empty(b, k, 2, dtype=torch.int32, device=dev)
    for t in range(k):
        v = v_all[:, t : t + 1]
        lohi[:, t] = cdf.gather(1, torch.cat([v, v + 1], 1)).to(torch.int32)
        upd = (t < upd_end).unsqueeze(1)
        cdf += ((iota > v) & upd) * delta
    return lohi[..., 0].contiguous(), lohi[..., 1].contiguous()


def model_lohi(syms: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
               params: Parameters, delta: int = 1):
    """``(lo, hi)`` int32 ``(B, K)`` planes for ``(B, K)`` uint8 symbols.

    ``lens`` is ``(B,)`` int32, ``init_cum`` the ``(symbol_count + 1,)``
    int32 initial row, all on one device.  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream.
    """
    dev = syms.device
    expect(syms, "syms", torch.uint8, (None, None), dev)
    b, k = syms.shape
    expect(lens, "lens", torch.int32, (b,), dev)
    expect(init_cum, "init_cum", torch.int32, (params.symbol_count + 1,), dev)
    if params.symbol_bits != 8 or not 1 <= delta <= 255:
        raise ValueError("model_lohi takes symbol_bits 8 and delta in 1..255")
    if not kernel_device(dev):
        return model_lohi_plain(syms, lens, init_cum, params, delta)
    lo = torch.empty(b, k, dtype=torch.int32, device=dev)
    hi = torch.empty(b, k, dtype=torch.int32, device=dev)
    if b == 0 or k == 0:
        return lo, hi
    lib = _build.lib()
    err = lib.rxt_model_lohi(
        syms.data_ptr(), lens.data_ptr(), init_cum.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), b, k, int(delta), params.freq_max, dev.index or 0,
        _build.stream_of(dev),
    )
    _build.check(err, "rxt_model_lohi")
    _build.count_launch("model_values", dev)
    return lo, hi


def precompute_encode_model(symbols: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                            params: Parameters, delta: int = 1):
    """Per-position model values in the reference's layout, for
    :func:`redux_tpu_torch.ops.coder.encode_blocks`.

    Counterpart: ``redux_tpu/ops/ranks.py::precompute_encode_model``
    (:171-229).  Returns ``(lo, hi, tot, eof_lo, eof_hi, eof_tot)``, int32:
    ``(B, K)`` values at each data position (``lo``/``hi`` past ``lens``
    are don't-care) and the ``(B,)`` triple of the EOF symbol coded at
    position ``lens``.  ``lo``/``hi`` come from :func:`model_lohi` (K1 on a
    CUDA tensor, its plain version on a CPU tensor); ``tot`` and the EOF
    triple are the reference's closed forms (:216-228): every data symbol
    sorts below EOF, so EOF's bounds move only by the update count.
    ``symbols`` may be any integer dtype with values below 256.
    """
    syms = symbols.to(torch.uint8).contiguous()
    lens = lens.to(torch.int32).contiguous()
    lo, hi = model_lohi(syms, lens, init_cum, params, delta)
    n = params.symbol_count
    row = init_cum.to(torch.int64)
    init_total = row[n]
    # Updates stop at the first t with total >= freq_max (the reference's
    # t_freeze, not clamped: a row at or past freq_max never updates).
    t_freeze = torch.div(params.freq_max - init_total + (delta - 1), delta, rounding_mode="floor")
    lens64 = lens.to(torch.int64)
    t_idx = torch.arange(syms.shape[1], device=syms.device)[None, :]
    n_upd_t = torch.minimum(torch.minimum(t_idx, lens64[:, None]), t_freeze)
    tot = (init_total + delta * n_upd_t).to(torch.int32)
    n_upd = torch.minimum(lens64, t_freeze).clamp(min=0)  # updates before EOF
    eof_lo = (row[n - 1] + delta * n_upd).to(torch.int32)
    eof_hi = (row[n] + delta * n_upd).to(torch.int32)
    return lo, hi, tot, eof_lo, eof_hi, eof_hi.clone()
