"""K1 — per-position model values (lo, hi) of every block.

Counterpart: ``redux_tpu/ops/pallas_model.py::model_lohi_pallas`` (kernel
``_model_kernel``, launched by ``_model_lohi_jit``).  For block ``b`` and
position ``t``, ``lo = cdf_t[v]`` and ``hi = cdf_t[v+1]`` with
``v = syms[b, t]``, read before the position's own update; the update
``cdf[i] += delta`` for ``i > v`` runs while ``t < lens[b]`` and
``t < tfreeze``.  Kernel: ``csrc/model_values.cu``.
"""

from __future__ import annotations

import torch

from .. import _build
from ..params import Parameters
from .coder import expect, kernel_device, tfreeze

launches = 0  # kernel launches of model_lohi (CUDA tensors only)


def model_lohi_plain(syms: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                     params: Parameters, delta: int):
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
               params: Parameters, delta: int):
    """``(lo, hi)`` int32 ``(B, K)`` planes for ``(B, K)`` uint8 symbols.

    ``lens`` is ``(B,)`` int32, ``init_cum`` the ``(symbol_count + 1,)``
    int32 initial row, all on one device.  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream.
    """
    global launches
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
    launches += 1
    return lo, hi
