"""K3 — the v2 block decoder.

Counterpart: ``redux_tpu/ops/pallas_decode.py::decode_blocks_pallas``
(:698-727; kernel ``_decode_kernel``, launched by ``_decode_pallas_jit``).
Kernel: ``csrc/decode.cu``.

Per block: prime ``z`` with ``code_bits`` bits; per symbol
``value = min(((z+1)*count - 1) // range, count - 1)``, the symbol with
``cdf[s] <= value < cdf[s+1]``, the ``+delta`` suffix update while
``count < freq_max``, narrowing with the pre-update count (``z`` moves
with ``low``), closed-form renormalisation, and ``n1 + n3`` more bits read
MSB-first (reads past the end of a row give zero bits).  Words are staged
block-major ``(B, W)``.

The kernel has two routes, chosen by the launch's block count ``B``
(:func:`warp_route_max`).  The thread route (one thread a block, the
model a Fenwick tree in shared memory: the cheapest model a block-symbol,
for throughput over many blocks) takes every quotient from a double
reciprocal with a one-step integer correction, at every parameter set
that :func:`~redux_tpu_torch.ops.coder.check_code_bits` admits: the
dividends reach ``2**63`` at the reference CLI's (8,30,32), but the
quotients stay below ``4 * count < 2**33`` (the value) and at most
``range <= 2**32`` (the narrowing), where the rounded product is within
one.  The warp route (one warp a block, the row in registers, no division
before the symbol search: the shortest chain a symbol, for launches of
few blocks) takes reciprocal quotients too, for its narrowing alone.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..params import Parameters
from .coder import M32, check_code_bits, expect, kernel_device, mask, renorm_plain


def decode_blocks_plain(words: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                        params: Parameters, k: int, delta: int = 1) -> torch.Tensor:
    """The plain PyTorch version: the decoder over all blocks at once, one
    Python step per symbol, in int64 with 32-bit masks.  Runs on any
    device.  Returns ``(B, k)`` uint8."""
    b, w = words.shape
    dev = words.device
    i64 = torch.int64
    cb = params.code_bits
    cmax = params.code_max
    s = params.symbol_count
    # Two zero words past every row: a read spans at most two words.
    w64 = torch.nn.functional.pad(words.to(i64) & M32, (0, 2))
    rows = torch.arange(b, device=dev)
    bitpos = torch.zeros(b, dtype=i64, device=dev)

    def read(n):
        nonlocal bitpos
        wi = (bitpos >> 5).clamp(max=w)
        window = (w64[rows, wi] << 32) | w64[rows, wi + 1]
        bits = (window >> (64 - (bitpos & 31) - n)) & mask(n)
        bitpos = bitpos + n
        return bits

    cdf = init_cum.to(i64).expand(b, s + 1).clone()
    iota = torch.arange(s + 1, device=dev)
    count = cdf[:, s].clone()
    lens = lens.to(i64)
    low = torch.zeros(b, dtype=i64, device=dev)
    high = torch.full_like(low, cmax)
    z = read(torch.full_like(low, cb))
    out = torch.zeros(b, k, dtype=torch.uint8, device=dev)
    t_end = min(int(lens.max()), k) if b else 0
    for t in range(t_end):
        active = t < lens
        rng = high - low + 1
        value = torch.minimum(((z + 1) * count - 1) // rng, count - 1)
        sym = (cdf <= value.unsqueeze(1)).sum(1) - 1
        f = cdf.gather(1, torch.stack([sym, sym + 1], 1))
        dlo = rng * f[:, 0] // count
        dhi = rng * f[:, 1] // count
        dv = (active & (count < params.freq_max)) * delta
        cdf += (iota > sym.unsqueeze(1)) * dv.unsqueeze(1)
        count = count + dv
        high = torch.where(active, low + dhi - 1, high)
        low = torch.where(active, low + dlo, low)
        z = torch.where(active, z - dlo, z)
        low, high, n1, n3 = renorm_plain(low, high, cb, active)
        n = (n1 + n3).clamp(max=cb)  # n1 + n3 <= code_bits on a valid stream
        z = torch.where(active, ((z << n) | read(n)) & cmax, z)
        out[:, t] = torch.where(active, sym, 0).to(torch.uint8)
    return out


# The warp route's blocks an SM at most: three warps a scheduler.  Its
# launch takes about 0.6 ms more for each warp a scheduler past the first
# (1.07 ms up to 512 blocks, 2.17 at 1536, 2.82 at 1792, on 132 SMs),
# against the thread route's 2.5-2.6 ms (tpu_wide and (8,30,32) alike).
WARP_BLOCKS_PER_SM = 12


@functools.lru_cache(maxsize=None)
def warp_route_max(device: torch.device) -> int:
    """The most blocks a K3 launch on ``device`` (a CUDA device) decodes on
    the warp route: :data:`WARP_BLOCKS_PER_SM` times its SM count."""
    return WARP_BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def decode_blocks(words: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                  params: Parameters, k: int, delta: int = 1, *,
                  _route: str | None = None) -> torch.Tensor:
    """Decode ``B`` blocks of ``k`` symbols at most.

    Args: ``(B, W)`` int32 (or uint32) big-endian words, zero-padded past
    each stream; ``(B,)`` int32 symbol counts (0 for no stream); the
    ``(symbol_count + 1,)`` int32 initial row.  Returns ``(B, k)`` uint8,
    zero past each block's count.  CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream, on the warp
    route where ``B <= warp_route_max(device)``, else the thread route
    (``_route``, ``"warp"`` or ``"thread"``, forces one: for the tests and
    the kernel A/B alone).  The blocks count into ``_build.route_blocks``.
    """
    dev = words.device
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    expect(words, "words", torch.int32, (None, None), dev)
    b, w = words.shape
    expect(lens, "lens", torch.int32, (b,), dev)
    expect(init_cum, "init_cum", torch.int32, (params.symbol_count + 1,), dev)
    check_code_bits(params)
    if params.symbol_bits != 8 or not 1 <= delta <= 255 or k < 0:
        raise ValueError("decode_blocks takes symbol_bits 8, delta in 1..255, k >= 0")
    k, delta = int(k), int(delta)
    if _route not in (None, "warp", "thread"):
        raise ValueError(f"decode_blocks: no route {_route!r}")
    if not kernel_device(dev):
        return decode_blocks_plain(words, lens, init_cum, params, k, delta)
    out = torch.empty(b, k, dtype=torch.uint8, device=dev)
    if b == 0 or k == 0:
        return out
    route = _route or ("warp" if b <= warp_route_max(dev) else "thread")
    lib = _build.lib()
    err = lib.rxt_decode_blocks(
        words.data_ptr(), lens.data_ptr(), init_cum.data_ptr(), out.data_ptr(), b, w, k,
        delta, params.freq_max, params.code_bits, int(route == "warp"), dev.index or 0,
        _build.stream_of(dev),
    )
    _build.check(err, "rxt_decode_blocks")
    _build.count_launch("decode", dev)
    _build.count_blocks(route, dev, b)
    return out
