"""User-defined adaptive models on the device path.

Counterpart: ``redux_tpu/ops/generic.py`` — ``JaxModel`` (:39) as
:class:`TorchModel`, ``dense_jax_model`` (:63), ``static_jax_model``
(:102), ``model_values_generic`` (:114), ``encode_blocks_generic``
(:142), ``decode_blocks_generic`` (:154-265) and ``make_generic_coders``
(:268).  The reference's headline extension point is the ``Model`` trait
(``src/model/mod.rs:17-29``): any model plugs into the codec.  A
:class:`TorchModel` bundles the trait's methods as callables over
``(B, ...)`` tensors, one lane a block, and the coders below drive it one
position a step with the closed-form renormalisation of the kernels.
Streams are the reference format (EOF symbol and ``code_bits`` drain),
bit-identical to :func:`redux_tpu_torch.oracle.compress_bytes` driving the
same rule on the host.

In the reference these coders are XLA ``lax.scan`` code, not Pallas: user
code cannot go into a hand-written kernel.  Here they are plain PyTorch on
the device of their inputs (the card for CUDA tensors), at the speed of
one step of tensor operations a position; the archive path stays on the
kernels.

Split-lookup contract (as in the reference): the lookup and the adaptation
are separate functions so the coder can gate the update on the lane being
live.  A host rule maps mechanically: ``get_frequency(s)`` is
``encode_sym`` then ``update``; ``get_symbol(v)`` is ``decode_val`` then
``update``.  As in the reference, nothing checks a user's rows: every
symbol needs a width of at least 1 and the total must stay within
``freq_max`` plus one increment.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..params import Parameters
from .coder import M32, encode_blocks, renorm_plain


class TorchModel(NamedTuple):
    """A lane-batched adaptive model: callables over a state of ``(B, ...)``
    tensors.  Frequencies are integers below ``2**31`` (every legal config
    has ``freq_bits <= 30``).

    * ``init(B, device)`` -> state for ``B`` lanes on ``device``.
    * ``total(state)`` -> ``(B,)`` cumulative total (model/mod.rs:21).
    * ``encode_sym(state, sym)`` -> ``(flo, fhi)``, the ``(B,)`` cumulative
      bounds of ``sym`` (the lookup half of model/mod.rs:23).
    * ``decode_val(state, value)`` -> ``(sym, flo, fhi)``, the symbol whose
      range holds ``value`` (model/mod.rs:25).
    * ``update(state, sym, active)`` -> the new state; a no-op on lanes
      where ``active`` is false (positions past ``lens``).

    Every callable but ``init`` follows its inputs' device.
    """

    init: Callable[[int, torch.device], Any]
    total: Callable[[Any], torch.Tensor]
    encode_sym: Callable[[Any, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
    decode_val: Callable[[Any, torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    update: Callable[[Any, torch.Tensor, torch.Tensor], Any]


def dense_torch_model(params: Parameters, init_cum, delta: int = 1) -> TorchModel:
    """The archive's dense order-0 ``+delta`` rule as a :class:`TorchModel`.

    The bridge between the generic and the kernel paths: its streams equal
    K1's values through :func:`redux_tpu_torch.ops.coder.encode_blocks`.
    The state is the ``(B, S+1)`` int64 cumulative row, frozen once its
    total reaches ``freq_max`` (adaptive_linear.rs:34 with ``+delta``).
    """
    s = params.symbol_count
    freq_max = params.freq_max
    row = torch.as_tensor(init_cum).to(torch.int64)
    # Above every live entry: the frozen total overshoots by delta - 1 at most.
    sentinel = freq_max + max(delta, 1)

    def init(b: int, device) -> torch.Tensor:
        return row.to(device).expand(b, s + 1).clone()

    def total(cum):
        return cum[:, s]

    def encode_sym(cum, sym):
        f = cum.gather(1, torch.stack([sym, sym + 1], 1).to(torch.int64))
        return f[:, 0], f[:, 1]

    def decode_val(cum, value):
        b = cum <= value[:, None]
        sym = (b.sum(1) - 1).clamp(0, s - 1)
        flo = torch.where(b, cum, 0).amax(1)
        fhi = torch.where(b, sentinel, cum).amin(1)
        return sym, flo, fhi

    def update(cum, sym, active):
        upd = active & (cum[:, s] < freq_max)
        above = torch.arange(s + 1, device=cum.device)[None, :] > sym[:, None]
        return cum + (above & upd[:, None]) * delta

    return TorchModel(init, total, encode_sym, decode_val, update)


def static_torch_model(params: Parameters, cum_row) -> TorchModel:
    """A frozen (non-adaptive) model from a fixed cumulative row.

    ``cum_row`` is ``(S+1,)`` nondecreasing with every symbol's width at
    least 1 and its total at most ``freq_max`` (not checked, as in the
    reference, :105-108).
    """
    m = dense_torch_model(params, cum_row, delta=0)
    return m._replace(update=lambda state, sym, active: state)


def model_values_generic(model: TorchModel, syms: torch.Tensor, lens: torch.Tensor,
                         params: Parameters):
    """Per-position model values for :func:`~redux_tpu_torch.ops.coder.encode_blocks`.

    The generic twin of :func:`redux_tpu_torch.ops.model.precompute_encode_model`:
    runs the model forward over the known symbols, one step a position,
    and returns ``(lo, hi, tot, eof_lo, eof_hi, eof_tot)`` as int64.
    """
    syms = syms.to(torch.int64)
    lens = lens.to(torch.int64)
    b, k = syms.shape
    state = model.init(b, syms.device)
    lo = torch.empty(b, k, dtype=torch.int64, device=syms.device)
    hi, tot = torch.empty_like(lo), torch.empty_like(lo)
    for t in range(k):
        tot[:, t] = model.total(state)
        lo[:, t], hi[:, t] = model.encode_sym(state, syms[:, t])
        state = model.update(state, syms[:, t], t < lens)
    eof = torch.full((b,), params.symbol_eof, dtype=torch.int64, device=syms.device)
    eof_lo, eof_hi = model.encode_sym(state, eof)
    return lo, hi, tot, eof_lo, eof_hi, model.total(state)


def encode_blocks_generic(syms: torch.Tensor, lens: torch.Tensor, model: TorchModel,
                          params: Parameters, n_words: int):
    """Encode ``B`` blocks with an arbitrary :class:`TorchModel`.

    Returns ``(words, byte_lens)`` as
    :func:`redux_tpu_torch.ops.coder.encode_blocks` does: per-block
    reference-format streams, bit-identical to
    :func:`redux_tpu_torch.oracle.compress_bytes` driving the same rule.
    """
    vals = model_values_generic(model, syms, lens, params)
    return encode_blocks(*vals, lens, params, n_words)


def decode_blocks_generic(words: torch.Tensor, lens: torch.Tensor, model: TorchModel,
                          params: Parameters, k: int) -> torch.Tensor:
    """Decode ``B`` blocks with an arbitrary :class:`TorchModel`.

    ``words`` is ``(B, W)`` big-endian u32 bit patterns (int32, uint32 or
    int64), ``lens`` the ``(B,)`` symbol counts.  The decoder tracks
    ``z = code - low`` (every renormalisation step is ``z <- (z << 1) |
    bit``), so a symbol consumes its ``n1 + n3`` bits in at most two
    chunked reads of a two-word register window per lane, as in the
    reference (:175-209; reads past the row repeat its last word).  The
    symbol is ``value = ((z + 1) * count - 1) // range`` (codec.rs:131),
    in int64: ``(z + 1) * count`` reaches ``2**62`` at (8,30,32).
    Returns ``(B, k)`` int64 symbols, 0 past ``lens``.
    """
    i64 = torch.int64
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    words = words.to(i64) & M32
    lens = lens.to(i64)
    b, wn = words.shape
    dev = words.device
    cb = params.code_bits
    rows = torch.arange(b, device=dev)
    zero = torch.zeros(b, dtype=i64, device=dev)

    cur = words[:, 0]
    nxt = words[:, 1] if wn > 1 else zero
    avail = zero + 32
    wordidx = zero + 2

    def read_bits(m):
        """``m`` (<= 31) bits from the window; at most one word loaded."""
        nonlocal cur, avail, nxt, wordidx
        take1 = torch.minimum(m, avail)
        v1 = torch.where(take1 > 0, cur >> (32 - take1), 0)
        cur = torch.where(take1 > 0, (cur << take1) & M32, cur)
        avail = avail - take1
        m2 = m - take1
        need2 = m2 > 0
        m2c = m2.clamp(min=1)
        v2 = torch.where(need2, nxt >> (32 - m2c), 0)
        cur = torch.where(need2, (nxt << m2c) & M32, cur)
        avail = torch.where(need2, 32 - m2, avail)
        loaded = words[rows, wordidx.clamp(max=wn - 1)]
        nxt = torch.where(need2, loaded, nxt)
        wordidx = wordidx + need2
        return torch.where(need2, (v1 << m2c) | v2, v1)

    # Prime z with the first code_bits bits (codec.rs:124-127).
    z = zero.clone()
    prime = zero + cb
    for _ in range(2):
        m = prime.clamp(max=31)
        z = (z << m) | read_bits(m)
        prime = prime - m

    n_reads = 1 if cb <= 31 else 2
    low, high = zero.clone(), zero + params.code_max
    state = model.init(b, dev)
    out = torch.zeros(b, k, dtype=i64, device=dev)
    for t in range(k):
        active = t < lens
        rng = high - low + 1
        count = model.total(state).to(i64)
        value = torch.minimum(((z + 1) * count - 1) // rng, count - 1)  # garbage-input guard
        sym, flo, fhi = model.decode_val(state, value)
        state = model.update(state, sym, active)
        dlo = rng * flo.to(i64) // count
        nhigh = low + rng * fhi.to(i64) // count - 1
        z = torch.where(active, z - dlo, z)
        low = torch.where(active, low + dlo, low)
        high = torch.where(active, nhigh, high)
        low, high, n1, n3 = renorm_plain(low, high, cb, active)
        n = n1 + n3
        for _ in range(n_reads):
            m = n.clamp(max=31)
            z = torch.where(m > 0, (z << m) | read_bits(m), z)
            n = n - m
        out[:, t] = torch.where(active, sym.to(i64), 0)
    return out


def make_generic_coders(model: TorchModel, params: Parameters):
    """``(encode, decode)`` closures over a fixed model and parameters:
    ``encode(syms, lens, n_words)`` -> ``(words, byte_lens)``;
    ``decode(words, lens, k)`` -> ``(B, k)`` symbols."""

    def encode(syms, lens, n_words):
        return encode_blocks_generic(syms, lens, model, params, n_words)

    def decode(words, lens, k):
        return decode_blocks_generic(words, lens, model, params, k)

    return encode, decode
