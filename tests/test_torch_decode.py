"""K3 (decoder): the port's plain version against the reference's Pallas
decoder in interpret mode (``decode_blocks_pallas``) on the sequential
oracle's v2 streams.  Exact equality of the decoded symbols.  Also the
CUDA kernel's algebra, emulated in numpy: the Fenwick descent and
``freq(sym)`` against the row search, the reciprocal quotients against
integer division at every parameter class, one emulated thread on valid
and on corrupt streams, and the wrapper's kernel arguments."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from redux_tpu import oracle
from redux_tpu.models.dense import prior_init_cum, uniform_init_cum
from redux_tpu.ops.pallas_decode import decode_blocks_pallas
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch.ops.coder import bytes_to_words, products_fit_53
from redux_tpu_torch.ops.decode import decode_blocks, decode_blocks_plain
from redux_tpu_torch.params import Parameters
from torch_kernel_emulation import (NODES, div53, div53_int, fenwick_add, fenwick_tree,
                                    renorm)


def _words(streams, extra_words):
    wn = max((len(s) + 3) // 4 for s in streams) + extra_words
    byts = np.zeros((len(streams), wn * 4), np.uint8)
    for i, s in enumerate(streams):
        byts[i, : len(s)] = np.frombuffer(s, np.uint8)
    return bytes_to_words(torch.from_numpy(byts))


def _check(blocks, cfg, ic, delta, k, extra_words=2):
    rp, p = RefParameters(*cfg), Parameters(*cfg)
    streams = [oracle.compress_block(b, rp, ic.astype(np.int64), delta) for b in blocks]
    words = _words(streams, extra_words)
    lens = np.array([len(b) for b in blocks], np.int32)
    got = decode_blocks(words, torch.from_numpy(lens), torch.from_numpy(ic), p, k, delta)
    ref = np.asarray(decode_blocks_pallas(
        jnp.asarray(words.numpy().view(np.uint32)), jnp.asarray(lens), jnp.asarray(ic), rp, k,
        delta))
    assert got.shape == (len(blocks), k) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.where(np.arange(k) < lens[:, None], ref, 0))
    for i, b in enumerate(blocks):
        assert got.numpy()[i, : len(b)].tobytes() == b, f"block {i}"
    return streams


def _mixed(seed, k):
    rng = np.random.default_rng(seed)
    return [
        bytes(rng.integers(0, 256, k, dtype=np.uint8)),
        bytes([65] * k),
        (b"the quick brown fox jumps over the lazy dog. " * 20)[:k],
        bytes(rng.integers(0, 4, k, dtype=np.uint8)),
        b"x",
        b"",
        bytes(rng.integers(0, 256, 77, dtype=np.uint8)),
    ]


@pytest.mark.parametrize("cfg,delta", [((8, 20, 22), 16), ((8, 15, 17), 1), ((8, 20, 22), 255)])
def test_decoder_matches_pallas(cfg, delta):
    k = 384
    ic = uniform_init_cum(RefParameters(*cfg)).astype(np.int32)
    _check(_mixed(delta, k), cfg, ic, delta, k)


def test_decoder_prior_and_freeze():
    """Warm-start prior + a small freq cap so the freeze engages mid-block."""
    cfg, k = (8, 14, 16), 480
    rng = np.random.default_rng(2)
    extra = np.zeros(257, np.int64)
    extra[:256] = rng.integers(0, 30, 256)
    ic = prior_init_cum(extra, RefParameters(*cfg)).astype(np.int32)
    _check(_mixed(3, k), cfg, ic, 64, k)


def test_decoder_freeze_overshoot_top_symbol():
    """tests/test_freeze_overshoot.py's scenario: the last update overshoots
    freq_max (final total freq_max + 2) and 0xFF is decoded after it."""
    cfg, delta, k = (8, 14, 16), 16, 1200
    rng = np.random.default_rng(99)
    data = rng.integers(0, 256, k, dtype=np.uint8)
    data[1010:] = 255
    ic = uniform_init_cum(RefParameters(*cfg)).astype(np.int32)
    assert int(ic[-1]) + delta * -(-(RefParameters(*cfg).freq_max - int(ic[-1])) // delta) > (
        RefParameters(*cfg).freq_max)
    _check([bytes(data), bytes(data[::-1])], cfg, ic, delta, k)


def test_decoder_streams_ending_on_word_boundary():
    """Streams whose length is a multiple of 4 bytes, given with no zero
    words after them: reads past the row must give zero bits."""
    cfg, delta = (8, 20, 22), 16
    ic = uniform_init_cum(RefParameters(*cfg)).astype(np.int32)
    rp = RefParameters(*cfg)
    text = b"word boundary streams end exactly here; " * 8
    blocks = []
    for n in range(1, 300):
        s = oracle.compress_block(text[:n], rp, ic.astype(np.int64), delta)
        if len(s) % 4 == 0:
            blocks.append(text[:n])
        if len(blocks) == 4:
            break
    assert len(blocks) == 4
    for b in blocks:  # one block per call: its row ends where its stream ends
        (s,) = _check([b], cfg, ic, delta, 320, extra_words=0)
        assert len(s) % 4 == 0


def _descent(node, value, base):
    """The kernel's symbol search: steps 256 .. 1, a node taken while its
    sum is <= the remainder, three levels a round (the 7 nodes below pos
    read together); then ``freq(sym)`` as node p = sym + 1 less the nodes
    p - 2**q, q under p's trailing zero count.  Returns (sym, flo, fhi)."""
    pos, rem, s = 0, value - base, 64
    while s:
        n = {}
        for j in range(1, 8):
            lvl = 2 if j >= 4 else (1 if j >= 2 else 0)
            idx = pos + ((j - (1 << lvl)) << (3 - lvl)) * s + ((4 * s) >> lvl)
            n[j] = node[idx] if idx <= NODES else 2**32 - 1
        j = 1
        for lvl in range(3):  # a, then b, then c of the kernel
            take = n[j] <= rem
            pos, rem = pos + (((4 * s) >> lvl) if take else 0), rem - (n[j] if take else 0)
            j = 2 * j + take
        s >>= 3
    p = pos + 1
    tz = (p & -p).bit_length() - 1
    f = node[p] - sum(node[p - (1 << q)] for q in range(tz))
    flo = value - rem
    return pos, flo, flo + f


@pytest.mark.parametrize("cfg,delta", [((8, 20, 22), 16), ((8, 15, 17), 255), ((8, 14, 16), 64)])
def test_fenwick_descent_equals_the_row_search(cfg, delta):
    """Over random adapted rows with zero-width neighbours, adapted past
    the freeze (count overshoots freq_max), the descent gives
    ``(cdf <= value).sum() - 1``, ``cdf[sym]`` and ``cdf[sym + 1]`` for
    every boundary value, ``count - 1`` and random values."""
    p = Parameters(*cfg)
    rng = np.random.default_rng(cfg[1] + delta)
    freq = rng.integers(0, 40, 257)
    freq[rng.integers(0, 257, 60)] = 0  # zero-width symbols, some neighbouring
    freq[100:104] = 0
    freq[255:] = [0, 1]
    cdf = np.concatenate([[0], np.cumsum(freq)]).astype(np.int64)
    node = fenwick_tree(cdf)

    def check():
        count = int(cdf[-1])
        values = {0, count - 1, *rng.integers(0, count, 40).tolist()}
        values |= {int(c) for c in cdf if c < count} | {int(c) - 1 for c in cdf if 0 < c}
        for value in sorted(values):
            sym = int((cdf <= value).sum()) - 1
            assert _descent(node, value, 0) == (sym, cdf[sym], cdf[sym + 1]), value

    updates = 0
    while cdf[-1] < p.freq_max:  # the kernel's update rule, dense and as a tree
        if updates % 97 == 0:
            check()
        v = int(rng.choice([0, 7, 101, 255, 256, *rng.integers(0, 257, 3).tolist()]))
        cdf[v + 1 :] += delta
        fenwick_add(node, v, delta)
        updates += 1
    assert cdf[-1] > p.freq_max  # the freeze overshoot
    check()
    assert node == fenwick_tree(cdf)


def _multiples(rng, b, q_max, a_max):
    """Pairs one below, at and one above a multiple of each divisor ``b``,
    and one below the next: ``q * b - 1``, ``q * b``, ``q * b + 1`` and
    ``q * b + b - 1`` for a random ``q`` in ``1 .. q_max`` (every 7th at
    ``q_max``), dividends clipped below ``a_max``."""
    q = (rng.random(b.size) * (q_max.astype(np.float64) + 1)).astype(np.uint64)
    q = np.minimum(np.maximum(q, 1), q_max)
    q[::7] = q_max[::7]
    one = np.uint64(1)
    return [np.minimum(a, a_max - one) for a in (q * b - one, q * b, q * b + one, q * b + b - one)]


def _thread_route_pairs(p, rng, n):
    """The quotients of K3's thread route at ``p``: ``(dividends,
    divisors)`` pairs.  The value quotient ``((z+1)*count - 1) // range``
    with ``z < 2**code_bits``, ``count`` up to ``freq_max + 254`` and a
    renormalised ``range`` in ``2**(code_bits-2) + 1 .. 2**code_bits``
    (the quotient below ``4 * count``); the narrowing quotients ``range *
    c // count`` with ``c <= count``; random pairs of each kind, each
    range's ends, and multiples (:func:`_multiples`) over the same
    divisors and dividends."""
    cb, c_max = p.code_bits, p.freq_max + 254
    u = np.uint64
    r_lo, r_hi = (1 << (cb - 2)) + 1, 1 << cb

    def ends(lo, hi, size):
        return np.concatenate([rng.integers(lo, hi + 1, size, dtype=u),
                               lo + rng.integers(0, 64, size // 4, dtype=u),
                               hi - rng.integers(0, 64, size // 4, dtype=u),
                               np.array([lo, hi], u)])

    pairs = []
    # The value quotient.
    rng_v = ends(r_lo, r_hi, n)
    z, count = rng.permutation(ends(0, r_hi - 1, n)), rng.permutation(ends(257, c_max, n))
    pairs.append(((z + u(1)) * count - u(1), rng_v))
    a_max = u(r_hi) * u(c_max)  # every value dividend is below it
    pairs += [(a, rng_v) for a in _multiples(rng, rng_v, (a_max - u(1)) // rng_v, a_max)]
    # The narrowing quotients.
    count = ends(1, c_max, n)
    c = (rng.random(count.size) * (count.astype(np.float64) + 1)).astype(u)
    c = np.minimum(c, count)
    c[::5] = count[::5]
    c[1::5] = 0
    rng_n = rng.permutation(ends(r_lo, r_hi, n))
    rng_n[::11] = r_hi
    pairs.append((rng_n * c, count))
    pairs += [(a, count) for a in _multiples(rng, count, np.full(count.size, r_hi, u),
                                             u(r_hi) * count + u(1))]
    return pairs


@pytest.mark.parametrize("cfg", [(8, 20, 22), (8, 15, 17), (8, 21, 32), (8, 30, 32)])
def test_reciprocal_quotient_is_exact(cfg):
    """``rxt::div53`` against integer division over the pairs K3's thread
    route reaches at this configuration (:func:`_thread_route_pairs`), at
    every parameter class: the reference CLI's (8,30,32) and the first set
    past ``products_fit_53``'s edge, (8,21,32), have dividends past
    ``2**53`` (up to ``2**62``), and the quotients stay below ``2**33``.  Where
    ``products_fit_53``, also random and boundary pairs (a = q*b - 1, q*b,
    q*b + b - 1) over every divisor and dividend the decoder reaches:
    divisors up to 2**code_bits (the range) and freq_max + 254 (the count),
    dividends below 2**code_bits * (freq_max + 255).  The encoders' (K2,
    K4, K5) quotients are the same function over a subset of these pairs:
    ``range * flo`` and ``range * fhi`` over ``count``, with
    ``range <= 2**code_bits`` and ``flo <= fhi <= count <= freq_max + 254``."""
    p = Parameters(*cfg)
    rng = np.random.default_rng(cfg[2] + cfg[1])
    n = 200_000
    pairs = _thread_route_pairs(p, rng, n)
    for a, b in pairs:
        assert int(a.max()) < 1 << 63 and int((a // b).max()) < 1 << 33
    if cfg[2] == 32:  # dividends past 2**53: 2**53.0001 at (8,21,32), 2**62 at (8,30,32)
        assert not products_fit_53(p) and max(int(a.max()) for a, _ in pairs) > 1 << 53
    if products_fit_53(p):
        a_max = (1 << p.code_bits) * (p.freq_max + 255)
        assert a_max <= 1 << 53
        b_max = max(1 << p.code_bits, p.freq_max + 254)
        b = np.concatenate([
            rng.integers(1, b_max + 1, n, dtype=np.uint64),
            rng.integers(1, 64, n // 4, dtype=np.uint64),
            np.uint64(b_max) - rng.integers(0, 64, n // 4, dtype=np.uint64),
            np.array([1, 2, 3, 1 << p.code_bits, p.freq_max, p.freq_max + 254], np.uint64),
        ])
        q_max = np.uint64(a_max - 1) // b
        pairs += [(a, b) for a in _multiples(rng, b, q_max, np.uint64(a_max))]
        pairs.append((rng.integers(0, a_max, b.size, dtype=np.uint64), b))
    for a, b in pairs:
        np.testing.assert_array_equal(div53(a, b), a // b)


def test_products_fit_53_routes_the_instantiations(monkeypatch):
    """K3 has one instantiation: ``decode_blocks`` passes
    ``rxt_decode_blocks`` no instantiation flag, so its thread route takes
    the same arguments, in the same places, at tpu_wide, tpu32, the first
    set past the 53-bit edge and the reference CLI's (8,30,32) (the card's
    warp route made empty here).  K2 keeps two: ``products_fit_53`` still
    picks ``encode_blocks``' instantiation, reciprocal quotients (flag 1)
    up to the edge and u64 divisions (flag 0) past it."""
    from redux_tpu_torch import _build
    from redux_tpu_torch.ops import decode as dec
    from redux_tpu_torch.ops import encode as enc

    assert products_fit_53(Parameters.tpu_wide()) and products_fit_53(Parameters.tpu32())
    assert not products_fit_53(Parameters.default())
    # The edge: 32 + bit_length(2**20 - 1 + 254) = 53, 32 + bit_length(2**21 - 1 + 254) = 54.
    assert products_fit_53(Parameters(8, 20, 32)) and not products_fit_53(Parameters(8, 21, 32))

    seen = {"rxt_decode_blocks": [], "rxt_encode_blocks": []}

    class FakeLib:
        def rxt_decode_blocks(self, *args):
            seen["rxt_decode_blocks"].append(args)
            return 0

        def rxt_encode_blocks(self, *args):
            seen["rxt_encode_blocks"].append(args)
            return 0

    for mod in (dec, enc):
        monkeypatch.setattr(mod, "kernel_device", lambda dev: True)
    monkeypatch.setattr(dec, "warp_route_max", lambda dev: 0)
    monkeypatch.setattr(_build, "card_launches", type(_build.card_launches)())
    monkeypatch.setattr(_build, "route_blocks", type(_build.route_blocks)())
    monkeypatch.setattr(_build, "lib", lambda: FakeLib())
    monkeypatch.setattr(_build, "stream_of", lambda dev: 0)
    words = torch.zeros(2, 4, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    lo = torch.zeros(2, 8, dtype=torch.int32)
    n_args = len(_build.SIGNATURES["rxt_decode_blocks"])
    for params in (Parameters.tpu_wide(), Parameters.tpu32(), Parameters(8, 21, 32),
                   Parameters.default()):
        ic = torch.from_numpy(uniform_init_cum(RefParameters(params.symbol_bits, params.freq_bits,
                                                             params.code_bits)).astype(np.int32))
        decode_blocks(words, lens, ic, params, 8, 16)
        args = seen["rxt_decode_blocks"][-1]
        assert len(args) == n_args == 13, params
        # ..., B, W, k, delta, freq_max, code_bits, warp, device, stream
        assert args[4:] == (2, 4, 8, 16, params.freq_max, params.code_bits, 0, 0, 0), params
        enc.encode_blocks(lo, lo, lens, 257, params, 4, 16)
        assert seen["rxt_encode_blocks"][-1][13] == int(products_fit_53(params)), params
    assert dict(_build.route_blocks) == {("thread", "cpu"): 8}


def _decode_block_emulated(words, n_sym, ic, p, delta):
    """numpy/Python emulation of one thread of ``csrc/decode.cu``'s thread
    route: Fenwick descent, ``freq(sym)``, reciprocal quotients at every
    parameter set, the update after the narrowing with the pre-update
    count."""
    cb, cmax = p.code_bits, p.code_max
    bits = "".join(f"{int(w) & 0xFFFFFFFF:032b}" for w in words)
    pos_bits = 0

    def read(n):
        nonlocal pos_bits
        s = bits[pos_bits : pos_bits + n].ljust(n, "0")
        pos_bits += n
        return int(s, 2) if n else 0

    node = fenwick_tree(ic.astype(np.int64))
    count = int(ic[-1])
    low, high, z = 0, cmax, read(cb)
    out = []
    for _ in range(n_sym):
        rng = high - low + 1
        value = min(div53_int((z + 1) * count - 1, rng), count - 1)
        sym, flo, fhi = _descent(node, value, int(ic[0]))
        dlo, dhi = div53_int(rng * flo, count), div53_int(rng * fhi, count)
        high, low, z = low + dhi - 1, low + dlo, z - dlo
        low, high, n1, n3 = renorm(low, high, cb)
        n = min(n1 + n3, cb)
        z = ((z << n) | read(n)) & cmax
        if count < p.freq_max:
            fenwick_add(node, sym, delta)
            count += delta
        out.append(sym & 0xFF)  # a byte, as the kernel stores it (256 on corrupt streams)
    return bytes(out)


@pytest.mark.parametrize("cfg,delta", [((8, 20, 22), 16), ((8, 14, 16), 64)])
def test_kernel_algorithm_decodes_reference_streams(cfg, delta):
    """The emulated kernel thread decodes the sequential oracle's streams,
    with the freeze engaged at (8,14,16), and equals the plain version."""
    rp, p = RefParameters(*cfg), Parameters(*cfg)
    k = 600
    ic = uniform_init_cum(rp).astype(np.int32)
    blocks = [b for b in _mixed(17, k) if b]
    streams = [oracle.compress_block(b, rp, ic.astype(np.int64), delta) for b in blocks]
    words = _words(streams, 2)
    lens = torch.tensor([len(b) for b in blocks], dtype=torch.int32)
    plain = decode_blocks(words, lens, torch.from_numpy(ic), p, k, delta).numpy()
    for i, b in enumerate(blocks):
        got = _decode_block_emulated(words[i].numpy(), len(b), ic, p, delta)
        assert got == b and got == plain[i, : len(b)].tobytes(), f"block {i}"


def _freezing_row(rp, delta: int, at: int) -> np.ndarray:
    """A warm-start row from a seeded histogram whose total reaches
    ``freq_max`` at its ``at``-th update, overshooting it by ``delta // 2 +
    1``: the largest counts, and dividends, the decoder meets."""
    off = delta // 2 + 1
    head = rp.freq_max - at * delta + off - rp.symbol_count
    w = np.random.default_rng(rp.freq_bits).integers(1, 100, rp.symbol_count).astype(np.float64)
    extra = np.floor(w / w.sum() * head).astype(np.int64)
    extra[0] += head - int(extra.sum())
    ic = prior_init_cum(extra, rp)
    assert ic[-1] + at * delta == rp.freq_max + off
    return ic


@pytest.mark.parametrize("cfg", [(8, 21, 32), (8, 30, 32)])
def test_kernel_algorithm_past_the_53_bit_edge(cfg):
    """Where ``products_fit_53`` is false and the dividends reach
    ``2**62``, the emulated thread, on reciprocal quotients as at every
    parameter set, decodes the oracle's streams over a row whose total
    reaches freq_max mid-block, equal to the plain version (exact integer
    division); and on the same words with bits flipped, decoded to ``k``
    symbols a block, it still equals the plain version: a corrupt stream's
    ``z`` bears no relation to the interval, so the value quotient can pass
    ``count``, where both clamp it alike."""
    rp, p = RefParameters(*cfg), Parameters(*cfg)
    delta, k = 16, 900
    ic = _freezing_row(rp, delta, 600).astype(np.int32)
    ic_t = torch.from_numpy(ic)
    blocks = [b for b in _mixed(23, k) if b]
    streams = [oracle.compress_block(b, rp, ic.astype(np.int64), delta) for b in blocks]
    words = _words(streams, 2)
    lens = torch.tensor([len(b) for b in blocks], dtype=torch.int32)
    plain = decode_blocks(words, lens, ic_t, p, k, delta).numpy()
    for i, b in enumerate(blocks):
        got = _decode_block_emulated(words[i].numpy(), len(b), ic, p, delta)
        assert got == b and got == plain[i, : len(b)].tobytes(), f"block {i}"
    rng = np.random.default_rng(cfg[1])
    bad = words.numpy().view(np.uint32).copy()
    for i, st in enumerate(streams):
        n_words = (len(st) + 3) // 4
        for w in [0, *rng.integers(0, n_words, 3).tolist()]:
            bad[i, w] ^= np.uint32(1 << int(rng.integers(0, 32)))
    bad_t = torch.from_numpy(bad.view(np.int32))
    plain = decode_blocks_plain(bad_t, torch.full_like(lens, k), ic_t, p, k, delta).numpy()
    for i in range(len(blocks)):
        got = _decode_block_emulated(bad[i], k, ic, p, delta)
        assert got == plain[i].tobytes(), f"corrupt block {i}"


def test_decoder_wrapper_checks():
    p = Parameters.tpu_wide()
    ic = torch.arange(258, dtype=torch.int32)
    words = torch.zeros(2, 4, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        decode_blocks(words.to(torch.int64), lens, ic, p, 8, 16)
    with pytest.raises(ValueError):
        decode_blocks(words, lens, ic.to(torch.int64), p, 8, 16)
    with pytest.raises(ValueError):
        decode_blocks(words, lens, ic, p, 8, 0)
    out = decode_blocks(words.view(torch.uint32), lens, ic, p, 8, 16)
    assert out.shape == (2, 8) and not out.any()
