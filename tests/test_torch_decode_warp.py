"""K3's warp route on the CPU: one warp of ``csrc/decode.cu``'s untemplated
``decode_kernel``, emulated statement for statement
(``torch_kernel_emulation.decode_warp``), against the port's plain decoder
(``decode_blocks_plain``) and the reference's sequential decoder
(``redux_tpu.oracle.decompress_block``), byte for byte, on the oracle's v2
streams; its narrowing quotient against integer division; and how
``decode_blocks`` picks a route and counts its blocks."""

import numpy as np
import pytest
import torch

from redux_tpu import oracle
from redux_tpu.models.dense import prior_init_cum, uniform_init_cum
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch import _build
from redux_tpu_torch.ops import decode as dec
from redux_tpu_torch.ops.coder import bytes_to_words
from redux_tpu_torch.ops.decode import decode_blocks_plain
from redux_tpu_torch.params import Parameters
from torch_kernel_emulation import decode_warp, narrow, renorm, renorm32

CONFIGS = {"tpu_wide": (8, 20, 22), "tpu32": (8, 15, 17), "ref30": (8, 30, 32)}
FREEZE_AT = 600  # the prior rows' position of the last update


def _row(cfg, delta: int, prior: bool) -> np.ndarray:
    """The uniform row, or a warm-start row from a seeded histogram whose
    total reaches freq_max at its FREEZE_AT-th update, overshooting it by
    delta // 2 + 1 (for delta > 1): the freeze engages mid-block."""
    rp = RefParameters(*cfg)
    if not prior:
        return uniform_init_cum(rp)
    off = delta // 2 + 1 if delta > 1 else 0
    head = rp.freq_max - FREEZE_AT * delta + off - rp.symbol_count
    w = np.random.default_rng(cfg[1]).integers(1, 100, rp.symbol_count).astype(np.float64)
    extra = np.floor(w / w.sum() * head).astype(np.int64)
    extra[0] += head - int(extra.sum())
    ic = prior_init_cum(extra, rp)
    assert ic[-1] + FREEZE_AT * delta == rp.freq_max + off
    return ic


def _blocks(case: str):
    """``(k, blocks)`` of each edge case."""
    rng = np.random.default_rng(len(case))
    text = b"the quick brown fox jumps over the lazy dog; " * 40
    if case == "top_symbol_after_freeze":
        k = 1200
        data = rng.integers(0, 256, k, dtype=np.uint8)
        data[FREEZE_AT + 10 :] = 255
        return k, [bytes(data), bytes(data[::-1])]
    if case == "word_boundary":  # found per row in _streams
        return 320, None
    if case == "zero_length":
        k = 384
        return k, [b"", text[:k], b"", b"x", b""]
    if case == "short_last":
        k = 512
        return k, [text[:k], bytes(rng.integers(0, 4, k, dtype=np.uint8)), text[7:80]]
    assert case == "k_not_16"
    k = 1000
    return k, [text[:k], bytes(rng.integers(0, 256, k - 5, dtype=np.uint8)), text[:13]]


def _streams(case, rp, ic, delta):
    k, blocks = _blocks(case)
    if blocks is None:  # the first prefixes of a text whose streams end on a word
        text = b"word boundary streams end exactly here; " * 8
        blocks = []
        for n in range(1, k):
            s = oracle.compress_block(text[:n], rp, ic, delta)
            if len(s) % 4 == 0:
                blocks.append(text[:n])
            if len(blocks) == 3:
                break
        assert len(blocks) == 3
    return k, blocks, [oracle.compress_block(b, rp, ic, delta) for b in blocks]


@pytest.mark.parametrize("case", ["top_symbol_after_freeze", "word_boundary", "zero_length",
                                  "short_last", "k_not_16"])
@pytest.mark.parametrize("prior", [False, True], ids=["uniform", "prior"])
@pytest.mark.parametrize("delta", [1, 16])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_warp_route_decodes_edge_streams(config, delta, prior, case):
    """One warp of the route decodes each block of the case from its row
    of words alone (no zero words past the longest stream: reads past the
    row give zero bits) to the plain decoder's row of ``k`` bytes and to
    the reference decoder's bytes."""
    cfg = CONFIGS[config]
    rp, p = RefParameters(*cfg), Parameters(*cfg)
    ic = _row(cfg, delta, prior)
    k, blocks, streams = _streams(case, rp, ic, delta)
    wn = max(1, max((len(s) + 3) // 4 for s in streams))
    byts = np.zeros((len(streams), wn * 4), np.uint8)
    for i, s in enumerate(streams):
        byts[i, : len(s)] = np.frombuffer(s, np.uint8)
    words = bytes_to_words(torch.from_numpy(byts))
    lens = torch.tensor([len(b) for b in blocks], dtype=torch.int32)
    ic32 = ic.astype(np.int32)
    plain = decode_blocks_plain(words, lens, torch.from_numpy(ic32), p, k, delta).numpy()
    for i, (b, s) in enumerate(zip(blocks, streams)):
        got = decode_warp(words[i].numpy(), len(b), ic32, p, k, delta)
        assert got.tobytes() == plain[i].tobytes(), f"block {i}"
        assert got[: len(b)].tobytes() == b == oracle.decompress_block(s, len(b), rp, ic, delta)
        assert not got[len(b) :].any()


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_narrow_quotient_is_exact(config):
    """``narrow`` gives floor(c * range / count) over the pairs the route
    reaches: count up to freq_max + 254 (the freeze's overshoot), c <=
    count, range up to 2**code_bits; random, at the ends of each range,
    and with c * range one below, at and one above a multiple of count."""
    p = Parameters(*CONFIGS[config])
    rng = np.random.default_rng(p.code_bits)
    n = 4000
    count = np.concatenate([rng.integers(257, p.freq_max + 255, n),
                            np.full(n // 4, p.freq_max + 254), rng.integers(257, 2000, n // 4)])
    range_ = np.concatenate([rng.integers(1, (1 << p.code_bits) + 1, count.size - 3),
                             [1 << p.code_bits, (1 << p.code_bits) - 1, 2]])
    cases = [(rng.random(count.size) * count).astype(np.int64), count, np.zeros_like(count)]
    q = rng.integers(0, 1 << 20, count.size)
    at = np.minimum(q * count // range_, count)  # c * range just below a multiple of count
    cases += [at, np.minimum(at + 1, count)]
    for c in cases:
        for ce, re, ne in zip(c.tolist(), range_.tolist(), count.tolist()):
            got = narrow([ce * re], [ce], ne, float(re) * (1.0 / ne))
            assert got == [ce * re // ne], (ce, re, ne)


def _fake_card(monkeypatch, sms: int = 132):
    """``decode_blocks`` on CPU tensors as if on a card of ``sms`` SMs: the
    library records its calls, ``route_blocks`` and the launch counter
    start empty."""
    seen = []

    class FakeLib:
        def rxt_decode_blocks(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(dec, "kernel_device", lambda dev: True)
    monkeypatch.setattr(dec, "warp_route_max", lambda dev: dec.WARP_BLOCKS_PER_SM * sms)
    monkeypatch.setattr(_build, "card_launches", type(_build.card_launches)())
    monkeypatch.setattr(_build, "route_blocks", type(_build.route_blocks)())
    monkeypatch.setattr(_build, "lib", lambda: FakeLib())
    monkeypatch.setattr(_build, "stream_of", lambda dev: 0)
    return seen


@pytest.mark.parametrize("sms", [132, 114])
def test_decode_blocks_routes_by_block_count(monkeypatch, sms):
    """The warp route up to WARP_BLOCKS_PER_SM blocks an SM, the thread
    route past it; ``_route`` forces either; each launch counts once under
    ``"decode"`` and its blocks under its route; an unknown route raises."""
    seen = _fake_card(monkeypatch, sms)
    p = Parameters.tpu_wide()
    ic = torch.from_numpy(uniform_init_cum(RefParameters(8, 20, 22)).astype(np.int32))
    thr = dec.WARP_BLOCKS_PER_SM * sms
    calls = [(1, None, 1), (thr, None, 1), (thr + 1, None, 0), (thr + 1, "warp", 1),
             (5, "thread", 0)]
    for b, route, warp in calls:
        words = torch.zeros(b, 4, dtype=torch.int32)
        dec.decode_blocks(words, torch.ones(b, dtype=torch.int32), ic, p, 8, 16, _route=route)
        assert seen[-1][4] == b and seen[-1][10] == warp, (b, route)
    assert _build.card_launches == {("decode", 0): len(calls)}
    assert _build.route_blocks == {("warp", "cpu"): 2 + 2 * thr, ("thread", "cpu"): thr + 6}
    with pytest.raises(ValueError):
        dec.decode_blocks(words, torch.ones(5, dtype=torch.int32), ic, p, 8, 16, _route="lane")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_renorm32_equals_the_u64_renorm(config):
    """``renorm32`` (the warp route's interval in 32 bits) against
    ``rxt::renorm`` in 64 bits: over random intervals, equal and adjacent
    bounds, and the empty interval after a zero-width quotient (high = low
    - 1, wrapping at low = 0), the same n1, n3 and bounds mod 2**32."""
    cb = CONFIGS[config][2]
    rng = np.random.default_rng(cb)
    cases = [(0, (1 << cb) - 1), (0, 0), (5, 5), (0, 1 << 64), (7, 6)]
    lows = rng.integers(0, 1 << cb, 3000).tolist()
    cases += [(lo, int(rng.integers(lo, 1 << cb))) for lo in lows]
    cases += [(lo, lo + 1) for lo in lows[:200] if lo + 1 < 1 << cb]
    for low, high in cases:
        high64 = (high - 1) % (1 << 64) if high == 1 << 64 else high  # (0, 2**64 - 1)
        want = renorm(low, high64, cb)
        got = renorm32(low, high64 & 0xFFFFFFFF, cb)
        assert got == want, (low, high)
