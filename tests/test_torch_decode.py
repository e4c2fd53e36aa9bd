"""K3 (decoder): the port's plain version against the reference's Pallas
decoder in interpret mode (``decode_blocks_pallas``) on the sequential
oracle's v2 streams.  Exact equality of the decoded symbols."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from redux_tpu import oracle
from redux_tpu.models.dense import prior_init_cum, uniform_init_cum
from redux_tpu.ops.pallas_decode import decode_blocks_pallas
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch.ops.coder import bytes_to_words
from redux_tpu_torch.ops.decode import decode_blocks
from redux_tpu_torch.params import Parameters


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
