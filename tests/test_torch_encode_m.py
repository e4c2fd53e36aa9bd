"""K5 (model-in-kernel encoder): the port's plain version against the
reference's ``encode_blocks_pallas_m`` in interpret mode, and against the
port's own ranked encode (K1 -> K2).  Exact equality (tolerance 0) of the
byte lengths, the overflow flags and the stream bytes up to each byte
length."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redux_tpu.models.dense import prior_init_cum, uniform_init_cum
from redux_tpu.ops.coder import max_block_words
from redux_tpu.ops.pallas_encode import encode_blocks_pallas_m
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch.ops.encode import encode_blocks_fused, encode_blocks_ranked
from redux_tpu_torch.ops.encode_m import encode_blocks_m
from redux_tpu_torch.params import Parameters


def _stream_bytes(words, byte_lens, n_words):
    w = np.asarray(words).astype(np.uint32)
    return [w[i].astype(">u4").tobytes()[: min(int(n), 4 * n_words)]
            for i, n in enumerate(np.asarray(byte_lens))]


def _case(name):
    """(cfg, delta, k, blocks, prior): ``test_pallas_encode.py:119-141``
    and tpu32 with the freeze engaged."""
    if name == "wide_mixed":
        rng = np.random.default_rng(4)
        k = 300
        return (8, 20, 22), 16, k, [
            bytes(rng.integers(0, 256, k, dtype=np.uint8)),
            bytes([65] * k),
            (b"the quick brown fox jumps over the lazy dog. " * 10)[:k],
            b"x",
            bytes(rng.integers(0, 256, 97, dtype=np.uint8)),
        ], False
    if name == "prior_and_freeze_8_14_16":
        rng = np.random.default_rng(5)
        k = 600
        return (8, 14, 16), 4, k, [bytes(rng.integers(0, 8, k, dtype=np.uint8)),
                                   (b"abcabcabd" * 80)[:k]], True
    if name == "tpu32_freeze":
        rng = np.random.default_rng(6)
        k = 640
        return (8, 15, 17), 64, k, [
            bytes(rng.integers(0, 256, k, dtype=np.uint8)),
            (b"tpu32 freezes here " * 40)[:k],
            bytes([255] * k),
            b"",
        ], False
    raise KeyError(name)


def _init_row(rp, prior):
    if not prior:
        return uniform_init_cum(rp).astype(np.int32)
    full = np.zeros(rp.symbol_count, dtype=np.int64)
    full[:256] = 3
    return prior_init_cum(full, rp).astype(np.int32)


@pytest.mark.parametrize("name", ["wide_mixed", "prior_and_freeze_8_14_16", "tpu32_freeze"])
def test_model_in_kernel_matches_reference(name):
    cfg, delta, k, blocks, prior = _case(name)
    rp, p = RefParameters(*cfg), Parameters(*cfg)
    ic = _init_row(rp, prior)
    if name.endswith("freeze"):
        assert int(ic[-1]) + delta * k > rp.freq_max  # the freeze engages mid-block
    syms = np.zeros((len(blocks), k), np.uint8)
    lens = np.array([len(d) for d in blocks], np.int32)
    for i, d in enumerate(blocks):
        syms[i, : len(d)] = np.frombuffer(d, np.uint8)
    n_words = max_block_words(min(int(ic[-1]) + delta * k, rp.freq_max), rp.symbol_count, rp, k)
    w_r, bl_r, ov_r = encode_blocks_pallas_m(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), rp, n_words, delta)
    args = (torch.from_numpy(syms), torch.from_numpy(lens), torch.from_numpy(ic), p, n_words,
            delta)
    w, bl, ov = encode_blocks_m(*args)
    assert w.shape == (len(blocks), n_words) and w.dtype == torch.int32
    np.testing.assert_array_equal(bl.numpy(), np.asarray(bl_r))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(ov_r))
    assert _stream_bytes(w.numpy().view(np.uint32), bl, n_words) == _stream_bytes(
        w_r, bl_r, n_words)
    # the port's ranked encode (K1 -> K2) derives the same triple
    r = encode_blocks_ranked(*args)
    assert all(torch.equal(a, b) for a, b in zip(r, (w, bl, ov)))


def test_wrappers_reject_what_the_reference_rejects():
    """(8,30,32) is off the reference kernels' path: its encoders raise
    ValueError, and so do K4's and K5's wrappers; so do bad arguments."""
    rp, p = RefParameters.default(), Parameters.default()
    ic = uniform_init_cum(rp).astype(np.int32)
    syms = np.zeros((2, 16), np.uint8)
    lens = np.array([16, 3], np.int32)
    with pytest.raises(ValueError):
        encode_blocks_pallas_m(jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), rp, 16, 7)
    args = (torch.from_numpy(syms), torch.from_numpy(lens), torch.from_numpy(ic))
    for fn in (encode_blocks_m, encode_blocks_fused):
        with pytest.raises(ValueError):
            fn(*args, p, 16, 7)
        wide = Parameters.tpu_wide()
        with pytest.raises(ValueError):  # lens of the wrong type
            fn(args[0], args[1].to(torch.int64), args[2], wide, 16, 7)
        with pytest.raises(ValueError):  # delta outside 1..255
            fn(*args, wide, 16, 0)
        with pytest.raises(ValueError):  # symbols as int32
            fn(args[0].to(torch.int32), *args[1:], wide, 16, 7)
