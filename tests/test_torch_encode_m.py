"""K5 (model-in-kernel encoder): the port's plain version and an
emulation of one thread of the CUDA kernel against the reference's
``encode_blocks_pallas_m`` in interpret mode, and the plain version
against the port's own ranked encode (K1 -> K2).  Exact equality
(tolerance 0) of the byte lengths, the overflow flags and the stream bytes
up to each byte length.  Also the kernel's closed-form Fenwick reads and
unrolled update walk against the dense row and the loop walk."""

import functools

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
from torch_kernel_emulation import (NODES, encode_m_thread, fenwick_add, fenwick_prefix,
                                    fenwick_tree, load_walk, store_walk)

CASES = ["wide_mixed", "prior_and_freeze_8_14_16", "tpu32_freeze", "edges_220_prior",
         "tails_256_freeze"]


def _stream_bytes(words, byte_lens, n_words):
    w = np.asarray(words).astype(np.uint32)
    return [w[i].astype(">u4").tobytes()[: min(int(n), 4 * n_words)]
            for i, n in enumerate(np.asarray(byte_lens))]


def _case(name):
    """(cfg, delta, k, blocks, prior): ``test_pallas_encode.py:119-141``,
    tpu32 with the freeze engaged, and the kernel's edges: a pad lane
    (None: lens -1), an empty and a 1-byte block, K not a multiple of 16
    (K5's byte loads), and lengths around its groups of 16 with the freeze
    inside a block."""
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
    if name == "edges_220_prior":
        rng = np.random.default_rng(7)
        k = 220
        return (8, 20, 22), 16, k, [
            bytes(rng.integers(0, 256, k, dtype=np.uint8)),
            None,
            b"",
            b"x",
            (b"edges of the model-in-kernel encoder " * 6)[: k - 1],
            bytes(rng.integers(0, 256, 17, dtype=np.uint8)),
        ], True
    if name == "tails_256_freeze":
        rng = np.random.default_rng(8)
        k = 256
        text = (b"groups of sixteen, then the tail " * 8)[:k]
        return (8, 15, 17), 255, k, [
            bytes(rng.integers(0, 256, k, dtype=np.uint8)),
            text[:255],
            text[:33],
            bytes(rng.integers(0, 256, 16, dtype=np.uint8)),
            text[:15],
            None,
            bytes([255] * k),
        ], False
    raise KeyError(name)


def _init_row(rp, prior):
    if not prior:
        return uniform_init_cum(rp).astype(np.int32)
    full = np.zeros(rp.symbol_count, dtype=np.int64)
    full[:256] = 3
    return prior_init_cum(full, rp).astype(np.int32)


@functools.cache
def _reference(name):
    """The case's inputs and the reference kernel's triple (interpret mode)."""
    cfg, delta, k, blocks, prior = _case(name)
    rp = RefParameters(*cfg)
    ic = _init_row(rp, prior)
    if name.endswith("freeze"):
        assert int(ic[-1]) + delta * k > rp.freq_max  # the freeze engages mid-block
    syms = np.zeros((len(blocks), k), np.uint8)
    lens = np.array([-1 if d is None else len(d) for d in blocks], np.int32)
    for i, d in enumerate(blocks):
        if d is not None:
            syms[i, : len(d)] = np.frombuffer(d, np.uint8)
    n_words = max_block_words(min(int(ic[-1]) + delta * k, rp.freq_max), rp.symbol_count, rp, k)
    w_r, bl_r, ov_r = encode_blocks_pallas_m(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), rp, n_words, delta)
    return (Parameters(*cfg), delta, syms, lens, ic, n_words,
            (np.asarray(w_r), np.asarray(bl_r), np.asarray(ov_r)))


@pytest.mark.parametrize("name", CASES)
def test_model_in_kernel_matches_reference(name):
    p, delta, syms, lens, ic, n_words, (w_r, bl_r, ov_r) = _reference(name)
    args = (torch.from_numpy(syms), torch.from_numpy(lens), torch.from_numpy(ic), p, n_words,
            delta)
    w, bl, ov = encode_blocks_m(*args)
    assert w.shape == (len(lens), n_words) and w.dtype == torch.int32
    np.testing.assert_array_equal(bl.numpy(), np.asarray(bl_r))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(ov_r))
    assert _stream_bytes(w.numpy().view(np.uint32), bl, n_words) == _stream_bytes(
        w_r, bl_r, n_words)
    # the port's ranked encode (K1 -> K2) derives the same triple
    r = encode_blocks_ranked(*args)
    assert all(torch.equal(a, b) for a, b in zip(r, (w, bl, ov)))


@pytest.mark.parametrize("name", CASES)
def test_kernel_thread_codes_reference_streams(name):
    """The emulated block of ``csrc/encode_m.cu`` (a model lane: symbols 16
    a load, a round ahead, closed-form reads, the update as node + d; a
    coder lane: the tile's bounds, runs of 8, the coder step) gives the
    reference kernel's triple, and every word of the plain version's."""
    p, delta, syms, lens, ic, n_words, (w_r, bl_r, ov_r) = _reference(name)
    n_rounds = (int(lens.max()) + 15) // 16  # the CTA's longest block (one CTA of <= 128)
    rows = [encode_m_thread(syms[i], int(n), ic, p, n_words, delta, n_rounds)
            for i, n in enumerate(lens)]
    words = np.array([r[0] for r in rows], np.uint32).reshape(len(rows), n_words)
    bl = np.array([r[1] for r in rows], np.int32)
    ov = np.array([r[2] for r in rows], bool)
    np.testing.assert_array_equal(bl, bl_r)
    np.testing.assert_array_equal(ov, ov_r)
    assert _stream_bytes(words, bl, n_words) == _stream_bytes(w_r, bl_r, n_words)
    w_p, _, _ = encode_blocks_m(torch.from_numpy(syms), torch.from_numpy(lens),
                                torch.from_numpy(ic), p, n_words, delta)
    np.testing.assert_array_equal(words, w_p.numpy().view(np.uint32))


@pytest.mark.parametrize("cfg,delta", [((8, 20, 22), 16), ((8, 15, 17), 255), ((8, 14, 16), 64)])
def test_closed_form_reads_equal_the_dense_row(cfg, delta):
    """Over random rows with zero-width symbols (some neighbouring, and
    symbol 255), adapted until the total overshoots freq_max: for every
    byte v, cdf[0] + prefix(v) from v's set bits is cdf[v] and adding
    node(v + 1) less the trailing-ones terms gives cdf[v + 1]; the walk in
    closed form stored with d equals the loop walk for d = delta and leaves
    the tree as it was for d = 0."""
    p = Parameters(*cfg)
    rng = np.random.default_rng(cfg[1] * 7 + delta)
    target = p.freq_max - 60 * delta  # about 60 updates to the freeze
    freq = rng.integers(0, target // 257, 257)
    freq[rng.integers(0, 257, 60)] = 0
    freq[100:104] = 0
    freq[254:] = [3, 0, 1]
    freq[50] += target - freq.sum()
    cdf = np.concatenate([[5], 5 + np.cumsum(freq)]).astype(np.int64)  # cdf[0] = 5
    node = fenwick_tree(cdf)

    def check():
        for v in range(256):
            pre, low = fenwick_prefix(node, v)
            up = load_walk(node, v)
            assert cdf[0] + pre == cdf[v], v
            assert cdf[0] + pre + up[1][0] - low == cdf[v + 1], v
            for d in (delta, 0):
                mine, loop = list(node), list(node)
                store_walk(mine, up, d)
                fenwick_add(loop, v, d)
                assert mine == loop, (v, d)

    updates = 0
    while cdf[-1] < p.freq_max:  # the kernel's update rule, dense and as a tree
        if updates % 10 == 0:
            check()
        v = int(rng.choice([0, 7, 101, 254, 255, *rng.integers(0, 256, 3).tolist()]))
        cdf[v + 1 :] += delta
        store_walk(node, load_walk(node, v), delta)
        updates += 1
    assert updates > 50 and cdf[-1] > p.freq_max  # the freeze overshoot
    check()
    assert node == fenwick_tree(cdf) and len(node) == NODES + 1


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
