"""K2 (coder): the port's plain version against the reference's Pallas
coder in interpret mode (``encode_blocks_pallas``), fed the same
``(lo, hi)``.  Exact equality of the stream bytes up to each block's byte
length, of the byte lengths and of the overflow flags.  Also the CUDA
kernel's algorithm, one thread emulated in Python (reciprocal quotients,
branch-free emission), and the choice of the kernel's instantiation."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from redux_tpu import oracle
from redux_tpu.models.dense import prior_init_cum, uniform_init_cum
from redux_tpu.ops.coder import max_block_words
from redux_tpu.ops.pallas_encode import encode_blocks_pallas
from redux_tpu.ops.pallas_encode import encode_blocks_ranked as ref_encode_ranked
from redux_tpu.ops.ranks import precompute_encode_model
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch.ops.coder import products_fit_53, tfreeze
from redux_tpu_torch.ops.encode import encode_blocks, encode_blocks_ranked
from redux_tpu_torch.params import Parameters
from torch_kernel_emulation import Coder, count_at


def _stream_bytes(words, byte_lens, n_words):
    """Per block: the stream bytes the buffer holds (capped at n_words)."""
    w = np.asarray(words).astype(np.uint32)
    return [w[i].astype(">u4").tobytes()[: min(int(n), 4 * n_words)]
            for i, n in enumerate(np.asarray(byte_lens))]


def _compare(lo, hi, lens, init_total, cfg, n_words, delta):
    rp, p = RefParameters(*cfg), Parameters(*cfg)
    w_r, bl_r, ov_r = encode_blocks_pallas(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(lens), jnp.int32(init_total), rp,
        n_words, delta,
    )
    w, bl, ov = encode_blocks(
        torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(lens), init_total, p,
        n_words, delta,
    )
    assert w.shape == (len(lens), n_words) and w.dtype == torch.int32
    np.testing.assert_array_equal(bl.numpy(), np.asarray(bl_r))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(ov_r))
    assert _stream_bytes(w.numpy().view(np.uint32), bl, n_words) == _stream_bytes(
        w_r, bl_r, n_words)
    return w, bl, ov


def _blocks_to_lohi(blocks, k, ic, cfg, delta):
    syms = np.zeros((len(blocks), k), np.int32)
    lens = np.zeros(len(blocks), np.int32)
    for i, d in enumerate(blocks):
        syms[i, : len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    lo, hi, _, _, _, _ = precompute_encode_model(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), RefParameters(*cfg).freq_max,
        delta=delta, with_tot=False,
    )
    return np.array(lo, np.int32), np.array(hi, np.int32), lens


def _mixed_blocks(seed, k):
    rng = np.random.default_rng(seed)
    return [
        bytes(rng.integers(0, 256, k, dtype=np.uint8)),
        bytes([65] * k),
        (b"the quick brown fox jumps over the lazy dog. " * 20)[:k],
        b"x",
        b"",
        bytes(rng.integers(0, 4, 97, dtype=np.uint8)),
    ]


@pytest.mark.parametrize("cfg,delta", [((8, 20, 22), 16), ((8, 15, 17), 1), ((8, 14, 16), 120)])
def test_coder_matches_pallas(cfg, delta):
    k = 300
    ic = uniform_init_cum(RefParameters(*cfg)).astype(np.int32)
    blocks = _mixed_blocks(cfg[1], k)
    lo, hi, lens = _blocks_to_lohi(blocks, k, ic, cfg, delta)
    n_words = max_block_words(RefParameters(*cfg).freq_max, 257, RefParameters(*cfg), k)
    w, bl, ov = _compare(lo, hi, lens, int(ic[-1]), cfg, n_words, delta)
    assert not ov.any()
    # and both are the sequential oracle's v2 payloads
    got = _stream_bytes(w.numpy().view(np.uint32), bl, n_words)
    for i, d in enumerate(blocks):
        assert got[i] == oracle.compress_block(d, RefParameters(*cfg), ic.astype(np.int64), delta)


def test_coder_output_past_capacity():
    """Streams longer than n_words: the buffer holds the first n_words
    words and byte_lens still counts every bit."""
    cfg, delta, k = (8, 20, 22), 16, 400
    ic = uniform_init_cum(RefParameters(*cfg)).astype(np.int32)
    rng = np.random.default_rng(9)
    blocks = [bytes(rng.integers(0, 256, k, dtype=np.uint8)) for _ in range(3)] + [b"ab" * 10]
    lo, hi, lens = _blocks_to_lohi(blocks, k, ic, cfg, delta)
    _, bl, _ = _compare(lo, hi, lens, int(ic[-1]), cfg, 16, delta)
    assert (bl.numpy()[:3] > 4 * 16).all() and bl.numpy()[3] < 4 * 16


def _e3_plane(k, counts, plan):
    """(lo, hi) rows that hold the interval at the middle half (one E3
    underflow step each) for ``mid`` positions, then one chosen step."""
    lo = np.zeros(k, np.int32)
    hi = np.zeros(k, np.int32)
    mid, last = plan
    for t in range(k):
        c = counts[t]
        if t < mid:
            lo[t], hi[t] = c // 4, 3 * c // 4
        elif last == "low":  # E1 run of 3 bits, lead 0
            lo[t], hi[t] = 0, c // 8
        elif last == "high":  # E1 run of 3 bits, lead 1
            lo[t], hi[t] = 7 * c // 8, c
        elif last == "half":  # E1 run of 1 bit: no rest bits
            lo[t], hi[t] = 0, c // 2
        else:
            lo[t], hi[t] = c // 4, 3 * c // 4
    return lo, hi


def test_coder_overflow_flag_long_e3_runs():
    """Long E3 (underflow) runs: pieces past 64 bits set ovf and are cut
    exactly as the reference cuts them; shorter runs stay exact."""
    cfg, delta, init_total, k = (8, 20, 22), 4, 256, 96
    counts = [init_total + delta * t for t in range(k)]  # multiples of 4: exact quarters
    plans = [(80, "term"), (70, "low"), (70, "high"), (64, "half"), (40, "low"),
             (62, "half"), (63, "half"), (61, "high"), (90, "high")]
    rows = [_e3_plane(k, counts, plan) for plan in plans]
    lo = np.stack([r[0] for r in rows])
    hi = np.stack([r[1] for r in rows])
    lens = np.array([80, 72, 72, 66, 41, 63, 64, 62, 95], np.int32)
    _, _, ov = _compare(lo, hi, lens, init_total, cfg, 8, delta)
    assert ov.numpy().tolist() == [True, True, True, True, False, False, False, False, True]


def test_ranked_encode_matches_reference():
    """K1 -> K2 composition against the reference's ranked encode, with a
    warm-start prior and partial blocks."""
    cfg, delta, k = (8, 20, 22), 16, 256
    rp, p = RefParameters(*cfg), Parameters(*cfg)
    rng = np.random.default_rng(4)
    extra = np.zeros(257, np.int64)
    extra[:256] = rng.integers(0, 200, 256)
    ic = prior_init_cum(extra, rp).astype(np.int32)
    syms = rng.integers(0, 256, (5, k)).astype(np.uint8)
    syms[2] = np.frombuffer((b"ranked encode " * 30)[:k], np.uint8)
    lens = np.array([k, 200, k, 0, 1], np.int32)
    n_words = k // 4 + 16
    w_r, bl_r, ov_r = ref_encode_ranked(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), rp, n_words, delta)
    w, bl, ov = encode_blocks_ranked(
        torch.from_numpy(syms), torch.from_numpy(lens), torch.from_numpy(ic), p, n_words, delta)
    np.testing.assert_array_equal(bl.numpy(), np.asarray(bl_r))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(ov_r))
    assert _stream_bytes(w.numpy().view(np.uint32), bl, n_words) == _stream_bytes(
        w_r, bl_r, n_words)


def test_coder_wrapper_checks():
    p = Parameters.tpu_wide()
    lo = torch.zeros(2, 4, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        encode_blocks(lo, lo[:, :3], lens, 257, p, 4, 16)
    with pytest.raises(ValueError):
        encode_blocks(lo, lo, lens.to(torch.int64), 257, p, 4, 16)
    with pytest.raises(ValueError):
        encode_blocks(lo, lo, lens, 257, Parameters(8, 20, 44), 4, 16)
    w, bl, ov = encode_blocks(lo, lo, torch.tensor([0, -1], dtype=torch.int32), 257, p, 4, 16)
    assert bl.tolist() == [1, 0] and not ov.any() and w[1].tolist() == [0] * 4


def _encode_block_emulated(lo, hi, n, init_total, params, n_words, delta):
    """Python emulation of one thread of ``csrc/encode.cu`` (the reciprocal
    instantiation): per position t < n the step over the total
    ``rxt::Count`` gives for t, then the terminator (none for n < 0).
    Returns ``(words, byte_len, ovf)`` as the kernel stores them."""
    tf = tfreeze(init_total, params, delta)
    coder = Coder(n_words, params.code_bits)
    for t in range(n):
        coder.step(int(lo[t]), int(hi[t]), count_at(t, init_total, delta, tf))
    if n >= 0:
        coder.terminate()
    return coder.finish()


def _emulated_triple(lo, hi, lens, init_total, params, n_words, delta):
    rows = [_encode_block_emulated(lo[i], hi[i], int(n), init_total, params, n_words, delta)
            for i, n in enumerate(lens)]
    words = np.array([r[0] for r in rows], np.uint32).reshape(len(rows), n_words)
    return words, np.array([r[1] for r in rows]), np.array([r[2] for r in rows])


@pytest.mark.parametrize("cfg,delta", [((8, 20, 22), 16), ((8, 14, 16), 64)])
def test_kernel_algorithm_codes_reference_streams(cfg, delta):
    """The emulated kernel thread codes the sequential oracle's streams byte
    for byte, with the freeze engaged at (8,14,16), and gives the plain
    version's triple."""
    rp, p = RefParameters(*cfg), Parameters(*cfg)
    k = 600
    ic = uniform_init_cum(rp).astype(np.int32)
    if cfg == (8, 14, 16):
        assert 0 < tfreeze(int(ic[-1]), p, delta) < k  # the freeze lands mid-block
    blocks = _mixed_blocks(17, k)
    lo, hi, lens = _blocks_to_lohi(blocks, k, ic, cfg, delta)
    n_words = max_block_words(rp.freq_max, 257, rp, k)
    words, bl, ov = _emulated_triple(lo, hi, lens, int(ic[-1]), p, n_words, delta)
    got = _stream_bytes(words, bl, n_words)
    for i, d in enumerate(blocks):
        assert got[i] == oracle.compress_block(d, rp, ic.astype(np.int64), delta), f"block {i}"
    w_p, bl_p, ov_p = encode_blocks(torch.from_numpy(lo), torch.from_numpy(hi),
                                    torch.from_numpy(lens), int(ic[-1]), p, n_words, delta)
    np.testing.assert_array_equal(bl, bl_p.numpy())
    np.testing.assert_array_equal(ov, ov_p.numpy())
    np.testing.assert_array_equal(words, w_p.numpy().view(np.uint32))


def test_kernel_algorithm_long_e3_runs():
    """The emulated kernel thread on the crafted long E3 runs: pieces past
    64 bits set ovf and are cut as the plain version cuts them, a pad lane
    (lens -1) writes nothing, and words past the capacity are dropped."""
    cfg, delta, init_total, k = (8, 20, 22), 4, 256, 96
    p = Parameters(*cfg)
    counts = [init_total + delta * t for t in range(k)]
    plans = [(80, "term"), (70, "low"), (70, "high"), (64, "half"), (62, "half"), (90, "high")]
    rows = [_e3_plane(k, counts, plan) for plan in plans] * 2
    lo = np.stack([r[0] for r in rows])
    hi = np.stack([r[1] for r in rows])
    lens = np.array([80, 72, 72, 66, 63, 95, 0, -1, 1, 5, 96, 40], np.int32)
    words, bl, ov = _emulated_triple(lo, hi, lens, init_total, p, 8, delta)
    w_p, bl_p, ov_p = encode_blocks(torch.from_numpy(lo), torch.from_numpy(hi),
                                    torch.from_numpy(lens), init_total, p, 8, delta)
    np.testing.assert_array_equal(bl, bl_p.numpy())
    np.testing.assert_array_equal(ov, ov_p.numpy())
    np.testing.assert_array_equal(words, w_p.numpy().view(np.uint32))
    assert ov[:6].tolist() == [True, True, True, True, False, True] and bl[7] == 0


def test_encode_blocks_passes_products_fit_53(monkeypatch):
    """encode_blocks launches the reciprocal instantiation (flag 1) at
    tpu_wide and tpu32 and the u64 one (flag 0) at the reference CLI's
    (8,30,32); the flag is what products_fit_53 says."""
    import redux_tpu_torch
    from redux_tpu_torch import _build
    from redux_tpu_torch.ops import encode as enc

    seen = []

    class FakeLib:
        def rxt_encode_blocks(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(enc, "kernel_device", lambda dev: True)
    monkeypatch.setattr(_build, "card_launches", type(_build.card_launches)())
    monkeypatch.setattr(_build, "lib", lambda: FakeLib())
    monkeypatch.setattr(_build, "stream_of", lambda dev: 0)
    lo = torch.zeros(2, 8, dtype=torch.int32)
    lens = torch.full((2,), 8, dtype=torch.int32)
    for params, fits in ((Parameters.tpu_wide(), 1), (Parameters.tpu32(), 1),
                         (Parameters.default(), 0)):
        assert products_fit_53(params) == bool(fits)
        encode_blocks(lo, lo, lens, 257, params, 4, 16)
        assert seen[-1][13] == fits, params
    assert redux_tpu_torch.launch_counts()["encode"] == 3


def test_symbol_encoder_params_fit_53():
    """K4 and K5 have only the reciprocal instantiation: every valid
    parameter set they take (fits_u32 or fits_wide32) keeps the coder's
    dividends below 2**53."""
    taken = [Parameters(8, f, c) for f in range(10, 31) for c in range(f + 2, 33)
             if c + f <= 64 and (Parameters(8, f, c).fits_u32 or Parameters(8, f, c).fits_wide32)]
    assert len(taken) > 20 and all(products_fit_53(p) for p in taken)
