"""K4 (fused model + coder): the port's plain version against the
reference's fused Pallas kernel in interpret mode
(``_encode_fused_model_jit``), driven as ``tests/test_pallas_encode.py``
drives it: the init column, the (init_total, tfreeze) constants and pad
lanes with ``lens = -1``.  Exact equality (tolerance 0) of the byte
lengths, the overflow flags and the stream bytes up to each byte length.
Also the CUDA kernel's schedule, emulated in numpy: groups of 32 blocks,
K1's chunk step filling a tile, and one coder a block reading it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redux_tpu import api as ref_api
from redux_tpu.models.dense import prior_init_cum, uniform_init_cum
from redux_tpu.ops.pallas_encode import EPOCH, LANES, SLAB, _build_init_col, _encode_fused_model_jit
from redux_tpu.params import Parameters as RefParameters

import redux_tpu_torch.ops.encode as enc
from redux_tpu_torch import api
from redux_tpu_torch.ops.encode import encode_blocks_fused, encode_blocks_ranked
from redux_tpu_torch.params import Parameters
from redux_tpu_torch.ops.coder import tfreeze
from redux_tpu_torch.testdata import incompressible, text_like
from torch_kernel_emulation import SLOTS, Coder, count_at, model_chunk


def _stream_bytes(words, byte_lens, n_words):
    w = np.asarray(words).astype(np.uint32)
    return [w[i].astype(">u4").tobytes()[: min(int(n), 4 * n_words)]
            for i, n in enumerate(np.asarray(byte_lens))]


def _blocks(k, seed):
    rng = np.random.default_rng(seed)
    return [
        bytes(rng.integers(0, 256, k, dtype=np.uint8)),
        bytes([7] * k),    # every hi read crosses a bucket boundary of the TPU's sweep
        bytes([255] * k),  # the top bucket
        (b"fused model+coder " * 40)[:k],
        b"z",              # a 1-byte block
        b"",               # terminator only
        bytes(rng.integers(0, 4, k // 3, dtype=np.uint8)),
    ]


def _init_row(params, prior):
    if not prior:
        return uniform_init_cum(params).astype(np.int32)
    full = np.zeros(params.symbol_count, np.int64)
    full[:256] = np.random.default_rng(11).integers(0, 300, 256)
    return prior_init_cum(full, params).astype(np.int32)


def _ref_fused(syms, lens, ic, rp, n_words, delta):
    b, k = syms.shape
    b_pad = ((b + LANES - 1) // LANES) * LANES
    k_pad = ((k + 1 + EPOCH - 1) // EPOCH) * EPOCH
    with jax.enable_x64(False):
        syms_t = jnp.pad(jnp.asarray(syms, jnp.int32), ((0, b_pad - b), (0, k_pad - k))).T
        lens_p = jnp.pad(jnp.asarray(lens), (0, b_pad - b), constant_values=-1).reshape(1, b_pad)
        it0 = jnp.asarray(ic, jnp.int32)[-1]
        tf = jnp.maximum((jnp.int32(rp.freq_max) - it0 + (delta - 1)) // jnp.int32(delta), 0)
        consts = jnp.stack([it0, tf]).reshape(1, 2)
        words_t, blen, ovf = _encode_fused_model_jit(
            syms_t, lens_p, _build_init_col(ic, rp), consts, rp, n_words, delta)
    return np.asarray(words_t).T[:b], np.asarray(blen)[0, :b], np.asarray(ovf)[0, :b].astype(bool)


CASES = {
    "tpu_wide_delta16_prior": ((8, 20, 22), 16, True, 256),
    "freeze_overshoot_8_14_16_delta120": ((8, 14, 16), 120, False, 220),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_matches_reference_kernel(name):
    cfg, delta, prior, k = CASES[name]
    rp, p = RefParameters(*cfg), Parameters(*cfg)
    ic = _init_row(rp, prior)
    blocks = _blocks(k, cfg[1])
    syms = np.zeros((len(blocks), k), np.uint8)
    lens = np.array([len(d) for d in blocks], np.int32)
    for i, d in enumerate(blocks):
        syms[i, : len(d)] = np.frombuffer(d, np.uint8)
    if name.startswith("freeze"):
        assert int(ic[-1]) + delta * k > rp.freq_max  # the freeze engages mid-block
    n_words = ((k // 2 + SLAB - 1) // SLAB) * SLAB
    w_r, bl_r, ov_r = _ref_fused(syms, lens, ic, rp, n_words, delta)
    w, bl, ov = encode_blocks_fused(torch.from_numpy(syms), torch.from_numpy(lens),
                                    torch.from_numpy(ic), p, n_words, delta)
    np.testing.assert_array_equal(bl.numpy(), bl_r)
    np.testing.assert_array_equal(ov.numpy(), ov_r)
    assert _stream_bytes(w.numpy().view(np.uint32), bl, n_words) == _stream_bytes(
        w_r, bl_r, n_words)
    # and the two-kernel route gives the same triple
    r = encode_blocks_ranked(torch.from_numpy(syms), torch.from_numpy(lens),
                             torch.from_numpy(ic), p, n_words, delta)
    assert all(torch.equal(a, b) for a, b in zip(r, (w, bl, ov)))


def _fail(*_args, **_kw):
    raise AssertionError("K1/K2 ran under REDUX_TPU_ENC_FUSED=1")


def test_ranked_under_fused_variable(monkeypatch):
    """Under REDUX_TPU_ENC_FUSED=1 the ranked encode runs K4 alone and
    returns the triple of K1 -> K2; at (8,30,32), which K4 does not take,
    it runs K1 -> K2 as the reference does; "0" keeps K1 -> K2."""
    p = Parameters.tpu_wide()
    data = text_like(3000, 3) + incompressible(1000, 3)
    k = 512
    syms = np.zeros((8, k), np.uint8)
    syms.reshape(-1)[: len(data)] = np.frombuffer(data, np.uint8)
    lens = np.array([k] * 7 + [len(data) - 7 * k], np.int32)
    ic = torch.from_numpy(_init_row(RefParameters.tpu_wide(), True))
    args = (torch.from_numpy(syms), torch.from_numpy(lens), ic, p, 160, 16)
    monkeypatch.setenv("REDUX_TPU_ENC_FUSED", "0")
    two = encode_blocks_ranked(*args)
    monkeypatch.setenv("REDUX_TPU_ENC_FUSED", "1")
    with monkeypatch.context() as m:
        m.setattr(enc, "model_lohi", _fail)
        m.setattr(enc, "encode_blocks", _fail)
        fused = encode_blocks_ranked(*args)
    assert all(torch.equal(a, b) for a, b in zip(two, fused))
    assert not enc.fused_selected(Parameters.default()) and enc.fused_selected(p)
    cli = Parameters.default()
    ic_cli = torch.from_numpy(uniform_init_cum(RefParameters.default()).astype(np.int32))
    with pytest.raises(ValueError):
        encode_blocks_fused(args[0], args[1], ic_cli, cli, 160, 16)
    w, bl, _ = encode_blocks_ranked(args[0], args[1], ic_cli, cli, 160, 7)
    assert (bl > 0).all() and w.shape == (8, 160)


def test_api_encode_under_fused_variable(monkeypatch):
    """``api.encode`` with the fused encoder selected emits the reference's
    archive bytes, and both packages decode it."""
    data = text_like(9000, 4) + incompressible(1500, 4) + b"\x07" * 700 + b"\xff" * 500
    ref = ref_api.encode(data, block_size=1024)
    monkeypatch.setenv("REDUX_TPU_ENC_FUSED", "1")
    monkeypatch.setattr(enc, "model_lohi", _fail)
    mine = api.encode(data, block_size=1024, device="cpu")
    assert mine == ref
    assert ref_api.decode(mine) == data
    assert api.decode(mine, device="cpu") == data


def _encode_fused_emulated(syms, lens, ic, params, n_words, delta):
    """numpy/Python emulation of ``csrc/encode_fused.cu``: a CTA a group of
    32 blocks (lanes past B have lens -1); per chunk of 32 positions the
    model warps run ``rxt::model_chunk`` on every block that has a
    position in the chunk and write its lo/hi into a tile of 32 positions
    x 33; then lane j of the coder warp codes block j's positions t < lens
    from the tile, over the total of position t.  Returns the triple."""
    b, k = syms.shape
    init_total = int(ic[-1])
    tf = tfreeze(init_total, params, delta)
    out = []
    for g0 in range(0, b, 32):
        glens = [min(int(lens[g0 + j]), k) if g0 + j < b else -1 for j in range(32)]
        rows = np.zeros((32, SLOTS), np.int64)
        rows[:, : len(ic)] = ic
        coders = [Coder(n_words, params.code_bits) for _ in range(32)]
        for c in range((max(glens) + 31) // 32):
            t0 = c * 32
            tile = np.zeros((2, 32, 33), np.int64)  # lo, hi; [position, block]
            for j, n in enumerate(glens):
                if t0 >= n:
                    continue
                v = np.zeros(32, np.int64)
                m = min(n - t0, 32)
                v[:m] = syms[g0 + j, t0 : t0 + m]
                n_act = min(max(min(n, tf) - t0, 0), 32)
                tile[0, :, j], tile[1, :, j] = model_chunk(rows[j], v, n_act, delta)
            for pos in range(32):
                count = count_at(t0 + pos, init_total, delta, tf)
                for j, n in enumerate(glens):
                    if t0 + pos < n:
                        coders[j].step(int(tile[0, pos, j]), int(tile[1, pos, j]), count)
        for j, n in enumerate(glens[: b - g0]):
            if n >= 0:
                coders[j].terminate()
            out.append(coders[j].finish())
    words = np.array([r[0] for r in out], np.uint32).reshape(b, n_words)
    return words, np.array([r[1] for r in out]), np.array([r[2] for r in out])


FUSED_SCHEDULE_CASES = {
    "tpu_wide_delta16_prior_b37": ((8, 20, 22), 16, True),
    "freeze_in_chunk_8_14_16_delta120_b37": ((8, 14, 16), 120, False),
}


@pytest.mark.parametrize("name", sorted(FUSED_SCHEDULE_CASES))
def test_fused_schedule_matches_reference_kernel(name):
    """The emulated schedule against the reference's fused kernel in
    interpret mode and the plain version: B = 37 (a partial second group),
    K = 220 (not a multiple of 32), pad lanes, empty and 1-byte blocks, and
    at (8,14,16) delta 120 the freeze inside a chunk."""
    cfg, delta, prior = FUSED_SCHEDULE_CASES[name]
    rp, p = RefParameters(*cfg), Parameters(*cfg)
    k, b = 220, 37
    ic = _init_row(rp, prior)
    blocks = (_blocks(k, cfg[1] + 5) * 6)[:b]
    syms = np.zeros((b, k), np.uint8)
    lens = np.array([len(d) for d in blocks], np.int32)
    for i, d in enumerate(blocks):
        syms[i, : len(d)] = np.frombuffer(d, np.uint8)
    lens[[9, 33]] = -1  # pad lanes, one in each group
    syms[9] = 3
    tf = tfreeze(int(ic[-1]), p, delta)
    if not prior:
        assert 0 < tf < k and tf % 32 != 0  # the freeze lands inside a chunk
    n_words = ((k // 2 + SLAB - 1) // SLAB) * SLAB
    words, bl, ov = _encode_fused_emulated(syms, lens, ic, p, n_words, delta)
    w_r, bl_r, ov_r = _ref_fused(syms, lens, ic, rp, n_words, delta)
    np.testing.assert_array_equal(bl, bl_r)
    np.testing.assert_array_equal(ov, ov_r)
    assert _stream_bytes(words, bl, n_words) == _stream_bytes(w_r, bl_r, n_words)
    w_p, bl_p, ov_p = encode_blocks_fused(torch.from_numpy(syms), torch.from_numpy(lens),
                                          torch.from_numpy(ic), p, n_words, delta)
    np.testing.assert_array_equal(bl, bl_p.numpy())
    np.testing.assert_array_equal(ov, ov_p.numpy())
    np.testing.assert_array_equal(words, w_p.numpy().view(np.uint32))
    assert bl[9] == bl[33] == 0 and (lens == 0).any() and (lens == 1).any()
