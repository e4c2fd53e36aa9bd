"""K4 (fused model + coder): the port's plain version against the
reference's fused Pallas kernel in interpret mode
(``_encode_fused_model_jit``), driven as ``tests/test_pallas_encode.py``
drives it: the init column, the (init_total, tfreeze) constants and pad
lanes with ``lens = -1``.  Exact equality (tolerance 0) of the byte
lengths, the overflow flags and the stream bytes up to each byte length.
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
from redux_tpu_torch.testdata import incompressible, text_like


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
