"""Generic (user-defined) models on the port's device path, against the
reference's ``ops.generic``, ``ops.ranks.precompute_encode_model``,
``ops.coder.encode_blocks`` and ``ops.bitpack`` and against the oracle
(the port of ``tests/test_generic_model.py``, on generated blocks).

1. the dense ``TorchModel`` gives the streams of K1's values through the
   reference-format coder, and the reference's streams on the same numpy
   inputs; ``precompute_encode_model`` equals the reference's in all six
   outputs;
2. the generic decoder and K3 (its plain version) both decode them;
3. a static model and a two-speed model match their host twins through
   the oracle, and the generic decoder decodes the oracle's streams.

Tolerance 0 throughout: the bar is byte equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redux_tpu.ops import bitpack as ref_bitpack
from redux_tpu.ops import coder as ref_coder
from redux_tpu.ops import generic as ref_generic
from redux_tpu.ops.ranks import precompute_encode_model as ref_precompute
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch import cuda_checks, oracle, testdata
from redux_tpu_torch.models.dense import prior_init_cum, uniform_init_cum
from redux_tpu_torch.ops import bitpack, coder
from redux_tpu_torch.ops.decode import decode_blocks
from redux_tpu_torch.ops.generic import (decode_blocks_generic, dense_torch_model,
                                         encode_blocks_generic, make_generic_coders,
                                         model_values_generic, static_torch_model)
from redux_tpu_torch.ops.model import precompute_encode_model
from redux_tpu_torch.params import Parameters

GENERIC_CONFIGS = [(8, 14, 16), (8, 30, 32)]  # the reference's u32 and int64 paths


def _blocks():
    return [
        testdata.text_like(400, 11),
        b"",
        b"\x00" * 300,
        bytes(range(256)),
        testdata.incompressible(350, 11),
        b"abracadabra" * 30,
    ]


def _stage(blocks):
    b = len(blocks)
    k = max(max(len(d) for d in blocks), 1)
    syms = np.zeros((b, k), dtype=np.int32)
    lens = np.array([len(d) for d in blocks], dtype=np.int32)
    for i, d in enumerate(blocks):
        syms[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
    return syms, lens, k


def _words_u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def _decoded_blocks(out, lens):
    return [bytes(np.asarray(out)[i, :n].astype(np.uint8)) for i, n in enumerate(lens)]


@pytest.mark.parametrize("cfg", GENERIC_CONFIGS, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("delta", [1, 16])
def test_dense_generic_matches_specialized_and_reference(cfg, delta):
    blocks = _blocks()
    syms, lens, k = _stage(blocks)
    p, rp = Parameters(*cfg), RefParameters(*cfg)
    ic = uniform_init_cum(p).astype(np.int32)
    w = coder.max_block_words(min(257 + delta * k, p.freq_max), p.symbol_count, p, k)
    syms_t, lens_t, ic_t = map(torch.from_numpy, (syms, lens, ic))

    model = dense_torch_model(p, ic_t, delta=delta)
    gw, gl = encode_blocks_generic(syms_t, lens_t, model, p, w)
    sw, sl = coder.encode_blocks(*precompute_encode_model(syms_t, lens_t, ic_t, p, delta),
                                 lens_t, p, w)
    assert torch.equal(gl, sl) and torch.equal(gw, sw)

    rmodel = ref_generic.dense_jax_model(rp, ic, delta=delta)
    rgw, rgl = ref_generic.encode_blocks_generic(jnp.asarray(syms), jnp.asarray(lens), rmodel, rp, w)
    pre = ref_precompute(jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), rp.freq_max,
                         delta=delta)
    rsw, rsl = ref_coder.encode_blocks(*pre, jnp.asarray(lens), rp, w)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rgl))
    np.testing.assert_array_equal(_words_u32(gw), np.asarray(rgw))
    np.testing.assert_array_equal(_words_u32(sw), np.asarray(rsw))
    np.testing.assert_array_equal(sl.numpy(), np.asarray(rsl))

    # Both decoders give the input back: the generic one, and K3, which
    # stops at lens and so never reads the EOF symbol or the drain.
    assert _decoded_blocks(decode_blocks_generic(gw, lens_t, model, p, k), lens) == blocks
    assert _decoded_blocks(decode_blocks(gw, lens_t, ic_t, p, k, delta), lens) == blocks


@pytest.mark.parametrize("cfg,delta,prior", [
    ((8, 14, 16), 1, False), ((8, 30, 32), 16, False), ((8, 20, 22), 16, True),
    ((8, 12, 14), 16, True),  # frozen inside the block: 4096 <= total + 16 t
])
def test_precompute_encode_model_matches_reference(cfg, delta, prior):
    syms, lens, k = _stage(_blocks())
    lens[0] = -1  # a pad lane
    p, rp = Parameters(*cfg), RefParameters(*cfg)
    if prior:
        extra = np.zeros(p.symbol_count, np.int64)
        extra[:256] = np.bincount(syms.reshape(-1), minlength=256) // 8
        ic = prior_init_cum(extra, p).astype(np.int32)
    else:
        ic = uniform_init_cum(p).astype(np.int32)
    assert ic[-1] < p.freq_max
    mine = precompute_encode_model(*map(torch.from_numpy, (syms, lens, ic)), p, delta)
    ref = ref_precompute(jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), rp.freq_max,
                         delta=delta)
    assert len(mine) == 6
    for name, a, r in zip(("lo", "hi", "tot", "eof_lo", "eof_hi", "eof_tot"), mine, ref):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("cfg", GENERIC_CONFIGS, ids=lambda c: "-".join(map(str, c)))
def test_static_model_matches_host_oracle(cfg):
    blocks = _blocks()
    syms, lens, k = _stage(blocks)
    p = Parameters(*cfg)
    cum = cuda_checks.skewed_cum(p)
    assert cum[-1] <= p.freq_max
    w = coder.max_block_words(int(cum[-1]), p.symbol_count, p, k)

    enc, dec = make_generic_coders(static_torch_model(p, cum), p)
    words, byte_lens = enc(torch.from_numpy(syms), torch.from_numpy(lens), w)
    streams = bitpack.words_to_streams(_words_u32(words), byte_lens.tolist())
    refs = [oracle.compress_bytes(d, cuda_checks.StaticHost(p, cum)) for d in blocks]
    assert streams == refs

    decoded = dec(torch.from_numpy(bitpack.streams_to_words(streams, w)), torch.from_numpy(lens), k)
    assert _decoded_blocks(decoded, lens) == blocks


@pytest.mark.parametrize("cfg", GENERIC_CONFIGS, ids=lambda c: "-".join(map(str, c)))
def test_two_speed_model_matches_host_oracle(cfg):
    blocks = _blocks()
    syms, lens, k = _stage(blocks)
    p = Parameters(*cfg)
    ic = uniform_init_cum(p)
    w = coder.max_block_words(min(257 + 4 * (k + 1), p.freq_max), p.symbol_count, p, k)

    enc, dec = make_generic_coders(cuda_checks.two_speed_torch_model(p, ic), p)
    words, byte_lens = enc(torch.from_numpy(syms), torch.from_numpy(lens), w)
    streams = bitpack.words_to_streams(_words_u32(words), byte_lens.tolist())
    refs = [oracle.compress_bytes(d, cuda_checks.TwoSpeedHost(p, ic)) for d in blocks]
    assert streams == refs

    # Decode the host oracle's streams with the generic decoder.
    decoded = dec(torch.from_numpy(bitpack.streams_to_words(refs, w)), torch.from_numpy(lens), k)
    assert _decoded_blocks(decoded, lens) == blocks


def test_update_is_a_no_op_on_inactive_lanes():
    """The model state stops at ``lens``: values past a block's end do not
    move it (the EOF triple of a short block equals its full twin's)."""
    p = Parameters(8, 14, 16)
    syms = torch.from_numpy(np.frombuffer(testdata.text_like(2 * 64, 3), np.uint8)
                            .reshape(2, 64).astype(np.int64))
    short = syms.clone()
    short[0, 40:] = 7  # anything past lens
    lens = torch.tensor([40, 64])
    model = dense_torch_model(p, uniform_init_cum(p))
    full = model_values_generic(model, syms, lens, p)
    cut = model_values_generic(model, short, lens, p)
    for a, b in zip(full[3:], cut[3:]):
        assert torch.equal(a, b)
    assert torch.equal(full[0][:, :40], cut[0][:, :40])


def test_generic_check_on_the_cpu():
    """``cuda_checks.check_generic`` (chip_smoke.py phase 9 (b)) on CPU
    tensors at a small size: the same comparisons the card runs."""
    data = testdata.mixed(4 * 512, 5)
    res = cuda_checks.check_generic(torch.device("cpu"), data, n_blocks=4, k=512, n_oracle=2)
    assert res["blocks"] == 4 and res["oracle_blocks"] == 2 and res["stream_bytes"] > 0


def test_bitpack_matches_reference():
    rng = np.random.default_rng(4)
    streams = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (0, 1, 5, 17, 40)]
    words = bitpack.streams_to_words(streams, 10)
    np.testing.assert_array_equal(words, ref_bitpack.streams_to_words(streams, 10))
    assert words.dtype == np.uint32
    lens = [len(s) for s in streams]
    assert bitpack.words_to_streams(words, lens) == ref_bitpack.words_to_streams(words, lens) \
        == streams
    assert bitpack.words_to_stream(words[3], 17) == ref_bitpack.words_to_stream(words[3], 17)
    with pytest.raises(ValueError):
        bitpack.streams_to_words([b"x" * 9], 2)
