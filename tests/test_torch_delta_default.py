"""Every kernel entry of the port, its plain version and its sharded entry
take ``delta=1`` when the caller leaves ``delta`` out, as the reference's
entries do: each is called without ``delta`` (``device="cpu"``) and held
to the reference entry called without it (interpret mode on the CPU).
The shapes are ``tests/test_torch_mesh.py``'s (7 blocks of 160 at
tpu_wide with a prior row).  Exact equality throughout (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redux_tpu.ops.pallas_decode import decode_blocks_pallas
from redux_tpu.ops.pallas_encode import encode_blocks_pallas, encode_blocks_pallas_m
from redux_tpu.ops.pallas_encode import encode_blocks_ranked as ref_encode_ranked
from redux_tpu.ops.pallas_model import model_lohi_pallas
from redux_tpu.parallel import mesh as ref_mesh
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch.ops.decode import decode_blocks, decode_blocks_plain
from redux_tpu_torch.ops.encode import (encode_blocks, encode_blocks_fused,
                                        encode_blocks_fused_plain, encode_blocks_plain,
                                        encode_blocks_ranked)
from redux_tpu_torch.ops.encode_m import encode_blocks_m, encode_blocks_m_plain
from redux_tpu_torch.ops.model import model_lohi, model_lohi_plain
from redux_tpu_torch.parallel import (data_parallel_mesh, decode_blocks_sharded,
                                      encode_blocks_m_sharded, encode_blocks_ranked_sharded)
from redux_tpu_torch.params import Parameters
from test_torch_mesh import CFG, K, N_WORDS, _check_triple, _inputs

P, RP = Parameters(*CFG), RefParameters(*CFG)


def _args():
    syms, lens, ic = _inputs()
    return (syms, lens, ic), (torch.from_numpy(syms), torch.from_numpy(lens),
                              torch.from_numpy(ic))


@pytest.mark.parametrize("entry", [model_lohi, model_lohi_plain])
def test_model_values_default_delta(entry):
    (syms, lens, ic), args = _args()
    lo, hi = entry(*args, P)
    lo_r, hi_r = model_lohi_pallas(jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), RP)
    valid = np.arange(K)[None, :] < lens[:, None]
    np.testing.assert_array_equal(np.where(valid, lo.numpy(), 0), np.where(valid, lo_r, 0))
    np.testing.assert_array_equal(np.where(valid, hi.numpy(), 0), np.where(valid, hi_r, 0))


@pytest.mark.parametrize("entry", [encode_blocks, encode_blocks_plain])
def test_coder_default_delta(entry):
    (syms, lens, ic), args = _args()
    lo, hi = model_lohi_plain(*args, P, 1)
    mine = entry(lo, hi, args[1], int(ic[-1]), P, N_WORDS)
    ref = encode_blocks_pallas(jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
                               jnp.asarray(lens), int(ic[-1]), RP, N_WORDS)
    _check_triple(mine, ref)


@pytest.mark.parametrize("entry", [encode_blocks_ranked, encode_blocks_fused,
                                   encode_blocks_fused_plain, encode_blocks_m,
                                   encode_blocks_m_plain])
def test_symbol_encoders_default_delta(entry):
    (syms, lens, ic), args = _args()
    mine = entry(*args, P, N_WORDS)
    if entry in (encode_blocks_m, encode_blocks_m_plain):
        ref = encode_blocks_pallas_m(jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), RP,
                                     N_WORDS)
    else:
        ref = ref_encode_ranked(jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), RP,
                                N_WORDS)
    _check_triple(mine, ref)


def _staged(args):
    words, _, _ = encode_blocks_ranked(*args, P, N_WORDS, 1)
    return torch.nn.functional.pad(words, (0, 2))  # zeros past the longest stream


@pytest.mark.parametrize("entry", [decode_blocks, decode_blocks_plain])
def test_decoder_default_delta(entry):
    (syms, lens, ic), args = _args()
    words = _staged(args)
    mine = entry(words, args[1], args[2], P, K)
    ref = decode_blocks_pallas(jnp.asarray(words.numpy().view(np.uint32)), jnp.asarray(lens),
                               jnp.asarray(ic), RP, K)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    valid = np.arange(K)[None, :] < lens[:, None]
    np.testing.assert_array_equal(np.where(valid, mine.numpy(), 0), np.where(valid, syms, 0))


def _ref_mesh2():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    return ref_mesh.data_parallel_mesh(n=2)


@pytest.mark.parametrize("name", ["ranked", "m", "decode"])
def test_sharded_entries_default_delta(name):
    (syms, lens, ic), args = _args()
    mesh = data_parallel_mesh(["cpu"] * 2)
    j = (jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic))
    if name == "ranked":
        _check_triple(encode_blocks_ranked_sharded(*args, P, N_WORDS, mesh),
                      ref_mesh.encode_blocks_ranked_sharded(*j, RP, N_WORDS, _ref_mesh2()))
    elif name == "m":
        _check_triple(encode_blocks_m_sharded(*args, P, N_WORDS, mesh),
                      ref_mesh.encode_blocks_pallas_m_sharded(*j, RP, N_WORDS, _ref_mesh2()))
    else:
        words = _staged(args)
        mine = decode_blocks_sharded(words, args[1], args[2], P, K, mesh)
        ref = ref_mesh.decode_blocks_pallas_sharded(
            jnp.asarray(words.numpy().view(np.uint32)), j[1], j[2], RP, K, _ref_mesh2())
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
