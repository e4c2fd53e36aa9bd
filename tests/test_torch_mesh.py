"""The data-parallel layer: the port's sharded entries over ``["cpu"] * n``
against the reference's sharded Pallas entries on the virtual CPU devices
that ``conftest.py`` sets up (interpret mode), and against the unsharded
port; and ``api.encode``/``decode`` over a device list against the
reference.  Lane counts are not multiples of the device count.  Exact
equality throughout (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redux_tpu import api as ref_api
from redux_tpu.models.dense import prior_init_cum
from redux_tpu.parallel import mesh as ref_mesh
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch import api
from redux_tpu_torch.ops.decode import decode_blocks
from redux_tpu_torch.ops.encode import encode_blocks_ranked
from redux_tpu_torch.ops.encode_m import encode_blocks_m
from redux_tpu_torch.parallel import (
    data_parallel_mesh,
    decode_blocks_sharded,
    encode_blocks_m_sharded,
    encode_blocks_ranked_sharded,
    lane_quantum,
    pad_to_devices,
)
from redux_tpu_torch.params import Parameters
from redux_tpu_torch.testdata import incompressible, text_like

CFG, DELTA, K, B = (8, 20, 22), 16, 160, 7
N_WORDS = K // 4 + 16


def _stream_bytes(words, byte_lens, n_words):
    w = np.asarray(words).astype(np.uint32)
    return [w[i].astype(">u4").tobytes()[: min(int(n), 4 * n_words)]
            for i, n in enumerate(np.asarray(byte_lens))]


def _inputs():
    rp = RefParameters(*CFG)
    data = text_like(5 * K, 21) + incompressible(K, 21) + b"\x07" * (K // 2)
    syms = np.zeros((B, K), np.uint8)
    syms.reshape(-1)[: len(data)] = np.frombuffer(data, np.uint8)
    lens = np.minimum(K, np.maximum(len(data) - K * np.arange(B), 0)).astype(np.int32)
    lens[2] = 1  # a 1-byte block
    full = np.zeros(rp.symbol_count, np.int64)
    full[:256] = np.bincount(syms.reshape(-1), minlength=256) // 4
    ic = prior_init_cum(full, rp).astype(np.int32)
    return syms, lens, ic


def _ref_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return ref_mesh.data_parallel_mesh(n=n)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _check_triple(mine, ref):
    w, bl, ov = mine
    w_r, bl_r, ov_r = ref
    np.testing.assert_array_equal(bl.numpy(), np.asarray(bl_r))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(ov_r))
    assert _stream_bytes(w.numpy().view(np.uint32), bl, N_WORDS) == _stream_bytes(
        w_r, bl_r, N_WORDS)


def test_mesh_helpers():
    mesh = data_parallel_mesh(["cpu", "cpu", "cpu", "cpu"], n=3)
    assert mesh == [torch.device("cpu")] * 3
    assert lane_quantum(mesh) == 3
    assert [pad_to_devices(b, mesh) for b in (0, 1, 3, 7)] == [3, 3, 3, 9]
    with pytest.raises(ValueError):
        data_parallel_mesh([])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_sharded_model_in_kernel_encode(n):
    syms, lens, ic = _inputs()
    p, rp = Parameters(*CFG), RefParameters(*CFG)
    args = (torch.from_numpy(syms), torch.from_numpy(lens), torch.from_numpy(ic))
    mine = encode_blocks_m_sharded(*args, p, N_WORDS, data_parallel_mesh(["cpu"] * n), DELTA)
    ref = ref_mesh.encode_blocks_pallas_m_sharded(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), rp, N_WORDS, _ref_mesh(n), DELTA)
    _check_triple(mine, ref)
    assert _equal(mine, encode_blocks_m(*args, p, N_WORDS, DELTA))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_sharded_ranked_encode(n):
    syms, lens, ic = _inputs()
    p, rp = Parameters(*CFG), RefParameters(*CFG)
    args = (torch.from_numpy(syms), torch.from_numpy(lens), torch.from_numpy(ic))
    mine = encode_blocks_ranked_sharded(*args, p, N_WORDS, data_parallel_mesh(["cpu"] * n), DELTA)
    ref = ref_mesh.encode_blocks_ranked_sharded(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), rp, N_WORDS, _ref_mesh(n), DELTA)
    _check_triple(mine, ref)
    assert _equal(mine, encode_blocks_ranked(*args, p, N_WORDS, DELTA))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_sharded_decode(n):
    syms, lens, ic = _inputs()
    p, rp = Parameters(*CFG), RefParameters(*CFG)
    ic_t = torch.from_numpy(ic)
    words, _, _ = encode_blocks_ranked(torch.from_numpy(syms), torch.from_numpy(lens), ic_t, p,
                                       N_WORDS, DELTA)
    words = torch.nn.functional.pad(words, (0, 2))  # zeros past the longest stream
    lens_t = torch.from_numpy(lens)
    mine = decode_blocks_sharded(words, lens_t, ic_t, p, K, data_parallel_mesh(["cpu"] * n),
                                 DELTA)
    ref = ref_mesh.decode_blocks_pallas_sharded(
        jnp.asarray(words.numpy().view(np.uint32)), jnp.asarray(lens), jnp.asarray(ic), rp, K,
        _ref_mesh(n), DELTA)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    assert torch.equal(mine, decode_blocks(words, lens_t, ic_t, p, K, DELTA))
    valid = np.arange(K)[None, :] < lens[:, None]
    np.testing.assert_array_equal(np.where(valid, mine.numpy(), 0), np.where(valid, syms, 0))


def test_api_over_a_device_list():
    """``device=[cpu, cpu, cpu]`` gives the bytes of ``device="cpu"`` and of
    the reference, and the archive decodes in both packages, sharded or
    not."""
    data = text_like(11000, 22) + incompressible(2500, 22) + b"mesh" * 300
    three = ["cpu", torch.device("cpu"), "cpu"]
    mine = api.encode(data, block_size=1024, device=three)
    assert mine == api.encode(data, block_size=1024, device="cpu")
    assert mine == ref_api.encode(data, block_size=1024)
    assert api.decode(mine, device=three) == data
    assert api.decode(mine, device=["cpu"]) == data
    assert ref_api.decode(mine) == data
