"""K1 (model values): the port's plain version against the reference's
Pallas kernel in interpret mode (``model_lohi_pallas``), exact equality at
every position ``t < lens``; and a numpy emulation of the CUDA kernel's
32-positions-at-a-time algebra against both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from redux_tpu.models.dense import prior_init_cum, uniform_init_cum
from redux_tpu.ops.pallas_model import model_lohi_pallas
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch.ops.model import model_lohi, model_lohi_plain
from redux_tpu_torch.params import Parameters
from torch_kernel_emulation import SLOTS, model_chunk


def _check(syms, lens, ic, cfg, delta):
    rp, p = RefParameters(*cfg), Parameters(*cfg)
    lo_r, hi_r = model_lohi_pallas(
        jnp.asarray(syms.astype(np.int32)), jnp.asarray(lens), jnp.asarray(ic), rp, delta
    )
    lo, hi = model_lohi(
        torch.from_numpy(syms), torch.from_numpy(lens), torch.from_numpy(ic), p, delta
    )
    lo_r, hi_r = np.asarray(lo_r), np.asarray(hi_r)
    assert lo.shape == hi.shape == syms.shape and lo.dtype == torch.int32
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(lo.numpy()[i, :n], lo_r[i, :n], err_msg=f"lo {i}")
        np.testing.assert_array_equal(hi.numpy()[i, :n], hi_r[i, :n], err_msg=f"hi {i}")


def _syms(seed, b, k):
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 256, (b, k)).astype(np.uint8)
    syms[1] = 0
    syms[2] = 255
    syms[3, ::2] = 7  # hi reads across the 8-row bucket edges of the TPU sweep
    syms[4] = (rng.integers(0, 4, k) * 64).astype(np.uint8)
    return syms


@pytest.mark.parametrize("delta", [1, 16, 255])
def test_model_values_uniform_wide(delta):
    k = 320
    syms = _syms(delta, 9, k)
    lens = np.array([k, k, k, k, k, 0, 1, 77, k - 1], np.int32)
    ic = uniform_init_cum(RefParameters.tpu_wide()).astype(np.int32)
    _check(syms, lens, ic, (8, 20, 22), delta)


def test_model_values_prior_and_freeze_tpu32():
    """tpu32 with a warm-start prior: delta 255 drives the total past
    freq_max = 32767 inside the block, so the freeze engages mid-block."""
    cfg = (8, 15, 17)
    rng = np.random.default_rng(5)
    k = 512
    syms = _syms(11, 6, k)
    lens = np.array([k, k, 300, 0, k, 129], np.int32)
    extra = np.zeros(257, np.int64)
    extra[:256] = rng.integers(0, 60, 256)
    ic = prior_init_cum(extra, RefParameters(*cfg)).astype(np.int32)
    assert int(ic[-1]) + 255 * k > RefParameters(*cfg).freq_max
    _check(syms, lens, ic, cfg, 255)


def _model_chunked(syms, lens, ic, freq_max, delta):
    """numpy emulation of the kernel's 32-positions-at-a-time algorithm
    (``csrc/model_values.cu``): ``rxt::model_chunk`` on every chunk, the
    active positions those below min(lens, tfreeze, K)."""
    b, k = syms.shape
    tf = max(-(-(freq_max - int(ic[-1])) // delta), 0)
    lo = np.zeros((b, k), np.int64)
    hi = np.zeros((b, k), np.int64)
    for blk in range(b):
        row = np.zeros(SLOTS, np.int64)
        row[: len(ic)] = ic
        upd_end = min(int(lens[blk]), tf, k)
        for t0 in range(0, k, 32):
            n = min(32, k - t0)
            v = np.zeros(32, np.int64)
            v[:n] = syms[blk, t0 : t0 + n]
            n_act = min(max(upd_end - t0, 0), 32)
            lo_c, hi_c = model_chunk(row, v, n_act, delta)
            lo[blk, t0 : t0 + n] = lo_c[:n]
            hi[blk, t0 : t0 + n] = hi_c[:n]
    return lo, hi


def _check_chunked(syms, lens, ic, cfg, delta):
    """The emulation equals the plain version at every position and the
    reference's Pallas kernel (interpret mode) at every t < lens."""
    rp, p = RefParameters(*cfg), Parameters(*cfg)
    lo_e, hi_e = _model_chunked(syms, lens, ic, p.freq_max, delta)
    lo_p, hi_p = model_lohi_plain(torch.from_numpy(syms), torch.from_numpy(lens),
                                  torch.from_numpy(ic), p, delta)
    np.testing.assert_array_equal(lo_e, lo_p.numpy())
    np.testing.assert_array_equal(hi_e, hi_p.numpy())
    lo_r, hi_r = model_lohi_pallas(
        jnp.asarray(syms.astype(np.int32)), jnp.asarray(lens), jnp.asarray(ic), rp, delta)
    lo_r, hi_r = np.asarray(lo_r), np.asarray(hi_r)
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(lo_e[i, :n], lo_r[i, :n], err_msg=f"lo {i}")
        np.testing.assert_array_equal(hi_e[i, :n], hi_r[i, :n], err_msg=f"hi {i}")


@pytest.mark.parametrize("delta", [1, 16, 255])
def test_chunked_algebra_tpu_wide(delta):
    """K1's chunk update at tpu_wide; K = 333 is not a multiple of 32 and
    the lens end inside chunks."""
    k = 333
    syms = _syms(100 + delta, 9, k)
    syms[5, 40:72] = 9  # one symbol over a whole chunk
    lens = np.array([k, k, k, k, k, 0, 1, 77, k - 1], np.int32)
    ic = uniform_init_cum(RefParameters.tpu_wide()).astype(np.int32)
    _check_chunked(syms, lens, ic, (8, 20, 22), delta)


def test_chunked_algebra_tpu32_freeze_inside_a_chunk():
    """tpu32 with a prior: the freeze lands inside a chunk (tfreeze not a
    multiple of 32), and the last block is short."""
    cfg, delta, k = (8, 15, 17), 255, 300
    rng = np.random.default_rng(21)
    extra = np.zeros(257, np.int64)
    extra[:256] = rng.integers(0, 40, 256)
    ic = prior_init_cum(extra, RefParameters(*cfg)).astype(np.int32)
    tf = -(-(RefParameters(*cfg).freq_max - int(ic[-1])) // delta)
    assert 0 < tf < k and tf % 32 != 0
    syms = _syms(13, 5, k)
    lens = np.array([k, k, tf + 3, tf - 1, 131], np.int32)
    _check_chunked(syms, lens, ic, cfg, delta)


def test_model_values_wrapper_checks():
    p = Parameters.tpu_wide()
    ic = torch.arange(258, dtype=torch.int32)
    syms = torch.zeros(2, 8, dtype=torch.uint8)
    lens = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        model_lohi(syms.to(torch.int32), lens, ic, p, 16)
    with pytest.raises(ValueError):
        model_lohi(syms, lens[:1], ic, p, 16)
    with pytest.raises(ValueError):
        model_lohi(syms, lens, ic[:-1], p, 16)
    with pytest.raises(ValueError):
        model_lohi(syms[:, ::2], lens, ic, p, 16)
    lo, hi = model_lohi(syms, lens, ic, p, 16)
    assert lo[0, 0] == 0 and hi[0, 0] == 1 and hi[0, 1] == 17
