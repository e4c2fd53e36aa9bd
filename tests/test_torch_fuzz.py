"""The port's randomized differential campaign (``redux_tpu_torch.fuzz``) on
the CPU, where each kernel wrapper runs its plain version: the draw, the
coverage of the instantiation classes, seeded trials against the JAX
package (``redux_tpu.api``, ``redux_tpu.native``, ``redux_tpu.oracle``,
tolerance 0), the command line, a planted fault and the reference's own
fault.  The campaign on the card is in ``tests/test_torch_cuda.py``.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redux_tpu import api as ref_api
from redux_tpu import native as ref_native
from redux_tpu import oracle as ref_oracle
from redux_tpu.ops.coder import encode_blocks_v2 as ref_encode_blocks_v2
from redux_tpu.ops.ranks import precompute_encode_model as ref_precompute_encode_model
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch import api, container, cuda_checks, fuzz
from redux_tpu_torch.errors import InvalidInputError
from redux_tpu_torch.ops.coder import products_fit_53, words_to_bytes
from redux_tpu_torch.ops.encode import encode_blocks_ranked
from redux_tpu_torch.params import Parameters
from redux_tpu_torch.testdata import text_like

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_draw_is_deterministic():
    a, b = fuzz.draw(3, 5), fuzz.draw(3, 5)
    assert (a.cfg, a.delta, a.k, a.prior_budget, a.blocks) == (b.cfg, b.delta, b.k,
                                                               b.prior_budget, b.blocks)
    assert np.array_equal(a.init_cum, b.init_cum)
    assert all(1 <= len(x) <= a.k for x in a.blocks) and 1 <= len(a.blocks) <= fuzz.MAX_BLOCKS
    assert fuzz.draw(3, 6).blocks != a.blocks and fuzz.draw(4, 5).blocks != a.blocks


@pytest.mark.parametrize("cfg,cls", [
    ((8, 14, 16), "u32"), ((8, 20, 22), "wide32"), ((8, 21, 23), "wide32"),
    ((8, 22, 24), "fits53"), ((8, 20, 32), "fits53"), ((8, 21, 32), "u64"),
    ((8, 30, 32), "u64")])
def test_config_classes(cfg, cls):
    """Each class is what the predicates say: (8,21,23) is the wide32 edge,
    (8,20,32) the last config whose products fit 53 bits, (8,21,32) the
    first that takes u64 divisions."""
    p = Parameters(*cfg)
    assert fuzz.config_class(p) == cls
    assert cfg in fuzz.CONFIGS[cls]
    assert products_fit_53(p) == (cls != "u64")
    assert (p.fits_u32 or p.fits_wide32) == (cls in ("u32", "wide32"))


def test_draws_cover_every_class():
    """Seeds 0-3, trials 0-11: every class, several configs of each, a
    frozen model and a multi-chunk route's block count."""
    seen, frozen = {}, 0
    for seed in range(4):
        for index in range(12):
            t = fuzz.draw(seed, index)
            seen.setdefault(fuzz.config_class(t.params), set()).add(t.cfg)
            frozen += fuzz.tfreeze(int(t.init_cum[-1]), t.params, t.delta) < max(map(len, t.blocks))
            if index % 8 == 0:
                assert len(t.blocks) >= fuzz.MULTI_CHUNK_MIN_BLOCKS
    assert set(seen) == set(fuzz.CLASSES)
    assert all(len(cfgs) >= 2 for cfgs in seen.values()), seen
    assert frozen >= 1


# One small trial of each class: api routes (index % 4 == 0) at wide32 and
# u64, generic legs (index % 4 == 2) at u32 (the model frozen) and fits53.
SMALL_TRIALS = [(10, 4), (27, 2), (19, 6), (60, 4)]


@pytest.mark.parametrize("seed,index", SMALL_TRIALS)
def test_trial_matches_the_reference(seed, index):
    trial = fuzz.draw(seed, index)
    res = fuzz.run_trial(trial, "cpu")
    assert res["faults"] == [] and res["class"] == fuzz.config_class(trial.params)
    assert (res["route_chunks"] is not None) == (index % 4 == 0)
    assert res["generic"] == (index % 4 == 2)

    # The port's streams (K1 -> K2's plain versions) against the JAX package's
    # native coder on every complete block, and its oracle on the first two.
    p, ref_p = trial.params, RefParameters(*trial.cfg)
    syms, lens = trial.arrays()
    n_words = api._encode_words(p, trial.k, trial.delta)
    words, bl, ovf = encode_blocks_ranked(
        torch.from_numpy(syms), torch.from_numpy(lens),
        torch.from_numpy(trial.init_cum), p, n_words, trial.delta)
    byts = words_to_bytes(words).numpy()
    for i, block in enumerate(trial.blocks):
        if bool(ovf[i]) or int(bl[i]) > 4 * n_words:
            continue
        mine = byts[i, : int(bl[i])].tobytes()
        assert mine == ref_native.compress_block_v2(block, ref_p, trial.prior_extra, trial.delta)
        if i < 2:
            assert mine == ref_oracle.compress_block(block, ref_p, trial.init_cum.astype(np.int64),
                                                     trial.delta)
    if index % 4 == 0:
        data = b"".join(trial.blocks)
        kw = {"block_size": trial.k, "delta": trial.delta,
              "use_prior": trial.prior_budget is not None,
              "prior_budget": trial.prior_budget or api.DEFAULT_PRIOR_BUDGET}
        assert api.encode(data, params=p, device="cpu", **kw) == ref_api.encode(
            data, params=ref_p, **kw)


def test_k3_decodes_the_streams_stored_raw():
    """With ``decode_raw`` (the campaign's setting) K3 decodes every
    complete K2 stream, those not smaller than raw too, and gives their
    blocks back; as the main path stages them, those blocks get no symbols."""
    trial = fuzz.draw(27, 2)
    syms, lens = trial.arrays()
    x = cuda_checks.KernelInputs.of_blocks(syms, lens, trial.init_cum, trial.params,
                                           trial.delta, torch.device("cpu"))
    full = cuda_checks.compare_kernels(x, time_plain=False, reps=0, decode_raw=True)
    staged = cuda_checks.compare_kernels(x, time_plain=False, reps=0)
    _, bl, ovf = full["k2_triple"]
    raw = (ovf | (bl >= x.lens)).numpy()
    assert raw.any() and not ovf.any() and bool((bl <= 4 * x.n_words).all())
    for i in np.flatnonzero(raw):
        assert full["k3_syms"][i, : lens[i]].numpy().tobytes() == trial.blocks[i]
        assert not staged["k3_syms"][i].any()


def test_command_line_runs_two_trials():
    # One intra-op thread: the plain versions' small ops only contend for the cores.
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "redux_tpu_torch.fuzz", "--device", "cpu",
                          "--trials", "2"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("fuzz summary ") and '"trials": 2' in last


def test_a_flipped_bit_is_a_mismatch(monkeypatch, tmp_path, capsys):
    """A plain coder that flips the first bit of block 0's stream: the
    campaign exits 1, names the kernel and the block, and saves the inputs."""
    real = cuda_checks.encode_blocks_plain

    def flipped(*args):
        words, bl, ovf = real(*args)
        words = words.clone()
        words[0, 0] ^= -(1 << 31)  # the top bit of the stream's first byte
        return words, bl, ovf

    monkeypatch.setattr(cuda_checks, "encode_blocks_plain", flipped)
    monkeypatch.setattr(fuzz, "FAIL_DIR", tmp_path)
    assert fuzz.main(["--device", "cpu", "--seed", "27", "--trial", "2"]) == 1
    out = capsys.readouterr().out
    assert "MISMATCH seed=27 trial=2" in out and "encode differs from its plain version" in out
    assert "block 0 first" in out and "--seed 27 --trial 2" in out
    saved = np.load(tmp_path / "seed27_trial2.npz")
    syms, lens = fuzz.draw(27, 2).arrays()
    assert np.array_equal(saved["syms"], syms) and np.array_equal(saved["lens"], lens)


def test_the_degenerate_input_is_a_reference_fault(monkeypatch):
    """``tests/test_torch_degenerate.py``'s input as the one block of a
    trial: the reference's decoder does not give it back, so the campaign
    counts it as a reference_fault, not as a pass, with the port's stream
    equal to the reference's."""
    data = text_like(7186, 1) + bytes([111, 100, 116, 0])
    trial = fuzz.Trial(0, 1, Parameters.tpu_wide(), 255, 8192, [data])
    streams, faults = fuzz.reference_blocks(trial.blocks, trial.params, None, 255)
    assert list(faults) == [0] and faults[0] != data
    monkeypatch.setattr(fuzz, "draw", lambda seed, index: trial)
    s = fuzz.run_campaign(0, trials=1, device="cpu")
    assert s["trials"] == 1
    assert s["reference_fault_blocks"] == 1
    assert s["reference_faults"] == [[1, "kernels", 0, True]]  # the native coder's stream


def test_past_an_empty_interval_the_port_follows_the_reference_kernels():
    """Block 93 of trial 12 of seed 13 ((8,10,12), delta 255, the uniform
    row), which the campaign found: the model freezes at 1277 > 2**10 + 2,
    an interval empties, and from there the reference's serial coder
    (native and oracle alike) writes other bits than its block path
    (``redux_tpu.api.encode``).  The port's plain versions write the block
    path's bytes; the campaign counts the block as a reference_fault whose
    stream is not the serial coder's, and neither package decodes it."""
    block = fuzz.draw(13, 12).blocks[93]
    p, ref_p = Parameters(8, 10, 12), RefParameters(8, 10, 12)
    res = fuzz.run_trial(fuzz.Trial(13, 1, p, 255, 96, [block]), "cpu")
    assert res["faults"] == [("kernels", 0, False)]
    kw = {"block_size": 96, "delta": 255, "use_prior": False}
    mine = api.encode(block, params=p, device="cpu", **kw)
    assert mine == ref_api.encode(block, params=ref_p, **kw)
    serial = ref_native.compress_block_v2(block, ref_p, None, 255)
    assert serial == ref_oracle.compress_block(block, ref_p, None, 255)
    assert serial not in mine and container.parse_archive(mine)[0].block_raw == (False,)
    with pytest.raises(InvalidInputError):
        api.decode(mine, device="cpu")


# Reference faults that campaign runs found, as (seed, trial, blocks): seeds
# 5, 104, 106, 201 and 306 on the card, 13 on the CPU.  All have the model
# frozen, at (8,10,12) but for seed 306's at (8,12,14); trials 38 of seed
# 5, 38 of seed 201 and 90 of seed 13 start from a prior.
REFERENCE_FAULTS = [
    (5, 38, [136]), (104, 57, [9, 13, 18, 20, 36, 39, 43, 105, 126, 161, 173, 194]),
    (106, 34, [23]), (201, 3, [11, 21, 48]), (201, 29, [180]), (201, 38, [5, 98]),
    (306, 8, [31, 48, 60]), (13, 12, [93]), (13, 90, [103])]


@pytest.mark.parametrize("seed,index,blocks", REFERENCE_FAULTS)
def test_reference_faults_equal_the_reference_block_path(seed, index, blocks):
    """On each block the campaign counted as a reference_fault, the port's
    plain stream (K1 -> K2's plain versions from the trial's own row)
    equals, byte for byte, what ``redux_tpu.api.encode`` codes on the CPU
    (``ops.ranks.precompute_encode_model`` + ``ops.coder.encode_blocks_v2``),
    and the port's ``api.encode`` archive of the first such block equals
    ``redux_tpu.api.encode``'s (with a prior, the row is then the block's
    own)."""
    trial = fuzz.draw(seed, index)
    picked = [trial.blocks[i] for i in blocks]
    _, faults = fuzz.reference_blocks(picked, trial.params, trial.prior_extra, trial.delta)
    assert sorted(faults) == list(range(len(blocks)))
    p, ref_p = trial.params, RefParameters(*trial.cfg)
    syms, lens = trial.arrays()
    syms, lens = syms[blocks], lens[blocks]
    n_words = api._encode_words(p, trial.k, trial.delta)
    words, bl, ovf = encode_blocks_ranked(torch.from_numpy(syms), torch.from_numpy(lens),
                                          torch.from_numpy(trial.init_cum), p, n_words,
                                          trial.delta)
    lo, hi, tot, _, _, _ = ref_precompute_encode_model(
        jnp.asarray(syms.astype(np.int32)), jnp.asarray(lens), jnp.asarray(trial.init_cum),
        ref_p.freq_max, delta=trial.delta)
    w_r, bl_r, ovf_r = ref_encode_blocks_v2(lo, hi, tot, jnp.asarray(lens), ref_p, n_words)
    np.testing.assert_array_equal(bl.numpy(), np.asarray(bl_r))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovf_r))
    mine = words_to_bytes(words).numpy()
    theirs = np.asarray(w_r).view(np.uint32).astype(">u4").view(np.uint8).reshape(len(blocks), -1)
    for j, n in enumerate(bl.tolist()):
        n = min(n, 4 * n_words)
        assert mine[j, :n].tobytes() == theirs[j, :n].tobytes(), j

    kw = {"block_size": trial.k, "delta": trial.delta,
          "use_prior": trial.prior_budget is not None,
          "prior_budget": trial.prior_budget or api.DEFAULT_PRIOR_BUDGET}
    assert api.encode(picked[0], params=p, device="cpu", **kw) == ref_api.encode(
        picked[0], params=ref_p, **kw)
