"""The port's multi-host layer: real worker processes on ``torch.distributed``
(gloo, CPU) as ``tests/test_multihost.py`` runs the reference's, and the
sharded K2 entry against the reference's sharded XLA coder on the virtual
CPU devices of ``conftest.py``.  Each worker asserts that it imported
neither JAX nor the reference package."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redux_tpu.ops.ranks import precompute_encode_model as ref_precompute
from redux_tpu.parallel import mesh as ref_mesh
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch.models.dense import prior_init_cum
from redux_tpu_torch.ops.encode import encode_blocks
from redux_tpu_torch.ops.model import model_lohi
from redux_tpu_torch.parallel import data_parallel_mesh, encode_blocks_sharded, initialize_multihost
from redux_tpu_torch.parallel import multihost
from redux_tpu_torch.params import Parameters
from redux_tpu_torch.testdata import incompressible, text_like

# Each worker runs multihost.main, then asserts it imported no JAX.
WORKER = (
    "import sys\n"
    "from redux_tpu_torch.parallel import multihost\n"
    "rc = multihost.main(sys.argv[1:])\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'redux_tpu')]\n"
    "assert not bad, bad\n"
    "sys.exit(rc)\n"
)


def _run_workers(nproc, extra):
    return multihost.run_local(nproc, ["--device", "cpu", "--backend", "gloo", *extra], 120,
                               entry=("-c", WORKER))


def test_multihost_roundtrip_two_gloo_workers():
    outs = _run_workers(2, [])
    for pid, out in enumerate(outs):
        assert f"MULTIHOST OK p{pid}/2 blocks=8" in out, out
        assert "backend=gloo" in out and "device=cpu" in out, out


def test_scaling_worker_verifies():
    outs = _run_workers(2, ["--scaling", "--bytes-per-host", "8192", "--block-size", "1024",
                            "--iters", "1"])
    res = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    for pid, r in enumerate(res):
        assert r["verified"] is True, r
        assert (r["process"], r["n_procs"], r["bytes"]) == (pid, 2, 2 * 8192), r
        assert r["t_enc"] > 0 and r["t_dec"] > 0 and r["device"] == "cpu", r


def test_sharded_coder_matches_reference_xla_coder():
    """``encode_blocks_sharded`` over three CPU shards (7 lanes, not a
    multiple of 3) against the reference's ``mesh.encode_blocks_sharded``
    over the 8 virtual devices, and against the unsharded K2."""
    cfg, delta, k, b = (8, 20, 22), 16, 160, 7
    n_words = k // 4 + 16
    data = text_like(5 * k, 31) + incompressible(k, 31) + b"\x07" * (k // 2)
    syms = np.zeros((b, k), np.uint8)
    syms.reshape(-1)[: len(data)] = np.frombuffer(data, np.uint8)
    lens = np.minimum(k, np.maximum(len(data) - k * np.arange(b), 0)).astype(np.int32)
    lens[2] = 1
    p, rp = Parameters(*cfg), RefParameters(*cfg)
    extra = np.zeros(p.symbol_count, np.int64)
    extra[:256] = np.bincount(syms.reshape(-1), minlength=256) // 4
    ic = prior_init_cum(extra, p).astype(np.int32)

    syms_t, lens_t, ic_t = map(torch.from_numpy, (syms, lens, ic))
    lo, hi = model_lohi(syms_t, lens_t, ic_t, p, delta)
    mine = encode_blocks_sharded(lo, hi, lens_t, int(ic[-1]), p, n_words,
                                 data_parallel_mesh(["cpu"] * 3), delta)
    assert all(torch.equal(a, c) for a, c in
               zip(mine, encode_blocks(lo, hi, lens_t, int(ic[-1]), p, n_words, delta)))

    mesh = ref_mesh.data_parallel_mesh()
    b_pad = ref_mesh.pad_to_devices(b, mesh)
    syms_p = np.pad(syms, ((0, b_pad - b), (0, 0))).astype(np.int32)
    lens_p = np.pad(lens, (0, b_pad - b))
    rlo, rhi, rtot, _, _, _ = ref_precompute(jnp.asarray(syms_p), jnp.asarray(lens_p),
                                             jnp.asarray(ic), rp.freq_max, delta=delta)
    rw, rbl, rov = ref_mesh.encode_blocks_sharded(rlo, rhi, rtot, jnp.asarray(lens_p), rp,
                                                  n_words, mesh)
    assert len(mesh.devices.flat) == len(jax.devices()) == 8
    words, byte_lens, ovf = mine
    np.testing.assert_array_equal(byte_lens.numpy(), np.asarray(rbl)[:b])
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(rov)[:b].astype(bool))
    w, rw = words.numpy().view(np.uint32), np.asarray(rw)[:b]
    for i, n in enumerate(byte_lens.tolist()):
        assert w[i].astype(">u4").tobytes()[:n] == rw[i].astype(">u4").tobytes()[:n], i


def test_initialize_multihost_joins_once(monkeypatch):
    """A second call is a no-op; the backend is the caller's."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(calls))
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    initialize_multihost("127.0.0.1:1234", 2, 1, "gloo")
    initialize_multihost("127.0.0.1:1234", 2, 1, "nccl")
    assert calls == [(("gloo",), {"init_method": "tcp://127.0.0.1:1234", "world_size": 2,
                                  "rank": 1})]


def test_cuda_workers_raise_without_cuda(monkeypatch):
    """``--device cuda`` (the default) raises where CUDA is absent, before
    joining any group: no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (multihost.run_multihost_roundtrip, multihost.run_scaling_worker):
        with pytest.raises(RuntimeError, match="cuda"):
            fn("127.0.0.1:1", 2, 0)
    assert multihost.default_backend("cuda") == "nccl"
    assert multihost.default_backend("cpu") == "gloo"
