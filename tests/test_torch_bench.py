"""The port's device benchmark (``redux_tpu_torch.bench``) on the CPU: the
plain versions stand in for the kernels, so its times mean nothing here;
what is checked is the verification, the ratio against the reference's
archive, the output keys and the refusal to run without CUDA."""

import json

import pytest
import torch

from redux_tpu import api as ref_api
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch import bench, testdata


def test_run_device_benchmark_on_the_cpu():
    data = testdata.mixed(16 << 10, 3)
    res = bench.run_device_benchmark(data, block_size=1024, iters=2, device="cpu")
    assert res["verified"] is True
    ref = ref_api.encode(data, params=RefParameters.tpu_wide(), block_size=1024, delta=16)
    assert res["ratio"] == len(data) / len(ref)
    assert (res["n_blocks"], res["block_size"], res["device"]) == (16, 1024, "cpu")
    assert len(res["encode_spread_ms"]) == len(res["decode_spread_ms"]) == 2
    assert res["encode_spread_ms"][0] <= res["encode_ms"] <= res["encode_spread_ms"][-1]
    assert res["aggregate_gbps"] > 0 and res["encode_e2e_gbps"] > 0
    # No kernel launches on the CPU, and no card numbers.
    assert res["kernels"] == [] and res["roofline"] is None
    assert res["h2d_pageable_gbps"] is None and res["h2d_pinned_gbps"] is None


def test_module_entry_prints_one_json_line(capsys):
    argv = ["--device", "cpu", "--bytes", "2000", "--seed", "4", "--block-size", "512", "--iters", "1"]
    assert bench.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    assert res["verified"] is True and res["block_size"] == 512 and res["n_blocks"] == 4
    assert bench.main(["--baseline", "--bytes", "65536"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["baseline_gbps"] > 0 and res["bytes"] == 65536


def test_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run_device_benchmark(b"no fallback" * 100)
    with pytest.raises(ValueError):
        bench.run_device_benchmark(b"", device="cpu")
