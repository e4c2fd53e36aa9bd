"""The memory-tight deployment ``rxt-wide22-fused`` and its cell
``fused22.text-256m``: the configuration's keywords, a CPU run of the cell
at a test's size, and its two readers, ``enc_fused.roofline_pct`` and
``enc.fused_block_share``."""

from __future__ import annotations

import json

import pytest

from benchmark import run, trace, work
from benchmark.run import Manifest, Run
from benchmark.tests.helpers import REPO, copy_benchmark
from redux_tpu_torch import api

FUSED = "rxt-wide22-fused"
FILES = [{"name": "a", "bytes": 300, "content": "text_like"},
         {"name": "b", "bytes": 1500, "content": "mixed"}]
CODEC = ("format", "symbol_bits", "freq_bits", "code_bits", "delta", "prior_budget",
         "prior_min_bytes", "block_size", "guarantees", "precision", "reduced")


def config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


def test_the_configuration_is_wide22_encoded_fused():
    fused, wide = config(FUSED), config("rxt-wide22")
    assert {k: fused[k] for k in CODEC} == {k: wide[k] for k in CODEC}
    assert fused["encode"] == {"fused": True} and fused["reduced"] == []
    assert run.codec_kwargs(fused) == dict(run.codec_kwargs(wide), fused=True)


def test_the_cell_and_its_metrics():
    m = Manifest()
    cell = m.cell("fused22.text-256m")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (FUSED, "text-256m", 1)
    assert m.config(cell["config"])["name"] == FUSED
    traced = [x["name"] for x in m.metrics("fused22.text-256m", traced=True)]
    assert traced == ["enc_fused.roofline_pct", "enc.fused_block_share"]
    untraced = {x["name"] for x in m.metrics("fused22.text-256m", traced=False)}
    assert untraced == {"card_ms_per_GiB", "peak_device_GiB", "setup_s"}


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    root = copy_benchmark(tmp_path_factory.mktemp("bench"), FILES, config=FUSED,
                          name="tiny.fused")
    return run.run_cell(run.Manifest(root), "tiny.fused", 2**31 + 2025, 1.5, True, device="cpu")


def test_a_traced_run_on_the_cpu_is_correct_and_fused(cpu_run):
    assert cpu_run["correct"] is True and cpu_run["failed"] == 0
    assert all(v["value"] == 0 for v in cpu_run["check"].values())
    assert cpu_run["metrics"]["enc.fused_block_share"] == {"value": 1.0, "unit": "ratio"}
    assert "enc_fused.roofline_pct" not in cpu_run["metrics"]  # no device trace here


def make_run(call_ops, n=1000):
    calls = [trace.Call("enc", "plain", 0, 100), trace.Call("dec", "plain", 100, 200)]
    tr = trace.Trace(calls=calls, cards=[0], window_ns=200, busy_ns={0: 100},
                     call_ops=[call_ops, {"decode_kernel": 30}], idle_by_phase={})
    r = Run({}, {}, {}, 1)
    r.trace = tr
    r.calls = [dict(kind="enc", mode="plain", file=0, bytes=n, seconds=1),
               dict(kind="dec", mode="plain", file=0, bytes=n, seconds=1)]
    r.work = {0: work.ArchiveWork(n=n, payload=600, coded_payload=500, coded_symbols=900)}
    return r


def test_the_roofline_reads_k4_alone():
    read = Manifest().reader("enc_fused.roofline_pct")
    split = make_run({"model_values_kernel": 10, "encode_kernel<true>": 20})
    assert read(split) is None
    fused = make_run({"encode_fused_kernel": 40, "encode_kernel<true>": 20, "crc32_kernel": 5})
    assert read(fused) == pytest.approx(100 * work.enc_coder(fused.work[0]) / 40e-9)


def record(n, **routes):
    return dict(kind="enc", bytes_in=n, bytes_out=n // 2, h2d=n, d2h=n // 2, **routes)


@pytest.mark.parametrize("routes,want", [
    ([dict(fused_blocks=4, split_blocks=0), dict(fused_blocks=65536, split_blocks=0)], 1.0),
    ([dict(fused_blocks=1, split_blocks=3), dict(fused_blocks=0, split_blocks=4)], 0.125),
    ([dict(fused_blocks=0, split_blocks=0)] * 2, None),
    ([dict(warp_blocks=1, thread_blocks=0)] * 2, None)],  # a program without encode routes
    ids=["fused", "mixed", "none", "unrecorded"])
def test_the_block_share_reads_the_records(monkeypatch, routes, want):
    read = Manifest().reader("enc.fused_block_share")
    recs = [record(100, **routes[0]), record(300, **routes[1])]
    monkeypatch.setattr(api, "recorded_calls", lambda: list(recs))
    r = Run({}, {}, {}, 1)
    r.calls = [dict(kind="enc", mode="timed", file=0, bytes=100, seconds=1),
               dict(kind="enc", mode="timed", file=1, bytes=300, seconds=1)]
    assert read(r) == want
