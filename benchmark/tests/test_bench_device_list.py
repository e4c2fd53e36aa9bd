"""The four-card deployment's configuration and its two readers: the
device list's balance of bus traffic (``dp.bus_skew``, from the program's
records) and of card time (``dp.card_busy_skew``, from the trace), on
synthetic runs and on a traced run over four CPU entries."""

from __future__ import annotations

import json

import pytest

from benchmark import run
from benchmark.run import Manifest, Run
from benchmark.tests.helpers import REPO, copy_benchmark
from benchmark.trace import Trace
from redux_tpu_torch import api

CODEC_KEYS = ("format", "symbol_bits", "freq_bits", "code_bits", "delta", "prior_budget",
              "prior_min_bytes", "block_size", "guarantees", "precision")


def reader(name):
    return Manifest(REPO).reader(name)


def call(kind, nbytes):
    return dict(kind=kind, mode="timed", file=0, bytes=nbytes, seconds=0.1)


def record(kind, n_in, n_out, h2d, d2h):
    """A record with bytes by entry, or without them where ``h2d`` is a number."""
    rec = dict(id=0, kind=kind, bytes_in=n_in, bytes_out=n_out, spans=[])
    if isinstance(h2d, list):
        rec.update(cards=["cpu"] * len(h2d), h2d=sum(h2d), d2h=sum(d2h), h2d_by_card=h2d,
                   d2h_by_card=d2h)
    else:
        rec.update(cards=["cpu"], h2d=h2d, d2h=d2h)
    return rec


def bus_run(monkeypatch, h2d, d2h):
    """A run of one timed round trip whose records carry ``h2d`` and ``d2h``."""
    recs = [record("enc", 100, 40, h2d, d2h), record("dec", 40, 100, h2d, d2h)]
    monkeypatch.setattr(api, "recorded_calls", lambda: list(recs))
    r = Run({}, {}, {}, len(h2d) if isinstance(h2d, list) else 1)
    r.calls = [call("enc", 100), call("dec", 100)]
    return r


@pytest.mark.parametrize("case, h2d, d2h, want", [
    ("one_entry", [150], [45], None),
    ("no_counts_by_entry", 150, 45, None),
    ("balanced", [40, 40, 40, 40], [10, 10, 10, 10], 1.0),
    ("one_stages_for_all", [160, 0, 0, 0], [40, 0, 0, 0], 4.0),
    ("uneven", [30, 10], [0, 0], 1.5),
])
def test_bus_skew(monkeypatch, case, h2d, d2h, want):
    got = reader("dp.bus_skew")(bus_run(monkeypatch, h2d, d2h))
    assert got == (pytest.approx(want) if want is not None else None)


def test_bus_skew_without_records(monkeypatch):
    monkeypatch.delattr(api, "recorded_calls")
    r = Run({}, {}, {}, 4)
    r.calls = [call("enc", 100), call("dec", 100)]
    assert reader("dp.bus_skew")(r) is None


@pytest.mark.parametrize("chips, busy, want", [
    (1, {0: 500}, None),
    (4, {0: 100, 1: 100, 2: 100, 3: 100}, 1.0),
    (4, {0: 400}, 4.0),  # three cards with no device op
    (4, {0: 300, 1: 100, 2: 100, 3: 300}, 1.5),
    (4, {}, None),
])
def test_card_busy_skew(chips, busy, want):
    r = Run({"chips": chips}, {}, {}, chips)
    r.trace = Trace(calls=[], cards=sorted(busy), window_ns=1000, busy_ns=busy, call_ops=[],
                    idle_by_phase={})
    got = reader("dp.card_busy_skew")(r)
    assert got == (pytest.approx(want) if want is not None else None)
    r.trace = None
    assert reader("dp.card_busy_skew")(r) is None


def test_each_configuration_has_the_cards_of_its_cells():
    data = json.loads((REPO / "BENCHMARK.json").read_text())
    m = Manifest(REPO)
    for c in data["configs"]:
        cells = [w for w in data["workloads"] if w["config"] == c["name"]]
        assert cells and all(w["chips"] == m.config(c["name"]).get("cards", 1) for w in cells)


def test_the_four_card_deployment_codes_as_wide22():
    m = Manifest(REPO)
    four, one = m.config("rxt-wide22-4card"), m.config("rxt-wide22")
    assert four["cards"] == 4 and four["reduced"] == []
    assert {k: four[k] for k in CODEC_KEYS} == {k: one[k] for k in CODEC_KEYS}
    assert run.codec_kwargs(four) == run.codec_kwargs(one)


def test_a_traced_run_over_four_entries_reports_the_bus_skew(tmp_path):
    """Four CPU entries and a file of one block: the first entry moves
    every byte and the others none, so the skew is the entries' count;
    the trace holds no card, so no card skew."""
    root = copy_benchmark(tmp_path, [{"name": "a", "bytes": 300, "content": "text_like"}])
    result = run.run_cell(Manifest(root), "tiny.files", 2**31 + 23, 1.5, True,
                          device=["cpu"] * 4)
    assert result["correct"] is True
    assert result["metrics"]["dp.bus_skew"] == {"value": 4.0, "unit": "x"}
    assert "dp.card_busy_skew" not in result["metrics"]
