"""The readers of the program's own records: a run's timed calls matched
one to one with the program's last recorded calls, the bus bytes a byte
read from them, and None where nothing matches or nothing was recorded."""

from __future__ import annotations

import pytest

from benchmark import program_records, run
from benchmark.run import Run
from benchmark.tests.helpers import copy_benchmark
from redux_tpu_torch import api

TINY = [{"name": "a", "bytes": 300, "content": "text_like"}]


def call(kind, mode, nbytes):
    return dict(kind=kind, mode=mode, file=0, bytes=nbytes, seconds=0.1)


def record(kind, n_in, n_out, h2d, d2h):
    return dict(id=0, kind=kind, bytes_in=n_in, bytes_out=n_out, cards=["cpu"], spans=[],
                h2d=h2d, d2h=d2h)


@pytest.fixture
def records(monkeypatch):
    recs = []
    monkeypatch.setattr(api, "recorded_calls", lambda: list(recs))
    return recs


def make_run(calls):
    r = Run({}, {}, {}, 1)
    r.calls = calls
    return r


def test_matching_records_give_bus_bytes_a_byte(records):
    records += [record("enc", 999, 9, 1, 1),  # older than the window: not read
                record("enc", 100, 40, 150, 45), record("dec", 40, 100, 60, 100),
                record("enc", 300, 90, 400, 100), record("dec", 90, 300, 130, 300)]
    r = make_run([call("enc", "plain", 100), call("dec", "plain", 100),
                  call("enc", "timed", 100), call("dec", "timed", 100),
                  call("enc", "plain", 300), call("dec", "plain", 300),
                  call("enc", "timed", 300), call("dec", "timed", 300)])
    assert program_records.bus_bytes_per_byte(r, "enc") == pytest.approx(695 / 400)
    assert program_records.bus_bytes_per_byte(r, "dec") == pytest.approx(590 / 400)
    assert [x["bytes_in"] for x in program_records.timed_records(r, "enc")] == [100, 300]


@pytest.mark.parametrize("fault", ["kind", "bytes", "too_few", "none", "no_timed_calls"])
def test_no_match_gives_none(records, fault):
    records += [record("enc", 100, 40, 150, 45), record("dec", 40, 100, 60, 100)]
    calls = [call("enc", "timed", 100), call("dec", "timed", 100)]
    if fault == "kind":
        records[1] = record("enc", 40, 100, 60, 100)
    elif fault == "bytes":
        calls[1] = call("dec", "timed", 101)
    elif fault == "too_few":
        calls += [call("enc", "timed", 100), call("dec", "timed", 100)]
    elif fault == "none":
        records.clear()
    else:
        calls = [call("enc", "plain", 100), call("dec", "plain", 100)]
    r = make_run(calls)
    assert program_records.bus_bytes_per_byte(r, "dec") is None
    enc = program_records.bus_bytes_per_byte(r, "enc")  # matched where only dec differs
    assert enc == (pytest.approx(1.95) if fault == "bytes" else None)


def test_a_program_that_records_nothing_gives_none(monkeypatch):
    monkeypatch.delattr(api, "recorded_calls")
    r = make_run([call("enc", "timed", 100)])
    assert program_records.timed_records(r, "enc") is None
    assert program_records.bus_bytes_per_byte(r, "enc") is None


def test_a_traced_run_on_the_cpu_reports_both(tmp_path):
    """A window of two round trips or more: a timed one among them.  At 300
    bytes the histogram and the initial row outweigh the file."""
    root = copy_benchmark(tmp_path, TINY)
    result = run.run_cell(run.Manifest(root), "tiny.files", 2**31 + 21, 1.5, True, device="cpu")
    assert result["correct"] is True
    for name in ("enc.bus_bytes_per_byte", "dec.bus_bytes_per_byte"):
        m = result["metrics"][name]
        assert m["unit"] == "B/B" and m["value"] > 1.0, (name, m)
