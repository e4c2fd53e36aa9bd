"""A run driven end to end on the CPU, past the look for a card, with the
timed path broken underneath: ``correct`` comes out false for each fault
a cell can have, and true without one."""

from __future__ import annotations

from benchmark import run
from benchmark.tests.helpers import copy_benchmark
from redux_tpu_torch import api

SMALL = [{"name": "a", "bytes": 700, "content": "text_like"},
         {"name": "b", "bytes": 300, "content": "fax"}]
TWO_BLOCKS = [{"name": "a", "bytes": 5000, "content": "mixed"}]


def cell_run(tmp_path, files, device="cpu"):
    root = copy_benchmark(tmp_path, files)
    return run.run_cell(run.Manifest(root), "tiny.files", 2**31 + 9, 0.01, False, device=device)


def test_sound_run_is_correct(tmp_path):
    r = cell_run(tmp_path, SMALL)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert all(v["value"] == 0 for v in r["check"].values())
    assert list(r)[-1] == "check"


def test_decode_returning_its_input(tmp_path, monkeypatch):
    """A step that returns its state unchanged."""
    monkeypatch.setattr(api, "decode", lambda archive, **kw: archive)
    r = cell_run(tmp_path, SMALL)
    assert r["correct"] is False and r["check"]["decoded"]["value"] > 0


def test_half_the_input_left_out(tmp_path, monkeypatch):
    real = api.encode
    monkeypatch.setattr(api, "encode", lambda data, **kw: real(
        data[: len(data) // 2] + bytes(len(data) - len(data) // 2), **kw))
    r = cell_run(tmp_path, SMALL)
    assert r["correct"] is False and r["check"]["header"]["value"] > 0


def test_second_devices_fetch_left_out(tmp_path, monkeypatch):
    """The exchange between devices left out: the second device's shares
    never reach the result."""
    real_init, real_put = api._Fetch.__init__, api._Fetch.put

    def init(self, out, *a, **kw):
        real_init(self, out, *a, **kw)
        out._fetches = getattr(out, "_fetches", 0) + 1
        self.card = out._fetches - 1

    monkeypatch.setattr(api._Fetch, "__init__", init)
    monkeypatch.setattr(api._Fetch, "put",
                        lambda self, *a: None if self.card else real_put(self, *a))
    r = cell_run(tmp_path, TWO_BLOCKS, device=["cpu", "cpu"])
    assert r["correct"] is False
    assert r["check"]["decoded"]["value"] + r["check"]["streams"]["value"] + r["failed"] > 0


def test_answer_altered_where_it_is_made(tmp_path, monkeypatch):
    """A byte of each payload flipped by the splice that makes it."""
    real = api.splice_payload

    def splice(*a, **kw):
        out = real(*a, **kw).clone()
        out[out.numel() // 2] ^= 1
        return out

    monkeypatch.setattr(api, "splice_payload", splice)
    r = cell_run(tmp_path, SMALL)
    assert r["correct"] is False and r["failed"] > 0
