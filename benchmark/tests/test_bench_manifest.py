"""BENCHMARK.json against the benchmark's contract, and the harness
finding configurations, mixes and metrics by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import gen
from benchmark.run import Manifest, Run
from benchmark.tests.helpers import REPO, copy_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 << 10


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(manifest, section):
    entries = manifest[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert set(e) - {"workloads"} == KEYS[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_cells_and_configs(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    configs = {c["name"] for c in manifest["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in manifest["workloads"]} == configs
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(1, len(cells) // 4)
    for c in manifest["configs"]:
        assert c["file"].startswith("benchmark/configs/") and c["reduced"] == []
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4)
        gen.load_mix(REPO / "benchmark" / "traffic" / f"{w['traffic']}.json")
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            mv = next(x for x in manifest["end_to_end"] if x["name"] == m["moves"])
            assert w in mv.get("workloads", [w])
    for w in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        assert len([m for m in manifest["end_to_end"] if w in m.get("workloads", [w])]) >= 2
        assert any(w in m["workloads"] for m in manifest["per_layer"])


def test_every_metric_has_a_reader(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_added_files_are_found_with_no_edit(tmp_path):
    """A new configuration, mix and per-layer metric go in as new files and
    new entries: the harness finds each by its name."""
    root = copy_benchmark(tmp_path, [{"name": "x", "bytes": 10, "content": "fax"}])
    cfg = json.loads((root / "benchmark/configs/rxt-wide22.json").read_text())
    cfg.update(name="rxt-new", delta=8)
    (root / "benchmark/configs/rxt-new.json").write_text(json.dumps(cfg))
    (root / "benchmark/metrics/calls_seen.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "rxt-new", "source": "x", "reduced": [], "why": "x",
                            "file": "benchmark/configs/rxt-new.json"})
    data["workloads"].append({"name": "new.cell", "config": "rxt-new", "traffic": "test-tiny.files",
                              "chips": 1, "why": "x"})
    data["per_layer"].append({"name": "calls_seen", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "api encode",
                              "moves": "encode_GBps", "workloads": ["new.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    m = Manifest(root)
    assert m.config("rxt-new")["delta"] == 8
    assert m.mix(m.cell("new.cell")["traffic"])["files"][0]["content"] == "fax"
    names = [x["name"] for x in m.metrics("new.cell", traced=True)]
    assert names == ["calls_seen"]
    run = Run(m.cell("new.cell"), m.config("rxt-new"), {}, 1)
    run.calls = [{}, {}]
    assert m.reader("calls_seen")(run) == 2
