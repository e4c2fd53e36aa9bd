"""A copy of the benchmark in a temporary directory, with a tiny cell
added as data files: what a later change adds, found with no edit."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[2]


def copy_benchmark(tmp: Path, files: list[dict], config: str = "rxt-wide22",
                   name: str = "tiny.files", order: str = "shuffle",
                   encode: Optional[dict] = None) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and ``benchmark/``, with a cell
    ``name`` over a traffic mix of ``files`` (name, bytes, content) that
    every metric with a cell list also lists; ``encode``, where given, is
    the copied configuration's ``encode`` object."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if encode is not None:
        path = tmp / "benchmark" / "configs" / f"{config}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), encode=encode)))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    traffic = f"test-{name}"
    (tmp / "benchmark" / "traffic" / f"{traffic}.json").write_text(
        json.dumps({"order": order, "files": files}))
    manifest["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                  "chips": 1, "why": "a test cell"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp
