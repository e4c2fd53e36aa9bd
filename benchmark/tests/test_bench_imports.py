"""The run's guards: no JAX by whole top-level name, no result without
the cards a cell asks for or without the program beside it."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.helpers import REPO


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("redux_tpu_torch", "redux_tpu_torch.api", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in ("jax", "jaxlib", "flax", "redux_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "redux_tpu.api", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert run.forbidden_modules() == ["jaxlib", "redux_tpu"]


def test_the_harness_loads_no_jax():
    code = ("import sys, benchmark.run, benchmark.control, redux_tpu_torch.api;"
            "print(benchmark.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("REDUX_TPU")}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "wide22.mixed-1g",
                           "--seed", "1", "--seconds", "1", *extra],
                          cwd=cwd, capture_output=True, text=True, env=env, timeout=120)


def test_no_card_no_result():
    out = _run(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    """A short run of the smallest cell, where there is a card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "wide22.calgary-files", "--seed", "5", "--seconds", "2", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
