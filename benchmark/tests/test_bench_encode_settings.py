"""A configuration's ``encode`` object: keyword settings of ``api.encode``
that reach every encode call of a run, that the reference holds each
archive to, and that are refused before any call where the harness sets
the key itself or ``api.encode`` does not take it."""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import gen, reference, run
from benchmark.tests.helpers import REPO, copy_benchmark
from redux_tpu_torch import api
from redux_tpu_torch.params import Parameters

SETTINGS = {"block_size": 16384, "use_prior": False}
FILES = [{"name": "a", "bytes": 40_000, "content": "mixed"},
         {"name": "b", "bytes": 5000, "content": "fax"}]
SEED = 2**31 + 29


def config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


def header(archive):
    return reference._header_fields(archive)


@pytest.mark.parametrize("name", ["rxt-wide22", "rxt-ref30", "rxt-wide22-4card"])
def test_committed_configurations_keep_their_keywords(name):
    """No committed configuration has ``encode``: each gets exactly the
    parameters, ``delta`` and the prior's budget."""
    cfg = config(name)
    assert run.codec_kwargs(cfg) == dict(
        params=Parameters(cfg["symbol_bits"], cfg["freq_bits"], cfg["code_bits"]),
        delta=cfg["delta"], prior_budget=cfg["prior_budget"])


@pytest.fixture(scope="module")
def settings_run(tmp_path_factory):
    """A run on the CPU of a cell whose configuration carries
    :data:`SETTINGS`, with every ``api.encode`` call's keywords and archive
    kept."""
    root = copy_benchmark(tmp_path_factory.mktemp("bench"), FILES, encode=SETTINGS)
    calls = []
    real = api.encode

    @functools.wraps(real)
    def encode(data, **kw):
        arch = real(data, **kw)
        calls.append((data, kw, arch))
        return arch

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api, "encode", encode)
        result = run.run_cell(run.Manifest(root), "tiny.files", SEED, 0.01, False, device="cpu")
    return result, calls


def test_a_run_under_settings_is_correct(settings_run):
    result, _ = settings_run
    assert result["correct"] is True and result["failed"] == 0
    assert all(v["value"] == 0 for v in result["check"].values())


def test_settings_reach_every_encode_call(settings_run):
    """The warm-up's calls and the window's alike."""
    result, calls = settings_run
    assert len(calls) == result["attempted"]
    for _, kw, arch in calls:
        assert {k: kw[k] for k in SETTINGS} == SETTINGS and kw["device"] == "cpu"
        fields = header(arch)
        assert fields["block_size"] == 16384 and fields["flags"] == 0


def test_a_reference_not_told_the_settings_reads_the_header(settings_run):
    """The same archives against the configuration without ``encode``:
    4 KiB blocks and a prior from 4096 bytes, so each header differs."""
    _, calls = settings_run
    cfg = reference.Config(config("rxt-wide22"))
    for data, _, arch in calls[: len(FILES)]:
        got = reference.compare_files([(data, [arch], [data])], cfg, np.random.default_rng(0), 64)
        assert got["header"] > 0


@pytest.mark.parametrize("name", ["rxt-wide22", "rxt-ref30"])
def test_use_prior_true_under_4096_bytes(name):
    """``use_prior`` true gives a prior under ``prior_min_bytes``, in the
    program's archive and in the reference's alike."""
    cfg_file = dict(config(name), encode={"use_prior": True})
    cfg = reference.Config(cfg_file)
    data = gen.content("text_like", 700, 1, "cpu")
    arch = api.encode(data, device="cpu", **run.codec_kwargs(cfg_file))
    assert header(arch)["flags"] == 1
    assert reference.expected(data, cfg)["fields"]["flags"] == 1
    assert reference.archives([data], cfg) == [arch]
    got = reference.compare_files([(data, [arch], [api.decode(arch, device="cpu")])], cfg,
                                  np.random.default_rng(0), 64)
    assert got == dict.fromkeys(reference.NUMBERS, 0)


REFUSED = [{"delta": 8}, {"prior_budget": 4096}, {"params": None}, {"device": "cpu"},
           {"_timings": {}}, {"data": ""}, {"no_such_key": 1}]


@pytest.mark.parametrize("settings", REFUSED, ids=lambda s: next(iter(s)))
def test_a_key_the_harness_sets_or_encode_lacks_is_refused_before_any_call(
        tmp_path, monkeypatch, settings):
    root = copy_benchmark(tmp_path, FILES[1:], encode=settings)
    calls = []
    monkeypatch.setattr(api, "encode", lambda *a, **kw: calls.append("encode"))
    monkeypatch.setattr(api, "decode", lambda *a, **kw: calls.append("decode"))
    monkeypatch.setattr(gen, "make_files", lambda *a, **kw: calls.append("make_files"))
    with pytest.raises(SystemExit) as e:
        run.run_cell(run.Manifest(root), "tiny.files", SEED, 0.01, False, device="cpu")
    assert repr(next(iter(settings))) in str(e.value.code)
    assert calls == []


def test_a_refused_key_stops_the_command_with_its_name(tmp_path):
    """The command itself, with no card: exit code not 0, no result, and
    the key named on standard error."""
    root = copy_benchmark(tmp_path, FILES[1:], encode={"no_such_key": 1})
    env = {k: v for k, v in os.environ.items() if not k.startswith("REDUX_TPU")}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "tiny.files",
                          "--seed", "1", "--seconds", "1"],
                         cwd=root, capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "'no_such_key'" in out.stderr


def test_settings_the_reference_cannot_follow_are_refused():
    for bad in ({"block_size": "16384"}, {"block_size": 0}, {"use_prior": 1}):
        with pytest.raises(ValueError, match=next(iter(bad))):
            reference.Config(dict(config("rxt-wide22"), encode=bad))
