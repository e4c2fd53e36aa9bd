"""The plain reference against the program's archives on the CPU, the
faults it must catch, and the control that it must reject."""

from __future__ import annotations

import json

import numpy as np
import pytest

import torch

from benchmark import control, gen, reference, run
from benchmark.tests.helpers import REPO, copy_benchmark
from redux_tpu_torch import api, oracle
from redux_tpu_torch.params import Parameters

CONFIGS = ["rxt-wide22", "rxt-ref30"]


def compare(data, archives, outputs, cfg, rng, sample):
    return reference.compare_files([(data, archives, outputs)], cfg, rng, sample)


def config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


def program(data, cfg):
    kw = dict(params=Parameters(cfg["symbol_bits"], cfg["freq_bits"], cfg["code_bits"]),
              delta=cfg["delta"], prior_budget=cfg["prior_budget"])
    arch = api.encode(data, device="cpu", **kw)
    return arch, api.decode(arch, device="cpu")


def inputs():
    return {
        "empty": b"",
        "short": gen.content("text_like", 700, 1, "cpu"),
        "mixed": (gen.content("mixed", 9000, 2, "cpu")
                  + gen.content("incompressible", 4096, 3, "cpu")),
        "fax": gen.content("fax", 5000, 4, "cpu"),
    }


@pytest.mark.parametrize("name", CONFIGS)
def test_block_coder_is_the_oracles(name):
    cfg = reference.Config(config(name))
    data = gen.content("mixed", 9000, 5, "cpu") + bytes(3000)
    want = reference.expected(data, cfg)
    blocks, lens = reference._rows(data, np.arange(want["fields"]["n_blocks"]), want["k"])
    got = reference.encode_blocks(blocks, lens, want["cum0"], cfg)
    p = Parameters(cfg.s, cfg.f, cfg.c)
    k = want["k"]
    for i, s in enumerate(got):
        assert s == oracle.compress_block(data[i * k : (i + 1) * k], p, want["cum0"], cfg.delta)


@pytest.mark.parametrize("name", CONFIGS)
def test_agrees_with_the_program(name):
    cfg = reference.Config(config(name))
    items = []
    for label, data in inputs().items():
        arch, out = program(data, config(name))
        got = compare(data, [arch, arch], [out], cfg, np.random.default_rng(0), 64)
        assert got == dict.fromkeys(reference.NUMBERS, 0), label
        items.append((data, [arch], [out]))
    # Every file's blocks in one batch, and one flipped stream byte among them.
    clean = dict.fromkeys(reference.NUMBERS, 0)
    assert reference.compare_files(items, cfg, np.random.default_rng(0), 64) == clean
    data, (arch,), outs = items[2]
    items[2] = (data, [_flip(arch, len(arch) - 5000)], outs)
    got = reference.compare_files(items, cfg, np.random.default_rng(0), 64)
    assert got == dict(clean, streams=1)


def test_sampled_blocks_include_the_longest_and_the_last():
    cfg = reference.Config(config("rxt-wide22"))
    data = gen.content("mixed", 40_000, 6, "cpu")
    arch, out = program(data, config("rxt-wide22"))
    got = compare(data, [arch], [out], cfg, np.random.default_rng(1), 2)
    assert got == dict.fromkeys(reference.NUMBERS, 0)


def _flip(b: bytes, i: int) -> bytes:
    x = bytearray(b)
    x[i] ^= 0x10
    return bytes(x)


def test_catches_each_fault():
    cfg = reference.Config(config("rxt-wide22"))
    data = inputs()["mixed"]
    arch, out = program(data, config("rxt-wide22"))
    table = np.frombuffer(arch, dtype="<u4", count=4, offset=32)
    raw = int(np.flatnonzero(table >= 1 << 31)[0])
    head = 32 + 16 + 512
    raw_off = head + int((table[:raw] & ((1 << 31) - 1)).sum())
    rng = lambda: np.random.default_rng(0)  # noqa: E731

    def check(a, o=out, more=()):
        return compare(data, [a, *more], [o], cfg, rng(), 64)

    assert check(_flip(arch, 9))["header"] == 1  # delta
    assert check(_flip(arch, 28))["header"] == 1  # crc
    assert check(_flip(arch, 32 + 16 + 3))["header"] == 1  # prior
    assert check(_flip(arch, 33))["table"] >= 1  # a block's length
    assert check(_flip(arch, head + 5))["streams"] == 1
    assert check(_flip(arch, raw_off + 5))["raw"] == 1
    assert check(arch, o=_flip(out, 100))["decoded"] == 1
    assert check(arch, more=[_flip(arch, head)])["repeats"] == 1
    assert check(arch[:20])["header"] > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_archive_is_the_programs(name):
    """The reference writes the program's archive byte for byte."""
    cfg = reference.Config(config(name))
    datas = list(inputs().values())
    want = [program(data, config(name))[0] for data in datas]
    assert reference.archives(datas, cfg, batch=3) == want


@pytest.mark.parametrize("name, encode", [
    pytest.param("rxt-wide22", None, id="rxt-wide22"),
    pytest.param("rxt-ref30", None, id="rxt-ref30"),
    pytest.param("rxt-wide22", {"block_size": 16384, "use_prior": False},
                 id="rxt-wide22-encode-settings"),
])
def test_control_is_rejected(tmp_path, name, encode):
    """The control, a whole run with the reference coding one precision
    below the configuration's in the program's place, at a size a test
    holds: ``correct`` comes out false, its streams differing; also where
    the configuration carries ``encode`` settings, under which the control
    builds its archives as the check reads them."""
    root = copy_benchmark(tmp_path, [{"name": "a", "bytes": 20_000, "content": "mixed"},
                                     {"name": "b", "bytes": 5000, "content": "fax"}], config=name,
                          encode=encode)
    r = control.control_run(run.Manifest(root), "tiny.files", 2**31 + 17, 0.01, device="cpu")
    assert r["correct"] is False and r["failed"] == 0
    assert r["check"]["streams"]["value"] > 0
    assert r["check"]["decoded"]["value"] == 0


def test_float64_is_exact_on_ref30_blocks():
    """Why the control is float32: at (8,30,32) in 4096-symbol blocks with
    the prior the split's products stay under 2**50, where float64 is exact."""
    cfg = reference.Config(config("rxt-ref30"))
    data = gen.content("text_like", 20_000, 8, "cpu")
    f64 = reference.archives([data], cfg, reference.float_quotient(torch.float64))
    assert f64 == reference.archives([data], cfg)
    assert reference.archives([data], cfg, control.CONTROL_QUOTIENT) != f64
