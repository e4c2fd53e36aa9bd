"""The generator: the program's test inputs byte for byte, deterministic
per seed, at the stated sizes."""

from __future__ import annotations

import itertools
import json
import shutil

import numpy as np
import pytest

from benchmark import gen
from benchmark.tests.helpers import REPO
from redux_tpu_torch import testdata

SEEDS = (0, 7, 2**31 + 5, 2**33 + 1)


@pytest.mark.parametrize("n", [0, 1, 5, 1000, 70_000, (1 << 21) + 3])
@pytest.mark.parametrize("kind", ["text_like", "mixed", "incompressible"])
def test_kinds_are_the_programs_test_inputs(kind, n):
    for seed in SEEDS:
        assert gen.content(kind, n, seed, "cpu") == getattr(testdata, kind)(n, seed)


@pytest.mark.parametrize("kind", sorted(p.stem for p in gen.CONTENT.glob("*.py")))
def test_deterministic_per_seed(kind):
    a = gen.content(kind, 50_000, 3, "cpu")
    assert len(a) == 50_000
    assert a == gen.content(kind, 50_000, 3, "cpu")
    assert a != gen.content(kind, 50_000, 4, "cpu")


def test_fax_is_mostly_zero_bytes():
    a = np.frombuffer(gen.content("fax", 200_000, 9, "cpu"), dtype=np.uint8)
    assert 0.9 < (a == 0).mean() < 0.97


def test_unknown_kind_refused():
    with pytest.raises(ValueError):
        gen.content("pictures", 10, 1, "cpu")


def test_new_kind_is_found_with_no_edit(tmp_path):
    """A content kind goes in as a new file beside the others: a mix that
    names it loads, and its files are made by it."""
    where = tmp_path / "content"
    shutil.copytree(gen.CONTENT, where, ignore=shutil.ignore_patterns("__pycache__"))
    (where / "zeros_then_text.py").write_text(
        "from pathlib import Path\n"
        "from benchmark.gen import kind\n\n\n"
        "def fill(out, seed):\n"
        "    kind('text_like', Path(__file__).parent)(out, seed)\n"
        "    out[: out.numel() // 2] = 0\n")
    p = tmp_path / "m.json"
    p.write_text(json.dumps({"files": [{"name": "a", "bytes": 100, "content": "zeros_then_text"}]}))
    with pytest.raises(ValueError):
        gen.load_mix(p)
    (f,) = gen.make_files(gen.load_mix(p, where), 3, "cpu", where)
    assert f.data == bytes(50) + testdata.text_like(100, 3)[50:]


def test_calgary_mix_sizes():
    mix = gen.load_mix(REPO / "benchmark/traffic/calgary-files.json")
    assert len(mix["files"]) == 14
    assert sum(f["bytes"] for f in mix["files"]) == 3_141_622
    assert {f["name"]: f["content"] for f in mix["files"]}["pic"] == "fax"


def test_files_and_order():
    mix = {"order": "shuffle", "files": [{"name": "a", "bytes": 10, "content": "text_like"},
                                         {"name": "b", "bytes": 20, "content": "fax"},
                                         {"name": "c", "bytes": 0, "content": "mixed"}]}
    files = gen.make_files(mix, 5, "cpu")
    assert [len(f.data) for f in files] == [10, 20, 0]
    assert files[0].data == testdata.text_like(10, 5)
    first = list(itertools.islice(gen.file_order(mix, 5), 30))
    assert first == list(itertools.islice(gen.file_order(mix, 5), 30))
    assert all(sorted(first[i : i + 3]) == [0, 1, 2] for i in range(0, 30, 3))
    assert first != list(itertools.islice(gen.file_order(mix, 6), 30))
    fixed = dict(mix, order="fixed")
    assert list(itertools.islice(gen.file_order(fixed, 5), 6)) == [0, 1, 2, 0, 1, 2]


def test_bad_mix_refused(tmp_path):
    p = tmp_path / "m.json"
    p.write_text(json.dumps({"files": [{"name": "a", "bytes": 1, "content": "x"}]}))
    with pytest.raises(ValueError):
        gen.load_mix(p)
