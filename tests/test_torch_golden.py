"""Golden archives for the card's machine, which has no JAX.

``tests/golden_torch/`` holds RXT v2 archives made by the reference
(``scripts/make_golden_torch.py``) from inputs that
``redux_tpu_torch.testdata`` generates with integer arithmetic only.
These tests rebuild each golden with the reference (so the goldens cannot
go stale) and hold the port's CPU path to them; ``chip_smoke.py`` checks
the same goldens on the card.
"""

import hashlib
import json
import pathlib

import pytest

from redux_tpu import api as ref_api
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch import api, container
from redux_tpu_torch.params import Parameters
from redux_tpu_torch.testdata import golden_input

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden_torch"
MANIFEST = json.loads((GOLDEN / "manifest.json").read_text())


def test_goldens_are_small_and_cover_the_mix():
    files = [GOLDEN / e["file"] for e in MANIFEST]
    assert sum(f.stat().st_size for f in files) < 512 << 10
    kinds = "+".join(e["kind"] for e in MANIFEST)
    assert {"text", "raw", "run"} <= set(kinds.split("+"))
    assert {tuple(e["params"]) for e in MANIFEST} >= {(8, 20, 22), (8, 15, 17)}
    raw_any = False
    for e, f in zip(MANIFEST, files):
        header, _ = container.parse_archive(f.read_bytes())
        assert e["input_len"] < 2 << 20 and header.orig_len == e["input_len"]
        raw_any |= any(header.block_raw)
    assert raw_any


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_golden_archive(entry):
    data = golden_input(entry["kind"], entry["n"], entry["seed"])
    assert len(data) == entry["input_len"]
    assert hashlib.sha256(data).hexdigest() == entry["input_sha256"]
    stored = (GOLDEN / entry["file"]).read_bytes()
    ref = ref_api.encode(data, params=RefParameters(*entry["params"]), delta=entry["delta"])
    assert ref == stored, "the reference no longer writes this golden"
    mine = api.encode(data, params=Parameters(*entry["params"]), delta=entry["delta"],
                      device="cpu")
    assert mine == stored
    assert api.decode(stored, device="cpu") == data
