"""Golden archives for the card's machine, which has no JAX.

``tests/golden_torch/`` holds RXT v2 archives, a compact archive and a
bare reference-format stream made by the reference
(``scripts/make_golden_torch.py``) from inputs that
``redux_tpu_torch.testdata`` generates with integer arithmetic only.
These tests rebuild each golden with the reference (so the goldens cannot
go stale) and hold the port's CPU path to them; ``chip_smoke.py`` checks
the same goldens on the card's machine.
"""

import hashlib
import json
import pathlib

import pytest

from redux_tpu import api as ref_api
from redux_tpu import oracle as ref_oracle
from redux_tpu.models.fenwick import AdaptiveFenwickModel as RefFenwick
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch import api, container, native, oracle
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
    assert {e.get("format", "rxt") for e in MANIFEST} == {"rxt", "compact", "redux"}
    raw_any = False
    for e, f in zip(MANIFEST, files):
        assert e["input_len"] < 2 << 20
        fmt = e.get("format", "rxt")
        if fmt == "rxt":
            header, _ = container.parse_archive(f.read_bytes())
            assert header.orig_len == e["input_len"]
            assert (header.params.freq_bits, header.params.code_bits, header.delta) == (
                e["params"][1], e["params"][2], e["delta"])
            raw_any |= any(header.block_raw)
        elif fmt == "compact":
            params, delta, orig_len, _, _ = container.parse_compact(f.read_bytes())
            assert (orig_len, params.freq_bits, params.code_bits, delta) == (
                e["input_len"], e["params"][1], e["params"][2], e["delta"])
    assert raw_any


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_golden_archive(entry):
    data = golden_input(entry["kind"], entry["n"], entry["seed"])
    assert len(data) == entry["input_len"]
    assert hashlib.sha256(data).hexdigest() == entry["input_sha256"]
    stored = (GOLDEN / entry["file"]).read_bytes()
    params, rp = Parameters(*entry["params"]), RefParameters(*entry["params"])
    fmt = entry.get("format", "rxt")
    if fmt == "compact":
        ref = ref_api.encode_compact(data, entry["cfg"])
        mine, back = api.encode_compact(data, entry["cfg"]), api.decode_compact(stored)
    elif fmt == "redux":
        ref = ref_oracle.compress_bytes(data, RefFenwick(rp))
        mine, back = native.compress_bytes(data, params), native.decompress_bytes(stored, params)
        assert oracle.compress_bytes(data[: 1 << 12]) == ref_oracle.compress_bytes(data[: 1 << 12])
    else:
        ref = ref_api.encode(data, params=rp, delta=entry["delta"])
        mine = api.encode(data, params=params, delta=entry["delta"], device="cpu")
        back = api.decode(stored, device="cpu")
    assert ref == stored, "the reference no longer writes this golden"
    assert mine == stored
    assert back == data
    assert api.decode_auto(stored, params=params, device="cpu") == data
