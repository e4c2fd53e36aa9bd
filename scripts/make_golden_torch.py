"""Write the golden archives of tests/golden_torch/ with the reference package.

Each entry of ``tests/golden_torch/manifest.json`` names a generated input
(``redux_tpu_torch.testdata.golden_input``), its format and the encode
settings; this script encodes it with the reference and writes the file:
``rxt`` (the default) with ``redux_tpu.api.encode``, ``compact`` with
``redux_tpu.api.encode_compact`` and ``redux`` (a bare reference-format
stream) with ``redux_tpu.oracle.compress_bytes``.  Run from the
repository root:

    JAX_PLATFORMS=cpu python scripts/make_golden_torch.py
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from redux_tpu import api, oracle  # noqa: E402
from redux_tpu.models.fenwick import AdaptiveFenwickModel  # noqa: E402
from redux_tpu.params import Parameters  # noqa: E402
from redux_tpu_torch.testdata import golden_input  # noqa: E402

GOLDEN = ROOT / "tests" / "golden_torch"


def main() -> None:
    manifest = json.loads((GOLDEN / "manifest.json").read_text())
    for entry in manifest:
        data = golden_input(entry["kind"], entry["n"], entry["seed"])
        assert hashlib.sha256(data).hexdigest() == entry["input_sha256"], entry["file"]
        params = Parameters(*entry["params"])
        fmt = entry.get("format", "rxt")
        if fmt == "compact":
            arch = api.encode_compact(data, entry["cfg"])
        elif fmt == "redux":
            arch = oracle.compress_bytes(data, AdaptiveFenwickModel(params))
        else:
            arch = api.encode(data, params=params, delta=entry["delta"])
        (GOLDEN / entry["file"]).write_bytes(arch)
        print(entry["file"], len(data), "->", len(arch))


if __name__ == "__main__":
    main()
