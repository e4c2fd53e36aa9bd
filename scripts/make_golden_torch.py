"""Write the golden archives of tests/golden_torch/ with the reference package.

Each entry of ``tests/golden_torch/manifest.json`` names a generated input
(``redux_tpu_torch.testdata.golden_input``) and the encode settings; this
script encodes it with ``redux_tpu.api.encode`` and writes the archive.
Run from the repository root:

    JAX_PLATFORMS=cpu python scripts/make_golden_torch.py
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from redux_tpu import api  # noqa: E402
from redux_tpu.params import Parameters  # noqa: E402
from redux_tpu_torch.testdata import golden_input  # noqa: E402

GOLDEN = ROOT / "tests" / "golden_torch"


def main() -> None:
    manifest = json.loads((GOLDEN / "manifest.json").read_text())
    for entry in manifest:
        data = golden_input(entry["kind"], entry["n"], entry["seed"])
        assert hashlib.sha256(data).hexdigest() == entry["input_sha256"], entry["file"]
        arch = api.encode(data, params=Parameters(*entry["params"]), delta=entry["delta"])
        (GOLDEN / entry["file"]).write_bytes(arch)
        print(entry["file"], len(data), "->", len(arch))


if __name__ == "__main__":
    main()
