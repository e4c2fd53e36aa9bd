"""The control of a cell's check: the plain reference put in the program's
place, its interval split's quotient computed in float32, one precision
below the exact integer arithmetic both configurations state.  (float64
is no control here: at (8,30,32) in a 4096-symbol block with the prior
the split's products stay under 2**50, where a float64 quotient is exact.)

    python3 -m benchmark.control --workload NAME --seconds S --seeds S1 S2 S3

runs the cell once a seed (:func:`benchmark.run.run_cell`, untraced, a
window of ``S`` seconds) with ``api.encode`` replaced by the reference's
archive of the file (:func:`benchmark.reference.archives`, coded on card
0, under the configuration's ``encode`` settings as the check reads
them) and ``api.decode`` by that archive's input, and prints one JSON line a seed:
``correct`` and the check's numbers.  ``correct`` has to come out false.
The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from unittest import mock

import torch

from benchmark import gen, reference
from benchmark.run import Manifest, run_cell

CONTROL_QUOTIENT = reference.float_quotient(torch.float32)


def control_run(manifest: Manifest, name: str, seed: int, seconds: float, device="cuda",
                batch: int = 1 << 16) -> dict:
    """One run of cell ``name`` with the control in the program's place;
    ``device`` is where the control codes and the run's inputs are made.
    The control codes the mix's files once, together, before the run: its
    encode returns a file's archive, its decode that archive's input."""
    from redux_tpu_torch import api

    cell = manifest.cell(name)
    cfg = reference.Config(manifest.config(cell["config"]))
    datas = [f.data for f in gen.make_files(manifest.mix(cell["traffic"]), seed, device,
                                            manifest.content)]
    made = dict(zip(datas, reference.archives(datas, cfg, CONTROL_QUOTIENT, device, batch)))
    inputs = {id(a): d for d, a in made.items()}

    @functools.wraps(api.encode)  # the program's keywords, for the run's check of them
    def encode(data, **kw):
        return made[data]

    def decode(archive, **kw):
        return inputs[id(archive)]

    with mock.patch.object(api, "encode", encode), mock.patch.object(api, "decode", decode):
        return run_cell(manifest, name, seed, seconds, False, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=0.01)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    manifest = Manifest()
    for seed in args.seeds:
        t = time.perf_counter()
        r = control_run(manifest, args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "failed": r["failed"],
                          "check": {k: v["value"] for k, v in r["check"].items()},
                          "seconds": time.perf_counter() - t}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
