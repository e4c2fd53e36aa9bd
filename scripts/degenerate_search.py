"""Search for an input on which the v2 coder narrows to an empty interval.

    python scripts/degenerate_search.py [--budget SECONDS] [--seed N]

Where such an input can exist: after renormalisation the coder's range is
at least ``2**(code_bits - 2) + 2``, which at code_bits = freq_bits + 2 is
``2**freq_bits + 2``.  The model's total stops growing once it reaches
``freq_max = 2**freq_bits - 1``, but the last ``+delta`` can overshoot it:
the frozen total is ``freq_max + delta - r`` with
``r = (freq_max - init_total) % delta`` (``r`` > 0).  Only when that total
exceeds the least range can a symbol of frequency 1 narrow to nothing,
``floor(range * lo / total) == floor(range * (lo + 1) / total)``.  With the
uniform row (init_total 257) and every delta that divides
``2**20 - 256`` (1, 2, 4, 8, 12, 16, 32, 64: every compact config) the
frozen total is at most ``2**20 + 1``: never.  With delta 255 it is
``2**20 + 241``.

The search: (8,20,22), uniform row, delta 255 (``api.encode(...,
use_prior=False, delta=255)``, one block).  A text prefix drives the model
to its freeze (4112 symbols); from there, with the model frozen, a
depth-limited search over continuations of the prefix's own bytes looks
for a coder state where some byte absent from the block (frequency 1)
narrows to an empty interval.  Prints the input's recipe as JSON
(``testdata.text_like`` prefix length and seed, the continuation, the
byte) and the oracle's state at that step.  Stops at the first hit or at
the time budget.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from redux_tpu_torch.models.dense import DenseModel  # noqa: E402
from redux_tpu_torch.oracle import Codec  # noqa: E402
from redux_tpu_torch.params import Parameters  # noqa: E402
from redux_tpu_torch.testdata import text_like  # noqa: E402

PARAMS = Parameters.tpu_wide()
DELTA = 255


class _NullWriter:
    def write_bits(self, symbol, bits):
        pass

    def flush_bits(self):
        pass


def _narrow(low, high, lo, hi, count, p):
    """One coder step (``oracle.Codec.compress_symbol`` without output):
    the narrowed and renormalised ``(low, high)``, or None for an empty
    interval."""
    rng = high - low + 1
    high = low + rng * hi // count - 1
    low = low + rng * lo // count
    if high < low:
        return None
    while True:
        if high < p.code_half:
            pass
        elif low >= p.code_half:
            low -= p.code_half
            high -= p.code_half
        elif low >= p.code_one_fourth and high < p.code_three_fourths:
            low -= p.code_one_fourth
            high -= p.code_one_fourth
        else:
            return low, high
        high = (high << 1) + 1
        low <<= 1


def frozen_state(prefix: bytes):
    """Code ``prefix`` with the block model; return the coder's
    ``(low, high)``, the frozen row and whether the model froze."""
    model = DenseModel(PARAMS, None, DELTA)
    codec = Codec(model)
    w = _NullWriter()
    for b in prefix:
        codec.compress_symbol(b, w)
    return codec.low, codec.high, [int(x) for x in model.cum], \
        model.total_frequency() >= PARAMS.freq_max


def search(budget: float, seed: int, depth: int = 3):
    p = PARAMS
    n_freeze = -(-(p.freq_max - 257) // DELTA)
    text = text_like(n_freeze + 4000, seed)
    t_end = time.monotonic() + budget
    n = n_freeze
    low, high, cum, frozen = frozen_state(text[:n])
    assert frozen
    count = cum[-1]
    steer = sorted({b for b in text[:n]})
    absent = [b for b in range(256) if b not in steer]
    while time.monotonic() < t_end and n < len(text) - depth:
        stack = [(low, high, ())]
        while stack:
            lw, hg, path = stack.pop()
            if hg - lw + 1 < count:
                for b in absent:
                    if _narrow(lw, hg, cum[b], cum[b + 1], count, p) is None:
                        return {"seed": seed, "prefix": n, "continuation": list(path),
                                "byte": b, "low": lw, "high": hg, "total": count}
            if len(path) < depth:
                for s in steer:
                    nxt = _narrow(lw, hg, cum[s], cum[s + 1], count, p)
                    stack.append((*nxt, path + (s,)))
        # No hit from this root: one more prefix byte.
        low, high = _narrow(low, high, cum[text[n]], cum[text[n] + 1], count, p)
        n += 1
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budget", type=float, default=120.0, help="seconds")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    t0 = time.monotonic()
    hit = search(args.budget, args.seed)
    print(json.dumps({"hit": hit, "seconds": round(time.monotonic() - t0, 3),
                      "params": [PARAMS.symbol_bits, PARAMS.freq_bits, PARAMS.code_bits],
                      "delta": DELTA}))
    return 0 if hit else 1


if __name__ == "__main__":
    sys.exit(main())
