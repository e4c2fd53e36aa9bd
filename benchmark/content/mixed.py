"""``text_like`` where one 32 KiB segment in 32 carries an incompressible
stretch, offset from block starts: ``redux_tpu_torch/testdata.py``'s
``mixed``, byte for byte."""

from pathlib import Path

import torch

from benchmark.gen import kind, splitmix64

_SEGMENT = 1 << 15


def fill(out: torch.Tensor, seed: int) -> None:
    kind("text_like", Path(__file__).parent)(out, seed)
    seg, n = _SEGMENT, out.numel()
    for s0 in range(16 * seg, n, 32 * seg):
        a, b = min(s0 + 1000, n), min(s0 + seg - 1000, n)
        out[a:b] = (splitmix64(seed + 1 + s0 // seg, b - a, 0, out.device) & 0xFF).to(torch.uint8)
