"""Uniform bytes: ``redux_tpu_torch/testdata.py``'s ``incompressible``,
byte for byte."""

import torch

from benchmark.gen import DRAWS, splitmix64


def fill(out: torch.Tensor, seed: int) -> None:
    for a in range(0, out.numel(), DRAWS):
        b = min(a + DRAWS, out.numel())
        out[a:b] = (splitmix64(seed, b - a, a, out.device) & 0xFF).to(torch.uint8)
