"""About 94% zero bytes; the rest a run of 1-8 set bits at a drawn offset
in its byte, as black strokes on a scanned page at 1 bit a pixel."""

import torch

from benchmark.gen import DRAWS, lsr, splitmix64


def fill(out: torch.Tensor, seed: int) -> None:
    for a in range(0, out.numel(), DRAWS):
        b = min(a + DRAWS, out.numel())
        z = splitmix64(seed, b - a, a, out.device)
        ink = (z & 0xFF) < 16
        width = 1 + (lsr(z, 8) & 7)
        shift = lsr(z, 11) & 7
        run = (((1 << width) - 1) << shift) & 0xFF
        out[a:b] = torch.where(ink, run, 0).to(torch.uint8)
