"""Words of a small vocabulary drawn with Zipf-like weights, with
punctuation: ``redux_tpu_torch/testdata.py``'s ``text_like``, byte for byte."""

import torch

from benchmark.gen import DRAWS, splitmix64, umod

_WORDS = (
    b"the of and to in a is that for it as was with be by on not he i this are "
    b"or his from at which but have an they you were her she there been one all "
    b"we their has would when if so no will more what can up out said about "
    b"into them some could time than only two may other then do new these first "
    b"any my now such like our over man me even most made after also did many"
).split()
_SEPS = (b" ", b" ", b" ", b" ", b" ", b" ", b", ", b". ", b".\n", b"\n\n")


def _token_table(device):
    tokens = [w + s for w in _WORDS for s in _SEPS]
    weights = [(4096 // (i + 1)) * (24 if j < 6 else 2)
               for i in range(len(_WORDS)) for j in range(len(_SEPS))]
    buf = torch.tensor(list(b"".join(tokens)), dtype=torch.uint8, device=device)
    tlen = torch.tensor([len(t) for t in tokens], dtype=torch.int64, device=device)
    toff = torch.cumsum(tlen, 0) - tlen
    lookup = torch.repeat_interleave(torch.arange(len(tokens), device=device),
                                     torch.tensor(weights, device=device))
    return buf, toff, tlen, lookup


def fill(out: torch.Tensor, seed: int) -> None:
    """Fill ``out`` (uint8, on its device) with the tokens of draws 0, 1,
    2, ... of ``seed``, cut where ``out`` ends."""
    dev = out.device
    buf, toff, tlen, lookup = _token_table(dev)
    have, start, n = 0, 0, out.numel()
    while have < n:
        m = min(DRAWS, (n - have) // 2 + 64)  # a token is 2-7 bytes
        idx = lookup[umod(splitmix64(seed, m, start, dev), lookup.numel())]
        start += m
        ls = tlen[idx]
        first = torch.repeat_interleave(toff[idx] - (torch.cumsum(ls, 0) - ls), ls)
        take = min(first.numel(), n - have)
        pos = torch.arange(take, dtype=torch.int64, device=dev)
        out[have : have + take] = buf[first[:take] + pos]
        have += take
