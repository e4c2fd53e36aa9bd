"""Seeded test inputs made with integer numpy arithmetic only.

The golden archives in ``tests/golden_torch/`` store only their archives,
so their inputs must come out bit-identical on any machine and numpy
version: everything here is a counter-based splitmix64 stream and integer
table lookups, with no numpy random generator.
"""

from __future__ import annotations

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)

# A small vocabulary with Zipf-like integer weights: skewed, text-like bytes.
_WORDS = (
    b"the of and to in a is that for it as was with be by on not he i this are "
    b"or his from at which but have an they you were her she there been one all "
    b"we their has would when if so no will more what can up out said about "
    b"into them some could time than only two may other then do new these first "
    b"any my now such like our over man me even most made after also did many"
).split()
_SEPS = (b" ", b" ", b" ", b" ", b" ", b" ", b", ", b". ", b".\n", b"\n\n")


def splitmix64(seed: int, n: int, start: int = 0) -> np.ndarray:
    """``n`` pseudo-random uint64 values: splitmix64 of counters
    ``seed * 2**32 + start + i``."""
    x = np.arange(start, start + n, dtype=np.uint64) + np.uint64((seed << 32) & (2**64 - 1))
    z = x * _GOLDEN + _GOLDEN
    z = (z ^ (z >> np.uint64(30))) * _M1
    z = (z ^ (z >> np.uint64(27))) * _M2
    return z ^ (z >> np.uint64(31))


def incompressible(n: int, seed: int) -> bytes:
    """``n`` uniform bytes."""
    return (splitmix64(seed, n) & np.uint64(0xFF)).astype(np.uint8).tobytes()


def text_like(n: int, seed: int) -> bytes:
    """``n`` bytes of words drawn with Zipf-like weights, with punctuation."""
    tokens = [w + s for w in _WORDS for s in _SEPS]
    weights = np.array(
        [(4096 // (i + 1)) * (24 if j < 6 else 2) for i in range(len(_WORDS))
         for j in range(len(_SEPS))], dtype=np.uint64)
    cum = np.cumsum(weights)
    buf = np.frombuffer(b"".join(tokens), dtype=np.uint8)
    tlen = np.array([len(t) for t in tokens], dtype=np.int64)
    toff = np.cumsum(tlen) - tlen
    out, have, start = [], 0, 0
    while have < n:
        m = (n - have) // 3 + 64
        r = splitmix64(seed, m, start) % cum[-1]
        start += m
        idx = np.searchsorted(cum, r, side="right")
        ls = tlen[idx]
        flat = np.repeat(toff[idx] - (np.cumsum(ls) - ls), ls) + np.arange(int(ls.sum()))
        out.append(buf[flat])
        have += int(ls.sum())
    return np.concatenate(out)[:n].tobytes()


def mixed(n: int, seed: int) -> bytes:
    """Text-like bytes where one 32 KiB segment in 32 (about 3%) carries an
    incompressible stretch, offset from block starts."""
    segment = 1 << 15
    data = bytearray(text_like(n, seed))
    for i, s0 in enumerate(range(0, n, segment)):
        if i % 32 == 16:
            a = min(s0 + 1000, n)
            b = min(s0 + segment - 1000, n)
            data[a:b] = incompressible(b - a, seed + 1 + i)
    return bytes(data)


def golden_input(kind: str, n: int, seed: int) -> bytes:
    """The input of a golden archive: ``text``, ``raw`` or ``run`` pieces
    joined as ``kind`` names them (e.g. ``"text+raw+run"``)."""
    parts = []
    for j, piece in enumerate(kind.split("+")):
        if piece == "text":
            parts.append(text_like(n, seed + j))
        elif piece == "raw":
            parts.append(incompressible(n // 4, seed + j))
        elif piece == "run":
            parts.append(bytes([0x61]) * (n // 4))
        else:
            raise ValueError(f"unknown golden piece {piece!r}")
    return b"".join(parts)
