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
    z = np.arange(start, start + n, dtype=np.uint64)
    z += np.uint64((seed << 32) & (2**64 - 1))
    z *= _GOLDEN
    z += _GOLDEN
    tmp = np.empty_like(z)
    for shift, mul in ((30, _M1), (27, _M2), (31, None)):  # in place: no n-sized temporaries
        np.right_shift(z, np.uint64(shift), out=tmp)
        z ^= tmp
        if mul is not None:
            z *= mul
    return z


def incompressible(n: int, seed: int) -> bytes:
    """``n`` uniform bytes."""
    return (splitmix64(seed, n) & np.uint64(0xFF)).astype(np.uint8).tobytes()


# Counters a segment of ``text_like``: the transients stay near 50 MB
# whatever ``n`` is.
_SEGMENT = 1 << 20


def _token_table():
    """The tokens as one byte buffer, their offsets and lengths, and the
    draw-to-token table (token i for ``cum[i-1] <= r < cum[i]``: what
    ``np.searchsorted(cum, r, side="right")`` gives, by one lookup)."""
    tokens = [w + s for w in _WORDS for s in _SEPS]
    weights = np.array(
        [(4096 // (i + 1)) * (24 if j < 6 else 2) for i in range(len(_WORDS))
         for j in range(len(_SEPS))], dtype=np.int64)
    buf = np.frombuffer(b"".join(tokens), dtype=np.uint8)
    tlen = np.array([len(t) for t in tokens], dtype=np.int64)
    toff = np.cumsum(tlen) - tlen
    lookup = np.repeat(np.arange(len(tokens), dtype=np.int16), weights)
    return buf, toff, tlen, lookup


def _text_like_into(out: np.ndarray, seed: int) -> None:
    """Fill ``out`` (uint8) with the tokens of draws ``0, 1, 2, ...``
    (splitmix64 counters of ``seed``), cut where ``out`` ends, one segment
    of ``_SEGMENT`` counters at a time: the bytes do not depend on the cut."""
    buf, toff, tlen, lookup = _token_table()
    n, have, start = out.size, 0, 0
    while have < n:
        m = min(_SEGMENT, (n - have) // 3 + 64)  # a token is 2-7 bytes
        idx = lookup[splitmix64(seed, m, start) % np.uint64(lookup.size)]
        start += m
        ls = tlen[idx]
        cs = np.cumsum(ls)
        want = min(int(cs[-1]), n - have)
        take = int(np.searchsorted(cs, want)) + 1  # tokens that reach ``want`` bytes
        # Byte p of the segment is byte p - start(t) of its token t: a run of
        # +1 steps that jumps at each token start to the token's offset.
        first = toff[idx[:take]]
        step = np.ones(int(cs[take - 1]), dtype=np.int32)
        step[0] = first[0]
        step[cs[: take - 1]] = first[1:] - (first[:-1] + ls[: take - 1] - 1)
        out[have : have + want] = buf[np.cumsum(step, dtype=np.int32)[:want]]
        have += want


def text_like(n: int, seed: int) -> bytes:
    """``n`` bytes of words drawn with Zipf-like weights, with punctuation."""
    out = np.empty(n, dtype=np.uint8)
    _text_like_into(out, seed)
    return out.tobytes()


def mixed(n: int, seed: int) -> bytes:
    """Text-like bytes where one 32 KiB segment in 32 (about 3%) carries an
    incompressible stretch, offset from block starts."""
    segment = 1 << 15
    out = np.empty(n, dtype=np.uint8)
    _text_like_into(out, seed)
    for s0 in range(16 * segment, n, 32 * segment):  # segments 16, 48, 80, ...
        a = min(s0 + 1000, n)
        b = min(s0 + segment - 1000, n)
        out[a:b] = (splitmix64(seed + 1 + s0 // segment, b - a) & np.uint64(0xFF)).astype(np.uint8)
    return out.tobytes()


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
