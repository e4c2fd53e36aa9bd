"""MSB-first bit I/O over byte streams (host code).

Counterpart: ``redux_tpu/bitio.py`` (``BitReader``, ``BitWriter``,
``pack_bits``), the same semantics, which are the upstream library's
(``src/bitio/mod.rs``):

* MSB-first bit order within each byte;
* ``read_bits(n)`` returns ``n`` bits as an int, raises :class:`EofError`
  when the stream is exhausted and :class:`InvalidInputError` when ``n``
  exceeds the 64-bit word;
* ``write_bits(sym, n)`` rejects values wider than ``n``;
* ``flush_bits`` pads the final partial byte with trailing zeros;
* both count the bytes consumed from / emitted to the stream (``count``).

The sequential codec (:mod:`redux_tpu_torch.oracle`) reads and writes
through these; the kernels pack bits on the card.
"""

from __future__ import annotations

import io
from typing import BinaryIO

from .errors import EofError, InvalidInputError

_WORD_BITS = 64


class BitReader:
    """MSB-first bit reader over a byte stream."""

    __slots__ = ("_stream", "_bits", "_nbits", "count")

    def __init__(self, stream: BinaryIO):
        self._stream = stream
        self._bits = 0  # pending (unread) bits, right-aligned
        self._nbits = 0  # number of pending bits
        self.count = 0  # bytes consumed from the underlying stream

    def read_bits(self, bits: int) -> int:
        if bits > _WORD_BITS:
            raise InvalidInputError()
        # Whole bytes only as they are needed: the byte counter matches the
        # upstream reader's at every step.
        while self._nbits < bits:
            b = self._stream.read(1)
            if not b:
                raise EofError()
            self.count += 1
            self._bits = (self._bits << 8) | b[0]
            self._nbits += 8
        self._nbits -= bits
        result = self._bits >> self._nbits
        self._bits &= (1 << self._nbits) - 1
        return result


class BitWriter:
    """MSB-first bit writer over a byte stream."""

    __slots__ = ("_stream", "_bits", "_nbits", "count")

    def __init__(self, stream: BinaryIO):
        self._stream = stream
        self._bits = 0  # pending (unwritten) bits, right-aligned
        self._nbits = 0
        self.count = 0  # bytes emitted to the underlying stream

    def write_bits(self, symbol: int, bits: int) -> None:
        if bits > _WORD_BITS or (symbol >> bits) > 0:
            raise InvalidInputError()  # value wider than the field
        self._bits = (self._bits << bits) | symbol
        self._nbits += bits
        if self._nbits >= 8:
            nbytes, rem = divmod(self._nbits, 8)
            self._stream.write((self._bits >> rem).to_bytes(nbytes, "big"))
            self.count += nbytes
            self._nbits = rem
            self._bits &= (1 << rem) - 1

    def flush_bits(self) -> None:
        """Pad the final partial byte with trailing zeros and write it."""
        if self._nbits > 0:
            self._stream.write(bytes([(self._bits << (8 - self._nbits)) & 0xFF]))
            self.count += 1
            self._bits = 0
            self._nbits = 0


def pack_bits(bit_chunks) -> bytes:
    """Pack ``(value, nbits)`` chunks MSB-first into bytes, zero-padded:
    the chunks fed through :class:`BitWriter` and flushed."""
    buf = io.BytesIO()
    w = BitWriter(buf)
    for value, nbits in bit_chunks:
        w.write_bits(value, nbits)
    w.flush_bits()
    return buf.getvalue()
