"""The sequential arithmetic codec (host code): test oracle, reference-format
streams and RXT v2 block payloads.

Counterpart: ``redux_tpu/oracle.py`` (``Codec``, ``_ZeroPadBitReader``,
``compress_block``, ``decompress_block`` and the stream API ``compress``,
``decompress``, ``compress_bytes``, ``decompress_bytes``), the same state
machine as the upstream library's Witten–Neal–Cleary coder
(``src/codec.rs``):

* state: ``low``/``high``, ``pending`` (pending-bit count when encoding,
  the code value when decoding) and ``extra`` (bits still to drain or to
  prime);
* encode: narrow by ``low + range * bound // count``, then emit E1/E2 bits
  (each followed by the pending opposite bits) and count E3 straddles;
  after the EOF symbol drain ``extra`` bits of ``low`` and pad to a byte;
* decode: prime ``code_bits`` bits, ``value = ((code - low + 1) * count -
  1) // range``, then renormalise as the encoder does, one bit a step.

Python integers are exact, so every product is exact for every legal
parameter set.  About 150 KB/s: large inputs go through
:mod:`redux_tpu_torch.native` or the kernels.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Optional, Tuple

from .bitio import BitReader, BitWriter
from .errors import EofError
from .models.base import Model
from .models.dense import DenseModel
from .models.fenwick import AdaptiveFenwickModel
from .params import Parameters


class Codec:
    """Arithmetic coder engine over one model."""

    def __init__(self, model: Model):
        p = model.params
        self.low = p.code_min
        self.high = p.code_max
        self.pending = 0
        self.extra = p.code_bits
        self.model = model

    # -- encode ------------------------------------------------------------

    def _put_bit(self, bit: bool, output: BitWriter) -> None:
        """Emit a bit, then the pending bits opposite to it."""
        output.write_bits(1 if bit else 0, 1)
        if self.pending:
            opp = 0 if bit else 1
            for _ in range(self.pending):
                output.write_bits(opp, 1)
            self.pending = 0

    def compress_symbol(self, symbol: int, output: BitWriter) -> None:
        p = self.model.params
        count = self.model.total_frequency()
        low_f, high_f = self.model.get_frequency(symbol)
        rng = self.high - self.low + 1
        self.high = self.low + (rng * high_f) // count - 1
        self.low = self.low + (rng * low_f) // count

        is_eof = symbol == p.symbol_eof
        while True:
            if self.high < p.code_half:  # E1
                self._put_bit(False, output)
                if is_eof:
                    self.extra -= 1
            elif self.low >= p.code_half:  # E2
                self._put_bit(True, output)
                if is_eof:
                    self.extra -= 1
            elif self.low >= p.code_one_fourth and self.high < p.code_three_fourths:  # E3
                self.pending += 1
                self.low -= p.code_one_fourth
                self.high -= p.code_one_fourth
                if is_eof:
                    self.extra -= 1
            else:
                break
            self.high = ((self.high << 1) + 1) & p.code_max
            self.low = (self.low << 1) & p.code_max

        if is_eof:
            # Drain `extra` disambiguation bits from low, then pad.
            while self.extra > 0:
                self._put_bit((self.low & p.code_half) != 0, output)
                self.low = (self.low << 1) & p.code_max
                self.extra -= 1
            output.flush_bits()

    def compress_stream(self, input: BitReader, output: BitWriter) -> None:
        p = self.model.params
        while True:
            try:
                symbol = input.read_bits(p.symbol_bits)
            except EofError:
                symbol = p.symbol_eof  # the input ended: code the EOF symbol
            self.compress_symbol(symbol, output)
            if symbol == p.symbol_eof:
                break

    # -- decode ------------------------------------------------------------

    def _get_bit(self, input: BitReader) -> None:
        self.pending = (self.pending << 1) | input.read_bits(1)

    def decompress_symbol(self, input: BitReader) -> int:
        p = self.model.params
        while self.extra > 0:  # prime code_bits bits
            self._get_bit(input)
            self.extra -= 1

        rng = self.high - self.low + 1
        count = self.model.total_frequency()
        value = ((self.pending - self.low + 1) * count - 1) // rng
        symbol, low_f, high_f = self.model.get_symbol(value)
        self.high = self.low + (rng * high_f) // count - 1
        self.low = self.low + (rng * low_f) // count

        if symbol == p.symbol_eof:
            return symbol

        while True:
            if self.high < p.code_half:  # E1
                pass
            elif self.low >= p.code_half:  # E2
                self.pending -= p.code_half
                self.low -= p.code_half
                self.high -= p.code_half
            elif self.low >= p.code_one_fourth and self.high < p.code_three_fourths:  # E3
                self.pending -= p.code_one_fourth
                self.low -= p.code_one_fourth
                self.high -= p.code_one_fourth
            else:
                break
            self.low <<= 1
            self.high = (self.high << 1) + 1
            self._get_bit(input)

        return symbol

    def decompress_stream(self, input: BitReader, output: BitWriter) -> None:
        p = self.model.params
        while True:
            symbol = self.decompress_symbol(input)
            if symbol == p.symbol_eof:
                break
            output.write_bits(symbol, p.symbol_bits)

    def decompress_symbols(self, input: BitReader, n: int) -> bytes:
        """Decode exactly ``n`` data symbols (stored-length termination: the
        EOF symbol is never decoded)."""
        out = bytearray()
        for _ in range(n):
            out.append(self.decompress_symbol(input))
        return bytes(out)


# -- RXT v2 block payloads ---------------------------------------------------
#
# A v2 block payload differs from a reference stream in two ways, both
# possible because the container stores each block's symbol count:
#
# * no EOF symbol and no code_bits drain: the decoder stops after the
#   stored count;
# * a 2-bit terminator: after the last symbol's renormalisation the interval
#   has high - low + 1 > quarter and low < half <= high, so
#   tq = ceil(low / quarter) is in {0, 1, 2} and V = tq * quarter (2 bits,
#   zero tail) lies in [low, high]; the decoder reads zeros past the end of
#   the stream, so its code value is exactly V.
#
# ``delta`` generalises the +1 adaptation.  These are the sequential
# oracles of the kernels' streams.


class _ZeroPadBitReader:
    """BitReader that returns zero bits past the end of the stream.

    The v2 decoder reads past the payload (priming, and the terminator's
    zero tail); the container guards real truncation with its stored
    lengths and checksum instead.
    """

    def __init__(self, stream: BinaryIO):
        self._r = BitReader(stream)

    def read_bits(self, bits: int) -> int:
        try:
            return self._r.read_bits(bits)
        except EofError:
            return 0


def compress_block(
    data: bytes,
    params: Parameters,
    init_cum=None,
    delta: int = 1,
) -> bytes:
    """Encode one v2 block payload sequentially (the kernels' oracle)."""
    model = DenseModel(params, init_cum, delta)
    codec = Codec(model)
    out = io.BytesIO()
    writer = BitWriter(out)
    for b in data:
        codec.compress_symbol(b, writer)
    p = params
    # Terminator tq = ceil(low / quarter) in {0, 1, 2}: 2 bits, the
    # pending bits flushed after the first.
    tq = (codec.low + p.code_one_fourth - 1) // p.code_one_fourth
    codec._put_bit((tq >> 1) != 0, writer)
    codec._put_bit((tq & 1) != 0, writer)
    writer.flush_bits()
    return out.getvalue()


def decompress_block(
    payload: bytes,
    n_symbols: int,
    params: Parameters,
    init_cum=None,
    delta: int = 1,
) -> bytes:
    """Decode one v2 block payload of ``n_symbols`` bytes sequentially."""
    model = DenseModel(params, init_cum, delta)
    codec = Codec(model)
    reader = _ZeroPadBitReader(io.BytesIO(payload))
    out = bytearray()
    for _ in range(n_symbols):
        out.append(codec.decompress_symbol(reader))
    return bytes(out)


# -- the stream API (the upstream library's compress/decompress) ------------


def compress(
    istream: BinaryIO, ostream: BinaryIO, model: Optional[Model] = None
) -> Tuple[int, int]:
    """Compress ``istream`` into ``ostream``; returns ``(bytes_in, bytes_out)``.

    The default model is the reference CLI's: the Fenwick model at
    ``Parameters(8, 30, 32)``.
    """
    if model is None:
        model = AdaptiveFenwickModel(Parameters.default())
    codec = Codec(model)
    reader = BitReader(istream)
    writer = BitWriter(ostream)
    codec.compress_stream(reader, writer)
    return (reader.count, writer.count)


def decompress(
    istream: BinaryIO, ostream: BinaryIO, model: Optional[Model] = None
) -> Tuple[int, int]:
    """Decompress ``istream`` into ``ostream``; returns ``(bytes_in, bytes_out)``."""
    if model is None:
        model = AdaptiveFenwickModel(Parameters.default())
    codec = Codec(model)
    reader = BitReader(istream)
    writer = BitWriter(ostream)
    codec.decompress_stream(reader, writer)
    return (reader.count, writer.count)


def compress_bytes(data: bytes, model: Optional[Model] = None) -> bytes:
    """Compress an in-memory buffer into a reference-format stream."""
    out = io.BytesIO()
    compress(io.BytesIO(data), out, model)
    return out.getvalue()


def decompress_bytes(data: bytes, model: Optional[Model] = None) -> bytes:
    """Decompress a reference-format stream held in memory."""
    out = io.BytesIO()
    decompress(io.BytesIO(data), out, model)
    return out.getvalue()
