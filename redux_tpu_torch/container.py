"""RXT block-parallel archive format, version 2.

Counterpart: ``redux_tpu/container.py`` (``build_archive``,
``parse_archive``, ``compute_crc``, ``verify_crc``, ``is_rxt_archive``, and
the compact single-block format at the end of this module), byte for byte.

Layout (all integers little-endian):

====== ====== ==========================================================
offset size   field
====== ====== ==========================================================
0      4      magic ``b"RXT1"``
4      1      version (2)
5      1      flags: bit0 = has_prior
6      1      symbol_bits
7      1      freq_bits
8      1      code_bits
9      1      delta: adaptation increment (1..255)
10     2      reserved (0)
12     4      block_size: symbols per block
16     8      orig_len: total decoded byte count
24     4      n_blocks
28     4      crc32 (zlib) of the original data
32     4*n    per-block stream byte lengths (top bit: stored raw)
...    512    warm-start prior: 256 x u16 extra counts (if has_prior)
...    —      payload: concatenated per-block streams
====== ====== ==========================================================
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import List, Optional

import numpy as np

from .errors import InvalidInputError
from .params import Parameters

MAGIC = b"RXT1"
VERSION = 2
FLAG_PRIOR = 1
HEADER_BYTES = 32

DEFAULT_BLOCK_SIZE = 1 << 12
DEFAULT_DELTA = 16
DEFAULT_PRIOR_BUDGET = 1 << 17

RAW_BIT = 1 << 31  # stored-length top bit: block stored raw (uncompressed)


@dataclasses.dataclass(frozen=True)
class ArchiveHeader:
    params: Parameters
    block_size: int
    orig_len: int
    block_byte_lens: List[int]
    prior_extra: Optional[np.ndarray]  # (256,) int64 extra counts, or None
    delta: int = 1
    crc32: int = 0
    block_raw: tuple = ()
    # Absolute archive offset of each block's payload bytes, (n_blocks,) int64.
    stream_offs: Optional[np.ndarray] = None

    @property
    def n_blocks(self) -> int:
        return len(self.block_byte_lens)

    @property
    def block_lens(self) -> List[int]:
        """Per-block symbol counts derived from orig_len and block_size."""
        out = []
        remaining = self.orig_len
        for _ in range(self.n_blocks):
            n = min(self.block_size, remaining)
            out.append(n)
            remaining -= n
        return out


def build_archive(
    header_params: Parameters,
    block_size: int,
    orig_len: int,
    block_streams: List[bytes],
    prior_extra: Optional[np.ndarray],
    delta: int = 1,
    crc: int = 0,
    block_raw: Optional[List[bool]] = None,
    payload: Optional[bytes] = None,
    stream_lens: Optional[List[int]] = None,
) -> bytes:
    """Serialize an RXT v2 archive.

    Per-block bytes come either as ``block_streams`` or as one joined
    ``payload`` with ``stream_lens``.
    """
    p = header_params
    if not 1 <= delta <= 255:
        raise InvalidInputError()
    if payload is not None:
        if stream_lens is None or sum(stream_lens) != len(payload):
            raise InvalidInputError()
        n_streams = len(stream_lens)
    else:
        stream_lens = [len(s) for s in block_streams]
        n_streams = len(block_streams)
    flags = FLAG_PRIOR if prior_extra is not None else 0
    head = bytearray()
    head += MAGIC
    head += struct.pack(
        "<BBBBBB2x", VERSION, flags, p.symbol_bits, p.freq_bits, p.code_bits, delta
    )
    head += struct.pack("<IQII", block_size, orig_len, n_streams, crc)
    raw = block_raw or [False] * n_streams
    lens = [n | (RAW_BIT if r else 0) for n, r in zip(stream_lens, raw)]
    head += struct.pack(f"<{n_streams}I", *lens)
    if prior_extra is not None:
        if prior_extra.shape != (256,) or prior_extra.max(initial=0) > 0xFFFF:
            raise InvalidInputError()
        head += prior_extra.astype("<u2").tobytes()
    return bytes(head) + (payload if payload is not None else b"".join(block_streams))


def header_bytes(n_blocks: int, has_prior: bool) -> int:
    """Bytes of an archive before its payload."""
    return HEADER_BYTES + 4 * n_blocks + (512 if has_prior else 0)


def write_header(
    dst,
    header_params: Parameters,
    block_size: int,
    orig_len: int,
    prior_extra: Optional[np.ndarray],
    delta: int,
    crc: int,
    block_raw: np.ndarray,
    stream_lens: np.ndarray,
) -> int:
    """Write the bytes :func:`build_archive` puts before the payload into
    the start of ``dst`` (a writable buffer) and return their count
    (:func:`header_bytes`).  ``block_raw`` and ``stream_lens`` are arrays,
    one entry a block; the block table is written by numpy, not a Python
    value a block."""
    p = header_params
    lens = np.asarray(stream_lens, dtype=np.int64)
    raw = np.asarray(block_raw, dtype=bool)
    if not 1 <= delta <= 255 or raw.shape != lens.shape or lens.ndim != 1:
        raise InvalidInputError()
    if lens.size and (lens.min() < 0 or lens.max() >= RAW_BIT):
        raise InvalidInputError()
    if prior_extra is not None and (
            prior_extra.shape != (256,) or prior_extra.max(initial=0) > 0xFFFF):
        raise InvalidInputError()
    n_streams = lens.size
    size = header_bytes(n_streams, prior_extra is not None)
    out = np.frombuffer(dst, dtype=np.uint8, count=size)
    flags = FLAG_PRIOR if prior_extra is not None else 0
    out[:4] = np.frombuffer(MAGIC, dtype=np.uint8)
    struct.pack_into("<BBBBBB2xIQII", out, 4, VERSION, flags, p.symbol_bits, p.freq_bits,
                     p.code_bits, delta, block_size, orig_len, n_streams, crc)
    table = out[HEADER_BYTES : HEADER_BYTES + 4 * n_streams].view("<u4")
    table[:] = lens.astype(np.uint32) | (raw.astype(np.uint32) << 31)
    if prior_extra is not None:
        out[size - 512 : size].view("<u2")[:] = prior_extra.astype("<u2")
    return size


def max_decoded_len(params: Parameters, payload_bytes: int) -> int:
    """Upper bound on symbols decodable from a payload of that many bytes.

    A frozen model at ``freq_max`` still costs each symbol at least
    ``(S-1)/(freq_max*ln2)`` bits; ``freq_max >> symbol_bits`` plus one
    symbols per bit bounds that with margin.  Headers claiming more are
    corrupt.
    """
    per_bit = (params.freq_max >> (params.symbol_bits)) + 1
    return 8 * payload_bytes * per_bit


def parse_archive(
    archive: bytes, with_streams: bool = True
) -> tuple[ArchiveHeader, Optional[List[bytes]]]:
    """Parse an RXT archive into its header and per-block payload streams.

    ``with_streams=False`` skips the per-block bytes list (decoders gather
    payload slices through ``header.stream_offs``).
    """
    if len(archive) < HEADER_BYTES or archive[:4] != MAGIC:
        raise InvalidInputError()
    version, flags, sb, fb, cb, delta = struct.unpack_from("<BBBBBB", archive, 4)
    if version != VERSION or delta < 1:
        raise InvalidInputError()
    # The container is byte-oriented: the kernels' model rows hold 257 symbols.
    if sb != 8:
        raise InvalidInputError()
    block_size, orig_len, n_blocks, crc = struct.unpack_from("<IQII", archive, 12)
    params = Parameters(sb, fb, cb)
    off = HEADER_BYTES
    if len(archive) < off + 4 * n_blocks:
        raise InvalidInputError()
    packed = struct.unpack_from(f"<{n_blocks}I", archive, off)
    byte_lens = [n & ~RAW_BIT for n in packed]
    block_raw = tuple(bool(n & RAW_BIT) for n in packed)
    off += 4 * n_blocks
    prior = None
    if flags & FLAG_PRIOR:
        if len(archive) < off + 512:
            raise InvalidInputError()
        prior = (
            np.frombuffer(archive, dtype="<u2", count=256, offset=off)
            .astype(np.int64)
            .copy()
        )
        off += 512
    lens_np = np.asarray(byte_lens, dtype=np.int64)
    offs = off + np.cumsum(lens_np) - lens_np  # exclusive prefix (empty-safe)
    total = int(lens_np.sum())
    if len(archive) < off + total:
        raise InvalidInputError()
    off += total
    streams = (
        [archive[o : o + n] for o, n in zip(offs, byte_lens)]
        if with_streams
        else None
    )
    header = ArchiveHeader(
        params, block_size, orig_len, byte_lens, prior, delta, crc, block_raw,
        offs,
    )
    if block_size == 0 and orig_len > 0:
        raise InvalidInputError()
    expect_blocks = (orig_len + block_size - 1) // block_size if orig_len else 0
    if expect_blocks != n_blocks:
        raise InvalidInputError()
    if orig_len > max_decoded_len(params, sum(byte_lens)) + HEADER_BYTES * 8:
        raise InvalidInputError()
    return header, streams


def verify_crc(header: ArchiveHeader, data: bytes) -> None:
    """Raise InvalidInputError if decoded ``data`` fails the stored crc32."""
    if zlib.crc32(data) & 0xFFFFFFFF != header.crc32:
        raise InvalidInputError()


def compute_crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def is_rxt_archive(data: bytes) -> bool:
    return data[:4] == MAGIC


# ---------------------------------------------------------------------------
# The compact single-block archive ("RXT compact").
#
# The 32-byte header and 4-byte block length above would erase the coding
# win on small inputs.  The compact archive frames ONE v2 block payload
# with a 5-7 byte header:
#
#   [0xB3][ver<<4 | cfg][varint orig_len][crc16][payload]
#
# cfg indexes COMPACT_CONFIGS (params and adaptation delta; uniform init:
# a 512-byte prior never pays at these sizes).  crc16 is the low half of
# the zlib crc32 that the block archive stores.
# ---------------------------------------------------------------------------

COMPACT_MAGIC = 0xB3
COMPACT_VERSION = 1
# (freq_bits, code_bits, delta) at symbol_bits 8; index = wire cfg id.
COMPACT_CONFIGS = [
    (20, 22, 2), (20, 22, 4), (20, 22, 8), (20, 22, 12),
    (20, 22, 16), (20, 22, 32), (20, 22, 1), (20, 22, 64),
]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_varint(data: bytes, off: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if off >= len(data) or shift > 56:
            raise InvalidInputError()
        b = data[off]
        off += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, off


def compact_config(cfg: int) -> tuple[Parameters, int]:
    """``(params, delta)`` of a compact cfg id; InvalidInputError if unknown."""
    if not 0 <= cfg < len(COMPACT_CONFIGS):
        raise InvalidInputError()
    fb, cb, delta = COMPACT_CONFIGS[cfg]
    return Parameters(8, fb, cb), delta


def build_compact(cfg: int, orig_len: int, payload: bytes, crc: int) -> bytes:
    compact_config(cfg)  # validates
    head = bytes([COMPACT_MAGIC, (COMPACT_VERSION << 4) | cfg])
    head += _varint(orig_len)
    head += struct.pack("<H", crc & 0xFFFF)
    return head + payload


def is_compact_archive(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == COMPACT_MAGIC


def parse_compact(archive: bytes) -> tuple[Parameters, int, int, int, bytes]:
    """-> ``(params, delta, orig_len, crc16, payload)``; raises
    InvalidInputError on a malformed header, and on an ``orig_len`` larger
    than the payload could carry (:func:`max_decoded_len`), which caps the
    work a crafted archive can demand."""
    if len(archive) < 4 or archive[0] != COMPACT_MAGIC:
        raise InvalidInputError()
    if archive[1] >> 4 != COMPACT_VERSION:
        raise InvalidInputError()
    params, delta = compact_config(archive[1] & 0x0F)
    orig_len, off = _read_varint(archive, 2)
    if len(archive) < off + 2:
        raise InvalidInputError()
    (crc16,) = struct.unpack_from("<H", archive, off)
    payload = archive[off + 2 :]
    if orig_len > max_decoded_len(params, len(payload)):
        raise InvalidInputError()
    return params, delta, orig_len, crc16, payload


def verify_crc16(crc16: int, data: bytes) -> None:
    """Raise InvalidInputError if ``data`` fails the compact archive's crc16."""
    if zlib.crc32(data) & 0xFFFF != crc16:
        raise InvalidInputError()
