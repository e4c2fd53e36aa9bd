"""S1-S3 — the main path's data on the card around K1-K3.

Counterpart: the host code of ``redux_tpu/api.py`` that stages the
kernels' data (the reference did this on the host because of its TPU's
host tunnel, not because the contract needs it): ``_gather_slices``
(:141-168) with decode's ``_stage`` (:460-476) and raw splice (:563-570),
encode's payload assembly (:357-399), and ``container.compute_crc`` /
``verify_crc`` (:278, :574).  Kernels: ``csrc/staging.cu``.

- :func:`gather_rows` (S1): ragged rows out of a byte buffer, zero to a
  fixed width, as bytes or as big-endian u32 words (K3's input), at
  offsets and lengths the caller holds on the host (checked there);
- :func:`splice_payload` (S2): the archive payload, each block's K2
  stream or its raw bytes, one after another, laid out by the wire
  lengths the caller holds on the host (checked there: no wait for the
  card);
- :func:`crc32` (S3): zlib's CRC-32 of a byte tensor, a CRC a
  ``CRC_SEGMENT``-byte segment and the GF(2) combine of the segments'
  CRCs (:func:`combine_crcs`, zlib's ``crc32_combine``);
  :func:`crc32_device` leaves it on the device without waiting.  The
  kernel's constant tables (:func:`crc_consts`) are built here.

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel on the current stream for CUDA tensors, counting the launch.
Malformed offsets or lengths raise :class:`InvalidInputError` before any
kernel or plain version reads the buffer: S1 and S2 take them as the
host arrays the caller holds and check them there, so neither waits for
the card.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

from .. import _build
from ..errors import InvalidInputError
from .coder import bytes_to_words, expect, kernel_device, words_to_bytes

CRC_SEGMENT = 256  # bytes a crc32 thread reads a tile, 16 at a time (csrc/staging.cu kCrcSegment)
CRC_THREADS = 512  # threads of a crc32 CTA that read (csrc/staging.cu kCrcThreads)
CRC_POLY = 0xEDB88320  # zlib's polynomial, reflected
_ONE = 0x80000000  # x^0: bit 31 is the coefficient of x^0
_ROW_BUDGET = 64 << 20  # bytes of int64 index a step of the plain versions
_CONSTS: dict = {}  # crc_consts() on each device, by device


def _row_steps(b: int, width: int):
    """Row ranges of at most ``_ROW_BUDGET // (8 * width)`` rows: the plain
    versions' int64 indices stay bounded whatever the row count."""
    step = max(1, _ROW_BUDGET // max(8 * width, 1))
    return ((r, min(r + step, b)) for r in range(0, b, step))


def gather_rows_plain(buf: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor, width: int,
                      words: bool) -> torch.Tensor:
    """The plain PyTorch version of :func:`gather_rows` (bounds already
    checked).  Runs on any device."""
    nbytes = 4 * width if words else width
    out = torch.zeros(offs.shape[0], nbytes, dtype=torch.uint8, device=buf.device)
    col = torch.arange(nbytes, device=buf.device)
    for r0, r1 in _row_steps(offs.shape[0], nbytes):
        keep = col[None, :] < lens[r0:r1, None]
        out[r0:r1][keep] = buf[(offs[r0:r1, None] + col[None, :])[keep]]
    return bytes_to_words(out) if words else out


def gather_rows(buf: torch.Tensor, offs, lens, width: int, words: bool = False) -> torch.Tensor:
    """Row ``i`` is ``buf[offs[i] : offs[i] + lens[i]]`` followed by zeros.

    Args: ``(N,)`` uint8 ``buf``; ``(B,)`` int64 ``offs`` and ``lens`` on
    the host (numpy arrays or CPU tensors) whatever the device: they are
    the archive header's offsets and lengths, which the caller holds, so
    the checks wait for nothing; the row width.  With ``words`` the rows
    are ``(B, width)`` int32 big-endian words (K3's input, ``4 * width``
    bytes a row); without, ``(B, width)`` uint8.  Raises
    :class:`InvalidInputError` where a row starts or ends outside ``buf``
    or is longer than its width, before anything goes up.  CPU tensors
    take the plain version; for a CUDA ``buf`` the offsets and lengths go
    up through pinned memory and the kernel is queued on the current
    stream.
    """
    dev = buf.device
    expect(buf, "buf", torch.uint8, (None,), dev)
    offs, lens = _host_int64(offs, "offs"), _host_int64(lens, "lens")
    b = offs.shape[0]
    if lens.shape != (b,):
        raise ValueError(f"lens: expected shape ({b},), got {lens.shape}")
    width = int(width)
    if width < 0:
        raise ValueError("width must be >= 0")
    if b and _rows_outside(offs, lens, 4 * width if words else width, buf.shape[0]):
        raise InvalidInputError()
    if not kernel_device(dev):
        if b and width:
            _build.count_bus(h2d=offs.nbytes + lens.nbytes)  # the card's table
        return gather_rows_plain(buf, torch.from_numpy(offs), torch.from_numpy(lens), width, words)
    out = torch.empty(b, width, dtype=torch.int32 if words else torch.uint8, device=dev)
    if b and width:
        table = torch.empty(2, b, dtype=torch.int64, pin_memory=True)  # one upload of both
        table.numpy()[0], table.numpy()[1] = offs, lens
        _build.count_bus(h2d=table.nbytes)
        table = table.to(dev, non_blocking=True)
        launch_gather_rows(buf, table[0], table[1], out, words)
        _build.count_launch("gather_rows", dev)
    return out


def _host_int64(a, name: str) -> np.ndarray:
    """``a`` (a numpy array or a CPU tensor) as a 1-D int64 numpy array;
    ValueError for another type, shape or device."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"{name}: expected a host array, got a tensor on {a.device}")
        a = a.numpy()
    if not isinstance(a, np.ndarray) or a.dtype != np.int64 or a.ndim != 1:
        raise ValueError(f"{name}: expected a 1-D int64 array")
    return a


def _rows_outside(offs: np.ndarray, lens: np.ndarray, cap: int, n: int) -> bool:
    """Whether a row starts before the buffer's ``n`` bytes, ends past them
    or is longer than ``cap`` (a row's bytes), by a few reductions."""
    if offs.min() < 0 or lens.min() < 0 or lens.max() > cap:
        return True
    return bool((offs > n - lens).any())


def launch_gather_rows(buf, offs, lens, out, words: bool) -> None:
    """S1's launch alone into ``out`` (``(B, width)``, 16-byte aligned),
    with ``offs`` and ``lens`` on the device, unchecked: what
    :func:`gather_rows` runs once its checks pass (and what a timing of
    the kernel alone calls)."""
    if out.data_ptr() % 16:
        raise ValueError("gather_rows: out must start 16-byte aligned")
    dev = buf.device
    err = _build.lib().rxt_gather_rows(
        buf.data_ptr(), buf.shape[0], offs.data_ptr(), lens.data_ptr(), out.data_ptr(),
        out.shape[0], out.shape[1] * out.element_size(), int(words), dev.index or 0,
        _build.stream_of(dev))
    _build.check(err, "rxt_gather_rows")


def splice_payload_plain(words: torch.Tensor, blocks: torch.Tensor, raw: torch.Tensor,
                         wire: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`splice_payload` (lengths already
    checked).  Runs on the device of ``blocks``."""
    b, k = blocks.shape
    dev = blocks.device
    _build.count_bus(h2d=raw.nbytes + wire.nbytes)  # the card's row table
    raw, wire = raw.to(dev), wire.to(dev, torch.int64)
    coded = words_to_bytes(words)
    width = max(k, coded.shape[1])
    offs = torch.cumsum(wire, 0) - wire
    out = torch.zeros(int(wire.sum()), dtype=torch.uint8, device=dev)
    col = torch.arange(width, device=dev)
    pad = torch.nn.functional.pad
    for r0, r1 in _row_steps(b, width):
        rows = torch.where(raw[r0:r1, None], pad(blocks[r0:r1], (0, width - k)),
                           pad(coded[r0:r1], (0, width - coded.shape[1])))
        keep = col[None, :] < wire[r0:r1, None]
        out[(offs[r0:r1, None] + col[None, :])[keep]] = rows[keep]
    return out


def splice_payload(words: torch.Tensor, blocks: torch.Tensor, raw: torch.Tensor,
                   wire: torch.Tensor) -> torch.Tensor:
    """The archive payload of ``B`` blocks: each block's ``wire[i]`` wire
    bytes, one block after another (block ``i`` at ``wire[:i].sum()``); a
    coded block writes its stream (K2's ``(B, n_words)`` int32 ``words``,
    big-endian), a raw block its own bytes (``(B, k)`` uint8 ``blocks``).

    ``words`` and ``blocks`` lie on the device.  ``raw`` ((B,) bool) and
    ``wire`` ((B,) int32, ``raw ? symbols : coded bytes``) lie on the CPU
    whatever the device: they are the flags and lengths of the archive's
    header, which the caller holds on the host, so the checks wait for
    nothing.  Returns ``(wire.sum(),)`` uint8 on the device.  Raises
    :class:`InvalidInputError` where a length is negative, a coded stream
    is longer than K2's buffer (``4 * n_words`` bytes: the bound the
    encoder must never pass silently) or a raw block longer than ``k``.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (its row table from :func:`splice_rows`).
    """
    dev = blocks.device
    expect(blocks, "blocks", torch.uint8, (None, None), dev)
    b, k = blocks.shape
    expect(words, "words", torch.int32, (b, None), dev)
    host = torch.device("cpu")
    expect(raw, "raw", torch.bool, (b,), host)
    expect(wire, "wire", torch.int32, (b,), host)
    if b and _past_capacity(raw, wire, k, 4 * words.shape[1]):
        raise InvalidInputError()
    if not kernel_device(dev):
        return splice_payload_plain(words, blocks, raw, wire)
    out = torch.empty(int(wire.numpy().sum(dtype=np.int64)), dtype=torch.uint8, device=dev)
    if out.shape[0]:
        launch_splice_payload(_aligned(words), _aligned(blocks), *splice_rows(raw, wire, dev), out)
        _build.count_launch("splice_payload", dev)
    return out


def _past_capacity(raw: torch.Tensor, wire: torch.Tensor, k: int, coded_cap: int) -> bool:
    """Whether a length is negative or passes its row's capacity (``k``
    raw, ``coded_cap`` coded); a row at a time only where the largest
    length passes the smaller capacity."""
    w = wire.numpy()
    if w.min() < 0:
        return True
    if w.max() <= min(k, coded_cap):
        return False
    return bool((w > np.where(raw.numpy(), k, coded_cap)).any())


def splice_rows(raw: torch.Tensor, wire: torch.Tensor,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """S2's row table on ``device`` from the host's ``raw`` and ``wire``:
    each row's end in the payload ((B,) int64, the running sum of
    ``wire``) and its raw flag.  The lengths and flags go up as they are
    and the sum runs on the device: no host work a row, no wait."""
    _build.count_bus(h2d=wire.nbytes + raw.nbytes)
    wire, raw = wire.to(device, non_blocking=True), raw.to(device, non_blocking=True)
    return torch.cumsum(wire, 0, dtype=torch.int64), raw


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start 16-byte aligned
    (the kernels load 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_splice_payload(words, blocks, ends, raw, out) -> None:
    """S2's launch alone into ``out`` (``(total,)``, the last row's end),
    with ``ends`` and ``raw`` from :func:`splice_rows`, unchecked (see
    :func:`launch_gather_rows`); ``words``, ``blocks`` and ``out`` must
    start 16-byte aligned."""
    if any(t.data_ptr() % 16 for t in (words, blocks, out)):
        raise ValueError("splice_payload: words, blocks and out must start 16-byte aligned")
    dev = blocks.device
    err = _build.lib().rxt_splice_payload(
        words.data_ptr(), words.shape[1], blocks.data_ptr(), blocks.shape[1], blocks.shape[0],
        ends.data_ptr(), raw.data_ptr(), out.data_ptr(), out.shape[0], dev.index or 0,
        _build.stream_of(dev))
    _build.check(err, "rxt_splice_payload")


def _mulmod(a: int, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod P`` over GF(2) for the constant ``a`` and each int64
    element of ``b`` (32-bit values; bit 31 the coefficient of x^0):
    zlib's ``multmodp``, as ``csrc/staging.cu::mulmod``."""
    p = torch.zeros_like(b)
    for j in range(32):
        if a & (0x80000000 >> j):
            p ^= b
        b = (b >> 1) ^ ((b & 1) * CRC_POLY)
    return p


@functools.lru_cache(maxsize=None)
def pow8_table() -> tuple:
    """``x^(8 * 2^b) mod P`` for b = 0 .. 63 (the kernel's table too)."""
    out = [0x00800000]  # x^8
    for _ in range(63):
        out.append(int(_mulmod(out[-1], torch.tensor([out[-1]], dtype=torch.int64))[0]))
    return tuple(out)


def x8_power(e: int) -> int:
    """``x^(8e) mod P`` for ``e >= 0``: the product of :func:`pow8_table`'s
    entries at the set bits of ``e``."""
    p, table = _ONE, pow8_table()
    for bit in range(e.bit_length()):
        if e >> bit & 1:
            p = int(_mulmod(table[bit], torch.tensor([p], dtype=torch.int64))[0])
    return p


def inv8_table() -> tuple:
    """``x^(-8z) mod P`` for z = 0 .. 15: ``x^0`` divided by x, 8z times
    (x * c is ``c >> 1``, xored with P where c's bit 0 was set; P's bit 31
    is set, so bit 31 of the product tells which)."""
    c, out = _ONE, [_ONE]
    for _ in range(15 * 8):
        c = ((c ^ CRC_POLY) << 1 | 1 if c & _ONE else c << 1) & 0xFFFFFFFF
        out.append(c)
    return tuple(out[::8])


def shift_table(a: int) -> torch.Tensor:
    """(4, 256) int64: entry ``[k][b]`` is ``a * (b << 8k) mod P``, so that
    ``v * a`` is four lookups, one a byte of ``v`` (:func:`apply_shift`)."""
    b = torch.arange(256, dtype=torch.int64)
    return torch.stack([_mulmod(a, b << 8 * k) for k in range(4)])


def apply_shift(table: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v * a mod P`` for each int64 element of ``v`` by the shift table of
    ``a`` (the kernel's ``shift``)."""
    return (table[0][v & 0xFF] ^ table[1][(v >> 8) & 0xFF] ^ table[2][(v >> 16) & 0xFF]
            ^ table[3][(v >> 24) & 0xFF])


def slicing_tables() -> torch.Tensor:
    """(4, 256) int64: zlib's slicing-by-4 tables; row 0 is the byte
    table, ``t[k][i] = (t[k-1][i] >> 8) ^ t[0][t[k-1][i] & 0xFF]``."""
    c = torch.arange(256, dtype=torch.int64)
    for _ in range(8):
        c = (c >> 1) ^ ((c & 1) * CRC_POLY)
    rows = [c]
    for _ in range(3):
        rows.append((rows[-1] >> 8) ^ c[rows[-1] & 0xFF])
    return torch.stack(rows)


@functools.lru_cache(maxsize=None)
def crc_consts(segment: int = CRC_SEGMENT, threads: int = CRC_THREADS) -> np.ndarray:
    """The crc32 kernel's constants as uint32 words (``csrc/staging.cu``
    ``k*Off``), for ``threads`` (a multiple of 32) that each read
    ``segment`` bytes of a tile as 16-byte loads 512 bytes apart: the
    slicing tables; the shift tables of the gap between a lane's loads,
    ``x^(8 * 496)``, of the gap from its last load of a tile to its first
    of the next, and of the tree's levels: ``x^(8 * 16 * 2^s)`` between
    lanes, then ``x^(8 * 32 * segment * 2^s)`` between warps; then
    :func:`pow8_table` and :func:`inv8_table`."""
    levels = threads.bit_length() - 1
    tile, last = segment * threads, 512 * (segment // 16 - 1) + 16
    dists = [16 << s if s < 5 else 32 * segment << (s - 5) for s in range(levels)]
    tables = [slicing_tables(), shift_table(x8_power(512 - 16)), shift_table(x8_power(tile - last))]
    tables += [shift_table(x8_power(d)) for d in dists]
    words = [t.reshape(-1).numpy() for t in tables] + [np.array(pow8_table() + inv8_table())]
    return np.concatenate(words).astype(np.uint32)


def combine_crcs(crcs: torch.Tensor, after: torch.Tensor) -> int:
    """The CRC-32 of consecutive pieces from each piece's CRC ``crcs[i]``
    and the bytes that follow it ``after[i]`` (int64 tensors): the XOR of
    ``crcs[i] * x^(8 * after[i]) mod P``.  zlib's ``crc32_combine`` is
    this for two pieces."""
    c = crcs.to(torch.int64).clone()
    after = after.to(torch.int64)
    table = pow8_table()
    for bit in range(int(after.max()).bit_length() if after.numel() else 0):
        sel = ((after >> bit) & 1).bool()
        if bool(sel.any()):
            c = torch.where(sel, _mulmod(table[bit], c), c)
    while c.numel() > 1:  # XOR reduction, a tree
        if c.numel() % 2:
            c = torch.cat([c, c.new_zeros(1)])
        c = c[0::2] ^ c[1::2]
    return int(c[0]) if c.numel() else 0


def crc32_plain(u8: torch.Tensor) -> int:
    """The plain version of :func:`crc32`: each segment's CRC by
    ``zlib.crc32`` on the host, then :func:`combine_crcs` in PyTorch."""
    mv = memoryview(u8.cpu().numpy())
    n = u8.shape[0]
    starts = range(0, n, CRC_SEGMENT)
    crcs = torch.tensor([zlib.crc32(mv[s : s + CRC_SEGMENT]) for s in starts], dtype=torch.int64)
    after = torch.tensor([max(n - s - CRC_SEGMENT, 0) for s in starts], dtype=torch.int64)
    return combine_crcs(crcs, after)


def crc32(u8: torch.Tensor) -> int:
    """zlib's CRC-32 of a ``(N,)`` uint8 tensor (0 for an empty one).  CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream (:func:`crc32_device`) and wait for its 4-byte
    result."""
    expect(u8, "u8", torch.uint8, (None,), u8.device)
    if not kernel_device(u8.device):
        return crc32_plain(u8)
    return int(crc32_device(u8).item()) & 0xFFFFFFFF


def crc32_device(u8: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`crc32` left on the device: its 32 bits as a ``(1,)`` int32
    tensor on ``u8``'s device (``out`` where given, a one-element int32
    tensor there), with no wait.  Any alignment of ``u8``.  CPU tensors
    take the plain version; CUDA tensors launch the kernel on the current
    stream."""
    dev = u8.device
    expect(u8, "u8", torch.uint8, (None,), dev)
    if out is None:
        out = torch.empty(1, dtype=torch.int32, device=dev)
    expect(out, "out", torch.int32, (1,), dev)
    if not kernel_device(dev):
        crc = crc32_plain(u8)
        return out.fill_(crc - (1 << 32) if crc >> 31 else crc)
    if u8.shape[0] == 0:
        return out.zero_()
    launch_crc32(u8, out)
    _build.count_launch("crc32", dev)
    return out


def _consts_on(dev: torch.device) -> torch.Tensor:
    """:func:`crc_consts` as int32 on ``dev``, uploaded once a device."""
    if dev not in _CONSTS:
        consts = crc_consts()
        _build.count_bus(h2d=consts.nbytes)
        _CONSTS[dev] = torch.from_numpy(consts.view(np.int32)).to(dev)
    return _CONSTS[dev]


def launch_crc32(u8, out) -> None:
    """S3's launch alone: zeroes ``out`` (one int32) and XORs the CRC of
    ``u8`` into it, unchecked (see :func:`launch_gather_rows`)."""
    dev = u8.device
    err = _build.lib().rxt_crc32(u8.data_ptr(), u8.shape[0], _consts_on(dev).data_ptr(),
                                 out.data_ptr(), dev.index or 0, _build.stream_of(dev))
    _build.check(err, "rxt_crc32")
