"""Block-parallel compress/decompress of RXT v2 archives.

Counterpart: ``redux_tpu/api.py`` — ``encode`` (:226-398) and ``decode``
(:401-576) with their helpers (:51-138).  The same steps, the same bytes:

1. split the input into fixed-size blocks;
2. derive the warm-start prior from the global byte histogram;
3. per block and position, the model values (K1, ``ops.model``);
4. the interval coder over all blocks at once (K2, ``ops.encode``);
5. splice the per-block streams, storing incompressible blocks raw;

and for decode, the lanes sorted by coded length, the decoder (K3,
``ops.decode``), the inverse permutation, the raw splice and the crc.

The data lives on the device between one upload and one fetch: the
reference staged it on the host for its TPU's sake, the port on the card
with the staging kernels of ``ops.staging`` (S1 row gather, S2 payload
splice, S3 crc32) and ``torch.bincount`` for the histogram.  ``encode``
reads the input in lane chunks twice (histogram and crc, then the
kernels; an input of one chunk crosses the bus once) and fetches each
chunk's payload; the chunks' CRCs stay on the device until all are
queued.  ``decode`` works a range of blocks at a time: the
range's slice of the archive goes up, its output comes back into the
result's memory while the next range decodes, so its device memory is
two ranges' worth whatever the input's size.  Only the header, the
prior's 256 counts and the lanes' order are host work.

The device defaults to the card: ``device="cuda"`` runs the kernels, and
with no CUDA device a call raises RuntimeError before any kernel work
instead of running anything else.  The CPU runs the kernels' plain
PyTorch versions only when the caller asks for it (``device="cpu"``, as
the tests do).  A sequence of two or more devices shards the blocks over
them (``parallel.mesh``; the explicit counterpart of the reference's
``_dp_mesh`` branches, :98-113, :300-316, :483-510): the data stages on
the first device and the shards move from device to device.
``parallel.data_parallel_mesh()`` names every visible GPU.  The archive
bytes do not depend on the devices.

The routes of ``redux_tpu/api.py:579-720`` follow: ``encode_compact`` /
``decode_compact`` (one v2 block in a compact archive, host code through
:mod:`redux_tpu_torch.native`) and ``encode_auto`` / ``decode_auto`` (the
smallest of the self-decodable candidates, and the decoder that tells
them apart).  Unlike the reference, they never fall back to the Python
oracle when the native library cannot be built: that fallback would
change ``encode_auto``'s candidates, and so its bytes, silently.
"""

from __future__ import annotations

import ctypes
import time
import warnings
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from . import container, native
from .container import DEFAULT_BLOCK_SIZE, DEFAULT_DELTA, DEFAULT_PRIOR_BUDGET
from .convert import init_cum_from_numpy
from .errors import InvalidInputError, ReduxError
from .models.dense import prior_init_cum, quantize_prior, uniform_init_cum
from .ops.coder import max_block_words
from .ops.decode import decode_blocks
from .ops.encode import encode_blocks_ranked
from .ops.staging import combine_crcs, crc32_device, gather_rows, splice_payload
from .parallel.mesh import (Mesh, data_parallel_mesh, decode_blocks_sharded,
                            encode_blocks_ranked_sharded)
from .params import Parameters

# Default decode lane quantum of the reference (its LANES x PHASES = 1024 x 1):
# the auto block size snaps the block count under a multiple of it.
LANE_QUANTUM = 1024
_AUTO_BS_MIN = 1 << 21  # auto block sizing applies to inputs >= 2 MiB
ENC_CHUNK_BYTES = 256 << 20  # input bytes per encode dispatch
DEC_CHUNK_BYTES = 256 << 20  # decoded bytes per decode dispatch


def _static_words(params: Parameters, k: int, delta: int = DEFAULT_DELTA) -> int:
    max_count = min(params.symbol_count + DEFAULT_PRIOR_BUDGET + delta * k, params.freq_max)
    return max_block_words(max_count, params.symbol_count, params, k)


def _host_u8(data) -> torch.Tensor:
    """A CPU uint8 tensor over the bytes of ``data`` (no copy; read only:
    nothing writes through it, so torch's warning about a read-only buffer
    is silenced)."""
    if len(data) == 0:
        return torch.empty(0, dtype=torch.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(data, dtype=torch.uint8)


def _blocks(data, s0: int, s1: int, block_size: int, device: torch.device) -> torch.Tensor:
    """Blocks ``s0 .. s1`` of ``data`` as a ``(s1 - s0, block_size)`` uint8
    tensor on ``device``, zero past the end of ``data``: one copy from
    ``data``, the last block's tail zeroed on the device."""
    a, b = s0 * block_size, min(s1 * block_size, len(data))
    out = torch.empty((s1 - s0) * block_size, dtype=torch.uint8, device=device)
    out[: b - a].copy_(_host_u8(data)[a:b])
    out[b - a :].zero_()
    return out.view(s1 - s0, block_size)


def _block_lens(n: int, block_size: int) -> np.ndarray:
    """(n_blocks,) int32 symbols a block of an ``n``-byte input."""
    n_blocks = -(-n // block_size)
    return np.minimum(block_size, n - block_size * np.arange(n_blocks, dtype=np.int64)
                      ).astype(np.int32)


def _encode_words(params: Parameters, k: int, delta: int) -> int:
    """Per-block output capacity of the encoder.  Blocks whose stream
    reaches their raw size are stored raw, so the buffer never needs the
    adversarial bound."""
    return min(_static_words(params, k, delta), k // 4 + 16)


def _byte_histogram(u8: torch.Tensor) -> torch.Tensor:
    """(256,) int64 counts of the bytes of a uint8 tensor, on its device
    (the reference's ``np.bincount``; plain PyTorch on any device)."""
    return torch.bincount(u8, minlength=256)


def _prior_extra(hist: np.ndarray, params: Parameters,
                 prior_budget: int) -> Optional[np.ndarray]:
    """The warm-start prior (256 extra counts) from the byte histogram, or
    None for an empty input or an all-zero quantization."""
    if not hist.any():
        return None
    extra = quantize_prior(hist, params, min(prior_budget, params.freq_max // 2))[:256]
    return extra if extra.max(initial=0) > 0 else None


def _init_cum(params: Parameters, prior_extra: Optional[np.ndarray]) -> np.ndarray:
    if prior_extra is None:
        return uniform_init_cum(params).astype(np.int32)
    full = np.zeros(params.symbol_count, dtype=np.int64)
    full[:256] = prior_extra
    return prior_init_cum(full, params).astype(np.int32)


def _auto_block_size(n: int, lane_quantum: int = LANE_QUANTUM) -> int:
    """Block size that lands the block count just under a multiple of
    ``lane_quantum``; 256-aligned, at least 1024."""
    blocks0 = -(-n // DEFAULT_BLOCK_SIZE)
    lanes = -(-blocks0 // lane_quantum) * lane_quantum
    k = -(-(-(-n // lanes)) // 256) * 256
    return max(k, 1024)


def _lane_chunk(chunk_bytes: int, block_size: int) -> int:
    """Blocks (lanes) a chunk of ``encode`` or ``decode`` takes:
    ``chunk_bytes`` of blocks, a multiple of 128 and at least 128."""
    return max(128, (chunk_bytes // max(block_size, 1)) // 128 * 128)


def _default_block_size(n: int, lane_quantum: int = LANE_QUANTUM) -> int:
    """``encode``'s block size for ``n`` bytes: 4 KiB, auto-sized from 2 MiB."""
    return _auto_block_size(n, lane_quantum) if n >= _AUTO_BS_MIN else DEFAULT_BLOCK_SIZE


def _check_config(params: Parameters, block_size: int, delta: int, init_total: int):
    """Reject configs whose adaptation would freeze from the start."""
    if init_total >= params.freq_max:
        raise InvalidInputError()
    if not (params.fits_u32 or params.fits_wide32 or params.code_bits + params.freq_bits <= 62):
        raise InvalidInputError()


Devices = Union[torch.device, str, Sequence[Union[torch.device, str]]]


def _placement(device: Devices) -> tuple[torch.device, Optional[Mesh]]:
    """Where the data stages and, for two or more devices, the mesh to
    shard over: the data then stages on the mesh's first device."""
    if isinstance(device, (torch.device, str)):
        return torch.device(device), None
    mesh = data_parallel_mesh(device)
    return mesh[0], (mesh if len(mesh) > 1 else None)


def _require_cuda(device: torch.device) -> None:
    """Raise for a CUDA device on a machine without one: the card is the
    default, and the CPU runs only when the caller names it."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "redux_tpu_torch: device 'cuda' (the default) but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch versions")


class _Clock:
    """Wall time per phase into ``timings`` (seconds, accumulated).  With
    ``timings`` given, each mark first waits for the CUDA devices of
    ``devices``, so a phase holds the device work it queued."""

    def __init__(self, timings: Optional[dict], devices: Sequence[torch.device] = ()):
        self.tt = timings if timings is not None else {}
        self.wait = [d for d in devices if d.type == "cuda"] if timings is not None else []
        self.t0 = time.perf_counter()

    def mark(self, name: str) -> None:
        for d in self.wait:
            torch.cuda.synchronize(d)
        now = time.perf_counter()
        self.tt[name] = self.tt.get(name, 0.0) + (now - self.t0)
        self.t0 = now


def encode(
    data: bytes,
    params: Optional[Parameters] = None,
    block_size: Optional[int] = None,
    delta: int = DEFAULT_DELTA,
    use_prior: Optional[bool] = None,
    prior_budget: int = DEFAULT_PRIOR_BUDGET,
    *,
    device: Devices = "cuda",
    lane_quantum: int = LANE_QUANTUM,
    _timings: Optional[dict] = None,
) -> bytes:
    """Compress ``data`` into an RXT v2 block-parallel archive.

    Defaults: :meth:`Parameters.tpu_wide`, adaptation increment 16, a
    128k-count warm-start prior for inputs of 4096 bytes or more, and
    4 KiB blocks, auto-sized for inputs >= 2 MiB (see
    :func:`_auto_block_size`).  ``device`` (default ``"cuda"``) runs the
    kernels; ``device="cpu"`` runs their plain versions; a sequence of
    devices shards the blocks over them.

    ``_timings`` receives the wall time of each phase: ``pass1`` (each
    chunk's upload, histogram and crc), ``pass2`` (each chunk's upload,
    K1 -> K2, the payload splice and its fetch) and ``header``.
    """
    device, mesh = _placement(device)
    clock = _Clock(_timings, mesh or [device])
    params = params or Parameters.tpu_wide()
    if block_size is None:
        block_size = _default_block_size(len(data), lane_quantum)
    if params.symbol_bits != 8:
        raise InvalidInputError("the RXT container is byte-only (symbol_bits = 8)")
    if use_prior is None:
        use_prior = len(data) >= 4096
    # The parameters' own limits before the device's (the prior's total is
    # checked once pass 1 has counted the bytes).
    _check_config(params, block_size, delta, int(uniform_init_cum(params)[-1]))
    _require_cuda(device)
    n, k = len(data), block_size
    lens = _block_lens(n, k)
    n_blocks = lens.size
    chunk = _lane_chunk(ENC_CHUNK_BYTES, k)

    # Pass 1, a lane chunk at a time: the histogram and the chunk's crc on
    # the device, fetched once after the last chunk.  An input of one
    # chunk keeps its blocks for pass 2.
    hist = torch.zeros(256, dtype=torch.int64, device=device)
    starts = range(0, n_blocks, chunk)
    crcs = torch.zeros(len(starts), dtype=torch.int32, device=device)
    after, kept = [], None
    for i, s0 in enumerate(starts):
        s1 = min(s0 + chunk, n_blocks)
        blocks = _blocks(data, s0, s1, k, device)
        flat = blocks.view(-1)[: min(s1 * k, n) - s0 * k]
        if use_prior:
            hist += _byte_histogram(flat)
        crc32_device(flat, crcs[i : i + 1])
        after.append(max(n - s1 * k, 0))
        if n_blocks <= chunk:
            kept = blocks
    crc = combine_crcs(crcs.cpu().to(torch.int64) & 0xFFFFFFFF, torch.tensor(after))
    prior_extra = _prior_extra(hist.cpu().numpy(), params, prior_budget) if use_prior else None
    ic = _init_cum(params, prior_extra)
    _check_config(params, block_size, delta, int(ic[-1]))
    clock.mark("pass1")

    if n == 0:
        return container.build_archive(params, block_size, 0, [], prior_extra, delta, crc)

    # Pass 2, a lane chunk at a time: K1 -> K2 on the chunk's blocks, the
    # raw rule, the payload spliced on the device and fetched, and the
    # wire lengths and raw flags for the header.
    n_words = _encode_words(params, k, delta)
    ic_t = init_cum_from_numpy(ic, params, device)
    pieces, wire_parts, raw_parts = [], [], []
    for s0 in range(0, n_blocks, chunk):
        s1 = min(s0 + chunk, n_blocks)
        blocks = kept if kept is not None else _blocks(data, s0, s1, k, device)
        lens_t = torch.from_numpy(lens[s0:s1]).to(device)
        if mesh is None:
            words, bl, ov = encode_blocks_ranked(blocks, lens_t, ic_t, params, n_words, delta)
        else:
            words, bl, ov = encode_blocks_ranked_sharded(
                blocks, lens_t, ic_t, params, n_words, mesh, delta)
        # Stored raw: overflowed blocks and any block not smaller coded.
        # The wire lengths and flags come to the host for the header; S2
        # lays the payload out by them.
        raw = ov | (bl >= lens_t)
        head = torch.stack([torch.where(raw, lens_t, bl), raw.to(torch.int32)]).cpu()
        wire, raw_h = head[0], head[1].bool()
        payload = splice_payload(words, blocks, raw_h, wire)
        pieces.append(payload.cpu().numpy())
        wire_parts.append(wire.numpy())
        raw_parts.append(raw_h.numpy())
        del blocks, words, payload
    clock.mark("pass2")

    out = container.build_archive(
        params, block_size, n, [], prior_extra, delta, crc,
        np.concatenate(raw_parts).tolist(), payload=b"".join(pieces),
        stream_lens=np.concatenate(wire_parts).tolist(),
    )
    clock.mark("header")
    return out


class _Lanes(NamedTuple):
    """The decoder's lanes of an archive, one a block."""

    raw: np.ndarray  # (B,) bool: stored raw, no symbols to decode
    block_lens: np.ndarray  # (B,) int32 symbols a block
    coded_lens: np.ndarray  # (B,) int64 coded stream bytes, 0 for a raw block
    order: np.ndarray  # lanes sorted by coded length (the reference's order)


def _by_length(lens: np.ndarray) -> np.ndarray:
    """The stable argsort of stream lengths (numpy's radix sort when they
    fit 16 bits, as they do below 16 KiB blocks)."""
    if lens.size and lens.max() < 1 << 16:
        lens = lens.astype(np.uint16)
    return np.argsort(lens, kind="stable")


def _decode_lanes(header) -> _Lanes:
    """Which blocks of ``header`` are coded, their stream lengths and the
    order K3 takes them in; InvalidInputError where a raw block's stored
    length is not its block length, or a coded stream is longer than the
    decoder's row (``n_words + 2`` words, :func:`_stage_lanes`) can hold:
    the encoder never writes one."""
    block_lens = _block_lens(header.orig_len, max(header.block_size, 1))  # parse checked n_blocks
    raw = (np.asarray(header.block_raw, dtype=bool) if header.block_raw
           else np.zeros(header.n_blocks, dtype=bool))
    stream_lens = np.asarray(header.block_byte_lens, dtype=np.int64)
    if (stream_lens[raw] != block_lens[raw]).any():
        raise InvalidInputError()
    coded_lens = np.where(raw, 0, stream_lens)
    n_words = _static_words(header.params, header.block_size, header.delta)
    if coded_lens.max(initial=0) > 4 * (n_words + 2):
        raise InvalidInputError()
    return _Lanes(raw, block_lens, coded_lens, _by_length(coded_lens))


def _stage_lanes(arch: torch.Tensor, header, lanes: _Lanes, sel: np.ndarray, base: int = 0):
    """K3's input for the lanes ``sel`` of the archive bytes ``arch`` (a
    uint8 tensor from archive offset ``base`` on; S1 on its device): their
    streams as a ``(len(sel), wcap)`` word matrix, zero past each stream
    and for two words past the longest (reads past a stream's terminator
    see zero bits; the kernel also bounds-checks its row), and their int32
    symbol counts, 0 for a raw block."""
    dev = arch.device
    n_words = _static_words(header.params, header.block_size, header.delta)
    lens_o = lanes.coded_lens[sel]
    wcap = min(max(4, -(-int(lens_o.max(initial=0)) // 4) + 2), n_words + 2)
    words = gather_rows(arch, torch.from_numpy(header.stream_offs[sel] - base).to(dev),
                        torch.from_numpy(lens_o).to(dev), wcap, words=True)
    klens = np.where(lanes.raw[sel], 0, lanes.block_lens[sel]).astype(np.int32)
    return words, torch.from_numpy(klens).to(dev)


def _chunk_slices(header, lanes: _Lanes, chunk: int) -> list:
    """``(s0, s1, a, b)`` of each of ``decode``'s chunks: blocks ``s0 ..
    s1`` of ``chunk`` and the bytes ``archive[a:b]`` that hold them (the
    payload is in block order)."""
    n = header.n_blocks
    ends = header.stream_offs + np.where(lanes.raw, lanes.block_lens, lanes.coded_lens)
    out = []
    for s0 in range(0, n, chunk):
        s1 = min(s0 + chunk, n)
        out.append((s0, s1, int(header.stream_offs[s0]), int(ends[s1 - 1])))
    return out


def _decode_chunk(arch: torch.Tensor, base: int, header, lanes: _Lanes, s0: int,
                  out: torch.Tensor, ic_t: torch.Tensor, mesh: Optional[Mesh]) -> None:
    """Blocks ``s0 .. s0 + len(out)`` into the rows of ``out`` (``(rows,
    k)`` uint8 on ``arch``'s device) from their slice ``arch`` of the
    archive, which starts at archive offset ``base``: a raw block's row is
    its stored bytes (S1, bytes), the coded blocks go through S1 (words)
    and K3 sorted by coded length, and their symbols into their rows.  Both
    S1 calls check their rows, which waits for the card, before K3 is
    queued.  No coded block, no K3."""
    dev = arch.device
    raw = lanes.raw[s0 : s0 + out.shape[0]]
    ri, ci = np.flatnonzero(raw), np.flatnonzero(~raw)
    if ri.size:
        r = s0 + ri
        rows = gather_rows(arch, torch.from_numpy(header.stream_offs[r] - base).to(dev),
                           torch.from_numpy(lanes.block_lens[r].astype(np.int64)).to(dev),
                           out.shape[1])
    if ci.size:
        ci = ci[_by_length(lanes.coded_lens[s0 + ci])]
        words, klens = _stage_lanes(arch, header, lanes, s0 + ci, base)
        k, p, d = header.block_size, header.params, header.delta
        if mesh is None:
            syms = decode_blocks(words, klens, ic_t, p, k, d)
        else:
            syms = decode_blocks_sharded(words, klens, ic_t, p, k, mesh, d)
        del words
        out.index_copy_(0, torch.from_numpy(ci).to(dev), syms)
    if ri.size:
        out.index_copy_(0, torch.from_numpy(ri).to(dev), rows)


_new_pybytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p, ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_pybytes_data = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(
    ("PyBytes_AsString", ctypes.pythonapi))


def _new_bytes(n: int) -> tuple[bytes, torch.Tensor]:
    """A new ``bytes`` of ``n`` >= 1 bytes, not yet written, and a writable
    uint8 CPU tensor over its memory.  CPython's
    ``PyBytes_FromStringAndSize(NULL, n)`` makes a fresh object that no one
    else holds, so ``decode`` can write its output there and return it:
    the result is the one full-size copy of the output on the host.  The
    tensor must not outlive the object."""
    if n < 1:
        raise ValueError("n must be >= 1")
    obj = _new_pybytes(None, n)
    return obj, torch.frombuffer((ctypes.c_uint8 * n).from_address(_pybytes_data(obj)),
                                 dtype=torch.uint8)


class _Fetch:
    """``decode``'s chunk outputs on the device and their way into the
    result's memory ``dst`` (a uint8 CPU tensor).

    :meth:`out` gives chunk ``i`` its output rows, one of ``n_slots``
    device slots of ``(rows, k)``, allocated once.  On a CUDA device
    :meth:`put` copies a chunk's bytes to the host on a side stream, after
    the chunk's work on the current stream, into one of as many pinned
    slots (allocated at the first put), and :meth:`drain` waits for that
    copy and copies the pinned slot into ``dst``: ``decode`` drains chunk
    ``i - 1`` while the card runs chunk ``i``.  Every put drains first, so
    a chunk waits for the host copy of the chunk two before it, the last
    one to use its slots.  On the CPU, put copies into ``dst`` at once: no
    pinned memory, no stream.
    """

    def __init__(self, dst: torch.Tensor, device: torch.device, rows: int, k: int,
                 n_slots: int):
        self.dst = dst
        self.outs = torch.empty(n_slots, rows, k, dtype=torch.uint8, device=device)
        self.side = torch.cuda.Stream(device) if device.type == "cuda" else None
        if self.side is not None:
            self.outs.record_stream(self.side)  # freed only once the side stream's copies end
        self.pinned = []
        self.pending = None  # (event, pinned slot, offset in dst)

    def out(self, i: int, rows: int) -> torch.Tensor:
        return self.outs[i % self.outs.shape[0], :rows]

    def put(self, i: int, flat: torch.Tensor, off: int) -> None:
        """Chunk ``i``'s bytes ``flat`` (a view of its output) to ``dst[off:]``."""
        self.drain()
        if self.side is None:
            self.dst[off : off + flat.shape[0]].copy_(flat)
            return
        if not self.pinned:
            self.pinned = [torch.empty(self.outs[0].numel(), dtype=torch.uint8, pin_memory=True)
                           for _ in range(self.outs.shape[0])]
        slot = self.pinned[i % len(self.pinned)][: flat.shape[0]]
        self.side.wait_stream(torch.cuda.current_stream(flat.device))
        with torch.cuda.stream(self.side):
            slot.copy_(flat, non_blocking=True)
            self.pending = (self.side.record_event(), slot, off)

    def drain(self) -> None:
        """The pending chunk from its pinned slot into ``dst``."""
        if self.pending is not None:
            done, slot, off = self.pending
            done.synchronize()
            self.dst[off : off + slot.shape[0]].copy_(slot)
            self.pending = None


def decode(archive: bytes, *, device: Devices = "cuda",
           _timings: Optional[dict] = None) -> bytes:
    """Decompress an RXT archive.

    Verifies the stored crc32 and raises :class:`InvalidInputError` on any
    corruption instead of returning garbage.  ``device`` (default
    ``"cuda"``) runs the kernel; ``device="cpu"`` runs its plain version; a
    sequence of devices shards each chunk's blocks over them.

    A chunk is a range of ``_lane_chunk(DEC_CHUNK_BYTES, k)`` blocks.  Each
    has its own upload (its slice of the archive), S1 and K3 into its own
    output rows (:func:`_decode_chunk`), S3, and fetch (:class:`_Fetch`:
    on the card the output comes back on a side stream while the next
    chunk runs); the chunks' CRCs stay on the device until the last chunk,
    then come back together to be combined and checked.
    The device holds at most two chunks' outputs and one chunk's slice,
    words and symbols, whatever the input's size.

    ``_timings`` receives the wall time of each phase, summed over the
    chunks: ``parse`` (the header and the lanes), ``upload`` (a chunk's
    slice), ``kernels`` (S1 -> K3 into the rows, the raw rows) and
    ``crc+fetch`` (S3, the copy to the host and into the result).  Each
    mark waits for the card, which serializes the fetch that otherwise
    overlaps the next chunk: read the wall clock from a call without
    ``_timings``.
    """
    device, mesh = _placement(device)
    clock = _Clock(_timings, mesh or [device])
    header, _ = container.parse_archive(archive, with_streams=False)
    params = header.params
    _require_cuda(device)
    if header.orig_len == 0:
        container.verify_crc(header, b"")
        return b""
    n, k, n_blocks = header.orig_len, header.block_size, header.n_blocks
    lanes = _decode_lanes(header)
    ic_t = init_cum_from_numpy(_init_cum(params, header.prior_extra), params, device)
    chunk = _lane_chunk(DEC_CHUNK_BYTES, k)
    slices = _chunk_slices(header, lanes, chunk)
    result, dst = _new_bytes(n)
    fetch = _Fetch(dst, device, min(chunk, n_blocks), k, min(2, len(slices)))
    src = _host_u8(archive)
    crcs = torch.zeros(len(slices), dtype=torch.int32, device=device)
    after = []
    clock.mark("parse")

    for i, (s0, s1, base, end) in enumerate(slices):
        arch = src[base:end].to(device)
        clock.mark("upload")
        out = fetch.out(i, s1 - s0)
        _decode_chunk(arch, base, header, lanes, s0, out, ic_t, mesh)
        del arch
        clock.mark("kernels")
        fetch.drain()  # the previous chunk into the result while K3 runs
        flat = out.view(-1)[: min(s1 * k, n) - s0 * k]
        crc32_device(flat, crcs[i : i + 1])
        after.append(n - s0 * k - flat.shape[0])
        fetch.put(i, flat, s0 * k)
        clock.mark("crc+fetch")
    fetch.drain()
    if combine_crcs(crcs.cpu().to(torch.int64) & 0xFFFFFFFF, torch.tensor(after)) != header.crc32:
        raise InvalidInputError()
    clock.mark("crc+fetch")
    return result


def encode_compact(data: bytes, cfg: int) -> bytes:
    """Compress into an RXT compact archive: one v2 block under a 5-7 byte
    header, for inputs where the block archive's header would erase the
    win.  ``cfg`` indexes ``container.COMPACT_CONFIGS``.  Host code (the
    native serial coder); raises ``native.NativeUnavailable`` if the
    library cannot be built."""
    params, delta = container.compact_config(cfg)
    payload = native.compress_block_v2(data, params, None, delta)
    return container.build_compact(cfg, len(data), payload, container.compute_crc(data))


def decode_compact(archive: bytes) -> bytes:
    """Decode an RXT compact archive; InvalidInputError on corruption.
    Host code, as :func:`encode_compact`."""
    params, delta, orig_len, crc16, payload = container.parse_compact(archive)
    out = native.decompress_block_v2(payload, orig_len, params, None, delta)
    container.verify_crc16(crc16, out)
    return out


# Compact candidates of encode_auto: delta 2 suits high-entropy and binary
# inputs, 16 suits text.  Indices into container.COMPACT_CONFIGS.
_COMPACT_AUTO_CFGS = (0, 2, 4)  # delta 2, 8, 16
_COMPACT_MAX = 1 << 20  # the serial single-block encode pays below ~1 MiB


def encode_auto(
    data: bytes,
    params: Optional[Parameters] = None,
    block_size: Optional[int] = None,
    *,
    device: Devices = "cuda",
) -> bytes:
    """Compress to the smallest of the self-decodable candidates:

    1. the block archive with the warm-start prior;
    2. from 4096 bytes, the block archive with uniform init;
    3. above ``_COMPACT_MAX`` with blocks under 16 KiB, the block archive
       with 16 KiB blocks;
    4. up to ``_COMPACT_MAX``, compact archives at ``_COMPACT_AUTO_CFGS``
       and, when ``params`` is None, the bare reference-format stream
       (unless its first bytes would misroute in :func:`decode_auto`).

    :func:`decode_auto` tells every candidate apart.  ``device`` runs the
    block encodes, as in :func:`encode`; the compact candidates and the
    bare stream are host code through :mod:`redux_tpu_torch.native`,
    which raises if it cannot be built (no fallback to the oracle).
    """
    candidates = [encode(data, params=params, block_size=block_size, use_prior=True,
                         device=device)]
    if len(data) >= 4096:  # the reference's threshold for the uniform candidate
        candidates.append(
            encode(data, params=params, block_size=block_size, use_prior=False, device=device)
        )
    if len(data) > _COMPACT_MAX and (block_size or DEFAULT_BLOCK_SIZE) < (1 << 14):
        candidates.append(
            encode(data, params=params, block_size=1 << 14, use_prior=True, device=device)
        )
    if 0 < len(data) <= _COMPACT_MAX:
        for cfg in _COMPACT_AUTO_CFGS:
            candidates.append(encode_compact(data, cfg))
        if params is None:
            ref = native.compress_bytes(data, Parameters.default())
            # A stream starting with the block archive's magic would
            # misroute in decode_auto, and one starting with the compact
            # magic could pass a compact parse and crc16 by chance.
            if not container.is_rxt_archive(ref) and not (
                len(ref) and ref[0] == container.COMPACT_MAGIC
            ):
                candidates.append(ref)
    return min(candidates, key=len)


def decode_auto(data: bytes, params: Optional[Parameters] = None, *,
                device: Devices = "cuda") -> bytes:
    """Decode a block archive, a compact archive or a bare reference-format
    stream.

    Reference streams carry no magic, so what is neither archive (or a
    compact-looking stream that fails its parse or crc16) is decoded as a
    bare stream at ``params`` (default: the reference CLI's (8,30,32)).
    ``device`` runs the block archive's decode, as in :func:`decode`; the
    rest is host code through :mod:`redux_tpu_torch.native`.
    """
    if container.is_rxt_archive(data):
        return decode(data, device=device)
    if container.is_compact_archive(data):
        try:
            return decode_compact(data)
        except ReduxError:
            pass
    return native.decompress_bytes(data, params)
