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

The device defaults to the card: ``device="cuda"`` runs the kernels, and
with no CUDA device a call raises RuntimeError before any kernel work
instead of running anything else.  The CPU runs the kernels' plain
PyTorch versions only when the caller asks for it (``device="cpu"``, as
the tests do).  A sequence of two or more devices shards the blocks over
them (``parallel.mesh``; the explicit counterpart of the reference's
``_dp_mesh`` branches, :98-113, :300-316, :483-510).
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

import time
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from . import container, native
from .container import DEFAULT_BLOCK_SIZE, DEFAULT_DELTA, DEFAULT_PRIOR_BUDGET
from .convert import init_cum_from_numpy
from .errors import InvalidInputError, ReduxError
from .models.dense import prior_init_cum, quantize_prior, uniform_init_cum
from .ops.coder import bytes_to_words, max_block_words, words_to_bytes
from .ops.decode import decode_blocks
from .ops.encode import encode_blocks_ranked
from .parallel.mesh import (Mesh, data_parallel_mesh, decode_blocks_sharded,
                            encode_blocks_ranked_sharded)
from .params import Parameters

# Default decode lane quantum of the reference (its LANES x PHASES = 1024 x 1):
# the auto block size snaps the block count under a multiple of it.
LANE_QUANTUM = 1024
_AUTO_BS_MIN = 1 << 21  # auto block sizing applies to inputs >= 2 MiB
ENC_CHUNK_BYTES = 256 << 20  # input bytes per encode dispatch
DEC_CHUNK_BYTES = 256 << 20  # decoded bytes per decode dispatch
# Bytes a histogram step: NumPy's bincount widens each byte to 8, so the
# input is counted in segments (128 MiB of transient at most).
_HIST_SEGMENT = 16 << 20


def _static_words(params: Parameters, k: int, delta: int = DEFAULT_DELTA) -> int:
    max_count = min(params.symbol_count + DEFAULT_PRIOR_BUDGET + delta * k, params.freq_max)
    return max_block_words(max_count, params.symbol_count, params, k)


def _block_rows(src: np.ndarray, s0: int, s1: int, block_size: int) -> np.ndarray:
    """Blocks ``s0 .. s1`` of the uint8 array ``src`` as a fresh
    ``(s1 - s0, block_size)`` array, zero past the end of ``src``."""
    part = src[s0 * block_size : s1 * block_size]
    rows = np.zeros((s1 - s0) * block_size, dtype=np.uint8)
    rows[: part.size] = part
    return rows.reshape(s1 - s0, block_size)


def _block_lens(n: int, block_size: int) -> np.ndarray:
    """(n_blocks,) int32 symbols a block of an ``n``-byte input."""
    n_blocks = -(-n // block_size)
    return np.minimum(block_size, n - block_size * np.arange(n_blocks, dtype=np.int64)
                      ).astype(np.int32)


def _split_blocks(data: bytes, block_size: int):
    """(n_blocks, block_size) uint8 blocks (zero tail) and their lengths."""
    lens = _block_lens(len(data), block_size)
    syms = _block_rows(np.frombuffer(data, dtype=np.uint8), 0, lens.size, block_size)
    return syms, lens, lens.size


def _encode_words(params: Parameters, k: int, delta: int) -> int:
    """Per-block output capacity of the encoder.  Blocks whose stream
    reaches their raw size are stored raw, so the buffer never needs the
    adversarial bound."""
    return min(_static_words(params, k, delta), k // 4 + 16)


def _prior_extra(data: bytes, params: Parameters, prior_budget: int) -> Optional[np.ndarray]:
    """The warm-start prior (256 extra counts) from the byte histogram, or
    None for empty input or an all-zero quantization."""
    if not data:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    hist = np.zeros(256, dtype=np.int64)
    for s0 in range(0, src.size, _HIST_SEGMENT):
        hist += np.bincount(src[s0 : s0 + _HIST_SEGMENT], minlength=256)
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


def _gather_slices(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                   budget: int = 64 << 20) -> np.ndarray:
    """Concatenate ``buf[starts[i] : starts[i] + lens[i]]`` with a bounded
    int64 index transient (built in ~``budget``-byte segments)."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    out = np.empty(total, dtype=buf.dtype)
    csum = np.cumsum(lens)
    cuts = np.searchsorted(csum, np.arange(budget, total, budget))
    seg = np.concatenate([[0], cuts, [len(lens)]])
    pos = 0
    for a, b in zip(seg[:-1], seg[1:]):
        if a == b:
            continue
        ls = lens[a:b]
        n = int(ls.sum())
        idx = np.repeat(starts[a:b] - (np.cumsum(ls) - ls), ls) + np.arange(n, dtype=np.int64)
        out[pos : pos + n] = buf[idx]
        pos += n
    return out


def _slice_rows(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                width: int) -> np.ndarray:
    """``(len(starts), width)`` uint8 rows, row i ``buf[starts[i] :
    starts[i] + lens[i]]`` followed by zeros (``lens <= width``)."""
    rows = np.zeros((len(starts), width), dtype=np.uint8)
    rows[np.arange(width, dtype=np.int32)[None, :] < lens[:, None]] = \
        _gather_slices(buf, starts, lens)
    return rows


def _check_config(params: Parameters, block_size: int, delta: int, init_total: int):
    """Reject configs whose adaptation would freeze from the start."""
    if init_total >= params.freq_max:
        raise InvalidInputError()
    if not (params.fits_u32 or params.fits_wide32 or params.code_bits + params.freq_bits <= 62):
        raise InvalidInputError()


Devices = Union[torch.device, str, Sequence[Union[torch.device, str]]]


def _placement(device: Devices) -> tuple[torch.device, Optional[Mesh]]:
    """Where the tensors live and, for two or more devices, the mesh to
    shard over (the tensors then stay on the host)."""
    if isinstance(device, (torch.device, str)):
        return torch.device(device), None
    mesh = data_parallel_mesh(device)
    if len(mesh) == 1:
        return mesh[0], None
    return torch.device("cpu"), mesh


def _require_cuda(device: torch.device) -> None:
    """Raise for a CUDA device on a machine without one: the card is the
    default, and the CPU runs only when the caller names it."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "redux_tpu_torch: device 'cuda' (the default) but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch versions")


class _Clock:
    """Host wall time per phase into ``timings`` (seconds, accumulated)."""

    def __init__(self, timings: Optional[dict]):
        self.tt = timings if timings is not None else {}
        self.t0 = time.perf_counter()

    def mark(self, name: str) -> None:
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
    """
    clock = _Clock(_timings)
    device, mesh = _placement(device)
    params = params or Parameters.tpu_wide()
    if block_size is None:
        block_size = _default_block_size(len(data), lane_quantum)
    if params.symbol_bits != 8:
        raise InvalidInputError("the RXT container is byte-only (symbol_bits = 8)")
    if use_prior is None:
        use_prior = len(data) >= 4096
    prior_extra = _prior_extra(data, params, prior_budget) if use_prior else None
    ic = _init_cum(params, prior_extra)
    _check_config(params, block_size, delta, int(ic[-1]))
    _require_cuda(device)
    crc = container.compute_crc(data)
    clock.mark("prior+crc")

    if len(data) == 0:
        return container.build_archive(params, block_size, 0, [], prior_extra, delta, crc)

    src = np.frombuffer(data, dtype=np.uint8)
    k = block_size
    lens = _block_lens(len(data), k)
    n_blocks = lens.size
    n_words = _encode_words(params, k, delta)
    ic_t = init_cum_from_numpy(ic, params, device)
    clock.mark("split")

    # One lane chunk at a time: its blocks, the kernels, and its slice of
    # the payload (coded streams and raw blocks in block order), so the
    # host's transients are a chunk's whatever the input's size.
    chunk = _lane_chunk(ENC_CHUNK_BYTES, k)
    pieces, wire_parts, raw_parts = [], [], []
    for s0 in range(0, n_blocks, chunk):
        s1 = min(s0 + chunk, n_blocks)
        rows = _block_rows(src, s0, s1, k)
        syms_t = torch.from_numpy(rows).to(device)
        lens_t = torch.from_numpy(lens[s0:s1]).to(device)
        if mesh is None:
            words, bl, ov = encode_blocks_ranked(syms_t, lens_t, ic_t, params, n_words, delta)
        else:
            words, bl, ov = encode_blocks_ranked_sharded(
                syms_t, lens_t, ic_t, params, n_words, mesh, delta)
        bl_i = bl.cpu().numpy()
        ov_i = ov.cpu().numpy()
        wcap = min(max(1, -(-int(bl_i.max(initial=1)) // 4)), n_words)
        byts_i = words_to_bytes(words[:, :wcap]).cpu().numpy()
        del syms_t, words  # on the CPU syms_t is ``rows``, rewritten below
        # Stored raw: overflowed blocks and any block not smaller coded.
        raw_i = ov_i | (bl_i >= lens[s0:s1])
        if int(bl_i.max(initial=0)) > 4 * n_words and not bool(
            raw_i[bl_i > 4 * n_words].all()
        ):
            raise InvalidInputError()  # buffer bound violated: never silent
        # Each coded block's row takes its stream (shorter than the block);
        # a raw block's row keeps its bytes.  The wire bytes are each row's
        # first wire_len bytes.
        coded = np.flatnonzero(~raw_i)
        width = min(k, byts_i.shape[1])
        rows[coded, :width] = byts_i[coded, :width]
        wire_i = np.where(raw_i, lens[s0:s1], bl_i)
        pieces.append(rows[np.arange(k, dtype=np.int32)[None, :] < wire_i[:, None]])
        wire_parts.append(wire_i)
        raw_parts.append(raw_i)
    clock.mark("kernel+fetch")

    payload = b"".join(pieces)
    del pieces
    out = container.build_archive(
        params, block_size, len(data), [], prior_extra, delta, crc,
        np.concatenate(raw_parts).tolist(), payload=payload,
        stream_lens=np.concatenate(wire_parts).astype(np.int64).tolist(),
    )
    clock.mark("splice")
    return out


class _Lanes(NamedTuple):
    """The decoder's lanes of an archive, one a block."""

    raw: np.ndarray  # (B,) bool: stored raw, no symbols to decode
    block_lens: np.ndarray  # (B,) int32 symbols a block
    coded_lens: np.ndarray  # (B,) int64 coded stream bytes, 0 for a raw block
    order: np.ndarray  # lanes sorted by coded length (the reference's order)


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
    return _Lanes(raw, block_lens, coded_lens, np.argsort(coded_lens, kind="stable"))


def _stage_lanes(arch_u8: np.ndarray, header, lanes: _Lanes, sel: np.ndarray,
                 device: torch.device):
    """K3's input for the lanes ``sel`` of the archive ``arch_u8``: their
    streams as a ``(len(sel), wcap)`` word matrix on ``device``, zero past
    each stream and for two words past the longest (reads past a stream's
    terminator see zero bits; the kernel also bounds-checks its row), and
    their symbol counts, 0 for a raw block."""
    n_words = _static_words(header.params, header.block_size, header.delta)
    lens_o = lanes.coded_lens[sel]
    wcap = min(max(4, -(-int(lens_o.max(initial=0)) // 4) + 2), n_words + 2)
    byts = _slice_rows(arch_u8, header.stream_offs[sel], lens_o, wcap * 4)
    klens = np.where(lanes.raw[sel], 0, lanes.block_lens[sel]).astype(np.int32)
    return bytes_to_words(torch.from_numpy(byts).to(device)), torch.from_numpy(klens).to(device)


def decode(archive: bytes, *, device: Devices = "cuda",
           _timings: Optional[dict] = None) -> bytes:
    """Decompress an RXT archive.

    Verifies the stored crc32 and raises :class:`InvalidInputError` on any
    corruption instead of returning garbage.  ``device`` (default
    ``"cuda"``) runs the kernel; ``device="cpu"`` runs its plain version; a
    sequence of devices shards the blocks over them.
    """
    clock = _Clock(_timings)
    device, mesh = _placement(device)
    header, _ = container.parse_archive(archive, with_streams=False)
    params = header.params
    _require_cuda(device)
    if header.orig_len == 0:
        container.verify_crc(header, b"")
        return b""
    ic = _init_cum(params, header.prior_extra)
    n_blocks = header.n_blocks
    k = header.block_size
    arch_u8 = np.frombuffer(archive, dtype=np.uint8)
    lanes = _decode_lanes(header)
    ic_t = init_cum_from_numpy(ic, params, device)
    clock.mark("parse")

    # Each chunk of lanes decodes straight into its blocks' rows; a raw
    # block's row is its stored bytes.  Every row is written once.
    chunk = _lane_chunk(DEC_CHUNK_BYTES, k)
    syms_u8 = np.empty((n_blocks, k), dtype=np.uint8)
    for s0 in range(0, n_blocks, chunk):
        sel = lanes.order[s0 : s0 + chunk]
        if lanes.coded_lens[sel].max(initial=0) == 0:  # all-raw slab: no kernel work
            syms_u8[sel] = 0
            continue
        words, klens = _stage_lanes(arch_u8, header, lanes, sel, device)
        if mesh is None:
            out = decode_blocks(words, klens, ic_t, params, k, header.delta)
        else:
            out = decode_blocks_sharded(words, klens, ic_t, params, k, mesh, header.delta)
        syms_u8[sel] = out.cpu().numpy()
    clock.mark("stage+kernel+fetch")

    ri = np.flatnonzero(lanes.raw)
    for s0 in range(0, ri.size, chunk):
        r = ri[s0 : s0 + chunk]
        syms_u8[r] = _slice_rows(arch_u8, header.stream_offs[r],
                                 lanes.block_lens[r].astype(np.int64), k)
    out = syms_u8.reshape(-1)[: header.orig_len].tobytes()
    container.verify_crc(header, out)
    clock.mark("assemble")
    return out


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
