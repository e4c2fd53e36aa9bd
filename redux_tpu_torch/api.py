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
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import container
from .container import DEFAULT_BLOCK_SIZE, DEFAULT_DELTA, DEFAULT_PRIOR_BUDGET
from .convert import init_cum_from_numpy
from .errors import InvalidInputError
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


def _static_words(params: Parameters, k: int, delta: int = DEFAULT_DELTA) -> int:
    max_count = min(params.symbol_count + DEFAULT_PRIOR_BUDGET + delta * k, params.freq_max)
    return max_block_words(max_count, params.symbol_count, params, k)


def _split_blocks(data: bytes, block_size: int):
    """(n_blocks, block_size) uint8 blocks (zero tail) and their lengths."""
    n_blocks = (len(data) + block_size - 1) // block_size
    lens = np.full(n_blocks, block_size, dtype=np.int32)
    if len(data) % block_size:
        lens[-1] = len(data) % block_size
    syms = np.zeros(n_blocks * block_size, dtype=np.uint8)
    syms[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    return syms.reshape(n_blocks, block_size), lens, n_blocks


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
    hist = np.bincount(np.frombuffer(data, dtype=np.uint8), minlength=256)
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
        block_size = (
            _auto_block_size(len(data), lane_quantum)
            if len(data) >= _AUTO_BS_MIN
            else DEFAULT_BLOCK_SIZE
        )
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

    syms, lens, n_blocks = _split_blocks(data, block_size)
    k = block_size
    n_words = _encode_words(params, k, delta)
    blk_lens = np.minimum(block_size, len(data) - block_size * np.arange(n_blocks, dtype=np.int64))
    ic_t = init_cum_from_numpy(ic, params, device)
    clock.mark("split")

    chunk = max(128, (ENC_CHUNK_BYTES // k) // 128 * 128)
    cat_parts, bl_parts, raw_parts = [], [], []
    for s0 in range(0, n_blocks, chunk):
        s1 = min(s0 + chunk, n_blocks)
        syms_t = torch.from_numpy(syms[s0:s1]).to(device)
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
        # Stored raw: overflowed blocks and any block not smaller coded.
        raw_i = ov_i | (bl_i >= blk_lens[s0:s1])
        if int(bl_i.max(initial=0)) > 4 * n_words and not bool(
            raw_i[bl_i > 4 * n_words].all()
        ):
            raise InvalidInputError()  # buffer bound violated: never silent
        mask = (
            np.arange(byts_i.shape[1], dtype=np.int32)[None, :]
            < np.where(raw_i, 0, bl_i)[:, None]
        )
        cat_parts.append(byts_i[mask])
        bl_parts.append(bl_i)
        raw_parts.append(raw_i)
    byte_lens = np.concatenate(bl_parts)
    raw_v = np.concatenate(raw_parts)
    coded_cat = np.concatenate(cat_parts)
    clock.mark("kernel+fetch")

    # Splice: coded bytes are in block order; raw blocks go in at their places.
    coded_lens = np.where(raw_v, 0, byte_lens)
    raw_idx = np.flatnonzero(raw_v)
    if raw_idx.size:
        cuts = np.cumsum(coded_lens)[raw_idx]
        pieces = np.split(coded_cat, cuts)
        parts = []
        for j, i in enumerate(raw_idx):
            parts.append(pieces[j].tobytes())
            parts.append(data[i * block_size : i * block_size + blk_lens[i]])
        parts.append(pieces[-1].tobytes())
        payload = b"".join(parts)
    else:
        payload = coded_cat.tobytes()
    wire_lens = np.where(raw_v, blk_lens, byte_lens).astype(np.int64)
    out = container.build_archive(
        params, block_size, len(data), [], prior_extra, delta, crc,
        raw_v.tolist(), payload=payload, stream_lens=wire_lens.tolist(),
    )
    clock.mark("splice")
    return out


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
    block_lens = np.asarray(header.block_lens, dtype=np.int32)
    raw_v = (
        np.asarray(header.block_raw, dtype=bool)
        if header.block_raw
        else np.zeros(n_blocks, dtype=bool)
    )
    k = header.block_size
    n_words = _static_words(params, k, header.delta)
    arch_u8 = np.frombuffer(archive, dtype=np.uint8)
    stream_offs = header.stream_offs
    stream_lens = np.asarray(header.block_byte_lens, dtype=np.int64)
    if (stream_lens[raw_v] != block_lens[raw_v]).any():
        raise InvalidInputError()
    coded_lens = np.where(raw_v, 0, stream_lens)
    sym_lens = np.where(raw_v, 0, block_lens)
    # Lanes sorted by coded length (the reference's order; inverted below).
    order = np.argsort(coded_lens, kind="stable")
    ic_t = init_cum_from_numpy(ic, params, device)
    clock.mark("parse")

    chunk = max(128, (DEC_CHUNK_BYTES // max(k, 1)) // 128 * 128)
    syms_u8 = np.empty((n_blocks, k), dtype=np.uint8)
    for s0 in range(0, n_blocks, chunk):
        s1 = min(s0 + chunk, n_blocks)
        sel = order[s0:s1]
        coded_max = int(coded_lens[sel].max(initial=0))
        if coded_max == 0:  # all-raw slab: no kernel work
            syms_u8[s0:s1] = 0
            continue
        # Two zero words past the longest stream: reads past a stream's
        # terminator see zero bits (the kernel also bounds-checks its row).
        wcap = min(max(4, -(-coded_max // 4) + 2), n_words + 2)
        lens_o = coded_lens[sel]
        cat = _gather_slices(arch_u8, stream_offs[sel], lens_o)
        byts = np.zeros((s1 - s0, wcap * 4), dtype=np.uint8)
        byts[np.arange(wcap * 4, dtype=np.int32)[None, :] < lens_o[:, None]] = cat
        words = bytes_to_words(torch.from_numpy(byts).to(device))
        klens = torch.from_numpy(sym_lens[sel].astype(np.int32)).to(device)
        if mesh is None:
            out = decode_blocks(words, klens, ic_t, params, k, header.delta)
        else:
            out = decode_blocks_sharded(words, klens, ic_t, params, k, mesh, header.delta)
        syms_u8[s0:s1] = out.cpu().numpy()
    clock.mark("stage+kernel+fetch")

    inv = np.empty(n_blocks, dtype=np.int64)
    inv[order] = np.arange(n_blocks)
    flat = syms_u8[inv]  # back in block order
    if raw_v.any():
        ri = np.flatnonzero(raw_v)
        rlens = block_lens[ri].astype(np.int64)
        cat = _gather_slices(arch_u8, stream_offs[ri], rlens)
        rows = np.zeros((ri.size, k), dtype=np.uint8)
        rows[np.arange(k, dtype=np.int32)[None, :] < rlens[:, None]] = cat
        flat[ri] = rows
    out = flat.reshape(-1)[: header.orig_len].tobytes()
    container.verify_crc(header, out)
    clock.mark("assemble")
    return out
