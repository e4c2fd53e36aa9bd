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
chunk's payload straight to its offset in the returned ``bytes``, the
header written in front of it at the end; the chunks' CRCs stay on the
device until all are queued.  ``decode`` works a range of blocks at a
time: the range's slice of the archive goes up, its output comes back
into the result's memory while the next range decodes, so its device
memory is two ranges' worth whatever the input's size.  On the card
every upload goes through pinned slots on a side stream, the next
chunk's while the current one's kernels run (:class:`_Upload`), and
every fetch likewise (:class:`_Fetch`).  Only the header, the prior's
256 counts and the lanes' order are host work.

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
import mmap
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
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

    def mark(self, name: str, part: Optional[str] = None) -> None:
        """Time since the last mark into ``name`` and, with ``part``, also
        into ``"name part"``: a phase's parts sum to the phase."""
        for d in self.wait:
            torch.cuda.synchronize(d)
        now = time.perf_counter()
        for key in (name, f"{name} {part}") if part else (name,):
            self.tt[key] = self.tt.get(key, 0.0) + (now - self.t0)
        self.t0 = now


_new_pybytes = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_pybytes_data = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p)(
    ("PyBytes_AsString", ctypes.pythonapi))
_pybytes_resize = ctypes.PYFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.c_ssize_t)(("_PyBytes_Resize", ctypes.pythonapi))
_py_decref = ctypes.PYFUNCTYPE(None, ctypes.c_void_p)(("Py_DecRef", ctypes.pythonapi))


class _Output:
    """A new ``bytes`` of at most ``n`` >= 1 bytes that a call writes in
    place through ``view`` (a writable uint8 CPU tensor over its memory)
    and returns at its final length with :meth:`result`: the one full-size
    copy of a call's output on the host.

    CPython's ``PyBytes_FromStringAndSize(NULL, n)`` makes the object.  It
    is held here as a bare pointer, its one reference, because
    ``_PyBytes_Resize`` refuses an object that anything else holds; for a
    block this size glibc's ``realloc`` shrinks it where it lies (pages
    past the end were never touched).  A failing resize frees the object
    and raises.  Use it as a context manager: the object is freed if the
    call raises before :meth:`result`.

    Its pages are new: the first write to each faults it in and zeroes it.
    :meth:`prefault` takes that off the caller's copies: ``TOUCH_THREADS``
    threads write a zero into each page of a range the caller will write
    (its first byte and each page start in it, never a byte outside it),
    ``TOUCH_PIECE`` bytes a task, while the card works; :meth:`ready`
    waits for a range's tasks before the caller writes it.  Every task is
    waited for (or cancelled) before the object is handed over or freed.
    """

    TOUCH_THREADS = 4
    TOUCH_PIECE = 16 << 20

    def __init__(self, n: int):
        if n < 1:
            raise ValueError("n must be >= 1")
        self.n = n
        self._ptr = ctypes.c_void_p(_new_pybytes(None, n))
        self.view = torch.frombuffer(
            (ctypes.c_uint8 * n).from_address(_pybytes_data(self._ptr)), dtype=torch.uint8)
        self._pool = None
        self._touches = []  # (a, b, future) of each prefault task

    def prefault(self, a: int, b: int) -> None:
        """Fault in the pages of bytes ``[a, b)``, which the caller will
        write all of, on the worker threads."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.TOUCH_THREADS, "redux-prefault")
        arr = self.view.numpy()
        for p in range(a, b, self.TOUCH_PIECE):
            q = min(p + self.TOUCH_PIECE, b)
            self._touches.append((p, q, self._pool.submit(_touch_pages, arr, p, q)))

    def ready(self, a: int, b: int) -> None:
        """Wait until every prefault of a byte in ``[a, b)`` is done."""
        for p, q, done in self._touches:
            if p < b and a < q:
                done.result()

    def _join(self) -> None:
        """Wait for the prefault tasks, cancelling those not started."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool, self._touches = None, []

    def result(self, m: int) -> bytes:
        """The object, cut to its first ``m`` bytes.  Nothing may write
        through ``view`` any more, nor hold a tensor over it."""
        if not 1 <= m <= self.n:
            raise ValueError(f"length {m} outside 1..{self.n}")
        self._join()
        self.view = None
        ptr, self._ptr = self._ptr, None
        _pybytes_resize(ctypes.byref(ptr), m)
        obj = ctypes.cast(ptr, ctypes.py_object).value
        _py_decref(ptr)
        return obj

    def __enter__(self) -> "_Output":
        return self

    def __exit__(self, *exc) -> None:
        self._join()
        if self._ptr is not None:
            self.view = None
            _py_decref(self._ptr)
            self._ptr = None


def _touch_pages(arr: np.ndarray, a: int, b: int) -> None:
    """Write a zero into byte ``a`` of ``arr`` and into each byte of ``[a,
    b)`` that starts a page: numpy, which lets the GIL go."""
    if a < b:
        arr[a] = 0
        arr[a + (-(arr.ctypes.data + a)) % mmap.PAGESIZE : b : mmap.PAGESIZE] = 0


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device``: on a CUDA device through pinned
    memory, queued on the current stream with no wait."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)


def _pinned(n: int) -> torch.Tensor:
    """``n`` bytes of pinned host memory (PyTorch's caching host allocator
    keeps it for the next call); raises if the memory cannot be pinned."""
    return torch.empty(n, dtype=torch.uint8, pin_memory=True)


class _Upload:
    """The host ranges a call reads, in order, each into a device slot.

    ``ranges`` lists ``(a, b, n)``: bytes ``data[a:b]``, then zeros to
    ``n`` bytes.  :meth:`take` gives the next range's first ``n`` bytes on
    ``device`` (ordered on the current stream after its copy), and
    :meth:`prefetch` starts the copy of the range after it, so that the
    caller can queue a range's kernels first and copy the next range on
    the host while they run.  The device holds ``min(2, len(ranges))``
    slots of the widest range, allocated once a call.

    On a CUDA device a range goes through one of as many pinned host
    slots (:func:`_pinned`, allocated at the first copy): the host copies
    it there in pieces of ``PIECE`` bytes and a side stream copies each
    piece up as soon as it is there, then zeroes the tail.  Events order
    the reuse of each slot: the host refills a pinned slot only after its
    last upload ended, and the side stream overwrites a device slot only
    after the work queued on the current stream by the range before it.
    On the CPU a range is a plain copy: no pinned memory, no stream.
    """

    PIECE = 32 << 20

    def __init__(self, data, ranges: Sequence[tuple[int, int, int]], device: torch.device):
        self.src = _host_u8(data)
        self.ranges = list(ranges)
        self.device = device
        n_slots = min(2, len(self.ranges))
        width = max((n for _, _, n in self.ranges), default=0)
        self.slots = torch.empty(n_slots, width, dtype=torch.uint8, device=device)
        self.side = torch.cuda.Stream(device) if device.type == "cuda" else None
        if self.side is not None:
            self.slots.record_stream(self.side)  # freed only once the side stream's copies end
        self.pinned = []
        self.uploaded = [None] * n_slots  # the side stream's event after a slot's last upload
        self.released = [None] * n_slots  # the current stream's event after a slot's last reader
        self.loaded = self.taken = 0  # at most one range is loaded ahead of the last taken

    def _load(self) -> None:
        j = self.loaded
        a, b, n = self.ranges[j]
        s = j % self.slots.shape[0]
        dst = self.slots[s]
        self.loaded += 1
        if self.side is None:
            dst[: b - a].copy_(self.src[a:b])
            dst[b - a : n].zero_()
            return
        if not self.pinned:
            self.pinned = [_pinned(self.slots.shape[1]) for _ in range(self.slots.shape[0])]
        if self.uploaded[s] is not None:
            self.uploaded[s].synchronize()
        if self.released[s] is not None:
            self.side.wait_event(self.released[s])
        pin = self.pinned[s]
        for p in range(0, b - a, self.PIECE):
            q = min(p + self.PIECE, b - a)
            pin[p:q].copy_(self.src[a + p : a + q])
            with torch.cuda.stream(self.side):
                dst[p:q].copy_(pin[p:q], non_blocking=True)
        with torch.cuda.stream(self.side):
            dst[b - a : n].zero_()
            self.uploaded[s] = self.side.record_event()

    def prefetch(self) -> None:
        """Copy the range after the one last taken, if there is one."""
        if self.loaded == self.taken < len(self.ranges):
            self._load()

    def take(self) -> torch.Tensor:
        """The next range on the device, ``(n,)`` uint8."""
        j = self.taken
        s = j % self.slots.shape[0]
        if self.side is not None and j:
            prev = (j - 1) % self.slots.shape[0]
            self.released[prev] = torch.cuda.current_stream(self.device).record_event()
        if self.loaded == j:
            self._load()
        if self.side is not None:
            torch.cuda.current_stream(self.device).wait_event(self.uploaded[s])
        self.taken += 1
        return self.slots[s, : self.ranges[j][2]]


class _Fetch:
    """Byte ranges on the device into the result's memory (an
    :class:`_Output`).

    On a CUDA device :meth:`put` copies a range to the host on a side
    stream, after the work queued on the current stream, into one of
    ``n_slots`` pinned slots of ``slot_bytes`` (allocated at the first
    put), and :meth:`drain` waits for that copy and copies the pinned slot
    into ``dst``: the caller drains range ``i - 1`` while the card runs
    range ``i``.  Every put drains first, so a range waits for the host
    copy of the range two before it, the last one to use its slot.  On
    the CPU, put copies into ``dst`` at once: no pinned memory, no stream.
    Each copy into ``dst`` first waits for the range's prefault
    (:meth:`_Output.ready`).
    """

    def __init__(self, out: _Output, device: torch.device, slot_bytes: int, n_slots: int):
        self.out = out
        self.slot_bytes, self.n_slots = slot_bytes, n_slots
        self.side = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.pinned = []
        self.pending = None  # (event, pinned slot, offset in dst)

    def put(self, i: int, flat: torch.Tensor, off: int) -> None:
        """Range ``i``'s bytes ``flat`` (on the device) to ``dst[off:]``."""
        self.drain()
        if self.side is None:
            self.out.ready(off, off + flat.shape[0])
            self.out.view[off : off + flat.shape[0]].copy_(flat)
            return
        if not self.pinned:
            self.pinned = [_pinned(self.slot_bytes) for _ in range(self.n_slots)]
        slot = self.pinned[i % self.n_slots][: flat.shape[0]]
        self.side.wait_stream(torch.cuda.current_stream(flat.device))
        flat.record_stream(self.side)  # its memory is reused only once the copy ends
        with torch.cuda.stream(self.side):
            slot.copy_(flat, non_blocking=True)
            self.pending = (self.side.record_event(), slot, off)

    def drain(self) -> None:
        """The pending range from its pinned slot into ``dst``."""
        if self.pending is not None:
            done, slot, off = self.pending
            done.synchronize()
            self.out.ready(off, off + slot.shape[0])
            self.out.view[off : off + slot.shape[0]].copy_(slot)
            self.pending = None


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

    The input goes up a lane chunk at a time (:class:`_Upload`), twice
    past one chunk; each chunk's payload comes back (:class:`_Fetch`)
    straight to its offset in the returned ``bytes``, and the header is
    written in front of it once the last payload is there
    (:func:`container.write_header`).  Each range's pages are prefaulted
    once its length is known (:meth:`_Output.prefault`).

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
    spans = [(s0, min(s0 + chunk, n_blocks)) for s0 in range(0, n_blocks, chunk)]
    # Each chunk's bytes, zero past the input to its blocks' end; pass 2
    # reads them again past one chunk.
    ranges = [(s0 * k, min(s1 * k, n), (s1 - s0) * k) for s0, s1 in spans]
    up = _Upload(data, ranges + (ranges if len(spans) > 1 else []), device)

    # Pass 1, a lane chunk at a time: the histogram and the chunk's crc on
    # the device, fetched once after the last chunk.  An input of one
    # chunk keeps its blocks for pass 2.
    hist = torch.zeros(256, dtype=torch.int64, device=device)
    crcs = torch.zeros(len(spans), dtype=torch.int32, device=device)
    after, kept = [], None
    for i, (a, b, _) in enumerate(ranges):
        slot = up.take()
        if use_prior:
            hist += _byte_histogram(slot[: b - a])
        crc32_device(slot[: b - a], crcs[i : i + 1])
        up.prefetch()
        after.append(n - b)
        if len(spans) == 1:
            kept = slot
    crc = combine_crcs(crcs.cpu().to(torch.int64) & 0xFFFFFFFF, torch.tensor(after))
    prior_extra = _prior_extra(hist.cpu().numpy(), params, prior_budget) if use_prior else None
    ic = _init_cum(params, prior_extra)
    _check_config(params, block_size, delta, int(ic[-1]))
    clock.mark("pass1")

    if n == 0:
        return container.build_archive(params, block_size, 0, [], prior_extra, delta, crc)

    # Pass 2, a lane chunk at a time: K1 -> K2 on the chunk's blocks, the
    # raw rule, the payload spliced on the device and fetched to its place
    # after the header, which the wire lengths and raw flags then fill.
    # A block is stored raw unless its stream is shorter, so the payload
    # takes at most n bytes.
    n_words = _encode_words(params, k, delta)
    ic_t = _to_device(init_cum_from_numpy(ic, params, "cpu"), device)
    head_len = container.header_bytes(n_blocks, prior_extra is not None)
    wire_all = np.empty(n_blocks, dtype=np.int32)
    raw_all = np.empty(n_blocks, dtype=bool)
    with _Output(head_len + n) as out:
        out.prefault(0, head_len)
        fetch = _Fetch(out, device, ranges[0][2], min(2, len(spans)))
        off = head_len
        for i, (s0, s1) in enumerate(spans):
            blocks = (kept if kept is not None else up.take()).view(s1 - s0, k)
            lens_t = _to_device(lens[s0:s1], device)
            if mesh is None:
                words, bl, ov = encode_blocks_ranked(blocks, lens_t, ic_t, params, n_words, delta)
            else:
                words, bl, ov = encode_blocks_ranked_sharded(
                    blocks, lens_t, ic_t, params, n_words, mesh, delta)
            up.prefetch()  # the next chunk's host copy while K1 -> K2 run
            fetch.drain()  # the previous chunk's payload into place, likewise
            # Stored raw: overflowed blocks and any block not smaller coded.
            # The wire lengths and flags come to the host for the header; S2
            # lays the payload out by them.
            raw = ov | (bl >= lens_t)
            head = torch.stack([torch.where(raw, lens_t, bl), raw.to(torch.int32)]).cpu()
            wire, raw_h = head[0], head[1].bool()
            out.prefault(off, off + int(wire.numpy().sum(dtype=np.int64)))
            payload = splice_payload(words, blocks, raw_h, wire)
            fetch.put(i, payload, off)
            off += payload.shape[0]
            wire_all[s0:s1], raw_all[s0:s1] = wire.numpy(), raw_h.numpy()
            del blocks, words, payload
        fetch.drain()
        clock.mark("pass2")
        out.ready(0, head_len)
        container.write_header(out.view.numpy(), params, block_size, n, prior_extra, delta, crc,
                               raw_all, wire_all)
        del fetch
        archive = out.result(off)
        clock.mark("header")
        return archive


class _Lanes(NamedTuple):
    """The decoder's lanes of an archive, one a block."""

    raw: np.ndarray  # (B,) bool: stored raw, no symbols to decode
    block_lens: np.ndarray  # (B,) int32 symbols a block
    coded_lens: np.ndarray  # (B,) int64 coded stream bytes, 0 for a raw block


def _by_length(lens: np.ndarray) -> np.ndarray:
    """The stable argsort of stream lengths (numpy's radix sort when they
    fit 16 bits, as they do below 16 KiB blocks)."""
    if lens.size and lens.max() < 1 << 16:
        lens = lens.astype(np.uint16)
    return np.argsort(lens, kind="stable")


def _decode_lanes(table: container.BlockTable) -> _Lanes:
    """Which blocks of ``table`` (:func:`container.parse_table`) are coded
    and their stream lengths (K3 takes a range's coded blocks sorted by
    them, :func:`_by_length`); InvalidInputError
    where a raw block's stored length is not its block length, or a coded
    stream is longer than the decoder's row (``n_words + 2`` words,
    :func:`_stage_lanes`) can hold: the encoder never writes one."""
    block_lens = _block_lens(table.orig_len, max(table.block_size, 1))  # parse checked n_blocks
    raw = table.raw
    if (table.byte_lens[raw] != block_lens[raw]).any():
        raise InvalidInputError()
    coded_lens = np.where(raw, 0, table.byte_lens)
    n_words = _static_words(table.params, table.block_size, table.delta)
    if coded_lens.max(initial=0) > 4 * (n_words + 2):
        raise InvalidInputError()
    return _Lanes(raw, block_lens, coded_lens)


def _stage_lanes(arch: torch.Tensor, header, lanes: _Lanes, sel: np.ndarray, base: int = 0):
    """K3's input for the lanes ``sel`` of the archive bytes ``arch`` (a
    uint8 tensor from archive offset ``base`` on; S1 on its device): their
    streams as a ``(len(sel), wcap)`` word matrix, zero past each stream
    and for two words past the longest (reads past a stream's terminator
    see zero bits; the kernel also bounds-checks its row), and their int32
    symbol counts, 0 for a raw block.  S1 takes the offsets and lengths
    as host arrays: no wait for the card."""
    dev = arch.device
    n_words = _static_words(header.params, header.block_size, header.delta)
    lens_o = lanes.coded_lens[sel]
    wcap = min(max(4, -(-int(lens_o.max(initial=0)) // 4) + 2), n_words + 2)
    words = gather_rows(arch, header.stream_offs[sel] - base, lens_o, wcap, words=True)
    klens = np.where(lanes.raw[sel], 0, lanes.block_lens[sel]).astype(np.int32)
    return words, _to_device(klens, dev)


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
    S1 calls check their rows on the host and queue their kernels with no
    wait.  No coded block, no K3."""
    dev = arch.device
    raw = lanes.raw[s0 : s0 + out.shape[0]]
    ri, ci = np.flatnonzero(raw), np.flatnonzero(~raw)
    if ri.size:
        r = s0 + ri
        rows = gather_rows(arch, header.stream_offs[r] - base,
                           lanes.block_lens[r].astype(np.int64), out.shape[1])
    if ci.size:
        ci = ci[_by_length(lanes.coded_lens[s0 + ci])]
        words, klens = _stage_lanes(arch, header, lanes, s0 + ci, base)
        k, p, d = header.block_size, header.params, header.delta
        if mesh is None:
            syms = decode_blocks(words, klens, ic_t, p, k, d)
        else:
            syms = decode_blocks_sharded(words, klens, ic_t, p, k, mesh, d)
        del words
        out.index_copy_(0, _to_device(ci, dev), syms)
    if ri.size:
        out.index_copy_(0, _to_device(ri, dev), rows)


def decode(archive: bytes, *, device: Devices = "cuda",
           _timings: Optional[dict] = None) -> bytes:
    """Decompress an RXT archive.

    Verifies the stored crc32 and raises :class:`InvalidInputError` on any
    corruption instead of returning garbage.  ``device`` (default
    ``"cuda"``) runs the kernel; ``device="cpu"`` runs its plain version; a
    sequence of devices shards each chunk's blocks over them.

    A chunk is a range of ``_lane_chunk(DEC_CHUNK_BYTES, k)`` blocks.  Each
    has its own upload (its slice of the archive, :class:`_Upload`: on the
    card the next range's slice goes up while K3 runs), S1 and K3 into its
    own output rows (:func:`_decode_chunk`), S3, and fetch
    (:class:`_Fetch`: on the card the output comes back on a side stream
    while the next chunk runs); the chunks' CRCs stay on the device until
    the last chunk, then come back together to be combined and checked.
    The device holds at most two chunks' slices and outputs and one
    chunk's words and symbols, whatever the input's size.

    The header's block table is read by numpy (:func:`container.parse_table`):
    no Python object a block.  The result's pages are faulted in on worker
    threads while the card decodes (:meth:`_Output.prefault`), so the
    fetch's copies write pages that are there.

    ``_timings`` receives the wall time of each phase, summed over the
    chunks: ``parse`` (the header and the lanes), ``upload`` (a chunk's
    slice), ``kernels`` (S1 -> K3 into the rows, the raw rows) and
    ``crc+fetch`` (S3, the copy to the host and into the result), which
    splits into ``crc+fetch s3`` (S3, and the CRCs' combine and check),
    ``crc+fetch d2h`` (the copy to a pinned slot, and its wait) and
    ``crc+fetch copy`` (the slot into the result, with any wait for its
    prefault).  Each mark waits for the card, which serializes the fetch
    that otherwise overlaps the next chunk: read the wall clock from a
    call without ``_timings``.
    """
    device, mesh = _placement(device)
    clock = _Clock(_timings, mesh or [device])
    header = container.parse_table(archive)
    params = header.params
    _require_cuda(device)
    if header.orig_len == 0:
        container.verify_crc(header, b"")
        return b""
    n, k, n_blocks = header.orig_len, header.block_size, header.n_blocks
    lanes = _decode_lanes(header)
    ic_t = _to_device(init_cum_from_numpy(_init_cum(params, header.prior_extra), params, "cpu"),
                      device)
    chunk = _lane_chunk(DEC_CHUNK_BYTES, k)
    slices = _chunk_slices(header, lanes, chunk)
    up = _Upload(archive, [(a, b, b - a) for _, _, a, b in slices], device)
    rows = min(chunk, n_blocks)
    outs = torch.empty(min(2, len(slices)), rows, k, dtype=torch.uint8, device=device)
    crcs = torch.zeros(len(slices), dtype=torch.int32, device=device)
    after = []
    with _Output(n) as output:
        for s0, s1, _, _ in slices:  # every byte of the result is written, a range at a time
            output.prefault(s0 * k, min(s1 * k, n))
        fetch = _Fetch(output, device, rows * k, outs.shape[0])
        clock.mark("parse")
        for i, (s0, s1, base, _) in enumerate(slices):
            arch = up.take()
            clock.mark("upload")
            out = outs[i % outs.shape[0], : s1 - s0]
            _decode_chunk(arch, base, header, lanes, s0, out, ic_t, mesh)
            del arch
            clock.mark("kernels")
            up.prefetch()  # the next range's host copy while K3 runs
            clock.mark("upload")
            fetch.drain()  # the previous range into the result, likewise
            clock.mark("crc+fetch", "copy")
            flat = out.view(-1)[: min(s1 * k, n) - s0 * k]
            crc32_device(flat, crcs[i : i + 1])
            after.append(n - s0 * k - flat.shape[0])
            clock.mark("crc+fetch", "s3")
            fetch.put(i, flat, s0 * k)
            clock.mark("crc+fetch", "d2h")
        fetch.drain()
        del fetch
        clock.mark("crc+fetch", "copy")
        crc = combine_crcs(crcs.cpu().to(torch.int64) & 0xFFFFFFFF, torch.tensor(after))
        if crc != header.crc32:
            raise InvalidInputError()
        clock.mark("crc+fetch", "s3")
        return output.result(n)


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
