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
splice, S3 crc32, S4 byte histogram).  ``encode``
reads the input in lane chunks twice (histogram and crc, then the
kernels; an input of one chunk a device crosses the bus once) and
fetches each chunk's payload straight to its offset in the returned
``bytes``, the header written in front of it at the end; the chunks'
CRCs stay on the device until all are queued.  ``decode`` works a range of blocks at a
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
the tests do).  A sequence of two or more devices splits the blocks
over them (the explicit counterpart of the reference's ``_dp_mesh``
branches, :98-113, :300-316, :483-510, which shard every chunk over
every device): a call runs in steps (:func:`_shares`), each giving each
device one contiguous share of at most a lane chunk, and each device
uploads, codes, splices, checks and fetches its own shares with its own
slots and streams; no byte goes from device to device, and only the
histogram's 256 counts, the CRCs and the wire lengths meet on the host.
A list may name one device twice (two shares a step on one card).
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
import itertools
import mmap
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from . import _build, container, native
from .container import DEFAULT_BLOCK_SIZE, DEFAULT_DELTA, DEFAULT_PRIOR_BUDGET
from .convert import init_cum_from_numpy
from .errors import InvalidInputError, ReduxError
from .models.dense import prior_init_cum, quantize_prior, uniform_init_cum
from .ops.coder import max_block_words
from .ops.decode import decode_blocks
from .ops.encode import encode_blocks_ranked
from .ops.staging import byte_histogram, combine_crcs, crc32_device, gather_rows, splice_payload
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
    (the reference's ``np.bincount``): S4 into a zeroed row, no wait."""
    return byte_histogram(u8, torch.zeros(256, dtype=torch.int64, device=u8.device))


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


def _cards(device: Devices) -> list[torch.device]:
    """The devices of a call, one share of a step each (:func:`_shares`):
    ``device`` alone, or each of a sequence, which may name a device more
    than once.  A CUDA device without an index is card 0, the card the
    kernels' launchers take for it, so every tensor of the call names its
    card whatever the current device."""
    devs = [device] if isinstance(device, (torch.device, str)) else list(device)
    if not devs:
        raise ValueError("a device list needs at least one device")
    devs = [torch.device(d) for d in devs]
    return [torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d
            for d in devs]


class _Share(NamedTuple):
    """Blocks ``s0 .. s1`` of a call, on its device ``card`` (an index into
    the call's devices), that device's share number ``i``."""

    card: int
    i: int
    s0: int
    s1: int


def _shares(n_blocks: int, chunk: int, n_cards: int) -> list[list[_Share]]:
    """The steps of a call over ``n_cards`` devices, in block order: each
    step gives each device at most one contiguous share of at most
    ``chunk`` blocks.  A step takes the next ``n_cards * chunk`` blocks, a
    chunk a device; the blocks left after the last such step are split
    evenly over the devices (the first ones take a block more where they
    do not divide), so a device goes without a share only where fewer
    blocks than devices are left.  One device: the lane chunks of
    ``chunk`` blocks, the last one the rest."""
    steps, s0, count = [], 0, [0] * n_cards
    while s0 < n_blocks:
        left = n_blocks - s0
        if left >= n_cards * chunk:
            sizes = [chunk] * n_cards
        else:
            sizes = [left // n_cards + (j < left % n_cards) for j in range(n_cards)]
        step = []
        for j, m in enumerate(sizes):
            if m:
                step.append(_Share(j, count[j], s0, s0 + m))
                count[j] += 1
                s0 += m
        steps.append(step)
    return steps


def _by_card(steps: list[list[_Share]], n_cards: int) -> list[list[_Share]]:
    """Each device's shares, in order."""
    own = [[] for _ in range(n_cards)]
    for step in steps:
        for sh in step:
            own[sh.card].append(sh)
    return own


def _each(shares: Sequence[_Share], *fns: Callable[[_Share], None],
          rec: Optional[_Recorder] = None) -> None:
    """Run the first of ``fns`` on every share of a step, then the second
    on every share, and so on: every device's kernels are queued before
    the host copies that follow them.  Each run serves its share's device
    (:meth:`_Recorder.serve`)."""
    for fn in fns:
        for sh in shares:
            _serve(rec, sh.card)
            fn(sh)


def _crc_of(steps: list[list[_Share]], crcs: dict, n: int, k: int,
            rec: Optional[_Recorder] = None) -> int:
    """The CRC-32 of a call's ``n`` bytes from each share's CRC, ``crcs[j][i]``
    on device ``j`` for its share ``i`` (one fetch a device, the call's
    ``sums wait``), combined in block order."""
    got = {j: _to_host(crcs[j]).to(torch.int64) & 0xFFFFFFFF for j in _serving(rec, crcs)}
    _mark(rec, "sums wait")
    order = [sh for step in steps for sh in step]
    return combine_crcs(torch.tensor([int(got[sh.card][sh.i]) for sh in order], dtype=torch.int64),
                        torch.tensor([n - min(sh.s1 * k, n) for sh in order], dtype=torch.int64))


def _require_cuda(device: torch.device) -> None:
    """Raise for a CUDA device on a machine without one: the card is the
    default, and the CPU runs only when the caller names it."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "redux_tpu_torch: device 'cuda' (the default) but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch versions")


RECORDED_CALLS = 4096  # the recorded calls kept, newest last: a traced window's and more
_records: deque = deque(maxlen=RECORDED_CALLS)
_call_ids = itertools.count()


def recorded_calls() -> list[dict]:
    """The last :data:`RECORDED_CALLS` calls of :func:`encode` and
    :func:`decode` made with ``_timings`` that returned, oldest first.
    Each is a dict: ``id`` (in call order), ``kind`` (``"enc"`` or
    ``"dec"``), ``bytes_in`` and ``bytes_out`` (the call's argument and
    result), ``cards`` (its devices), ``spans`` (``(phase, part,
    start_ns, end_ns)`` a mark; on a call over several devices a part that
    serves one device's shares ends in ``@j``, ``j`` its position in
    ``cards``), ``h2d`` and ``d2h`` (bytes the call copied to and from its
    devices, ``_build.bus_bytes`` over the call), ``h2d_by_card`` and
    ``d2h_by_card`` (the same bytes by the position in ``cards`` of the
    device each copy served: lists aligned with ``cards`` that sum to
    ``h2d`` and ``d2h``), ``blocks_by_card`` (the blocks of each position's
    shares, from :func:`_shares`), and ``warp_blocks`` and
    ``thread_blocks`` (the blocks K3 decoded on each route on the call's
    devices, ``_build.route_blocks`` over the call)."""
    return list(_records)


class _Recorder:
    """The record of one call made with ``_timings``: a span a mark, and
    the bytes the call copies over the bus.

    The call sets its phase (``phase``); :meth:`mark` ends the span since
    the previous mark (the recorder's start for the first) as ``part`` of
    that phase and adds its seconds to ``timings[phase]`` and
    ``timings["phase part"]`` at once, so a phase is the sum of its parts
    and a ``_timings`` that notes its writes notes each span's end.
    Nothing here waits for a device: a recorded call issues the waits of
    an unrecorded one.  Times are ``time.time_ns()``, the clock
    ``torch.profiler`` stamps its host events with.  The bytes are what
    the copies count into ``_build.bus_bytes`` from the recorder's start
    until the call has its result and hands its record to
    :func:`recorded_calls` (:meth:`done`), and so are the blocks K3
    decodes a route on the call's devices (``_build.route_blocks``).

    The call names the entry of its device list that its next steps serve
    (:meth:`serve`, by position: a list that names one device twice has
    two entries).  The bytes counted from then until it names another go
    to that entry; on a list of two or more, the marks made meanwhile end
    their part in ``@j``.  Steps that serve the whole call (the parse, the
    header, the CRCs' combine) serve no entry: their parts keep their
    names."""

    def __init__(self, timings: dict, kind: str, nbytes: int, cards: Sequence[torch.device]):
        self.tt, self.kind, self.bytes_in = timings, kind, nbytes
        self.cards = [str(d) for d in cards]
        self.indices = {d.index or 0 for d in cards if d.type == "cuda"}
        self.phase = ""
        self.spans = []
        self.entry = None  # the entry the next marks serve; None: the whole call
        self.owner = 0  # the entry the bytes counted since ``seen`` serve
        self.by_card = {way: [0] * len(cards) for way in ("h2d", "d2h")}
        self.blocks = [0] * len(cards)
        self.bus0 = _build.bus_bytes.copy()
        self.seen = self.bus0.copy()
        self.blocks0 = _build.route_blocks.copy()
        self.t0 = time.time_ns()

    def plan(self, own: list[list[_Share]]) -> None:
        """The call's shares, each entry's (:func:`_by_card`)."""
        self.blocks = [sum(sh.s1 - sh.s0 for sh in mine) for mine in own]

    def serve(self, j: Optional[int]) -> None:
        """The next steps serve entry ``j``, or the whole call (None: the
        bytes go on to the last entry named)."""
        if j is not None and j != self.owner:
            self._settle()
            self.owner = j
        self.entry = j

    def _settle(self) -> None:
        """The bytes counted since the last settle to the entry served."""
        for way in ("h2d", "d2h"):
            self.by_card[way][self.owner] += _build.bus_bytes[way] - self.seen[way]
            self.seen[way] = _build.bus_bytes[way]

    def mark(self, part: str) -> None:
        now = time.time_ns()
        if self.entry is not None and len(self.cards) > 1:
            part = f"{part}@{self.entry}"
        ns = now - self.t0
        for key in (self.phase, f"{self.phase} {part}"):  # first, close to ``now``
            self.tt[key] = self.tt.get(key, 0.0) + ns / 1e9
        self.spans.append((self.phase, part, self.t0, now))
        self.t0 = now

    def done(self, nbytes: int) -> None:
        """The call returns ``nbytes``: its record into :func:`recorded_calls`."""
        self._settle()
        bus = {way: _build.bus_bytes[way] - self.bus0[way] for way in ("h2d", "d2h")}
        blocks = {f"{route}_blocks": sum(_build.route_blocks[route, i] - self.blocks0[route, i]
                                         for i in self.indices) for route in ("warp", "thread")}
        _records.append(dict(id=next(_call_ids), kind=self.kind, bytes_in=self.bytes_in,
                             bytes_out=nbytes, cards=self.cards, spans=self.spans, **bus,
                             h2d_by_card=self.by_card["h2d"], d2h_by_card=self.by_card["d2h"],
                             blocks_by_card=self.blocks, **blocks))


def _phase(rec: Optional[_Recorder], phase: str) -> None:
    """The recorded call's next marks are parts of ``phase``."""
    if rec is not None:
        rec.phase = phase


def _mark(rec: Optional[_Recorder], part: str) -> None:
    """End the recorded call's span since its last mark as ``part``."""
    if rec is not None:
        rec.mark(part)


def _serve(rec: Optional[_Recorder], j: Optional[int]) -> None:
    """The recorded call's next steps serve entry ``j`` of its devices, or
    the whole call (None)."""
    if rec is not None:
        rec.serve(j)


def _serving(rec: Optional[_Recorder], entries):
    """Each of ``entries`` in turn, the recorded call's steps serving it
    until the next is drawn; once all are drawn, the whole call."""
    for j in entries:
        _serve(rec, j)
        yield j
    _serve(rec, None)


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
    Each wait for the tasks is a ``prefault wait`` of ``rec``, the call's
    recorder (None where the call is not recorded).
    """

    TOUCH_THREADS = 4
    TOUCH_PIECE = 16 << 20

    def __init__(self, n: int, rec: Optional[_Recorder] = None):
        if n < 1:
            raise ValueError("n must be >= 1")
        self.n, self.rec = n, rec
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
        _mark(self.rec, "prefault wait")

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
        _mark(self.rec, "prefault wait")
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
    _build.count_bus(h2d=t.nbytes)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A small device tensor on the host: on a CUDA device the host waits
    for it."""
    _build.count_bus(d2h=t.nbytes)
    return t.cpu()


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

    Each range counts the bytes it takes from ``data`` (the zeroed tail
    is set on the device).  ``rec``, the call's recorder (None where the
    call is not recorded), marks the host's steps of a copy: the pinned
    slots' allocation (``pin``), the wait for a slot's last upload (``slot
    wait``) and the host copy with the pieces' queueing (``stage``).
    """

    PIECE = 32 << 20

    def __init__(self, data, ranges: Sequence[tuple[int, int, int]], device: torch.device,
                 rec: Optional[_Recorder] = None):
        self.src = _host_u8(data)
        self.ranges = list(ranges)
        self.device = device
        self.rec = rec
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
        _build.count_bus(h2d=b - a)
        if self.side is None:
            dst[: b - a].copy_(self.src[a:b])
            dst[b - a : n].zero_()
            _mark(self.rec, "stage")
            return
        if not self.pinned:
            self.pinned = [_pinned(self.slots.shape[1]) for _ in range(self.slots.shape[0])]
            _mark(self.rec, "pin")
        if self.uploaded[s] is not None:
            self.uploaded[s].synchronize()
            _mark(self.rec, "slot wait")
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
        _mark(self.rec, "stage")

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

    Each range counts its bytes.  The output's recorder (``out.rec``)
    marks the host's steps: the pinned slots' allocation (``pin``), a
    put's queueing (``launch``), the wait for a fetch (``fetch wait``) and
    the copy into ``dst`` (``copy``).
    """

    def __init__(self, out: _Output, device: torch.device, slot_bytes: int, n_slots: int):
        self.out, self.rec = out, out.rec
        self.slot_bytes, self.n_slots = slot_bytes, n_slots
        self.side = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.pinned = []
        self.pending = None  # (event, pinned slot, offset in dst)

    def put(self, i: int, flat: torch.Tensor, off: int) -> None:
        """Range ``i``'s bytes ``flat`` (on the device) to ``dst[off:]``."""
        self.drain()
        _build.count_bus(d2h=flat.nbytes)
        if self.side is None:
            self.out.ready(off, off + flat.shape[0])
            self.out.view[off : off + flat.shape[0]].copy_(flat)
            _mark(self.rec, "copy")
            return
        if not self.pinned:
            self.pinned = [_pinned(self.slot_bytes) for _ in range(self.n_slots)]
            _mark(self.rec, "pin")
        slot = self.pinned[i % self.n_slots][: flat.shape[0]]
        self.side.wait_stream(torch.cuda.current_stream(flat.device))
        flat.record_stream(self.side)  # its memory is reused only once the copy ends
        with torch.cuda.stream(self.side):
            slot.copy_(flat, non_blocking=True)
            self.pending = (self.side.record_event(), slot, off)
        _mark(self.rec, "launch")

    def drain(self) -> None:
        """The pending range from its pinned slot into ``dst``."""
        if self.pending is not None:
            done, slot, off = self.pending
            done.synchronize()
            _mark(self.rec, "fetch wait")
            self.out.ready(off, off + slot.shape[0])
            self.out.view[off : off + slot.shape[0]].copy_(slot)
            _mark(self.rec, "copy")
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
    devices splits the blocks over them (:func:`_shares`).

    The input goes up a share (one lane chunk on one device) at a time,
    to the share's device (:class:`_Upload`, one a device), twice where a
    device has more than one share; each share's payload comes back from
    its device (:class:`_Fetch`, one a device) straight to its offset in
    the returned ``bytes``, and the header is written in front of it once
    the last payload is there (:func:`container.write_header`).  Each
    range's pages are prefaulted once its length is known
    (:meth:`_Output.prefault`).

    With ``_timings`` (a dict) the call is recorded (:func:`recorded_calls`)
    and ``_timings`` receives the host seconds of each phase, ``pass1``
    (each share's upload, histogram and crc, the prior), ``pass2`` (each
    share's upload, K1 -> K2, the payload splice and its fetch) and
    ``header``, and of each part of a phase (``"pass2 stage"``; over
    several devices ``"pass2 stage@j"`` where the part serves the ``j``-th
    device's share), at each mark: no mark waits for a device.
    """
    cards = _cards(device)
    rec = _Recorder(_timings, "enc", len(data), cards) if _timings is not None else None
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
    for d in cards:
        _require_cuda(d)
    n, k = len(data), block_size
    lens = _block_lens(n, k)
    n_blocks = lens.size
    steps = _shares(n_blocks, _lane_chunk(ENC_CHUNK_BYTES, k), len(cards))
    own = _by_card(steps, len(cards))
    busy = [j for j, mine in enumerate(own) if mine]
    if rec is not None:
        rec.plan(own)

    def span(sh: _Share) -> tuple[int, int, int]:
        """The share's bytes, zero past the input to its blocks' end."""
        return sh.s0 * k, min(sh.s1 * k, n), (sh.s1 - sh.s0) * k

    # Each device reads its shares twice (pass 2 again) where it has more
    # than one, else once: it keeps its one share's blocks for pass 2.
    _phase(rec, "pass1")
    ups = {j: _Upload(data, [span(sh) for sh in own[j]] * (1 if len(own[j]) == 1 else 2),
                      cards[j], rec) for j in busy}
    _mark(rec, "alloc")
    hists = {j: torch.zeros(256, dtype=torch.int64, device=cards[j]) for j in busy}
    crcs = {j: torch.zeros(len(own[j]), dtype=torch.int32, device=cards[j]) for j in busy}
    kept = {}
    _mark(rec, "launch")

    # Pass 1, a step at a time: each share's histogram and crc on its
    # device, fetched once after the last step.
    def count(sh: _Share) -> None:
        slot = ups[sh.card].take()
        a, b, _ = span(sh)
        if use_prior:
            byte_histogram(slot[: b - a], hists[sh.card])
        crc32_device(slot[: b - a], crcs[sh.card][sh.i : sh.i + 1])
        if len(own[sh.card]) == 1:
            kept[sh.card] = slot
        _mark(rec, "launch")

    def load_next(sh: _Share) -> None:
        ups[sh.card].prefetch()

    for step in steps:
        _each(step, count, load_next, rec=rec)
    hist = sum((_to_host(hists[j]) for j in _serving(rec, hists)),
               torch.zeros(256, dtype=torch.int64))
    crc = _crc_of(steps, crcs, n, k, rec)
    prior_extra = _prior_extra(hist.numpy(), params, prior_budget) if use_prior else None
    ic = _init_cum(params, prior_extra)
    _check_config(params, block_size, delta, int(ic[-1]))
    _mark(rec, "prior")

    if n == 0:
        archive = container.build_archive(params, block_size, 0, [], prior_extra, delta, crc)
        _phase(rec, "header")
        _mark(rec, "header")
        if rec is not None:
            rec.done(len(archive))
        return archive

    # Pass 2, a step at a time: K1 -> K2 on each share's blocks and the
    # raw rule, queued on every device of the step before any wire
    # length is read; then, share by share in block order, the payload
    # spliced on its device and fetched from there to its place after
    # the header, which the wire lengths and raw flags then fill.  A
    # block is stored raw unless its stream is shorter, so the payload
    # takes at most n bytes.
    _phase(rec, "pass2")
    n_words = _encode_words(params, k, delta)
    ic_np = init_cum_from_numpy(ic, params, "cpu")
    ic_total = int(ic_np[-1])  # K2's total, from the host: no read of the card's row
    head_len = container.header_bytes(n_blocks, prior_extra is not None)
    wire_all = np.empty(n_blocks, dtype=np.int32)
    raw_all = np.empty(n_blocks, dtype=bool)
    coded = {}  # device -> its share's blocks, K2's words and (wire, raw) rows

    def code(sh: _Share) -> None:
        j = sh.card
        blocks = (kept[j] if j in kept else ups[j].take()).view(sh.s1 - sh.s0, k)
        lens_t = _to_device(lens[sh.s0 : sh.s1], cards[j])
        words, bl, ov = encode_blocks_ranked(blocks, lens_t, ic_t[j], params, n_words, delta,
                                             ic_total)
        # Stored raw: overflowed blocks and any block not smaller coded.
        raw = ov | (bl >= lens_t)
        coded[j] = (blocks, words,
                    torch.stack([torch.where(raw, lens_t, bl), raw.to(torch.int32)]))
        _mark(rec, "launch")

    def overlap(sh: _Share) -> None:
        ups[sh.card].prefetch()  # the next share's host copy while K1 -> K2 run
        fetches[sh.card].drain()  # the previous share's payload into place, likewise

    with _Output(head_len + n, rec) as out:
        out.prefault(0, head_len)
        fetches = {j: _Fetch(out, cards[j], max((sh.s1 - sh.s0) * k for sh in own[j]),
                             min(2, len(own[j]))) for j in busy}
        _mark(rec, "alloc")
        ic_t = {j: _to_device(ic_np, cards[j]) for j in _serving(rec, busy)}
        _mark(rec, "launch")
        off = head_len
        for step in steps:
            _each(step, code, overlap, rec=rec)
            for sh in step:  # the wire lengths and flags to the host, S2 by them
                _serve(rec, sh.card)
                blocks, words, head = coded.pop(sh.card)
                head = _to_host(head)
                _mark(rec, "lengths wait")
                wire, raw_h = head[0], head[1].bool()
                wire_all[sh.s0 : sh.s1], raw_all[sh.s0 : sh.s1] = wire.numpy(), raw_h.numpy()
                size = int(wire.numpy().sum(dtype=np.int64))
                out.prefault(off, off + size)
                payload = splice_payload(words, blocks, raw_h, wire)
                _mark(rec, "launch")
                fetches[sh.card].put(sh.i, payload, off)
                off += size
                del blocks, words, payload
        for j in _serving(rec, busy):
            fetches[j].drain()
        _phase(rec, "header")
        out.ready(0, head_len)
        container.write_header(out.view.numpy(), params, block_size, n, prior_extra, delta,
                               crc, raw_all, wire_all)
        _mark(rec, "header")
        del fetches
        archive = out.result(off)
        _mark(rec, "header")
        if rec is not None:
            rec.done(len(archive))
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


def _stream_ends(header, lanes: _Lanes) -> np.ndarray:
    """(B,) int64 end of each block's bytes in the archive: its offset and
    its wire length (the payload is in block order, so blocks ``s0 .. s1``
    lie in ``archive[stream_offs[s0] : ends[s1 - 1]]``)."""
    return header.stream_offs + np.where(lanes.raw, lanes.block_lens, lanes.coded_lens)


def _decode_chunk(arch: torch.Tensor, base: int, header, lanes: _Lanes, s0: int,
                  out: torch.Tensor, ic_t: torch.Tensor, rec: Optional[_Recorder] = None
                  ) -> None:
    """Blocks ``s0 .. s0 + len(out)`` into the rows of ``out`` (``(rows,
    k)`` uint8 on ``arch``'s device) from their slice ``arch`` of the
    archive, which starts at archive offset ``base``: a raw block's row is
    its stored bytes (S1, bytes), the coded blocks go through S1 (words)
    and K3 sorted by coded length, and their symbols into their rows.  Both
    S1 calls check their rows on the host and queue their kernels with no
    wait.  No coded block, no K3.  Recorded (``rec``): the lanes' host work
    with both S1 calls (``lanes``), then K3 and the rows' placement
    (``launch``)."""
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
    _mark(rec, "lanes")
    if ci.size:
        k, p, d = header.block_size, header.params, header.delta
        syms = decode_blocks(words, klens, ic_t, p, k, d)
        del words
        out.index_copy_(0, _to_device(ci, dev), syms)
    if ri.size:
        out.index_copy_(0, _to_device(ri, dev), rows)
    _mark(rec, "launch")


def decode(archive: bytes, *, device: Devices = "cuda",
           _timings: Optional[dict] = None) -> bytes:
    """Decompress an RXT archive.

    Verifies the stored crc32 and raises :class:`InvalidInputError` on any
    corruption instead of returning garbage.  ``device`` (default
    ``"cuda"``) runs the kernel; ``device="cpu"`` runs its plain version; a
    sequence of devices splits the blocks over them (:func:`_shares`).

    A share is a range of at most ``_lane_chunk(DEC_CHUNK_BYTES, k)``
    blocks on one device.  Each has its own upload (its slice of the
    archive, to its device: :class:`_Upload`, one a device, the next
    share's slice going up while K3 runs), S1 and K3 into its own output
    rows (:func:`_decode_chunk`), S3, and fetch (:class:`_Fetch`, one a
    device: the output comes back on a side stream while the next share
    runs); the CRCs stay on their devices until the last step, then come
    back to be combined in block order and checked once.  A device holds
    at most two shares' slices and outputs and one share's words and
    symbols, whatever the input's size.

    The header's block table is read by numpy (:func:`container.parse_table`):
    no Python object a block.  The result's pages are faulted in on worker
    threads while the devices decode (:meth:`_Output.prefault`), so the
    fetches' copies write pages that are there.

    With ``_timings`` (a dict) the call is recorded (:func:`recorded_calls`)
    and ``_timings`` receives the host seconds of each phase, summed over
    the shares: ``parse`` (the header and the lanes), ``upload`` (a
    share's slice), ``kernels`` (S1 -> K3 into the rows, the raw rows) and
    ``crc+fetch`` (S3, the copy to the host and into the result, the
    CRCs' combine and check), and of each part of a phase (``"kernels
    lanes"``; over several devices ``"kernels lanes@j"`` where the part
    serves the ``j``-th device's share), at each mark: no mark waits for a
    device, so a recorded call overlaps what an unrecorded one does.
    """
    cards = _cards(device)
    rec = _Recorder(_timings, "dec", len(archive), cards) if _timings is not None else None
    _phase(rec, "parse")
    header = container.parse_table(archive)
    params = header.params
    for d in cards:
        _require_cuda(d)
    if header.orig_len == 0:
        container.verify_crc(header, b"")
        _mark(rec, "parse")
        if rec is not None:
            rec.done(0)
        return b""
    n, k, n_blocks = header.orig_len, header.block_size, header.n_blocks
    lanes = _decode_lanes(header)
    ic = init_cum_from_numpy(_init_cum(params, header.prior_extra), params, "cpu")
    steps = _shares(n_blocks, _lane_chunk(DEC_CHUNK_BYTES, k), len(cards))
    own = _by_card(steps, len(cards))
    busy = [j for j, mine in enumerate(own) if mine]
    if rec is not None:
        rec.plan(own)
    ends = _stream_ends(header, lanes)
    base = {sh: int(header.stream_offs[sh.s0]) for step in steps for sh in step}
    _mark(rec, "parse")
    ups = {j: _Upload(archive, [(base[sh], int(ends[sh.s1 - 1]), int(ends[sh.s1 - 1]) - base[sh])
                                for sh in own[j]], cards[j], rec) for j in busy}
    rows = {j: max(sh.s1 - sh.s0 for sh in own[j]) for j in busy}
    outs = {j: torch.empty(min(2, len(own[j])), rows[j], k, dtype=torch.uint8, device=cards[j])
            for j in busy}

    def rows_of(sh: _Share) -> torch.Tensor:
        return outs[sh.card][sh.i % outs[sh.card].shape[0], : sh.s1 - sh.s0]

    def decode_share(sh: _Share) -> None:
        _phase(rec, "upload")
        arch = ups[sh.card].take()
        _mark(rec, "launch")
        _phase(rec, "kernels")
        _decode_chunk(arch, base[sh], header, lanes, sh.s0, rows_of(sh), ic_t[sh.card], rec)

    def fetch_share(sh: _Share) -> None:
        j = sh.card
        _phase(rec, "upload")
        ups[j].prefetch()  # the next share's host copy while K3 runs
        _phase(rec, "crc+fetch")
        fetches[j].drain()  # the previous share into the result, likewise
        flat = rows_of(sh).view(-1)[: min(sh.s1 * k, n) - sh.s0 * k]
        crc32_device(flat, crcs[j][sh.i : sh.i + 1])
        _mark(rec, "launch")
        fetches[j].put(sh.i, flat, sh.s0 * k)

    with _Output(n, rec) as output:
        for step in steps:  # every byte of the result is written, a share at a time
            for sh in step:
                output.prefault(sh.s0 * k, min(sh.s1 * k, n))
        fetches = {j: _Fetch(output, cards[j], rows[j] * k, outs[j].shape[0]) for j in busy}
        _mark(rec, "alloc")
        crcs = {j: torch.zeros(len(own[j]), dtype=torch.int32, device=cards[j]) for j in busy}
        ic_t = {j: _to_device(ic, cards[j]) for j in _serving(rec, busy)}
        _mark(rec, "launch")
        for step in steps:
            _each(step, decode_share, fetch_share, rec=rec)
        for j in _serving(rec, busy):
            fetches[j].drain()
        del fetches
        ok = _crc_of(steps, crcs, n, k, rec) == header.crc32
        _mark(rec, "check")
        if not ok:
            raise InvalidInputError()
        result = output.result(n)
        _mark(rec, "check")
        if rec is not None:
            rec.done(n)
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
