"""The host's side of a call of ``api``: :class:`_Upload` takes host
ranges up to a device, :class:`_Fetch` brings device ranges back into the
result (an :class:`_Output`), :func:`_to_device` / :func:`_to_host` move
small arrays.  Every copy counts its bytes into ``_build.bus_bytes``, and
the host's steps are marks of the call's recorder (``rec``, any object
with ``mark(part)``), which records nothing where the call is not recorded.
"""

from __future__ import annotations

import ctypes
import mmap
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from . import _build


def _host_u8(data) -> torch.Tensor:
    """A CPU uint8 tensor over the bytes of ``data`` (no copy; read only:
    nothing writes through it, so torch's warning about a read-only buffer
    is silenced)."""
    if len(data) == 0:
        return torch.empty(0, dtype=torch.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(data, dtype=torch.uint8)


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
    waits for a range's tasks before the caller writes it (``rec``'s
    ``prefault wait``).  Every task is waited for (or cancelled) before the
    object is handed over or freed.
    """

    TOUCH_THREADS = 4
    TOUCH_PIECE = 16 << 20

    def __init__(self, n: int, rec):
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
        self.rec.mark("prefault wait")

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
        self.rec.mark("prefault wait")
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
    is set on the device).  Marks: the pinned slots' allocation (``pin``),
    the wait for a slot's last upload (``slot wait``), the host copy with
    the pieces' queueing (``stage``).
    """

    PIECE = 32 << 20

    def __init__(self, data, ranges: Sequence[tuple[int, int, int]], device: torch.device, rec):
        self.src = _host_u8(data)
        self.ranges = list(ranges)
        self.device, self.rec = device, rec
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
            self.rec.mark("stage")
            return
        if not self.pinned:
            self.pinned = [_pinned(self.slots.shape[1]) for _ in range(self.slots.shape[0])]
            self.rec.mark("pin")
        if self.uploaded[s] is not None:
            self.uploaded[s].synchronize()
            self.rec.mark("slot wait")
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
        self.rec.mark("stage")

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

    Each range counts its bytes.  Marks, on ``out.rec``: the pinned slots'
    allocation (``pin``), a put's queueing (``launch``), the wait for a
    fetch (``fetch wait``), the copy into ``dst`` (``copy``).
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
            self.rec.mark("copy")
            return
        if not self.pinned:
            self.pinned = [_pinned(self.slot_bytes) for _ in range(self.n_slots)]
            self.rec.mark("pin")
        slot = self.pinned[i % self.n_slots][: flat.shape[0]]
        self.side.wait_stream(torch.cuda.current_stream(flat.device))
        flat.record_stream(self.side)  # its memory is reused only once the copy ends
        with torch.cuda.stream(self.side):
            slot.copy_(flat, non_blocking=True)
            self.pending = (self.side.record_event(), slot, off)
        self.rec.mark("launch")

    def drain(self) -> None:
        """The pending range from its pinned slot into ``dst``."""
        if self.pending is not None:
            done, slot, off = self.pending
            done.synchronize()
            self.rec.mark("fetch wait")
            self.out.ready(off, off + slot.shape[0])
            self.out.view[off : off + slot.shape[0]].copy_(slot)
            self.rec.mark("copy")
            self.pending = None
