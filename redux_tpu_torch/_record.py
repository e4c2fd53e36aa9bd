"""The record of a call of ``api.encode`` or ``api.decode``: a
:class:`_Recorder` where the call is made with ``_timings``, else the
shared :data:`UNRECORDED`, whose methods do nothing and read no counter.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Iterable, Iterator, Optional, Sequence

import torch

from . import _build

RECORDED_CALLS = 4096  # the recorded calls kept, newest last: a traced window's and more
ROUTES = ("warp", "thread", "fused", "split")  # K3's, then the encoder's (``_build.count_blocks``)
_records: deque = deque(maxlen=RECORDED_CALLS)
_call_ids = itertools.count()


def recorded_calls() -> list[dict]:
    """The last :data:`RECORDED_CALLS` calls of ``api.encode`` and
    ``api.decode`` made with ``_timings`` that returned, oldest first.
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
    shares, from ``api._shares``), ``warp_blocks`` and ``thread_blocks``
    (the blocks K3 decoded on each route on the call's devices) and
    ``fused_blocks`` and ``split_blocks`` (the blocks encoded by K4 and by
    K1 -> K2 there), each ``_build.route_blocks`` over the call."""
    return list(_records)


class _Unrecorded:
    """The recorder of a call made without ``_timings``: the call uses it
    as it would a :class:`_Recorder`, and nothing is recorded."""

    def phase(self, phase: str) -> None:
        pass

    def mark(self, part: str) -> None:
        pass

    def serve(self, j: Optional[int]) -> None:
        pass

    def serving(self, cards: Iterable) -> Iterator:
        """Each of ``cards`` in turn, the call's steps serving its entry
        ``card.j`` until the next is drawn, then the whole call."""
        for card in cards:
            self.serve(card.j)
            yield card
        self.serve(None)

    def plan(self, own: list[list]) -> None:
        pass

    def done(self, nbytes: int) -> None:
        pass


UNRECORDED = _Unrecorded()


class _Recorder(_Unrecorded):
    """The record of one call made with ``_timings``: a span a mark, and
    the bytes the call copies over the bus.

    The call sets its phase (:meth:`phase`); :meth:`mark` ends the span
    since the previous mark (the recorder's start for the first) as
    ``part`` of that phase and adds its seconds to ``timings[phase]`` and
    ``timings["phase part"]`` at once, so a phase is the sum of its parts
    and a ``_timings`` that notes its writes notes each span's end.
    Nothing here waits for a device: a recorded call issues the waits of
    an unrecorded one.  Times are ``time.time_ns()``, the clock
    ``torch.profiler`` stamps its host events with.  The bytes are what
    the copies count into ``_build.bus_bytes`` from the recorder's start
    until the call has its result and hands its record to
    :func:`recorded_calls` (:meth:`done`), and so are the blocks coded a
    route on the call's devices (``_build.route_blocks``: K3's two, the
    encoder's two).

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
        self.keys = {_build.card_key(d) for d in cards}
        self.now = ""  # the phase of the next marks
        self.spans = []
        self.entry = None  # the entry the next marks serve; None: the whole call
        self.owner = 0  # the entry the bytes counted since ``seen`` serve
        self.by_card = {way: [0] * len(cards) for way in ("h2d", "d2h")}
        self.blocks = [0] * len(cards)
        self.bus0 = _build.bus_bytes.copy()
        self.seen = self.bus0.copy()
        self.blocks0 = _build.route_blocks.copy()
        self.t0 = time.time_ns()

    def phase(self, phase: str) -> None:
        """The call's next marks are parts of ``phase``."""
        self.now = phase

    def plan(self, own: list[list]) -> None:
        """The call's shares, each entry's (``api._by_card``)."""
        self.blocks = [sum(sh.s1 - sh.s0 for sh in mine) for mine in own]

    def serve(self, j: Optional[int]) -> None:
        """The call's next steps serve entry ``j`` of its devices, or the
        whole call (None: the bytes go on to the last entry named)."""
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
        """End the call's span since its last mark as ``part``."""
        now = time.time_ns()
        if self.entry is not None and len(self.cards) > 1:
            part = f"{part}@{self.entry}"
        ns = now - self.t0
        for key in (self.now, f"{self.now} {part}"):  # first, close to ``now``
            self.tt[key] = self.tt.get(key, 0.0) + ns / 1e9
        self.spans.append((self.now, part, self.t0, now))
        self.t0 = now

    def done(self, nbytes: int) -> None:
        """The call returns ``nbytes``: its record into :func:`recorded_calls`."""
        self._settle()
        bus = {way: _build.bus_bytes[way] - self.bus0[way] for way in ("h2d", "d2h")}
        blocks = {f"{route}_blocks": sum(_build.route_blocks[route, i] - self.blocks0[route, i]
                                         for i in self.keys) for route in ROUTES}
        _records.append(dict(id=next(_call_ids), kind=self.kind, bytes_in=self.bytes_in,
                             bytes_out=nbytes, cards=self.cards, spans=self.spans, **bus,
                             h2d_by_card=self.by_card["h2d"], d2h_by_card=self.by_card["d2h"],
                             blocks_by_card=self.blocks, **blocks))


def recorder(timings: Optional[dict], kind: str, nbytes: int,
             cards: Sequence[torch.device]) -> _Unrecorded:
    """A :class:`_Recorder` into ``timings``, or :data:`UNRECORDED` where it is None."""
    return UNRECORDED if timings is None else _Recorder(timings, kind, nbytes, cards)
