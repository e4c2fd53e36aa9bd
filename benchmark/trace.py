"""The reduction of a traced window to what the per-layer metrics read.

The harness runs the traced window under ``torch.profiler`` (CPU and CUDA
activity) and marks each call with a ``record_function`` range named
``enc.plain``, ``dec.plain``, ``enc.timed`` or ``dec.timed``; a timed call
passes a :class:`PhaseLog` as the program's ``_timings``, which puts a
zero-length ``mark:<phase>`` range in the trace at each of the program's
phase marks.  Plain calls run as in the untraced window: the device
metrics (kernel and copy time) are read from them alone, since a timed
call's marks, though none waits for the cards, put host work between its
launches and copies.  Timed calls name the device's idle gaps by the
phase the host was in.  An untraced window runs under the
profiler's CUDA activity alone, for the cards' busy time
(:func:`card_busy_ns`).

Every time here is the profiler's (nanoseconds on one clock for host and
device events).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import NamedTuple, Optional

import numpy as np
import torch

CALL_RANGES = ("enc.plain", "dec.plain", "enc.timed", "dec.timed")
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class PhaseLog(dict):
    """The program's ``_timings``: seconds a phase, and a ``mark:<phase>``
    range in the profiler's trace at each write (the program's phase
    marks write here as each phase ends)."""

    def __setitem__(self, key, value):
        with torch.profiler.record_function(f"mark:{key}"):
            pass
        super().__setitem__(key, value)


class Call(NamedTuple):
    kind: str  # "enc" or "dec"
    mode: str  # "plain" or "timed"
    start: int
    end: int


class Trace(NamedTuple):
    """A traced window, reduced."""

    calls: list  # Call, in order
    cards: list  # device indices with device activity
    window_ns: int  # from the first call's start to the last call's end
    busy_ns: dict  # card -> ns with any device op in the window
    call_ops: list  # per call, {op name: device ns}
    idle_by_phase: dict  # "enc pass2" -> idle ns of the timed calls, summed over cards


def _union_ns(iv: np.ndarray, a: int, b: int) -> int:
    """Length of the union of intervals ``iv`` (sorted by start) within [a, b)."""
    if iv.size == 0:
        return 0
    s = np.clip(iv[:, 0], a, b)
    e = np.clip(iv[:, 1], a, b)
    keep = e > s
    s, e = s[keep], e[keep]
    if s.size == 0:
        return 0
    run_end = np.maximum.accumulate(e)
    starts_new = np.ones(s.size, dtype=bool)
    starts_new[1:] = s[1:] > run_end[:-1]
    groups = np.cumsum(starts_new) - 1
    gs = s[starts_new]
    ge = np.zeros(gs.size, dtype=np.int64)
    np.maximum.at(ge, groups, e)
    return int((ge - gs).sum())


def _gaps(iv: np.ndarray, a: int, b: int) -> list[tuple[int, int]]:
    """The idle intervals within [a, b) between intervals ``iv`` (sorted)."""
    out, t = [], a
    for s, e in iv.tolist():
        if e <= a or s >= b:
            continue
        if s > t:
            out.append((t, min(s, b)))
        t = max(t, e)
    if t < b:
        out.append((t, b))
    return out


def op_name(name: str) -> str:
    """A device op's name without its parameter list (a copy's or a
    set's name whole)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i].strip()
            break
    # A long template argument list (PyTorch's own kernels) says little.
    return name.split("<")[0] if len(name) > 48 else name


class Event(NamedTuple):
    """One profiler event: on the host (``card`` None) or on a card."""

    name: str
    card: Optional[int]
    start: int
    end: int
    corr: int  # the correlation id that ties a device op to its launch


def events(prof) -> list[Event]:
    """The profiler's events, device ops (kernels, copies, sets) and host
    events; the call ranges and marks that the profiler mirrors on a
    card's timeline are left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        card = None
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kind = str(e.activity_type()).lower() if hasattr(e, "activity_type") else ""
            if name in CALL_RANGES or name.startswith("mark:") or (
                    kind and not any(k in kind for k in _DEVICE_KINDS)):
                continue
            card = e.device_index()
        out.append(Event(name, card, start, start + e.duration_ns(), e.correlation_id()))
    return out


def card_busy_ns(evs: list[Event]) -> dict:
    """Per card, the nanoseconds in which any of its ops in ``evs`` runs."""
    iv = defaultdict(list)
    for e in evs:
        if e.card is not None:
            iv[e.card].append((e.start, e.end))
    return {card: _union_ns(np.array(sorted(v), dtype=np.int64), min(a for a, _ in v),
                            max(b for _, b in v)) for card, v in iv.items()}


def reduce(evs: list[Event]) -> Trace:
    """The calls, device ops and phase marks of a traced window.

    A device op belongs to the call that launched it (the host time of
    its launch, by correlation id).  The device's clock is moved onto the
    host's by the least lead of a device op over its launch where that is
    negative (an op cannot start before it is launched)."""
    dev, calls, marks, launch = defaultdict(list), [], [], {}
    for e in evs:
        if e.card is not None:
            dev[e.card].append(e)
        elif e.name in CALL_RANGES:
            k, m = e.name.split(".")
            calls.append(Call(k, m, e.start, e.end))
        elif e.name.startswith("mark:"):
            marks.append((e.start, e.name[5:]))
        elif e.name.startswith("cuda") and e.corr:
            launch[e.corr] = e.start
    leads = [e.start - launch[e.corr] for ops in dev.values() for e in ops if e.corr in launch]
    skew = min(0, min(leads, default=0))
    calls.sort(key=lambda c: c.start)
    marks.sort()
    # A mark with a part ("crc+fetch copy") follows its phase's mark
    # ("crc+fetch") at the same point: keep the part's name.
    for j in range(len(marks) - 1, 0, -1):
        if marks[j][1].startswith(marks[j - 1][1] + " "):
            marks[j - 1] = (marks[j - 1][0], marks[j][1])
            del marks[j]
    iv = {card: np.array(sorted((e.start - skew, e.end - skew) for e in ops),
                         dtype=np.int64).reshape(-1, 2) for card, ops in dev.items()}
    a = calls[0].start if calls else 0
    b = calls[-1].end if calls else 0
    starts = np.array([c.start for c in calls], dtype=np.int64)
    call_ops = [defaultdict(int) for _ in calls]
    for ops in dev.values():
        for e in ops:
            t = launch.get(e.corr, e.start - skew)
            j = int(np.searchsorted(starts, t, side="right")) - 1
            if j >= 0 and t < calls[j].end:
                call_ops[j][op_name(e.name)] += e.end - e.start
    idle = defaultdict(int)
    mark_t = np.array([t for t, _ in marks], dtype=np.int64)
    for c in calls:
        if c.mode != "timed":
            continue
        for card in iv:
            for g0, g1 in _gaps(iv[card], c.start, c.end):
                # Each piece of the gap between two marks goes to the phase
                # that the later mark ends; after the call's last mark, "return".
                j = int(np.searchsorted(mark_t, g0, side="right"))
                while g0 < g1:
                    end = int(mark_t[j]) if j < len(marks) and mark_t[j] < c.end else c.end
                    phase = marks[j][1] if end < c.end else "return"
                    idle[f"{c.kind} {phase}"] += min(end, g1) - g0
                    g0, j = min(end, g1), j + 1
    return Trace(
        calls=calls,
        cards=sorted(iv),
        window_ns=b - a,
        busy_ns={card: _union_ns(v, a, b) for card, v in iv.items()},
        call_ops=[dict(o) for o in call_ops],
        idle_by_phase=dict(idle),
    )


def plain(tr: Trace, kind: str) -> list[int]:
    """Indices of the plain calls of ``kind``."""
    return [j for j, c in enumerate(tr.calls) if c.kind == kind and c.mode == "plain"]


def op_seconds(tr: Trace, kind: str, pattern: str) -> float:
    """Device seconds of the ops whose name matches ``pattern`` in the
    plain ``kind`` calls, summed over the cards."""
    rx = re.compile(pattern)
    return sum(ns for j in plain(tr, kind) for name, ns in tr.call_ops[j].items()
               if rx.search(name)) / 1e9


def breakdown(tr: Trace) -> dict:
    """The ten device ops that took the most time in the plain calls, and
    the ten phases of the timed calls with the most idle device time."""
    ops = defaultdict(int)
    for j in plain(tr, "enc") + plain(tr, "dec"):
        for name, ns in tr.call_ops[j].items():
            ops[f"{tr.calls[j].kind} {name}"] += ns
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.idle_by_phase.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v / 1e9] for k, v in top],
            "idle_gaps": [[k, v / 1e9] for k, v in gaps]}
