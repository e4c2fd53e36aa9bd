"""The recorder of ``api.encode`` / ``api.decode`` calls, on the CPU.

A call made with ``_timings`` is recorded (``api.recorded_calls``): its
spans, one a mark, tile the call; each phase key of ``_timings`` is the
sum of its parts; the bytes the call moves to and from its devices are
counted where they move and equal their closed form; a mark waits for no
device, and each span's end lies just before the ``mark:`` range a
noting ``_timings`` opens for it in ``torch.profiler``'s trace.  A call
without ``_timings`` builds no ``_Recorder`` and records nothing.  The chunks
are cut to 128 blocks of 256 bytes (``ENC_CHUNK_BYTES`` /
``DEC_CHUNK_BYTES`` patched), so a few hundred blocks take several
shares, on one device, on ``["cpu", "cpu"]`` and on ``["cpu"] * 4`` (two
full steps and an uneven last one).  Over a list the bytes and the parts
are counted by entry: each part that serves one entry's shares ends in
``@j``, ``j`` the entry's position in the list.
"""

import time

import numpy as np
import pytest
import torch

from redux_tpu_torch import _record, api, container, testdata

K = 256
CHUNK = 128
# name -> (blocks, bytes of the last block, devices)
CASES = {
    "one_share": (100, 256, "cpu"),
    "shares": (300, 100, "cpu"),
    "two_devices": (300, 100, ["cpu", "cpu"]),
    "four_entries": (2 * 4 * CHUNK + 7, 100, ["cpu"] * 4),
    "empty": (0, 0, "cpu"),
}
# Every part a call can mark, and those only the card's path has: its
# pinned slots and the waits for their events.
PARTS = {"stage", "copy", "slot wait", "fetch wait", "lengths wait", "sums wait",
         "prefault wait", "pin", "alloc", "parse", "lanes", "prior", "header", "check", "launch"}
CARD_ONLY = {"pin", "slot wait", "fetch wait"}
PHASES = {"enc": {"pass1", "pass2", "header"},
          "dec": {"parse", "upload", "kernels", "crc+fetch"}}
# The parts that serve the whole call, never one entry of a list.
WHOLE = {"alloc", "sums wait", "parse", "prior", "header", "check"}


def _part(part: str, n_cards: int) -> str:
    """A span's part without its entry (``stage@1`` -> ``stage``): on a
    list an entry below its length, on one device none."""
    name, tagged, j = part.partition("@")
    if tagged:
        assert n_cards > 1 and name not in WHOLE and 0 <= int(j) < n_cards, part
    return name


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's tests on one torch thread, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def chunked(monkeypatch):
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", CHUNK * K)
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", CHUNK * K)


def _input(n_blocks: int, last: int) -> bytes:
    n = max(n_blocks - 1, 0) * K + last
    return testdata.mixed(n, 11) if n else b""


class Noting(dict):
    """A ``_timings`` that opens a ``mark:<key>`` range at each write, as
    the benchmark's ``PhaseLog`` does."""

    def __setitem__(self, key, value):
        with torch.profiler.record_function(f"mark:{key}"):
            pass
        super().__setitem__(key, value)


def _round_trip(data: bytes, devices, timings=dict):
    """A recorded encode and decode of ``data``: per way, its ``_timings``,
    its record and the host clock just before and after it."""
    out = {}
    t_enc, t0 = timings(), time.time_ns()
    arch = api.encode(data, block_size=K, device=devices, _timings=t_enc)
    t1 = time.time_ns()
    rec_enc = api.recorded_calls()[-1]
    t_dec, t2 = timings(), time.time_ns()
    assert api.decode(arch, device=devices, _timings=t_dec) == data
    t3 = time.time_ns()
    out["enc"] = (t_enc, rec_enc, t0, t1)
    out["dec"] = (t_dec, api.recorded_calls()[-1], t2, t3)
    return arch, out


@pytest.fixture(scope="module")
def calls():
    """Each case's archive and its two recorded calls, made once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api, "ENC_CHUNK_BYTES", CHUNK * K)
        mp.setattr(api, "DEC_CHUNK_BYTES", CHUNK * K)
        return {name: (_input(b, last), devs, *_round_trip(_input(b, last), devs))
                for name, (b, last, devs) in CASES.items()}


@pytest.mark.parametrize("kind", ["enc", "dec"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_tile_the_call_and_phases_sum_their_parts(calls, case, kind):
    data, devs, arch, ways = calls[case]
    timings, rec, t0, t1 = ways[kind]
    assert rec["kind"] == kind
    assert (rec["bytes_in"], rec["bytes_out"]) == ((len(data), len(arch)) if kind == "enc"
                                                   else (len(arch), len(data)))
    assert rec["cards"] == [str(torch.device(d)) for d in api._cards(devs)]
    spans = rec["spans"]
    assert spans and t0 <= spans[0][2] and spans[-1][3] <= t1
    for (_, _, _, end), (_, _, start, _) in zip(spans, spans[1:]):
        assert start == end  # consecutive, no overlap
    for phase, part, start, end in spans:
        assert start <= end and _part(part, len(rec["cards"])) in PARTS
        assert phase in PHASES[kind]
    # Every phase key is the sum of its parts, each part the sum of its spans.
    assert {key.split(" ", 1)[0] for key in timings} == {s[0] for s in spans}
    for phase in {s[0] for s in spans}:
        parts = {key for key in timings if key.startswith(phase + " ")}
        assert timings[phase] == pytest.approx(sum(timings[p] for p in parts), abs=1e-9)
        for key in parts:
            ns = sum(s[3] - s[2] for s in spans if f"{s[0]} {s[1]}" == key)
            assert timings[key] == pytest.approx(ns / 1e9, abs=1e-9)
    # Marks grow with the shares, not with the blocks.
    n_shares = sum(map(len, api._shares(-(-len(data) // K), CHUNK, len(rec["cards"]))))
    assert len(spans) <= 8 + 12 * n_shares


@pytest.mark.parametrize("case", ["shares", "two_devices", "four_entries"])
def test_every_part_appears_in_a_call_of_several_shares(calls, case):
    """Every part the CPU's path has; the card's pinned slots and their
    waits are the card's alone (``tests/test_torch_cuda.py``)."""
    _, devs, _, ways = calls[case]
    n_cards = len(api._cards(devs))
    seen = {_part(s[1], n_cards) for kind in ways for s in ways[kind][1]["spans"]}
    assert seen == PARTS - CARD_ONLY
    assert {s[0] for kind in ways for s in ways[kind][1]["spans"]} == set().union(*PHASES.values())
    # The last mark comes after the result is made: a header or a check.
    assert [ways[kind][1]["spans"][-1][:2] for kind in ("enc", "dec")] == [
        ("header", "header"), ("crc+fetch", "check")]


def bus_bytes_by_card(data: bytes, arch: bytes, devs, k: int = K,
                      chunk: int = CHUNK) -> dict:
    """The bytes a round trip moves to and from each entry of its devices,
    worked out from the input, the archive (of ``k``-byte blocks) and the
    share plan (``chunk`` blocks a lane chunk): per way, ``(h2d, d2h)`` an
    entry."""
    n_cards = len(api._cards(devs))
    if not data:
        return {"enc": [(0, 0)] * n_cards, "dec": [(0, 0)] * n_cards}
    header = container.parse_table(arch)
    assert header.block_size == k
    own = api._by_card(api._shares(header.n_blocks, chunk, n_cards), n_cards)
    n = len(data)
    wire = header.byte_lens.astype(np.int64)  # a block's bytes in the payload
    coded = ~header.raw
    row = 4 * (header.params.symbol_count + 1)  # the initial cumulative row, int32
    out = {"enc": [], "dec": []}
    for mine in own:
        busy, shares = bool(mine), len(mine)
        blocks = sum(sh.s1 - sh.s0 for sh in mine)
        share_bytes = sum(min(sh.s1 * k, n) - sh.s0 * k for sh in mine)
        payload = sum(int(wire[sh.s0 : sh.s1].sum()) for sh in mine)
        n_coded = sum(int(coded[sh.s0 : sh.s1].sum()) for sh in mine)
        # Encode: the entry's shares' bytes up once, again where it has
        # more than one; the row, the blocks' lengths (int32) and S2's
        # table (int32 length, bool flag) up; its payload, its histogram
        # (256 int64, added up on the device, share by share), the CRCs
        # (int32 a share) and the wire lengths and flags (two int32 a
        # block) down.
        out["enc"].append((share_bytes * (1 if shares == 1 else 2) + row * busy + 9 * blocks,
                           payload + 2048 * busy + 4 * shares + 8 * blocks))
        # Decode: its shares' slices of the payload and the row up, and a
        # block's S1 offset and length (two int64), its row index (int64)
        # and a coded block's symbol count (int32); its output and the
        # CRCs down.
        out["dec"].append((payload + row * busy + 24 * blocks + 4 * n_coded,
                           share_bytes + 4 * shares))
    return out


def bus_bytes(data: bytes, arch: bytes, devs, k: int = K, chunk: int = CHUNK) -> dict:
    """The bytes a round trip moves to and from its devices: per way,
    ``(h2d, d2h)`` summed over the entries (:func:`bus_bytes_by_card`)."""
    return {kind: tuple(sum(way) for way in zip(*per))
            for kind, per in bus_bytes_by_card(data, arch, devs, k, chunk).items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bus_bytes_equal_their_closed_form(calls, case):
    data, devs, arch, ways = calls[case]
    want = bus_bytes(data, arch, devs)
    for kind in ("enc", "dec"):
        rec = ways[kind][1]
        assert (rec["h2d"], rec["d2h"]) == want[kind], kind
    if case == "shares":  # past one chunk the input goes up twice
        assert ways["enc"][1]["h2d"] > 2 * len(data)
    if case == "one_share":
        assert len(data) < ways["enc"][1]["h2d"] < len(data) + 4096


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_entry_counts_its_own_shares(calls, case):
    """The bytes by entry sum to the call's and are each entry's own
    shares' (a list that names the CPU two or four times counts each
    entry); the blocks by entry are the share plan's; on a list the
    entries' parts end in ``@j``, on one device no part does and each
    count by entry is the call's."""
    data, devs, arch, ways = calls[case]
    n_cards = len(api._cards(devs))
    want = bus_bytes_by_card(data, arch, devs)
    n_blocks = -(-len(data) // K)
    plan = [sum(sh.s1 - sh.s0 for sh in mine)
            for mine in api._by_card(api._shares(n_blocks, CHUNK, n_cards), n_cards)]
    for kind in ("enc", "dec"):
        rec = ways[kind][1]
        assert sum(rec["h2d_by_card"]) == rec["h2d"] and sum(rec["d2h_by_card"]) == rec["d2h"]
        assert list(zip(rec["h2d_by_card"], rec["d2h_by_card"])) == want[kind], kind
        assert rec["blocks_by_card"] == plan
        tagged = {s[1].partition("@")[2] for s in rec["spans"]} - {""}
        if n_cards == 1:
            assert not tagged
            assert (rec["h2d_by_card"], rec["d2h_by_card"]) == ([rec["h2d"]], [rec["d2h"]])
        elif data:
            assert tagged == {str(j) for j in range(n_cards)}
    if case == "four_entries":
        assert [len(step) for step in api._shares(n_blocks, CHUNK, 4)] == [4, 4, 4]
        assert plan == [2 * CHUNK + 2] * 3 + [2 * CHUNK + 1]


@pytest.mark.parametrize("devs", ["cpu", ["cpu", "cpu"]])
def test_an_unrecorded_call_records_nothing(chunked, monkeypatch, devs):
    data = _input(200, 256)
    before = api.recorded_calls()
    last = before[-1]["id"] if before else None

    def no_recorder(*a, **kw):
        raise AssertionError("a call without _timings built a recorder")

    monkeypatch.setattr(_record, "_Recorder", no_recorder)
    arch = api.encode(data, block_size=K, device=devs)
    assert api.decode(arch, device=devs) == data
    after = api.recorded_calls()
    assert (after[-1]["id"] if after else None) == last
    assert _record._records.maxlen == _record.RECORDED_CALLS >= 4096


@pytest.mark.parametrize("cards", [["cuda:1"], ["cuda:0", "cuda:1"], ["cpu"]])
def test_route_blocks_are_counted_on_the_calls_cards(monkeypatch, cards):
    """A record's ``warp_blocks`` and ``thread_blocks`` are what
    ``_build.route_blocks`` gained on the call's cards while it ran (K3's
    blocks a route), not on others; a CPU call has none."""
    from redux_tpu_torch import _build

    monkeypatch.setattr(_build, "route_blocks", type(_build.route_blocks)())
    _build.count_blocks("warp", torch.device("cuda", 1), 3)  # before the call
    rec = _record._Recorder({}, "dec", 10, [torch.device(c) for c in cards])
    for route, card, n in (("warp", 1, 7), ("thread", 0, 5), ("warp", 0, 2), ("warp", 2, 11)):
        _build.count_blocks(route, torch.device("cuda", card), n)
    rec.done(10)
    got = api.recorded_calls()[-1]
    want = {("cuda:1",): (7, 0), ("cuda:0", "cuda:1"): (9, 5), ("cpu",): (0, 0)}[tuple(cards)]
    assert (got["warp_blocks"], got["thread_blocks"]) == want


def test_a_mark_waits_for_no_device(monkeypatch):
    """The recorder of a call on the card marks with no synchronize."""

    def refuse(*a, **kw):
        raise AssertionError("a mark waited for the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", refuse)
    timings = {}
    rec = _record._Recorder(timings, "enc", 5, [torch.device("cuda", 0), torch.device("cuda", 1)])
    rec.phase("pass1")
    rec.mark("launch")
    rec.mark("sums wait")
    assert [s[:2] for s in rec.spans] == [("pass1", "launch"), ("pass1", "sums wait")]
    assert set(timings) == {"pass1", "pass1 launch", "pass1 sums wait"}


def test_span_ends_precede_their_profiler_marks(chunked):
    """The record's clock is the profiler's: each span's end comes just
    before the ``mark:`` ranges of its phase and part (within 5 ms here,
    the host's jitter allowed for)."""
    data = _input(300, 100)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, ways = _round_trip(data, "cpu", Noting)
    marks = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("mark:"))
    spans = ways["enc"][1]["spans"] + ways["dec"][1]["spans"]
    assert len(marks) == 2 * len(spans)  # the phase's key, then the part's
    for j, (phase, part, _, end) in enumerate(spans):
        (t_phase, name_phase), (t_part, name_part) = marks[2 * j], marks[2 * j + 1]
        assert (name_phase, name_part) == (f"mark:{phase}", f"mark:{phase} {part}")
        assert 0 <= t_phase - end < 5_000_000 and t_phase <= t_part
