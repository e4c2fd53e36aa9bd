"""``api.decode`` a range of blocks at a time, on the CPU.

The chunks are cut to 128 blocks of 256 bytes (``DEC_CHUNK_BYTES``
patched), so a few hundred blocks take several ranges: raw blocks in
several ranges, a range of raw blocks only, a short last block and a last
range of one block.  Every output is held to the input and to the JAX
package's ``decode``, byte for byte; so is the call pattern: each decoder
call takes the coded blocks of one range, sorted by coded length, and each
buffer a gather reads is that range's slice of the archive.
"""

import zlib

import numpy as np
import pytest
import torch

from redux_tpu import api as ref_api
from redux_tpu import errors as ref_errors

from redux_tpu_torch import _pipeline, api, container, testdata
from redux_tpu_torch._record import UNRECORDED
from redux_tpu_torch.errors import InvalidInputError
from redux_tpu_torch.ops.staging import combine_crcs

K = 256
CHUNK = 128


def _data(n_blocks: int, tail: int, raw_range: bool, last_raw: bool, seed: int) -> bytes:
    """``n_blocks`` blocks of ``K`` (the last ``tail`` bytes long) of
    ``text_like`` with incompressible blocks strewn over every range,
    range 1 incompressible throughout when ``raw_range``, and the last
    block incompressible when ``last_raw``."""
    n = (n_blocks - 1) * K + tail
    data = bytearray(testdata.text_like(n, seed))
    rng = np.random.default_rng(seed)
    raw = set(rng.choice(n_blocks - 1, n_blocks // 12, replace=False).tolist())
    if raw_range:
        raw |= set(range(CHUNK, 2 * CHUNK))
    if last_raw:
        raw.add(n_blocks - 1)
    for b in sorted(raw):
        data[b * K : (b + 1) * K] = testdata.incompressible(K, seed + b)
    return bytes(data[:n])


@pytest.fixture
def chunked(monkeypatch):
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", CHUNK * K)
    assert api._lane_chunk(api.DEC_CHUNK_BYTES, K) == CHUNK


def _ranges(header):
    """``(s0, s1, slice start, slice end)`` of each range of the archive
    (``header`` from ``container.parse_table``)."""
    lanes = api._decode_lanes(header)
    ends = header.stream_offs + np.where(lanes.raw, lanes.block_lens, lanes.coded_lens)
    return [(s0, min(s0 + CHUNK, header.n_blocks), int(header.stream_offs[s0]),
             int(ends[min(s0 + CHUNK, header.n_blocks) - 1]))
            for s0 in range(0, header.n_blocks, CHUNK)]


@pytest.mark.parametrize("n_blocks,tail,raw_range,last_raw", [
    (385, 100, True, False),  # a raw range, a last range of one short coded block
    (385, 256, False, True),  # a last range of one raw block
    (300, 17, True, False),  # a short last range with a short last block
    (128, 256, False, False),  # one range
    (1, 100, False, False),  # one short block
])
def test_decode_equals_the_input_and_the_reference(chunked, n_blocks, tail, raw_range,
                                                   last_raw):
    data = _data(n_blocks, tail, raw_range, last_raw, n_blocks + tail)
    arch = api.encode(data, block_size=K, device="cpu")
    header, _ = container.parse_archive(arch, with_streams=False)
    raw = np.asarray(header.block_raw)
    assert header.n_blocks == n_blocks
    assert raw[n_blocks - 1] == last_raw
    if raw_range:
        assert raw[CHUNK : 2 * CHUNK].all()
    if n_blocks > CHUNK:  # raw blocks in more than one range
        assert sum(raw[s0 : s0 + CHUNK].any() for s0 in range(0, n_blocks, CHUNK)) >= 2
    timings = {}
    got = api.decode(arch, device="cpu", _timings=timings)
    assert type(got) is bytes
    assert got == data == ref_api.decode(arch)
    phases = {"parse", "upload", "kernels", "crc+fetch"}
    assert {key.split(" ", 1)[0] for key in timings} == phases
    for phase in phases:  # each phase the sum of its parts
        parts = sum(v for key, v in timings.items() if key.startswith(phase + " "))
        assert parts == pytest.approx(timings[phase])


def test_each_call_takes_one_range(chunked, monkeypatch):
    """Each decoder call takes the coded blocks of one range, sorted by
    coded length (the stable order); each gather reads its range's slice
    of the archive and no more; a range without coded blocks decodes
    nothing and one without raw blocks gathers no bytes."""
    data = _data(385, 100, True, False, 5)
    arch = api.encode(data, block_size=K, device="cpu")
    header = container.parse_table(arch)
    lanes = api._decode_lanes(header)
    ranges = _ranges(header)
    staged, decoded, gathers = [], [], []
    real_stage, real_dec, real_gather = api._stage_lanes, api.decode_blocks, api.gather_rows

    def stage(arch_t, header_, lanes_, sel, base=0):
        staged.append((sel.copy(), base, int(arch_t.shape[0])))
        return real_stage(arch_t, header_, lanes_, sel, base)

    def dec(words, lens, *args):
        decoded.append(int(lens.shape[0]))
        return real_dec(words, lens, *args)

    def gather(buf, offs, lens, width, words=False):
        gathers.append((int(buf.shape[0]), int(offs.shape[0]), words))
        return real_gather(buf, offs, lens, width, words)

    monkeypatch.setattr(api, "_stage_lanes", stage)
    monkeypatch.setattr(api, "decode_blocks", dec)
    monkeypatch.setattr(api, "gather_rows", gather)
    assert api.decode(arch, device="cpu") == data

    want_staged, want_gathers = [], []
    for s0, s1, a, b in ranges:
        raw = lanes.raw[s0:s1]
        coded = s0 + np.flatnonzero(~raw)
        if raw.any():
            want_gathers.append((b - a, int(raw.sum()), False))
        if coded.size:
            want_staged.append((coded[np.argsort(lanes.coded_lens[coded], kind="stable")], a))
            want_gathers.append((b - a, coded.size, True))
    assert len(staged) == len(want_staged) == 3  # range 1 is all raw
    for (sel, base, size), (want_sel, want_base), (s0, s1, a, b) in zip(
            staged, want_staged, [r for r in ranges if r[0] != CHUNK]):
        assert np.array_equal(sel, want_sel)
        assert sel.min() >= s0 and sel.max() < s1 and base == want_base == a and size == b - a
        assert (np.diff(lanes.coded_lens[sel]) >= 0).all()
    assert decoded == [sel.size for sel, _ in want_staged]
    assert gathers == want_gathers
    slices = [b - a for _, _, a, b in ranges]  # they tile the payload
    assert sum(slices) == len(arch) - int(header.stream_offs[0])


@pytest.mark.parametrize("where", ["first", "last"])
def test_a_flipped_payload_byte_raises(chunked, where):
    """A flipped byte in the first or the last range's slice fails the
    combined crc; the reference raises too."""
    data = _data(385, 100, True, False, 11)
    arch = api.encode(data, block_size=K, device="cpu")
    ranges = _ranges(container.parse_table(arch))
    s0, s1, a, b = ranges[0] if where == "first" else ranges[-1]
    bad = bytearray(arch)
    bad[(a + b) // 2] ^= 0x20
    with pytest.raises(InvalidInputError):
        api.decode(bytes(bad), device="cpu")
    with pytest.raises(ref_errors.InvalidInputError):
        ref_api.decode(bytes(bad))


def test_a_device_list_gives_the_one_device_bytes(chunked):
    data = _data(300, 17, True, False, 13)
    arch = api.encode(data, block_size=K, device="cpu")
    assert api.decode(arch, device=["cpu", "cpu"]) == api.decode(arch, device="cpu") == data


@pytest.mark.parametrize("last", [0, 1, K])
def test_combined_crc_with_a_short_last_piece(last):
    """``combine_crcs`` over ranges' CRCs as ``decode`` joins them: full
    pieces, then an empty, a one-byte or a one-block last piece."""
    rng = np.random.default_rng(last)
    pieces = [rng.integers(0, 256, CHUNK * K, dtype=np.uint8).tobytes() for _ in range(3)]
    pieces.append(rng.integers(0, 256, last, dtype=np.uint8).tobytes())
    whole = b"".join(pieces)
    after = [len(whole) - sum(map(len, pieces[: i + 1])) for i in range(len(pieces))]
    crcs = torch.tensor([zlib.crc32(p) for p in pieces], dtype=torch.int64)
    assert combine_crcs(crcs, torch.tensor(after)) == zlib.crc32(whole)


def test_new_bytes_is_fresh_and_writable():
    """The result's memory: a new ``bytes`` per call (one byte too, which
    CPython otherwise shares), written through its tensor."""
    for n in (1, 2, 4097):
        with _pipeline._Output(n, UNRECORDED) as oa, _pipeline._Output(n, UNRECORDED) as ob:
            assert oa.view.shape == ob.view.shape == (n,)
            oa.view.fill_(7)
            ob.view.fill_(9)
            a, b = oa.result(n), ob.result(n)
        assert a is not b and len(a) == n
        assert a == b"\x07" * n and b == b"\x09" * n
    with pytest.raises(ValueError):
        _pipeline._Output(0, UNRECORDED)
