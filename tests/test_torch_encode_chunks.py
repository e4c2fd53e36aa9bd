"""``api.encode`` a lane chunk at a time into the returned archive, on the CPU.

The chunks are cut to 128 blocks of 256 bytes (``ENC_CHUNK_BYTES``
patched), so a few hundred blocks take several chunks.  Each archive is
held byte for byte to the JAX package's ``encode`` and decoded back; so
is the way it is built: each upload is its chunk's bytes with zeros to
the chunk's end (two passes past one chunk, one for an input of one
chunk), each payload goes to its block's offset in the returned
``bytes``, and the header written in front of it is ``build_archive``'s.
"""

import gc
import sys

import numpy as np
import pytest
import torch

from redux_tpu import api as ref_api
from redux_tpu import container as ref_container

from redux_tpu_torch import _pipeline, api, container, testdata
from redux_tpu_torch._record import UNRECORDED
from redux_tpu_torch.errors import InvalidInputError
from redux_tpu_torch.params import Parameters

K = 256
CHUNK = 128


def _data(n_blocks: int, tail: int, raw_chunk: bool, seed: int) -> bytes:
    """``n_blocks`` blocks of ``K`` (the last ``tail`` bytes long) of
    ``text_like``, a few incompressible blocks strewn over them, and chunk
    1 incompressible throughout when ``raw_chunk``."""
    n = (n_blocks - 1) * K + tail
    data = bytearray(testdata.text_like(n, seed))
    rng = np.random.default_rng(seed)
    raw = set(rng.choice(n_blocks, max(1, n_blocks // 16), replace=False).tolist())
    if raw_chunk:
        raw |= set(range(CHUNK, 2 * CHUNK))
    for b in sorted(raw):
        data[b * K : (b + 1) * K] = testdata.incompressible(K, seed + b)
    return bytes(data[:n])


@pytest.fixture
def chunked(monkeypatch):
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", CHUNK * K)
    assert api._lane_chunk(api.ENC_CHUNK_BYTES, K) == CHUNK


@pytest.mark.parametrize("n_blocks,tail,raw_chunk,use_prior,device", [
    (300, 256, True, True, "cpu"),  # a chunk stored raw throughout
    (300, 17, False, True, "cpu"),  # a short last block
    (257, 256, False, True, "cpu"),  # a last chunk of one block
    (128, 256, False, True, "cpu"),  # exactly one chunk
    (300, 17, True, False, "cpu"),  # no prior
    (12, 184, False, None, "cpu"),  # under 4096 bytes: no prior by default
    (300, 17, True, True, ["cpu", "cpu"]),  # a device list
], ids=["raw_chunk", "short_last_block", "last_chunk_of_one_block", "one_chunk", "no_prior",
        "under_4096", "device_list"])
def test_archive_equals_the_reference(chunked, n_blocks, tail, raw_chunk, use_prior, device):
    data = _data(n_blocks, tail, raw_chunk, n_blocks + tail)
    got = api.encode(data, block_size=K, use_prior=use_prior, device=device)
    assert type(got) is bytes
    assert got == ref_api.encode(data, block_size=K, use_prior=use_prior)
    header, _ = container.parse_archive(got, with_streams=False)
    raw = np.asarray(header.block_raw)
    assert header.n_blocks == n_blocks
    if raw_chunk:
        assert raw[CHUNK : 2 * CHUNK].all() and not raw.all()
    assert api.decode(got, device="cpu") == data


def test_result_is_exactly_the_archive_and_outlives_the_call(chunked):
    """The result is a ``bytes`` of the header and payload's length, held
    by its caller alone, and unchanged after ``del`` of everything else,
    ``gc.collect()`` and another call."""
    data = _data(300, 17, True, 3)
    arch = api.encode(data, block_size=K, device="cpu")
    header, _ = container.parse_archive(arch, with_streams=False)
    payload = sum(header.block_byte_lens)
    assert len(arch) == container.header_bytes(300, True) + payload
    assert sys.getrefcount(arch) == 2  # the name and the call's argument
    copy = bytes(bytearray(arch))
    del header
    gc.collect()
    other = api.encode(data[::-1], block_size=K, device="cpu")
    gc.collect()
    assert arch == copy and other != arch
    assert api.decode(arch, device="cpu") == data


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_write_header_equals_build_archive(prior, seed):
    """``container.write_header`` writes the bytes that the port's and the
    reference's ``build_archive`` put before the payload, for random
    lengths (raw blocks at their top bit) and block counts from 0."""
    rng = np.random.default_rng(seed)
    params = Parameters(8, int(rng.integers(12, 21)), 22)
    extra = rng.integers(0, 1 << 16, 256) if prior else None
    for n_blocks in (0, 1, int(rng.integers(2, 3000))):
        lens = rng.integers(0, 1 << 16, n_blocks)
        raw = rng.random(n_blocks) < 0.3
        args = (params, int(rng.integers(1, 1 << 20)), int(rng.integers(0, 1 << 40)))
        delta, crc = int(rng.integers(1, 256)), int(rng.integers(0, 1 << 32))
        payload = bytes(int(lens.sum()))
        size = container.header_bytes(n_blocks, prior)
        want = container.build_archive(*args, [], extra, delta, crc, raw.tolist(),
                                       payload=payload, stream_lens=lens.tolist())
        ref = ref_container.build_archive(*args, [], extra, delta, crc, raw.tolist(),
                                          payload=payload, stream_lens=lens.tolist())
        dst = np.full(size + 5, 0xAB, dtype=np.uint8)
        assert container.write_header(dst, *args, extra, delta, crc, raw, lens) == size
        assert dst[:size].tobytes() == want[:size] == ref[:size]
        assert (dst[size:] == 0xAB).all()


def test_write_header_refuses_what_build_archive_refuses():
    params, dst = Parameters.tpu_wide(), np.zeros(4096, dtype=np.uint8)
    lens, raw = np.array([5, 7]), np.array([False, True])
    for delta in (0, 256):
        with pytest.raises(InvalidInputError):
            container.write_header(dst, params, 4096, 12, None, delta, 0, raw, lens)
    for extra in (np.zeros(255, np.int64), np.full(256, 1 << 16)):
        with pytest.raises(InvalidInputError):
            container.write_header(dst, params, 4096, 12, extra, 16, 0, raw, lens)
    for bad in (np.array([5, -1]), np.array([5, 1 << 31])):
        with pytest.raises(InvalidInputError):
            container.write_header(dst, params, 4096, 12, None, 16, 0, raw, bad)
    with pytest.raises(InvalidInputError):
        container.write_header(dst, params, 4096, 12, None, 16, 0, raw[:1], lens)


def _record(monkeypatch):
    """Each upload's bytes and each fetch's ``(offset, length)``."""
    takes, puts = [], []
    real_take, real_put = _pipeline._Upload.take, _pipeline._Fetch.put

    def take(self):
        t = real_take(self)
        takes.append(t.numpy().tobytes())
        return t

    def put(self, i, flat, off):
        puts.append((off, int(flat.shape[0])))
        return real_put(self, i, flat, off)

    monkeypatch.setattr(_pipeline._Upload, "take", take)
    monkeypatch.setattr(_pipeline._Fetch, "put", put)
    return takes, puts


@pytest.mark.parametrize("n_blocks,tail", [(300, 17), (257, 256), (128, 100)])
def test_each_upload_and_fetch_covers_its_chunk(chunked, monkeypatch, n_blocks, tail):
    """An upload is its chunk's bytes with zeros to the chunk's end: each
    chunk once a pass past one chunk, once in all for an input of one
    chunk; a fetch is its chunk's payload, at the offset of its first
    block's stream in the archive."""
    data = _data(n_blocks, tail, n_blocks > CHUNK, 7)
    takes, puts = _record(monkeypatch)
    arch = api.encode(data, block_size=K, device="cpu")
    header, _ = container.parse_archive(arch, with_streams=False)
    spans = [(s0, min(s0 + CHUNK, n_blocks)) for s0 in range(0, n_blocks, CHUNK)]
    want = [data[s0 * K : s1 * K].ljust((s1 - s0) * K, b"\0") for s0, s1 in spans]
    assert takes == (want * 2 if len(spans) > 1 else want)
    ends = header.stream_offs + np.asarray(header.block_byte_lens)
    assert puts == [(int(header.stream_offs[s0]), int(ends[s1 - 1] - header.stream_offs[s0]))
                    for s0, s1 in spans]
    assert puts[-1][0] + puts[-1][1] == len(arch)


def test_the_cpu_path_pins_nothing(chunked, monkeypatch):
    """``device="cpu"`` copies plainly: no pinned memory, no stream."""
    def refuse(n):
        raise AssertionError("pinned memory on the CPU path")

    monkeypatch.setattr(_pipeline, "_pinned", refuse)
    data = _data(300, 17, True, 9)
    arch = api.encode(data, block_size=K, device="cpu")
    assert api.decode(arch, device="cpu") == data
    up = _pipeline._Upload(data, [(0, 10, 16)], torch.device("cpu"), UNRECORDED)
    assert up.side is None and up.take().tolist() == list(data[:10]) + [0] * 6


def test_output_shrinks_in_place():
    """``_Output`` hands over its object cut to the length asked, where it
    lies (a block of this size: no copy), and refuses a length outside
    1..n; a call that raises before the result frees it."""
    n = 64 << 20
    with _pipeline._Output(n, UNRECORDED) as out:
        addr = out._ptr.value
        out.view[:1000].copy_(torch.arange(1000) % 251)
        with pytest.raises(ValueError):
            out.result(n + 1)
        with pytest.raises(ValueError):
            out.result(0)
        got = out.result(1000)
    assert id(got) == addr and len(got) == 1000
    assert got == bytes(i % 251 for i in range(1000))
    with pytest.raises(RuntimeError):
        with _pipeline._Output(4096, UNRECORDED) as out:
            raise RuntimeError("the call failed")
    assert out._ptr is None and out.view is None


def _prefault_threads() -> list:
    import threading

    return [t for t in threading.enumerate() if t.name.startswith("redux-prefault")]


def test_touch_pages_writes_a_byte_a_page():
    """``_touch_pages`` writes a zero into the range's first byte and each
    page start inside it, and nothing else."""
    import mmap

    page = mmap.PAGESIZE
    arr = np.full(5 * page + 100, 0xFF, dtype=np.uint8)
    lead = (-arr.ctypes.data) % page  # the first page start in arr
    a, b = lead + 10, lead + 3 * page + 1
    _pipeline._touch_pages(arr, a, b)
    want = np.full_like(arr, 0xFF)
    want[[a, lead + page, lead + 2 * page, lead + 3 * page]] = 0
    assert np.array_equal(arr, want)
    _pipeline._touch_pages(arr, b, b)  # an empty range touches nothing
    assert np.array_equal(arr, want)


def test_prefaulted_output_is_correct_and_outlives_the_call(monkeypatch):
    """``_Output`` with its ranges prefaulted on worker threads (pieces of
    64 KiB here): every range is touched before it is written, the result
    is what was written, held by its caller alone, and survives ``gc``; the
    threads are joined when it is handed over."""
    monkeypatch.setattr(_pipeline._Output, "TOUCH_PIECE", 1 << 16)
    n = (1 << 20) + 123
    src = torch.from_numpy(np.random.default_rng(2).integers(0, 256, n, dtype=np.uint8))
    with _pipeline._Output(n, UNRECORDED) as out:
        for a in range(0, n, 300_000):
            out.prefault(a, min(a + 300_000, n))
        assert len(out._touches) == sum(-(-min(300_000, n - a) // (1 << 16))
                                        for a in range(0, n, 300_000))
        for a in range(0, n, 300_000):
            b = min(a + 300_000, n)
            out.ready(a, b)
            assert all(done.done() for p, q, done in out._touches if p < b and a < q)
            out.view[a:b].copy_(src[a:b])
        got = out.result(n)
    assert sys.getrefcount(got) == 2
    assert not _prefault_threads() and out._pool is None
    gc.collect()
    assert got == bytes(src.numpy())


def test_a_failing_call_joins_its_prefault_and_frees_the_output():
    """A call that raises with prefaults queued: the exit cancels what has
    not started, waits for what has, and only then frees the object."""
    with pytest.raises(RuntimeError):
        with _pipeline._Output(64 << 20, UNRECORDED) as out:
            out.prefault(0, 64 << 20)
            raise RuntimeError("the call failed")
    assert out._ptr is None and out.view is None and out._pool is None
    assert not _prefault_threads()


@pytest.mark.parametrize("n_blocks,tail", [(300, 17), (128, 256)])
def test_prefault_touches_only_what_is_written(chunked, monkeypatch, n_blocks, tail):
    """Encode prefaults the header and each chunk's payload once its wire
    lengths are known: the ranges tile the archive exactly, never past
    its end (the result's tail that ``_PyBytes_Resize`` gives back).
    Decode prefaults each range of blocks' output: they tile the input."""
    touched = []
    real = _pipeline._touch_pages

    def record(arr, a, b):
        touched.append((a, b))
        real(arr, a, b)

    monkeypatch.setattr(_pipeline, "_touch_pages", record)
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", CHUNK * K)
    data = _data(n_blocks, tail, False, 8)
    arch = api.encode(data, block_size=K, device="cpu")
    assert arch == ref_api.encode(data, block_size=K)
    spans = sorted(touched)
    assert spans[0][0] == 0 and spans[-1][1] == len(arch)
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
    touched.clear()
    assert api.decode(arch, device="cpu") == data
    spans = sorted(touched)
    assert spans[0][0] == 0 and spans[-1][1] == len(data)
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
