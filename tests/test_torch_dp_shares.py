"""The share plan and how a device list's work is laid out, on the CPU.

``api._shares`` pinned (one device: the lane chunks), each device's
uploads and fetches tiling exactly its shares (2, 3 and 4 CPU devices,
the chunks cut to 128 blocks of 256 bytes), a flipped payload byte in
every share raising, a failure on one device, a CUDA device in a list
without CUDA, and how a step is issued.  The inputs are
``tests/test_torch_dp_route.py``'s, on one torch thread as there.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from redux_tpu import api as ref_api
from redux_tpu import errors as ref_errors

from redux_tpu_torch import _pipeline, api, container
from redux_tpu_torch._record import _Unrecorded
from redux_tpu_torch.errors import InvalidInputError

from test_torch_dp_route import (CHUNK, K, LISTS, _flat, _input, _reference,  # noqa: F401
                                 chunked, one_thread)


def test_the_share_plan():
    """Steps of at most one share a device, each at most a chunk, in block
    order; full steps of a chunk a device, then the rest split evenly; one
    device gives the lane chunks."""
    c = 65536
    steps = api._shares(524_544, c, 4)  # 2 GiB + 1 MiB of 4 KiB blocks
    assert [len(s) for s in steps] == [4, 4, 4]
    assert [sh.s1 - sh.s0 for sh in steps[-1]] == [64] * 4
    assert sum(map(len, api._shares(524_544, c, 2))) == 10
    assert api._shares(3, 128, 4) == [[api._Share(0, 0, 0, 1), api._Share(1, 0, 1, 2),
                                       api._Share(2, 0, 2, 3)]]
    assert [sh.s1 - sh.s0 for sh in api._shares(10, 128, 4)[0]] == [3, 3, 2, 2]
    assert api._shares(0, 128, 3) == []
    for n_blocks in (1, 127, 128, 129, 300, 524_544):
        want = [(s0, min(s0 + c, n_blocks)) for s0 in range(0, n_blocks, c)]
        steps = api._shares(n_blocks, c, 1)
        assert [[(sh.s0, sh.s1) for sh in step] for step in steps] == [[w] for w in want]
        assert [(sh.card, sh.i) for sh in _flat(steps)] == [(0, i) for i in range(len(want))]
    rng = np.random.default_rng(5)
    for _ in range(200):
        n_blocks, chunk, n = int(rng.integers(0, 3000)), int(rng.integers(1, 300)), int(
            rng.integers(1, 9))
        steps = api._shares(n_blocks, chunk, n)
        flat = _flat(steps)
        assert [sh.s0 for sh in flat] == [0] + [sh.s1 for sh in flat[:-1]]
        assert (flat[-1].s1 if flat else 0) == n_blocks
        assert all(0 < sh.s1 - sh.s0 <= chunk for sh in flat)
        for step in steps[:-1]:
            assert [sh.card for sh in step] == list(range(n))
            assert all(sh.s1 - sh.s0 == chunk for sh in step)
        if steps:
            last = steps[-1]
            assert len(last) == min(n, last[-1].s1 - last[0].s0)
            sizes = [sh.s1 - sh.s0 for sh in last]
            assert max(sizes) - min(sizes) <= 1
        own = api._by_card(steps, n)
        assert all([sh.i for sh in mine] == list(range(len(mine))) for mine in own)


def _record(monkeypatch):
    """Each ``_Upload``'s and each ``_Fetch``'s record, in the order they
    were made: the uploads' ``(ranges, bytes taken)`` and the fetches'
    ``(offset, length)`` of each put."""
    ups, fetches = [], []
    real_up, real_take = _pipeline._Upload.__init__, _pipeline._Upload.take
    real_fetch, real_put = _pipeline._Fetch.__init__, _pipeline._Fetch.put

    def up_init(self, data, ranges, device, *rest):
        real_up(self, data, ranges, device, *rest)
        self.taken_bytes = []
        ups.append(self)

    def take(self):
        t = real_take(self)
        self.taken_bytes.append(t.numpy().tobytes())
        return t

    def fetch_init(self, out, device, slot_bytes, n_slots, *rest):
        real_fetch(self, out, device, slot_bytes, n_slots, *rest)
        self.puts = []
        fetches.append(self)

    def put(self, i, flat, off):
        self.puts.append((off, int(flat.shape[0])))
        return real_put(self, i, flat, off)

    monkeypatch.setattr(_pipeline._Upload, "__init__", up_init)
    monkeypatch.setattr(_pipeline._Upload, "take", take)
    monkeypatch.setattr(_pipeline._Fetch, "__init__", fetch_init)
    monkeypatch.setattr(_pipeline._Fetch, "put", put)
    return ups, fetches


@pytest.mark.parametrize("name, n", [("several_steps", 2), ("several_steps", 3),
                                     ("several_steps", 4), ("one_step_with_prior", 3),
                                     ("fewer_blocks_than_devices", 4)])
def test_each_device_uploads_and_fetches_its_shares(chunked, monkeypatch, name, n):
    """Encode: a device's uploads are its shares' bytes, zero to each
    share's end, twice where it has more than one share, once where it
    has one; its fetches are its shares' payloads, each at the offset of
    its first block's stream.  Decode: a device's uploads are its shares'
    slices of the archive; its fetches are its shares' output, at
    ``s0 * k``.  Over all devices the fetches tile the payload and the
    output, with no gap or overlap."""
    data, opts = _input(name)
    ups, fetches = _record(monkeypatch)
    arch = api.encode(data, device=["cpu"] * n, **opts)
    header = container.parse_table(arch)
    own = api._by_card(api._shares(header.n_blocks, CHUNK, n), n)
    busy = [j for j in range(n) if own[j]]
    assert len(ups) == len(fetches) == len(busy)
    ends = api._stream_ends(header, api._decode_lanes(header))
    puts = []
    for up, fetch, j in zip(ups, fetches, busy):
        spans = [data[sh.s0 * K : sh.s1 * K].ljust((sh.s1 - sh.s0) * K, b"\0") for sh in own[j]]
        assert up.taken_bytes == (spans * 2 if len(own[j]) > 1 else spans)
        want = [(int(header.stream_offs[sh.s0]), int(ends[sh.s1 - 1] - header.stream_offs[sh.s0]))
                for sh in own[j]]
        assert fetch.puts == want
        puts += want
    puts.sort()
    assert puts[0][0] == container.header_bytes(header.n_blocks, header.prior_extra is not None)
    assert all(a + m == b for (a, m), (b, _) in zip(puts, puts[1:]))
    assert puts[-1][0] + puts[-1][1] == len(arch)

    ups.clear()
    fetches.clear()
    assert api.decode(arch, device=["cpu"] * n) == data
    assert len(ups) == len(fetches) == len(busy)
    outs = []
    for up, fetch, j in zip(ups, fetches, busy):
        assert up.taken_bytes == [arch[int(header.stream_offs[sh.s0]) : int(ends[sh.s1 - 1])]
                                  for sh in own[j]]
        want = [(sh.s0 * K, min(sh.s1 * K, len(data)) - sh.s0 * K) for sh in own[j]]
        assert fetch.puts == want
        outs += want
    outs.sort()
    assert outs[0][0] == 0 and outs[-1][0] + outs[-1][1] == len(data)
    assert all(a + m == b for (a, m), (b, _) in zip(outs, outs[1:]))


@pytest.mark.parametrize("n", LISTS)
def test_a_flipped_payload_byte_in_any_share_raises(chunked, n):
    """A byte flipped in the middle of each share's slice of the archive
    in turn fails the combined crc over the list; the reference raises
    for it too."""
    data, opts = _input("several_steps")
    arch = api.encode(data, device=["cpu"] * n, **opts)
    header = container.parse_table(arch)
    ends = api._stream_ends(header, api._decode_lanes(header))
    shares = _flat(api._shares(header.n_blocks, CHUNK, n))
    assert len(shares) >= 5
    for sh in shares:
        bad = bytearray(arch)
        bad[(int(header.stream_offs[sh.s0]) + int(ends[sh.s1 - 1])) // 2] ^= 0x20
        with pytest.raises(InvalidInputError):
            api.decode(bytes(bad), device=["cpu"] * n)
    with pytest.raises(ref_errors.InvalidInputError):
        ref_api.decode(bytes(bad))


@pytest.mark.parametrize("way", ["encode", "decode"])
def test_a_failure_on_one_device_raises(chunked, monkeypatch, way):
    """A kernel wrapper that raises on the second device's share: the call
    raises that error, and the next call is whole."""
    data, opts = _input("one_step_with_prior")
    arch = api.encode(data, device="cpu", **opts)
    name = "encode_blocks_ranked" if way == "encode" else "decode_blocks"
    real, calls = getattr(api, name), []

    def fail_on_second(*args, **kwargs):
        calls.append(args[0].device)
        if len(calls) == 2:
            raise RuntimeError("launch failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(api, name, fail_on_second)
    with pytest.raises(RuntimeError, match="launch failed"):
        if way == "encode":
            api.encode(data, device=["cpu"] * 3, **opts)
        else:
            api.decode(arch, device=["cpu"] * 3)
    assert len(calls) == 2
    monkeypatch.setattr(api, name, real)
    assert api.encode(data, device=["cpu"] * 3, **opts) == arch
    assert api.decode(arch, device=["cpu"] * 3) == data


def test_a_cuda_device_in_a_list_raises_without_cuda():
    """A list naming a CUDA device on a machine without one raises before
    any work; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    data, opts = _input("one_step_with_prior")
    for devices in (["cpu", "cuda:0"], ["cuda", "cuda"]):
        with pytest.raises(RuntimeError, match="is_available"):
            api.encode(data, device=devices, **opts)
        with pytest.raises(RuntimeError, match="is_available"):
            api.decode(_reference("one_step_with_prior"), device=devices)
    with pytest.raises(ValueError):
        api.encode(data, device=[], **opts)


def test_how_a_step_is_issued():
    """The first function runs on every share of the step, then the
    second: every device's kernels queue before any host copy.  Each run
    serves its share's card first."""
    seen = []

    class Serves(_Unrecorded):
        def serve(self, j):
            seen.append(("serve", j))

    step = [(SimpleNamespace(j=j), api._Share(j, 0, 10 * j, 10 * j + 10)) for j in range(3)]

    def note(what):
        return lambda card, sh: seen.append((what, sh.card))

    api._each(step, note("queue"), note("copy"), rec=Serves())
    assert seen == [x for what in ("queue", "copy") for j in range(3)
                    for x in (("serve", j), (what, j))]
