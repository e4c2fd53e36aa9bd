"""``api.encode`` / ``api.decode`` over a list of devices, on the CPU.

A list of devices runs a call in steps (``api._shares``): each step gives
each device one contiguous share of at most a lane chunk, and each device
uploads, codes, splices, checks and fetches its own shares.  Here the
lists are 2, 3 and 4 CPU devices, and the chunks are cut to 128 blocks of
256 bytes (``ENC_CHUNK_BYTES`` and ``DEC_CHUNK_BYTES`` patched), so a few
hundred blocks take several steps.  Each archive is held byte for byte to
``device="cpu"`` and to the JAX package's ``encode`` (one small input also
to the reference's own sharded branch over the 8 virtual CPU devices of
``tests/conftest.py``) and decoded back in both packages.  Tolerance 0.
The plan and each device's uploads and fetches:
``tests/test_torch_dp_shares.py``.

The plain versions run on one torch thread here (:func:`one_thread`):
several test processes at once, each with a thread a core, oversubscribe
the cores, and a parallel op then waits for threads that are not
running (an encode of these inputs took 100 times longer).
"""

import functools

import pytest
import torch

from redux_tpu import api as ref_api

from redux_tpu_torch import api, container, testdata

K = 256
CHUNK = 128
LISTS = [2, 3, 4]
# name -> (blocks, bytes of the last block, blocks stored raw, use_prior)
INPUTS = {
    # Several steps on every list; blocks 128..255 all raw: on every list
    # a share of raw blocks only, which launches no K3.
    "several_steps": (700, 256, set(range(CHUNK, 2 * CHUNK)) | {3, 300, 450, 699}, True),
    "short_last_block_no_prior": (300, 17, {5, 140, 299}, False),
    # One step: each device keeps its one share's blocks for pass 2.
    "one_step_with_prior": (200, 256, {0, 77, 150}, True),
    # Under 4096 bytes (no prior by default); a device of four goes without.
    "fewer_blocks_than_devices": (3, 100, {1}, None),
    "empty": (0, 0, set(), None),
}


# (input, devices) of the archive test: every input once, the one of
# several steps on every list.
CASES = [("several_steps", 2), ("several_steps", 3), ("several_steps", 4),
         ("short_last_block_no_prior", 3), ("one_step_with_prior", 2),
         ("fewer_blocks_than_devices", 4), ("empty", 3)]


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
    assert api._lane_chunk(api.ENC_CHUNK_BYTES, K) == api._lane_chunk(api.DEC_CHUNK_BYTES, K)
    assert api._lane_chunk(api.ENC_CHUNK_BYTES, K) == CHUNK


@functools.lru_cache(maxsize=None)
def _input(name: str) -> tuple[bytes, dict]:
    """The input ``name`` of :data:`INPUTS` and its encode options."""
    n_blocks, tail, raw, use_prior = INPUTS[name]
    n = (n_blocks - 1) * K + tail if n_blocks else 0
    data = bytearray(testdata.text_like(n, n_blocks))
    for b in sorted(raw):
        data[b * K : (b + 1) * K] = testdata.incompressible(K, n_blocks + b)
    opts = {"block_size": K} | ({"use_prior": use_prior} if use_prior is not None else {})
    return bytes(data[:n]), opts


@functools.lru_cache(maxsize=None)
def _reference(name: str) -> bytes:
    data, opts = _input(name)
    return ref_api.encode(data, **opts)


@functools.lru_cache(maxsize=None)
def _one_device(name: str) -> bytes:
    data, opts = _input(name)
    return api.encode(data, device="cpu", **opts)


def _flat(steps):
    return [sh for step in steps for sh in step]


@pytest.mark.parametrize("name, n", CASES)
def test_archive_equals_the_one_device_and_the_reference(chunked, name, n):
    data, opts = _input(name)
    got = api.encode(data, device=["cpu"] * n, **opts)
    assert type(got) is bytes
    assert got == _one_device(name) == _reference(name)
    assert api.decode(got, device=["cpu"] * n) == data
    if name == "several_steps":  # the raw share is there, on every list
        header = container.parse_table(got)
        assert header.raw[CHUNK : 2 * CHUNK].all() and not header.raw.all()
        steps = api._shares(header.n_blocks, CHUNK, n)
        assert len(steps) >= 2 and api._Share(1, 0, CHUNK, 2 * CHUNK) in steps[0]


@pytest.mark.parametrize("name", list(INPUTS))
def test_both_packages_decode_the_archive_over_every_list(chunked, name):
    data, _ = _input(name)
    arch = _reference(name)
    assert ref_api.decode(arch) == data
    for n in LISTS:
        assert api.decode(arch, device=["cpu"] * n) == data


def test_the_reference_sharded_branch(monkeypatch):
    """The reference's Pallas branch sharded over the 8 virtual CPU devices
    (interpret mode; ``_dp_mesh`` left as it is) writes and reads the
    archives the port writes and reads over device lists."""
    monkeypatch.setenv("REDUX_TPU_FORCE_PALLAS", "1")
    assert ref_api._dp_mesh() is not None and ref_api._dp_mesh().devices.size == 8
    data = testdata.text_like(4000, 31) + testdata.incompressible(2100, 31) + b"dp" * 700
    ref = ref_api.encode(data, block_size=1024)
    for n in (1, 3, 4):
        mine = api.encode(data, block_size=1024, device=["cpu"] * n)
        assert mine == ref
        assert api.decode(ref, device=["cpu"] * n) == data
    assert ref_api.decode(mine) == data
