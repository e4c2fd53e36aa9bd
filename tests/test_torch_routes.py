"""The port's compact archive, its compact and auto routes, its package-level
stream API and its lane chunks, against the reference.  ``device="cpu"``
throughout (the block archive's plain versions); inputs come from numpy
seeds and ``redux_tpu_torch.testdata``; every comparison is byte equality."""

import io

import numpy as np
import pytest

import redux_tpu
from redux_tpu import api as ref_api
from redux_tpu import container as ref_container
from redux_tpu import errors as ref_errors
from redux_tpu import native as ref_native

import redux_tpu_torch
from redux_tpu_torch import api, container, errors, native
from redux_tpu_torch.testdata import incompressible, text_like


def _outcome(fn):
    try:
        return ("ok", fn())
    except (errors.ReduxError, ref_errors.ReduxError) as e:
        return ("raise", type(e).__name__)


# -- the compact archive ------------------------------------------------------


def test_compact_archive_bytes_and_parse_match_reference():
    rng = np.random.default_rng(12)
    for cfg in range(len(container.COMPACT_CONFIGS)):
        for orig_len in (0, 1, 127, 128, 300, 1 << 20):
            payload = bytes(rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8))
            payload += b"\x00" * (orig_len // 1000)  # enough payload for orig_len
            crc = int(rng.integers(0, 1 << 32))
            mine = container.build_compact(cfg, orig_len, payload, crc)
            assert mine == ref_container.build_compact(cfg, orig_len, payload, crc)
            assert container.is_compact_archive(mine) and ref_container.is_compact_archive(mine)
            p, delta, n, crc16, body = container.parse_compact(mine)
            rp, rdelta, rn, rcrc16, rbody = ref_container.parse_compact(mine)
            assert (p.freq_bits, p.code_bits, delta, n, crc16, body) == (
                rp.freq_bits, rp.code_bits, rdelta, rn, rcrc16, rbody)
    assert container.COMPACT_CONFIGS == ref_container.COMPACT_CONFIGS
    assert container.COMPACT_MAGIC == ref_container.COMPACT_MAGIC == 0xB3
    assert not container.is_compact_archive(b"\xb3") and not container.is_compact_archive(b"")


def test_compact_archive_rejections_match_reference():
    good = ref_container.build_compact(4, 1000, b"\x55" * 40, 0xBEEF)
    bad = [
        b"\xb2" + good[1:],                   # bad magic
        good[:1] + b"\x24" + good[2:],        # version 2
        good[:1] + b"\x18" + good[2:],        # cfg 8
        good[:1] + b"\x1f" + good[2:],        # cfg 15
        b"\xb3\x14\x80\x80",                  # truncated varint
        b"\xb3\x14" + b"\xff" * 10 + b"\x01",  # varint past 63 bits
        good[:4],                             # no room for the crc16
        good[:3],                             # shorter than a header
        ref_container.build_compact(4, 10**9, b"\x55" * 40, 0),  # orig_len past the bound
    ]
    for arch in bad:
        assert _outcome(lambda: container.parse_compact(arch)) == ("raise", "InvalidInputError")
        with pytest.raises(ref_errors.InvalidInputError):
            ref_container.parse_compact(arch)
    with pytest.raises(errors.InvalidInputError):
        container.build_compact(8, 1, b"", 0)
    with pytest.raises(errors.InvalidInputError):
        container.compact_config(-1)


def test_compact_route_matches_reference_and_rejects_a_bad_crc16():
    data = text_like(5000, 13)
    for cfg in range(len(container.COMPACT_CONFIGS)):
        mine = api.encode_compact(data, cfg)
        assert mine == ref_api.encode_compact(data, cfg)
        assert api.decode_compact(mine) == data == ref_api.decode_compact(mine)
    assert api.encode_compact(b"", 4) == ref_api.encode_compact(b"", 4)
    assert api.decode_compact(api.encode_compact(b"", 4)) == b""
    arch = bytearray(api.encode_compact(data, 4))
    arch[4] ^= 0x01  # the crc16's low byte, after magic, cfg and the 2-byte varint of 5000
    for bad in (bytes(arch), api.encode_compact(data, 4)[:-3]):
        assert _outcome(lambda: api.decode_compact(bad)) == _outcome(
            lambda: ref_api.decode_compact(bad))
        assert _outcome(lambda: api.decode_compact(bad))[0] == "raise"


# -- the auto route -----------------------------------------------------------


def _bare_streams_with_compact_magic():
    """Bare (8,30,32) reference streams whose first byte is the compact
    magic: one that fails the compact parse at once (version nibble), one
    that parses as a compact header and must fail its decode or crc16."""
    rng = np.random.default_rng(14)
    found = {}
    for _ in range(400000):
        data = bytes(rng.integers(0, 256, 6, dtype=np.uint8))
        s = native.compress_bytes(data)
        if s[0] != 0xB3:
            continue
        kind = "parses" if s[1] >> 4 == 1 and (s[1] & 0x0F) < 8 else "misparses"
        found.setdefault(kind, (data, s))
        if len(found) == 2:
            return found
    raise AssertionError(f"search found only {sorted(found)}")


def test_bare_streams_starting_with_the_compact_magic():
    """``decode_auto`` routes a bare stream that starts with 0xB3 through the
    compact parse and falls through to the bare-stream decoder, as the
    reference does; ``encode_auto`` never offers such a stream."""
    for kind, (data, stream) in _bare_streams_with_compact_magic().items():
        assert stream == ref_native.compress_bytes(data)
        assert container.is_compact_archive(stream)
        assert api.decode_auto(stream, device="cpu") == data, kind
        assert ref_api.decode_auto(stream) == data
        auto = api.encode_auto(data, device="cpu")
        assert auto == ref_api.encode_auto(data) and auto != stream
        assert api.decode_auto(auto, device="cpu") == data


def _regime(name):
    """The input and the ``encode_auto`` keywords of each size regime."""
    if name == "small":  # under 4096 bytes: one block archive, compact, the bare stream
        return text_like(3000, 15), {}
    if name == "compact_range":  # 4096 .. _COMPACT_MAX, params None: the bare stream competes
        return text_like(14000, 16) + incompressible(3000, 16) + b"\x00" * 500, {}
    if name == "binary_compact_range":
        return incompressible(6000, 17) + bytes(range(256)) * 4, {}
    if name == "above_compact_max":  # with _COMPACT_MAX patched to 6 KiB
        return text_like(6000, 18) + incompressible(1200, 18), {"block_size": 2048}
    raise KeyError(name)


@pytest.mark.parametrize("name", ["small", "compact_range", "binary_compact_range",
                                  "above_compact_max"])
def test_auto_route_matches_reference(name, monkeypatch):
    """The three regimes of ``encode_auto``.  Above ``_COMPACT_MAX`` (patched
    to 6 KiB in both packages, so that the 16 KiB-block candidate codes a
    7 KiB block, not one past 1 MiB) only block archives compete: with
    prior, without, and with 16 KiB blocks."""
    data, kw = _regime(name)
    if name == "above_compact_max":
        monkeypatch.setattr(api, "_COMPACT_MAX", 6 << 10)
        monkeypatch.setattr(ref_api, "_COMPACT_MAX", 6 << 10)
    mine = api.encode_auto(data, device="cpu", **kw)
    ref = ref_api.encode_auto(data, **kw)
    assert mine == ref
    assert api.decode_auto(mine, device="cpu") == data == ref_api.decode_auto(mine)
    if name == "above_compact_max":
        assert container.is_rxt_archive(mine)
    else:
        bare = native.compress_bytes(data)
        assert len(mine) <= len(bare)  # the bare stream competes: never larger
        assert api.decode_auto(bare, device="cpu") == data == ref_api.decode_auto(bare)


def test_auto_route_with_params_and_empty_input():
    data = text_like(2000, 19)
    p = redux_tpu_torch.Parameters.tpu32()
    rp = redux_tpu.Parameters.tpu32()
    mine = api.encode_auto(data, params=p, block_size=1024, device="cpu")
    assert mine == ref_api.encode_auto(data, params=rp, block_size=1024)
    assert api.decode_auto(mine, params=p, device="cpu") == data
    assert api.encode_auto(b"", device="cpu") == ref_api.encode_auto(b"")
    assert api.decode_auto(api.encode_auto(b"", device="cpu"), device="cpu") == b""
    bare = native.compress_bytes(data, p)
    assert api.decode_auto(bare, params=p, device="cpu") == data == ref_api.decode_auto(bare, rp)
    for bad in (b"\x01", b"RXT1" + b"\x00" * 10):
        assert _outcome(lambda: api.decode_auto(bad, device="cpu")) == _outcome(
            lambda: ref_api.decode_auto(bad))


# -- the package API ----------------------------------------------------------


def test_package_stream_api_matches_reference():
    for data in (b"", b"package api", text_like(2500, 20)):
        mine = redux_tpu_torch.compress_bytes(data)
        assert mine == redux_tpu.compress_bytes(data)
        assert redux_tpu_torch.decompress_bytes(mine) == data == redux_tpu.decompress_bytes(mine)
        out, ref_out = io.BytesIO(), io.BytesIO()
        counts = redux_tpu_torch.compress(io.BytesIO(data), out)
        assert counts == redux_tpu.compress(io.BytesIO(data), ref_out)
        assert out.getvalue() == ref_out.getvalue() == mine
        back, ref_back = io.BytesIO(), io.BytesIO()
        assert redux_tpu_torch.decompress(io.BytesIO(mine), back) == redux_tpu.decompress(
            io.BytesIO(mine), ref_back)
        assert back.getvalue() == ref_back.getvalue() == data


# -- lane chunks --------------------------------------------------------------


def test_multi_chunk_encode_and_decode(monkeypatch):
    """Encode and decode cut the lanes into chunks of at least 128 blocks.
    With the chunk sizes at 128 blocks of 256 bytes, 300 blocks take three
    chunks each way: the archive equals the one-chunk archive and the
    reference's, and decode round-trips.  A decode chunk is a range of
    blocks and its decoder call takes the range's coded blocks: the 130
    incompressible blocks first are stored raw, so the first range is all
    raw and launches no decoder, the second has 126 coded blocks."""
    k = 256
    data = incompressible(130 * k, 23) + text_like(170 * k - 77, 23)
    one_chunk = api.encode(data, block_size=k, device="cpu")
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", 128 * k)
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", 128 * k)
    three_chunks = api.encode(data, block_size=k, device="cpu")
    assert three_chunks == one_chunk == ref_api.encode(data, block_size=k)
    header, _ = container.parse_archive(three_chunks)
    assert header.n_blocks == 300 and sum(header.block_raw) >= 128

    calls = []
    real = api.decode_blocks

    def counting(words, lens, *args):
        calls.append(int(lens.shape[0]))
        return real(words, lens, *args)

    monkeypatch.setattr(api, "decode_blocks", counting)
    assert api.decode(three_chunks, device="cpu") == data
    raw = np.asarray(header.block_raw)
    assert calls == [int((~raw[s0 : s0 + 128]).sum()) for s0 in (128, 256)] == [126, 44], calls
    assert raw[:128].all()  # the first range took the all-raw branch
