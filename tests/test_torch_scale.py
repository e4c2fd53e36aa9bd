"""The at-size logic of the port on the CPU, at small sizes: the test-data
generators in segments, the byte histogram over lane chunks, and the main
path over nine lane chunks each way.

The card runs the same code at 2 GiB + 1 MiB (``chip_smoke.py`` phase 11):
524,544 blocks of 4 KiB, nine chunks of at most 65,536 blocks each way.
Here the chunks are cut to 128 blocks, as ``tests/test_torch_routes.py``
does, so 1,040 blocks of 256 bytes take eight full chunks and a short one.
"""

import numpy as np
import pytest

from redux_tpu import api as ref_api

from redux_tpu_torch import api, container, cuda_checks, testdata
from redux_tpu_torch._pipeline import _host_u8
from redux_tpu_torch.models.dense import quantize_prior
from redux_tpu_torch.params import Parameters


def _text_like_one_shot(n, seed):
    """``testdata.text_like`` as it was written before it ran in segments:
    every draw of a pass at once, a searchsorted per draw, one index of
    the whole output."""
    tokens = [w + s for w in testdata._WORDS for s in testdata._SEPS]
    weights = np.array(
        [(4096 // (i + 1)) * (24 if j < 6 else 2) for i in range(len(testdata._WORDS))
         for j in range(len(testdata._SEPS))], dtype=np.uint64)
    cum = np.cumsum(weights)
    buf = np.frombuffer(b"".join(tokens), dtype=np.uint8)
    tlen = np.array([len(t) for t in tokens], dtype=np.int64)
    toff = np.cumsum(tlen) - tlen
    out, have, start = [], 0, 0
    while have < n:
        m = (n - have) // 3 + 64
        r = testdata.splitmix64(seed, m, start) % cum[-1]
        start += m
        idx = np.searchsorted(cum, r, side="right")
        ls = tlen[idx]
        flat = np.repeat(toff[idx] - (np.cumsum(ls) - ls), ls) + np.arange(int(ls.sum()))
        out.append(buf[flat])
        have += int(ls.sum())
    return np.concatenate(out)[:n].tobytes()


def _mixed_one_shot(n, seed):
    segment = 1 << 15
    data = bytearray(_text_like_one_shot(n, seed))
    for i, s0 in enumerate(range(0, n, segment)):
        if i % 32 == 16:
            a = min(s0 + 1000, n)
            b = min(s0 + segment - 1000, n)
            data[a:b] = testdata.incompressible(b - a, seed + 1 + i)
    return bytes(data)


def _splitmix64_one_shot(seed, n, start=0):
    x = np.arange(start, start + n, dtype=np.uint64) + np.uint64((seed << 32) & (2**64 - 1))
    z = x * testdata._GOLDEN + testdata._GOLDEN
    z = (z ^ (z >> np.uint64(30))) * testdata._M1
    z = (z ^ (z >> np.uint64(27))) * testdata._M2
    return z ^ (z >> np.uint64(31))


@pytest.mark.parametrize("segment", [1 << 20, 4099, 61])
def test_segmented_generators_equal_the_one_shot_ones(segment, monkeypatch):
    """Segments of 4099 and 61 counters cut the inputs (up to 1.1 MiB)
    into tens to thousands of segments, the end inside a segment; the
    bytes are the one-shot generator's."""
    monkeypatch.setattr(testdata, "_SEGMENT", segment)
    assert np.array_equal(testdata.splitmix64(5, 10_007, 123), _splitmix64_one_shot(5, 10_007, 123))
    sizes = (1, 7, 4096, 100_003) + ((1 << 20) + (3 << 15) + 17,) * (segment > 100)
    for n in sizes:
        for seed in (0, 2024):
            assert testdata.text_like(n, seed) == _text_like_one_shot(n, seed), (n, seed)
            assert testdata.mixed(n, seed) == _mixed_one_shot(n, seed), (n, seed)


def test_text_like_is_a_prefix_of_longer_text_like():
    """The bytes are the draws' tokens in counter order, so a shorter input
    is a prefix of a longer one (the 256 MiB bench cell is the first
    quarter of the 512 MiB CLI input)."""
    long = testdata.text_like(300_001, 2024)
    assert testdata.text_like(123_457, 2024) == long[:123_457]
    assert testdata.mixed(1 << 20, 3) == testdata.mixed((1 << 20) + 5000, 3)[: 1 << 20]


@pytest.mark.parametrize("n", [4096, 70_001, 300_000])
def test_prior_in_segments_equals_the_one_shot_histogram(n, monkeypatch):
    """The byte histogram (S4's plain version, ``torch.bincount``) summed over encode's lane chunks of 128 blocks of 256 bytes
    gives the prior of the one-shot ``np.bincount``."""
    data = testdata.mixed(n, 11)
    params = Parameters.tpu_wide()
    budget = min(api.DEFAULT_PRIOR_BUDGET, params.freq_max // 2)
    one_shot = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    want = quantize_prior(one_shot, params, budget)[:256]
    assert np.array_equal(cuda_checks._byte_histogram(_host_u8(data)).numpy(), one_shot)
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", 128 * 256)
    header, _ = container.parse_archive(api.encode(data, block_size=256, device="cpu"))
    assert np.array_equal(header.prior_extra, want)


def test_nine_lane_chunks_each_way(monkeypatch):
    """1,040 blocks of 256 bytes with the chunks at 128 blocks: nine encode
    launches (eight of 128, one of 16) and nine decode launches, one a
    range of 128 blocks over its coded blocks (the 40 raw blocks fall in
    every range); the archive equals the one-chunk archive and the
    reference's, and decode round-trips."""
    k = 256
    rng = np.random.default_rng(9)
    data = bytearray(testdata.text_like(1040 * k - 77, 9))  # the last block short
    for b in rng.choice(1040, 40, replace=False):  # raw blocks in most chunks
        data[b * k : b * k + k] = testdata.incompressible(k, int(b))
    data = bytes(data[: 1040 * k - 77])
    one_chunk = api.encode(data, block_size=k, device="cpu")

    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", 128 * k)
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", 128 * k)
    enc_calls, dec_calls = [], []
    real_enc, real_dec = api.encode_blocks_ranked, api.decode_blocks

    def counting_enc(syms, lens, *args):
        enc_calls.append(int(lens.shape[0]))
        return real_enc(syms, lens, *args)

    def counting_dec(words, lens, *args):
        dec_calls.append(int(lens.shape[0]))
        return real_dec(words, lens, *args)

    monkeypatch.setattr(api, "encode_blocks_ranked", counting_enc)
    monkeypatch.setattr(api, "decode_blocks", counting_dec)
    timings = {}
    nine = api.encode(data, block_size=k, device="cpu", _timings=timings)
    assert enc_calls == [128] * 8 + [16]
    assert {key.split(" ", 1)[0] for key in timings} == {"pass1", "pass2", "header"}
    assert nine == one_chunk == ref_api.encode(data, block_size=k)
    header, _ = container.parse_archive(nine)
    assert header.n_blocks == 1040 and 40 <= sum(header.block_raw) < 1040
    assert api._lane_chunk(api.ENC_CHUNK_BYTES, k) == api._lane_chunk(api.DEC_CHUNK_BYTES, k) == 128
    # The archive holds the streams one launch over a chunk writes (the
    # check of the card's at-size run; its own launches go uncounted here).
    chunks = cuda_checks.check_chunk_streams(data, nine, "cpu", [4, 8])
    assert [c[:2] for c in chunks] == [(512, 128), (1024, 16)]
    assert api.decode(nine, device="cpu") == data
    # A decode chunk is a range of blocks; its K3 takes the range's coded blocks.
    raw = np.asarray(header.block_raw)
    assert dec_calls == [int((~raw[s0 : s0 + 128]).sum()) for s0 in range(0, 1040, 128)]
    assert len(dec_calls) == 9 and dec_calls[-1] == 15
