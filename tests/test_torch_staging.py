"""S1-S3, the staging kernels of the main path (``redux_tpu_torch/ops/staging.py``),
through their plain versions on the CPU: the row gather against a numpy
slice loop, the crc32 against ``zlib.crc32``, the payload splice against
the payload ``container.build_archive`` and the JAX package's
``api.encode`` write; and ``api.encode`` / ``decode`` over several lane
chunks against the JAX package, with raw blocks and a short last block.
Tolerance 0: the bar is byte equality.  The kernels themselves run in
``tests/test_torch_cuda.py`` (marked ``cuda``).
"""

import zlib

import numpy as np
import pytest
import torch

from redux_tpu import api as ref_api
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch import api, container, testdata
from redux_tpu_torch.errors import InvalidInputError
from redux_tpu_torch.ops import staging
from redux_tpu_torch.ops.coder import words_to_bytes
from redux_tpu_torch.ops.encode import encode_blocks_ranked
from redux_tpu_torch.params import Parameters

SEG = staging.CRC_SEGMENT


def _refuse(*args, **kwargs):
    raise AssertionError("a plain version ran on rows that should have been refused")


def _slice_loop(buf, offs, lens, nbytes):
    rows = np.zeros((len(offs), nbytes), dtype=np.uint8)
    for i, (o, n) in enumerate(zip(offs, lens)):
        rows[i, :n] = buf[o : o + n]
    return rows


@pytest.mark.parametrize("words", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_rows_equals_a_slice_loop(words, seed):
    """Random offsets and lengths, with zero-length rows and a row at the
    full width; in word mode the rows are big-endian u32 words."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, 20_000, dtype=np.uint8)
    width = 37
    nbytes = 4 * width if words else width
    b = 300
    lens = rng.integers(0, nbytes + 1, b)
    lens[:3] = [0, nbytes, 1]
    offs = rng.integers(0, buf.size - nbytes, b)
    offs[1] = buf.size - nbytes  # the full row ends at the buffer's end
    got = staging.gather_rows(torch.from_numpy(buf), torch.from_numpy(offs),
                              torch.from_numpy(lens), width, words=words)
    want = _slice_loop(buf, offs, lens, nbytes)
    if words:
        assert got.dtype == torch.int32 and got.shape == (b, width)
        want = want.reshape(b, width, 4)[:, :, ::-1].copy().view(np.int32).reshape(b, width)
    assert np.array_equal(got.numpy(), want)


def test_gather_rows_plain_in_steps(monkeypatch):
    """The plain version bounds its int64 index by row steps: with a
    64-byte budget each row is its own step, and the rows are the same."""
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.integers(0, 256, 4000, dtype=np.uint8))
    offs = torch.from_numpy(rng.integers(0, 3900, 50))
    lens = torch.from_numpy(rng.integers(0, 100, 50))
    whole = staging.gather_rows(buf, offs, lens, 25, words=True)
    monkeypatch.setattr(staging, "_ROW_BUDGET", 64)
    assert torch.equal(staging.gather_rows(buf, offs, lens, 25, words=True), whole)


@pytest.mark.parametrize("offs,lens,width", [
    ([10, 3990], [5, 11], 16),  # ends past the 4000-byte buffer
    ([-1], [4], 16),            # starts before it
    ([0, 5], [3, 17], 16),      # a row longer than its width
    ([0], [-2], 16),            # a negative length
])
def test_gather_rows_refuses_rows_outside_the_buffer(offs, lens, width, monkeypatch):
    monkeypatch.setattr(staging, "gather_rows_plain", _refuse)
    buf = torch.zeros(4000, dtype=torch.uint8)
    with pytest.raises(InvalidInputError):
        staging.gather_rows(buf, torch.tensor(offs), torch.tensor(lens), width)


def test_gather_rows_word_mode_takes_four_bytes_a_word():
    """In word mode a row holds ``4 * width`` bytes; one more is refused."""
    buf = torch.arange(64, dtype=torch.uint8)
    row = staging.gather_rows(buf, torch.tensor([0]), torch.tensor([8]), 2, words=True)
    assert row.tolist() == [[0x00010203, 0x04050607]]
    with pytest.raises(InvalidInputError):
        staging.gather_rows(buf, torch.tensor([0]), torch.tensor([9]), 2, words=True)


def test_wrappers_refuse_other_types():
    buf = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError):
        staging.gather_rows(buf.to(torch.int32), torch.tensor([0]), torch.tensor([1]), 4)
    with pytest.raises(ValueError):
        staging.gather_rows(buf, torch.tensor([0], dtype=torch.int32), torch.tensor([1]), 4)
    with pytest.raises(ValueError):
        staging.crc32(buf.view(4, 4))


@pytest.mark.parametrize("n", [0, 1, 2, 15, 16, 17, SEG - 1, SEG, SEG + 1, 2 * SEG,
                               5 * SEG + 3, 40 * SEG + 999])
def test_crc32_equals_zlib(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert staging.crc32(torch.from_numpy(data)) == zlib.crc32(data.tobytes())


def test_crc32_of_a_view_and_of_text():
    """A view that starts at an odd offset, and skewed text, equal zlib's."""
    text = testdata.text_like(300_001, 4)
    t = torch.frombuffer(bytearray(text), dtype=torch.uint8)
    assert staging.crc32(t) == zlib.crc32(text)
    assert staging.crc32(t[3:200_003]) == zlib.crc32(text[3:200_003])


@pytest.mark.parametrize("seed", range(4))
def test_combine_crcs_is_zlibs_combine(seed):
    """Pieces of random lengths (empty ones too): the XOR of each piece's
    CRC times x^(8 * bytes after it) is the CRC of the whole."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, int(rng.integers(0, 50_000)), dtype=np.uint8).tobytes()
    cuts = np.sort(rng.integers(0, len(data) + 1, int(rng.integers(1, 8))))
    bounds = [0, *cuts.tolist(), len(data)]
    pieces = [data[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    crcs = torch.tensor([zlib.crc32(p) for p in pieces], dtype=torch.int64)
    after = torch.tensor([len(data) - b for b in bounds[1:]], dtype=torch.int64)
    assert staging.combine_crcs(crcs, after) == zlib.crc32(data)


def test_pow8_table_squares_x8():
    """``x^(8 * 2^b) mod P``: x^8, x^16, then the reduction by P at x^32."""
    table = staging.pow8_table()
    assert table[:3] == (0x00800000, 0x00008000, staging.CRC_POLY)
    assert len(table) == 64


def _random_triple(rng, b, k, n_words):
    blocks = torch.from_numpy(rng.integers(0, 256, (b, k), dtype=np.uint8))
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (b, n_words))).to(torch.int32)
    lens = torch.from_numpy(rng.integers(1, k + 1, b)).to(torch.int32)
    byte_lens = torch.from_numpy(rng.integers(0, 4 * n_words + 1, b)).to(torch.int32)
    raw = torch.from_numpy(rng.integers(0, 2, b).astype(bool))
    return words, blocks, lens, byte_lens, raw


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splice_payload_equals_build_archives_payload(seed):
    """Raw and coded blocks mixed: the payload is what ``build_archive``
    writes from each block's stream (a coded block's first ``byte_lens``
    stream bytes, a raw block's first ``lens`` bytes)."""
    rng = np.random.default_rng(seed)
    words, blocks, lens, byte_lens, raw = _random_triple(rng, 40, 61, 9)
    wire = torch.where(raw, lens, byte_lens).to(torch.int64)
    got = staging.splice_payload(words, blocks, lens, byte_lens, raw,
                                 torch.cumsum(wire, 0) - wire, int(wire.sum()))
    coded = words_to_bytes(words).numpy()
    streams = [blocks[i, : lens[i]].numpy().tobytes() if raw[i]
               else coded[i, : byte_lens[i]].tobytes() for i in range(40)]
    arch = container.build_archive(Parameters.tpu_wide(), 61, int(lens.sum()), streams, None,
                                   16, 0, raw.tolist())
    assert got.numpy().tobytes() == arch[len(arch) - int(wire.sum()) :]


def test_splice_payload_equals_the_references_payload():
    """K1 -> K2 (plain versions) over blocks with raw ones and a short
    last block, the raw rule and S2: the payload of the JAX package's
    archive of the same input."""
    k = 512
    data = bytearray(testdata.text_like(40 * k - 100, 5))
    for b in (3, 17, 39):
        data[b * k : (b + 1) * k] = testdata.incompressible(k, b)
    data = bytes(data[: 40 * k - 100])
    ref = ref_api.encode(data, block_size=k)
    header, _ = container.parse_archive(ref, with_streams=False)
    p = Parameters.tpu_wide()
    lens = torch.from_numpy(api._block_lens(len(data), k))
    blocks = api._blocks(data, 0, 40, k, torch.device("cpu"))
    ic = torch.from_numpy(api._init_cum(p, header.prior_extra))
    n_words = api._encode_words(p, k, 16)
    words, bl, ovf = encode_blocks_ranked(blocks, lens, ic, p, n_words, 16)
    raw = ovf | (bl >= lens)
    assert raw.tolist() == list(header.block_raw) and raw.sum() >= 3
    wire = torch.where(raw, lens, bl).to(torch.int64)
    got = staging.splice_payload(words, blocks, lens, bl, raw, torch.cumsum(wire, 0) - wire,
                                 int(wire.sum()))
    assert got.numpy().tobytes() == ref[len(ref) - int(wire.sum()) :]


def test_splice_payload_refuses_a_stream_past_the_buffer(monkeypatch):
    """A coded block whose byte length passes K2's ``4 * n_words``-byte
    buffer raises (the encoder's bound is never passed silently); the same
    length on a raw block within ``k`` is fine."""
    rng = np.random.default_rng(7)
    words, blocks, lens, byte_lens, raw = _random_triple(rng, 4, 64, 4)
    raw[:] = torch.tensor([False, True, False, False])
    byte_lens[1] = 17
    lens[1] = 64
    wire = torch.where(raw, lens, byte_lens).to(torch.int64)
    offs = torch.cumsum(wire, 0) - wire
    assert staging.splice_payload(words, blocks, lens, byte_lens, raw, offs,
                                  int(wire.sum())).shape == (int(wire.sum()),)
    byte_lens[0] = 17
    wire = torch.where(raw, lens, byte_lens).to(torch.int64)
    monkeypatch.setattr(staging, "splice_payload_plain", _refuse)
    with pytest.raises(InvalidInputError):
        staging.splice_payload(words, blocks, lens, byte_lens, raw,
                               torch.cumsum(wire, 0) - wire, int(wire.sum()))
    with pytest.raises(InvalidInputError):  # a total too short for the offsets
        staging.splice_payload(words, blocks, lens, byte_lens, raw, offs, 3)


@pytest.mark.parametrize("params,delta,k", [(None, 16, 256), (Parameters.default(), 7, 512)])
def test_multi_chunk_encode_equals_the_reference(params, delta, k, monkeypatch):
    """Lane chunks of 128 blocks: 300 blocks with raw blocks in several
    chunks and a short last block encode to the JAX package's archive and
    one chunk's archive, and decode back (raw rows gathered chunk by
    chunk)."""
    rng = np.random.default_rng(k)
    n = 300 * k - 37
    data = bytearray(testdata.text_like(n, 12))
    for b in rng.choice(300, 25, replace=False):
        data[b * k : (b + 1) * k] = testdata.incompressible(k, int(b))
    data = bytes(data[:n])
    kw = {"block_size": k, "delta": delta}
    ref = ref_api.encode(data, params=None if params is None else RefParameters(
        params.symbol_bits, params.freq_bits, params.code_bits), **kw)
    one = api.encode(data, params=params, device="cpu", **kw)
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", 128 * k)
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", 128 * k)
    gathers = []
    real = api.gather_rows

    def counting(buf, offs, lens, width, words=False):
        gathers.append((int(offs.shape[0]), words))
        return real(buf, offs, lens, width, words)

    monkeypatch.setattr(api, "gather_rows", counting)
    timings = {}
    arch = api.encode(data, params=params, device="cpu", _timings=timings, **kw)
    assert arch == one == ref
    assert set(timings) == {"pass1", "pass2", "header"}
    header, _ = container.parse_archive(arch, with_streams=False)
    assert 25 <= sum(header.block_raw) < 300
    timings = {}
    assert api.decode(arch, device="cpu", _timings=timings) == data
    assert set(timings) == {"parse", "upload", "kernels", "crc+fetch"}
    assert [w for _, w in gathers] == [True, True, True, False]
    assert [b for b, w in gathers if w] == [128, 128, 44]


def test_offsets_past_the_archive_raise_before_any_gather(monkeypatch):
    """A header whose stream lengths pass the archive's end raises
    InvalidInputError before the decoder gathers a row."""
    data = testdata.mixed(20_000, 3)
    arch = bytearray(api.encode(data, block_size=4096, device="cpu"))
    monkeypatch.setattr(api, "gather_rows", _refuse)
    lens = np.frombuffer(bytes(arch[32 : 32 + 4 * 5]), "<u4").copy()
    lens[4] += 1  # the length bits (the raw bit stays)
    arch[32 : 32 + 20] = lens.astype("<u4").tobytes()
    with pytest.raises(InvalidInputError):
        api.decode(bytes(arch), device="cpu")
    with pytest.raises(InvalidInputError):  # the archive cut short
        api.decode(bytes(arch[:-1]), device="cpu")


def test_a_corrupted_payload_fails_the_crc():
    data = testdata.mixed(50_000, 8)
    arch = bytearray(api.encode(data, device="cpu"))
    arch[-100] ^= 0x10
    with pytest.raises(InvalidInputError):
        api.decode(bytes(arch), device="cpu")


def test_device_lists_stage_on_their_first_device():
    """A list of devices stages on its first; a list of CPU devices stays
    on the CPU and gives the one-device archive."""
    assert api._placement(["cpu", "cpu"]) == (torch.device("cpu"), [torch.device("cpu")] * 2)
    assert api._placement(["cpu"]) == (torch.device("cpu"), None)
    data = testdata.mixed(30_000, 2)
    arch = api.encode(data, block_size=1024, device=["cpu", "cpu", "cpu"])
    assert arch == api.encode(data, block_size=1024, device="cpu")
    assert api.decode(arch, device=["cpu", "cpu"]) == data


@pytest.mark.parametrize("n", [0, 1, 4095, 4096])
def test_small_inputs_equal_the_reference(n):
    """The empty input, one byte, and around the prior's threshold."""
    data = testdata.mixed(n, 1) if n else b""
    arch = api.encode(data, device="cpu")
    assert arch == ref_api.encode(data)
    assert api.decode(arch, device="cpu") == data
