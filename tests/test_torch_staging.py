"""S1-S4, the staging kernels of the main path (``redux_tpu_torch/ops/staging.py``),
through their plain versions on the CPU: the row gather against a numpy
slice loop, the crc32 against ``zlib.crc32``, the byte histogram (and the
kernel's algorithm, lane by lane) against ``np.bincount``, the payload splice against
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

from redux_tpu_torch import api, container, cuda_checks, testdata
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


@pytest.mark.parametrize("seed", range(6))
def test_host_check_refuses_the_rows_the_device_check_refused(seed):
    """The host's check (numpy, before anything goes up) refuses a set of
    rows exactly when the check the wrapper ran on the device refused it:
    ``(offs < 0) | (lens < 0) | (lens > cap) | (offs + lens > n)`` for any
    row.  Rows at the edges: an offset at the buffer's end, a length at the
    row's capacity, one past either."""
    rng = np.random.default_rng(seed)
    n, width = 700, 11
    buf = torch.zeros(n, dtype=torch.uint8)
    for words in (False, True):
        cap = 4 * width if words else width
        for _ in range(40):
            b = int(rng.integers(1, 6))
            offs = rng.integers(-2, n + 2, b)
            lens = rng.integers(-1, cap + 2, b)
            pick = rng.integers(0, 4)
            offs[0], lens[0] = [(n, 0), (n - cap, cap), (n - cap + 1, cap), (0, cap + 1)][pick]
            o, ln = torch.from_numpy(offs), torch.from_numpy(lens)
            device_check = bool(((o < 0) | (ln < 0) | (ln > cap) | (o + ln > n)).any())
            assert staging._rows_outside(offs, lens, cap, n) == device_check
            if device_check:
                with pytest.raises(InvalidInputError):
                    staging.gather_rows(buf, offs, lens, width, words)
            else:
                got = staging.gather_rows(buf, offs, lens, width, words)
                assert got.shape == (b, width)


def test_gather_rows_takes_host_arrays():
    """Numpy arrays and CPU tensors give the same rows; offsets on another
    device than the host's are refused (the wrapper checks them there)."""
    rng = np.random.default_rng(9)
    buf = torch.from_numpy(rng.integers(0, 256, 3000, dtype=np.uint8))
    offs, lens = rng.integers(0, 2900, 40), rng.integers(0, 60, 40)
    got = staging.gather_rows(buf, offs, lens, 15, words=True)
    assert torch.equal(got, staging.gather_rows(buf, torch.from_numpy(offs),
                                                torch.from_numpy(lens), 15, words=True))
    with pytest.raises(ValueError):
        staging.gather_rows(buf, torch.empty(40, dtype=torch.int64, device="meta"), lens, 15)
    with pytest.raises(ValueError):
        staging.gather_rows(buf, offs[None], lens, 15)


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


TILE = SEG * staging.CRC_THREADS


@pytest.mark.parametrize("n", [32 * SEG - 1, 32 * SEG, 32 * SEG + 1, TILE - 1, TILE, TILE + 1,
                               3 * TILE + SEG + 5])
def test_crc32_equals_zlib_at_warp_and_tile_edges(n):
    """Around a warp's 32 segments and a CTA's tile (512 segments)."""
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert staging.crc32(torch.from_numpy(data)) == zlib.crc32(data.tobytes())


@pytest.mark.parametrize("start", range(1, 16))
def test_crc32_of_views_1_to_15_bytes_in(start):
    data = np.random.default_rng(start).integers(0, 256, 3 * SEG + 40, dtype=np.uint8)
    t = torch.from_numpy(data)
    assert staging.crc32(t[start:]) == zlib.crc32(data[start:].tobytes())
    assert staging.crc32(t[start : start + SEG]) == zlib.crc32(data[start : start + SEG].tobytes())


def test_crc32_device_on_the_cpu_combines_to_zlib():
    """``crc32_device`` writes each piece's CRC into its slot of an int32
    tensor (no wait on a card; the plain version here); the slots, read as
    unsigned, combine to the whole's CRC as ``api`` combines its chunks."""
    data = np.random.default_rng(11).integers(0, 256, 10 * SEG + 77, dtype=np.uint8)
    bounds = [0, 1, SEG, 4 * SEG + 3, 10 * SEG + 77]
    slots = torch.zeros(len(bounds) - 1, dtype=torch.int32)
    t = torch.from_numpy(data)
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        assert staging.crc32_device(t[a:b], slots[i : i + 1]) is not None
    assert (slots < 0).any()  # a CRC past 2^31 reads as a negative int32
    after = torch.tensor([len(data) - b for b in bounds[1:]])
    assert staging.combine_crcs(slots.to(torch.int64) & 0xFFFFFFFF, after) == zlib.crc32(
        data.tobytes())
    one = staging.crc32_device(t)
    assert one.shape == (1,) and one.dtype == torch.int32
    assert int(one) & 0xFFFFFFFF == zlib.crc32(data.tobytes())
    with pytest.raises(ValueError):
        staging.crc32_device(t, torch.zeros(2, dtype=torch.int32))


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


def _mul(a: int, b: int) -> int:
    return int(staging._mulmod(a, torch.tensor([b], dtype=torch.int64))[0])


@pytest.mark.parametrize("seed", range(3))
def test_crc_shift_tables_multiply_as_mulmod(seed):
    """Each shift table of the kernel's constants (the gap between a lane's
    16-byte loads, 512 bytes apart; the gap from its last load of a tile to
    its first of the next; the tree's levels, x^(8 * 16 * 2^s) between
    lanes and x^(8 * 8 KiB * 2^s) between warps), read as four lookups,
    multiplies as ``_mulmod`` by its constant; the tree's constants are
    ``pow8_table``'s entries and x^(-8z) undoes x^(8z)."""
    consts = torch.from_numpy(staging.crc_consts().astype(np.int64))
    levels = staging.CRC_THREADS.bit_length() - 1
    tables = consts[1024 : 1024 * (3 + levels)].view(2 + levels, 4, 256)
    tile = staging.CRC_SEGMENT * staging.CRC_THREADS
    loads = staging.CRC_SEGMENT // 16
    mults = [staging.x8_power(496), staging.x8_power(tile - 512 * (loads - 1) - 16)]
    dists = [16 << s for s in range(5)] + [32 * staging.CRC_SEGMENT << s for s in range(levels - 5)]
    mults += [staging.x8_power(d) for d in dists]
    assert mults[2:] == [staging.pow8_table()[d.bit_length() - 1] for d in dists]
    v = torch.from_numpy(np.random.default_rng(seed).integers(0, 2**32, 500))
    for table, a in zip(tables, mults):
        assert torch.equal(staging.apply_shift(table, v), staging._mulmod(a, v))
    pow8 = consts[-80:-16].tolist()
    assert tuple(pow8) == staging.pow8_table()
    for z, inv in enumerate(consts[-16:].tolist()):
        assert _mul(inv, staging.x8_power(z)) == staging._ONE
    assert torch.equal(consts[:1024].view(4, 256), staging.slicing_tables())


@pytest.mark.parametrize("seed", range(4))
def test_crc_tree_combine_equals_combine_crcs(seed):
    """Random data in equal segments (a short last one zero-padded, the
    kernel's frame): their CRCs (register from 0) combined pairwise as a
    tree through the level tables, then moved back over the padding by
    x^(-8z), with the initial value's term, equal ``combine_crcs`` over the
    same segments and ``zlib.crc32``."""
    rng = np.random.default_rng(seed)
    seg, n_seg = 32, 16
    n = int(rng.integers(n_seg * seg - 15, n_seg * seg + 1))
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    z = n_seg * seg - n
    padded = data + bytes(z)
    raw = [zlib.crc32(padded[i * seg : (i + 1) * seg], 0xFFFFFFFF) ^ 0xFFFFFFFF
           for i in range(n_seg)]  # the register from 0: crc32 with init ~0 undone
    tables = [staging.shift_table(staging.x8_power(seg << s)) for s in range(4)]
    vals = torch.tensor(raw, dtype=torch.int64)
    for table in tables:
        vals = staging.apply_shift(table, vals[0::2]) ^ vals[1::2]
    f0 = _mul(staging.inv8_table()[z], int(vals[0]))
    crc = f0 ^ _mul(staging.x8_power(n), 0xFFFFFFFF) ^ 0xFFFFFFFF
    assert crc == zlib.crc32(data)
    pieces = [data[i : i + seg] for i in range(0, n, seg)]
    after = [max(n - i - seg, 0) for i in range(0, n, seg)]
    assert staging.combine_crcs(torch.tensor([zlib.crc32(p) for p in pieces]),
                                torch.tensor(after)) == crc


def _crc_kernel_model(data: bytes, align: int, segment: int, threads: int, ctas: int) -> int:
    """``csrc/staging.cu::crc32_kernel`` and its entry step for step, at a
    small segment and thread count, for ``data`` at an address ``align``
    bytes past 16: the frame of tiles ending at the input's end rounded up
    to 16, ``ceil(tiles / ctas)`` tiles a CTA, lane l of warp w reading
    bytes ``16 l + 512 j`` of the warp's run of a tile, its register over
    its loads with the gap tables between them, bytes outside the input as
    zero, the tree over the lanes and the warps, and each CTA's product by
    x^(8 after) (x^(-8z) for the last), CTA 0 adding the initial value's
    term."""
    consts = torch.from_numpy(staging.crc_consts(segment, threads).astype(np.int64))
    levels = threads.bit_length() - 1
    sl = consts[:1024].view(4, 256)
    gap, gap_tile = consts[1024:2048].view(4, 256), consts[2048:3072].view(4, 256)
    tree = consts[3072 : 3072 + 1024 * levels].view(levels, 4, 256)
    tile, run, n = segment * threads, 32 * segment, len(data)
    b = 1024 + align
    end16 = (b + n + 15) & ~15
    n_tiles = -(-(end16 - (b & ~15)) // tile)
    frame, z = end16 - b - n_tiles * tile, end16 - (b + n)
    per = -(-n_tiles // ctas)
    buf = torch.from_numpy(np.frombuffer(data, np.uint8).astype(np.int64))
    tid = torch.arange(threads)
    first = (tid // 32) * run + 16 * (tid % 32)  # each thread's first load in a tile
    crc = 0
    for cta in range(-(-n_tiles // per)):
        t0, t1 = cta * per, min(cta * per + per, n_tiles)
        r = torch.zeros(threads, dtype=torch.int64)
        for ti in range(t0, t1):
            r = staging.apply_shift(gap_tile, r)
            for j in range(segment // 16):
                if j:
                    r = staging.apply_shift(gap, r)
                for q in range(0, 16, 4):
                    pos = (frame + ti * tile + first + 512 * j + q)[:, None] + torch.arange(4)
                    ok = (pos >= 0) & (pos < n)
                    byte = torch.where(ok, buf[pos.clamp(0, max(n - 1, 0))] if n else 0, 0)
                    x = r ^ (byte[:, 0] | byte[:, 1] << 8 | byte[:, 2] << 16 | byte[:, 3] << 24)
                    r = (sl[3][x & 0xFF] ^ sl[2][(x >> 8) & 0xFF] ^ sl[1][(x >> 16) & 0xFF]
                         ^ sl[0][x >> 24])
        for s in range(levels):
            r = staging.apply_shift(tree[s], r[0::2]) ^ r[1::2]
        m = (staging.inv8_table()[z] if t1 == n_tiles
             else staging.x8_power((n_tiles - t1) * tile - z))
        crc ^= _mul(m, int(r[0]))
        if cta == 0:
            crc ^= _mul(staging.x8_power(n), 0xFFFFFFFF) ^ 0xFFFFFFFF
    return crc


@pytest.mark.parametrize("ctas", [1, 3])
@pytest.mark.parametrize("align", [0, 1, 9, 15])
def test_crc_kernel_algorithm_equals_zlib(align, ctas):
    """The kernel's algorithm (``_crc_kernel_model``: 64 threads reading 32
    bytes of a 2 KiB tile each) equals ``zlib.crc32`` at the load, warp,
    tile and multi-CTA edges, 0-15 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(align * 7 + ctas)
    for n in (1, 3, 4, 15, 16, 17, 511, 512, 513, 1023, 1024, 1025, 2047, 2048, 2049,
              3 * 2048 + 700):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert _crc_kernel_model(data, align, 32, 64, ctas) == zlib.crc32(data), n


def _byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's ``__byte_perm``: byte i of the result is byte ``sel`` nibble i
    of the pair (x bytes 0-3, y bytes 4-7)."""
    v = y << 32 | x
    return sum(((v >> 8 * (sel >> 4 * i & 7)) & 0xFF) << 8 * i for i in range(4))


def _byte_mask(lo: int, hi: int, word: int) -> int:
    a, b = min(max(lo - 4 * word, 0), 4), min(max(hi - 4 * word, 0), 4)
    return ((1 << 8 * b) - 1) & ~((1 << 8 * a) - 1)


def _gather_launch(b: int, rb: int, sms: int) -> tuple[int, int]:
    """``rxt_gather_rows``'s team of warps a row and its grid of 8-warp CTAs."""
    team = 1
    while team < 8 and b * team < 64 * sms and 2048 * team <= rb:
        team *= 2
    per_cta = 8 // team
    return team, min(-(-b // per_cta), 1 << 20)


def _gather_kernel_model(buf: np.ndarray, base: int, offs, lens, width: int, words: bool,
                         sms: int) -> np.ndarray:
    """``csrc/staging.cu::gather_rows_kernel`` and its entry step for step,
    thread by thread, for ``buf`` at address ``base``: the flat output of
    rows of ``rb`` bytes in 16-byte pieces, each owned by the row it starts
    in, lane l of a row's team taking pieces 16 l, 16 (l + 32 team), ...
    from the row's first 16-byte boundary; a piece's windows as at most two
    aligned 16-byte loads (asserted inside the buffer), realigned and (in
    word mode) byte-reversed by one ``__byte_perm`` a word and masked, or
    byte loads (asserted inside the buffer) where a load would leave it."""
    n, b = buf.size, len(offs)
    rb = 4 * width if words else width
    total = b * rb
    out = np.zeros(total + 16, dtype=np.uint8)
    end = base + n

    def chunk(c):  # an aligned 16-byte load, as four little-endian words
        assert c % 16 == 0 and base <= c and c + 16 <= end, "a load outside the buffer"
        return list(buf[c - base : c - base + 16].view("<u4").tolist())

    def window(at, lo, hi):
        p = base + at
        c0, sh = p & ~15, p & 15
        need_a, need_b = sh + lo < 16, sh + hi > 16
        if (not need_a or (c0 >= base and c0 + 16 <= end)) and (
                not need_b or (c0 + 16 >= base and c0 + 32 <= end)):
            w8 = (chunk(c0) if need_a else [0] * 4) + (chunk(c0 + 16) if need_b else [0] * 4)
            w = [w8[j + 2] if sh & 8 else w8[j] for j in range(6)]
            x = [w[j + 1] if sh & 4 else w[j] for j in range(5)]
            sel = (0x0123 if words else 0x3210) + 0x1111 * (sh & 3)
            o = [_byte_perm(x[j], x[j + 1], sel) for j in range(4)]
            if lo > 0 or hi < 16:
                for j in range(4):
                    m = _byte_mask(lo, hi, j)
                    o[j] &= _byte_perm(m, 0, 0x0123) if words else m
            return o
        w = [0] * 4
        for i in range(lo, hi):
            assert 0 <= at + i < n, "a byte outside the buffer"
            w[i >> 2] |= int(buf[at + i]) << 8 * (i & 3)
        return [_byte_perm(v, 0, 0x0123) for v in w] if words else w

    def row(r):
        o, ln = int(offs[r]), int(lens[r])
        return o, 0 if o < 0 or ln < 0 or o > n else min(ln, n - o, rb)

    team, grid = _gather_launch(b, rb, sms)
    teams = grid * 8 // team
    for cta in range(grid):
        for t in range(256):
            lane, warp = t & 31, (cta * 256 + t) >> 5
            first = 16 * ((warp % team) * 32 + lane)
            for r in range(warp // team, b, teams):
                r0, r1 = r * rb, r * rb + rb
                off, ln = row(r)
                for p in range(((r0 + 15) & ~15) + first, r1, 512 * team):
                    c, v = p - r0, [0] * 4
                    if c + 16 <= rb:
                        hi = min(16, ln - c)
                        if hi > 0:
                            v = window(off + c, 0, hi)
                    else:
                        j, cj = r, c
                        while j < b and cj > -16:
                            oj, lj = row(j)
                            lo, hi = max(0, -cj), min(16, lj - cj)
                            if hi > lo:
                                v = [a | w for a, w in zip(v, window(oj + cj, lo, hi))]
                            if rb - cj >= 16:
                                break
                            j, cj = j + 1, cj - rb
                    piece = np.array(v, dtype="<u4").view(np.uint8)
                    m = min(16, total - p)
                    out[p : p + m] = piece[:m]
    return out[:total].reshape(b, rb)


@pytest.mark.parametrize("words", [False, True])
@pytest.mark.parametrize("align", [0, 1, 7, 15])
def test_gather_kernel_algorithm_equals_a_slice_loop(words, align):
    """The kernel's algorithm (``_gather_kernel_model``) equals a numpy slice
    loop for a buffer at any alignment: offsets at every residue mod 16,
    rows ending at the buffer's last byte, widths that are not multiples of
    4 or 16 (rows under 16 bytes too), empty rows and full rows, one warp a
    row and teams of 2-8 warps; and it never reads outside the buffer."""
    rng = np.random.default_rng(align * 2 + words)
    for width, sms in ((3, 4), (37, 4), (13, 4), (300, 1), (1030, 1), (2100, 1), (4096, 2)):
        cap = 4 * width if words else width
        n = cap + 16 * 24 + int(rng.integers(0, 16))
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        offs = np.concatenate([16 * rng.integers(0, (n - cap) // 16, 16) + np.arange(16),
                               [n - cap, n - 1, n, 0]])
        lens = np.concatenate([rng.integers(0, cap + 1, 16), [cap, 1, 0, 0]])
        got = _gather_kernel_model(buf, 4096 + align, offs, lens, width, words, sms)
        want = _slice_loop(buf, offs, lens, cap)
        if words:
            want = want.reshape(len(offs), width, 4)[:, :, ::-1].reshape(len(offs), cap)
        assert np.array_equal(got, want), width


def test_gather_launch_teams():
    """One warp a row where the rows fill the SMs or are narrow; 2-8 warps a
    row for a few wide rows, each warp keeping 2 pieces a lane."""
    assert _gather_launch(16384, 1964, 132) == (1, 2048)
    assert _gather_launch(512, 4096, 132) == (4, 256)
    assert _gather_launch(100, 2100, 132) == (2, 25)
    assert _gather_launch(100, 16384, 132) == (8, 100)
    assert _gather_launch(3, 37, 132) == (1, 1)


def _bincount(data) -> np.ndarray:
    return np.bincount(np.frombuffer(bytes(data), np.uint8), minlength=256).astype(np.int64)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 4095, 4099])
def test_byte_histogram_equals_np_bincount(n):
    """S4's plain version into a zeroed row, from random bytes and from
    skewed text, against ``np.bincount``; the row is the one returned."""
    for data in (np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes(),
                 testdata.text_like(n, n + 1)):
        out = torch.zeros(256, dtype=torch.int64)
        got = staging.byte_histogram(torch.from_numpy(np.frombuffer(data, np.uint8).copy()), out)
        assert got is out and got.dtype == torch.int64 and got.shape == (256,)
        assert np.array_equal(got.numpy(), _bincount(data)), n


@pytest.mark.parametrize("start", range(1, 16))
def test_byte_histogram_of_views_1_to_15_bytes_in(start):
    data = np.random.default_rng(start).integers(0, 256, 3 * 4096 + 40, dtype=np.uint8)
    t = torch.from_numpy(data)
    for a, b in ((start, data.size), (start, start + 4096 + 17), (start, start + 1)):
        got = staging.byte_histogram(t[a:b], torch.zeros(256, dtype=torch.int64))
        assert np.array_equal(got.numpy(), _bincount(data[a:b])), (a, b)


def test_byte_histogram_adds_into_a_row_that_holds_counts():
    """Each call adds its counts to what the row holds, as pass 1 adds a
    share at a time; an empty tensor adds nothing."""
    data = testdata.mixed(70_001, 3)
    t = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    out = torch.arange(256, dtype=torch.int64) * 1000
    for a, b in ((0, 1), (1, 4096), (4096, 4096), (4096, 70_001)):
        staging.byte_histogram(t[a:b], out)
    assert np.array_equal(out.numpy(), np.arange(256) * 1000 + _bincount(data))
    assert np.array_equal(cuda_checks._byte_histogram(t).numpy(), _bincount(data))


@pytest.mark.parametrize("out", [
    torch.zeros(256, dtype=torch.int32),  # not int64
    torch.zeros(256, dtype=torch.float64),
    torch.zeros(255, dtype=torch.int64),  # not (256,)
    torch.zeros(257, dtype=torch.int64),
    torch.zeros(1, 256, dtype=torch.int64),
    torch.zeros(512, dtype=torch.int64)[::2],  # not contiguous
    np.zeros(256, dtype=np.int64),  # not a tensor
])
def test_byte_histogram_refuses_another_row(out):
    u8 = torch.arange(64, dtype=torch.uint8)
    with pytest.raises(InvalidInputError):
        staging.byte_histogram(u8, out)
    with pytest.raises(ValueError):
        staging.byte_histogram(u8.to(torch.int32), torch.zeros(256, dtype=torch.int64))


HIST_WARPS, HIST_LOADS, HIST_MIN_LOADS = 7, 8, 16  # csrc/staging.cu kHistWarps, kHistLoads, ...


def _histogram_launch(n: int, align: int, sms: int) -> tuple:
    """``rxt_byte_histogram``'s launch for ``n`` bytes whose first byte lies
    ``align`` bytes past a 16-byte boundary: (head bytes, 16-byte words,
    warps a CTA, CTAs)."""
    head = min((16 - align) % 16, n)
    m = (n - head) // 16
    warps_needed = -(-max(1, -(-m // HIST_MIN_LOADS)) // 32)
    warps = min(warps_needed, HIST_WARPS)
    return head, m, warps, min(-(-warps_needed // warps), sms)


def _histogram_kernel_model(data: bytes, align: int, sms: int) -> np.ndarray:
    """``byteHistogram_kernel``'s algorithm on the host, lane by lane, for
    ``data`` at ``align`` bytes past a 16-byte boundary on a card of
    ``sms`` SMs: each lane's column of 256 counts; its rounds of
    ``HIST_LOADS`` words a grid stride apart while a whole round lies in
    the words, then the rest one at a time; CTA 0's first warp's head and
    tail bytes, a byte a lane; each CTA's sum of a bin over its lanes from
    column ``(l + b) mod 32``, added into the row."""
    n = len(data)
    head, m, warps, grid = _histogram_launch(n, align, sms)
    u8 = np.frombuffer(data, np.uint8)
    words = u8[head : head + 16 * m].reshape(m, 16)
    threads = 32 * warps
    stride = grid * threads
    cols = np.zeros((grid, warps, 256, 32), dtype=np.uint32)  # [cta, warp, bin, lane]
    seen = np.zeros(m, dtype=np.int64)
    for cta in range(grid):
        for tid in range(threads):
            w, lane = divmod(tid, 32)
            i = cta * threads + tid
            reads = []
            while i + (HIST_LOADS - 1) * stride < m:
                reads += [i + j * stride for j in range(HIST_LOADS)]
                i += HIST_LOADS * stride
            reads += list(range(i, m, stride))
            for r in reads:
                seen[r] += 1
                np.add.at(cols[cta, w, :, lane], words[r], 1)
            if cta == 0 and tid < 32:
                tail = head + 16 * m
                if lane < head:
                    cols[cta, w, u8[lane], lane] += 1
                if lane < n - tail:
                    cols[cta, w, u8[tail + lane], lane] += 1
    assert (seen == 1).all()  # every word read once
    out = np.zeros(256, dtype=np.int64)
    for cta in range(grid):
        for b in range(256):
            out[b] += sum(int(cols[cta, w, b, (lane + b) % 32])
                          for w in range(warps) for lane in range(32))
    return out


def test_histogram_launch_follows_n():
    """One warp for a few bytes, only the warps the bytes fill for a small
    file, one CTA of 7 warps an SM for a share."""
    assert _histogram_launch(5, 3, 132) == (5, 0, 1, 1)
    assert _histogram_launch(21_504, 0, 132) == (0, 1344, 3, 1)
    assert _histogram_launch(768_771, 0, 132) == (0, 48048, 7, 14)
    assert _histogram_launch(256 << 20, 0, 132) == (0, 16 << 20, 7, 132)
    assert _histogram_launch(256 << 20, 5, 132) == (11, (16 << 20) - 1, 7, 132)


@pytest.mark.parametrize("align", [0, 1, 9, 15])
def test_histogram_kernel_algorithm_equals_np_bincount(align):
    """The kernel's algorithm (``_histogram_kernel_model``) equals
    ``np.bincount`` around the head and tail bytes, a warp's and a CTA's
    words and the grid's rounds, 0-15 bytes past a 16-byte boundary, one
    byte value included, on cards of 1 and 3 SMs."""
    rng = np.random.default_rng(align)
    for n, sms in ((1, 1), (15, 1), (16, 1), (17, 1), (31, 1), (40, 1), (16 * 16 * 32 - 1, 1),
                   (16 * 16 * 32 + 17, 1), (16 * 16 * 32 * 7 + 5, 3), (16 * 16 * 32 * 9, 1),
                   (16 * 16 * 32 * 7 * 3 * 3 + 333, 3)):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert np.array_equal(_histogram_kernel_model(data, align, sms), _bincount(data)), n
    run = b"\x61" * (16 * 16 * 32 * 8 + 9)
    assert np.array_equal(_histogram_kernel_model(run, align, 2), _bincount(run))


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
    wire = torch.where(raw, lens, byte_lens)
    got = staging.splice_payload(words, blocks, raw, wire)
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
    blocks = cuda_checks._blocks(data, 0, 40, k, torch.device("cpu"))
    ic = torch.from_numpy(api._init_cum(p, header.prior_extra))
    n_words = api._encode_words(p, k, 16)
    words, bl, ovf = encode_blocks_ranked(blocks, lens, ic, p, n_words, 16)
    raw = ovf | (bl >= lens)
    assert raw.tolist() == list(header.block_raw) and raw.sum() >= 3
    wire = torch.where(raw, lens, bl)
    got = staging.splice_payload(words, blocks, raw, wire)
    assert got.numpy().tobytes() == ref[len(ref) - int(wire.sum()) :]


def test_splice_payload_refuses_a_stream_past_the_buffer(monkeypatch):
    """A coded block whose byte length passes K2's ``4 * n_words``-byte
    buffer raises (the encoder's bound is never passed silently); the same
    length on a raw block within ``k`` is fine, one past ``k`` is not, and
    neither is a negative length."""
    rng = np.random.default_rng(7)
    words, blocks, lens, byte_lens, raw = _random_triple(rng, 4, 64, 4)
    raw[:] = torch.tensor([False, True, False, False])
    byte_lens[1] = 17
    lens[1] = 64
    wire = torch.where(raw, lens, byte_lens)
    assert staging.splice_payload(words, blocks, raw, wire).shape == (int(wire.sum()),)
    monkeypatch.setattr(staging, "splice_payload_plain", _refuse)
    for row, length in ((0, 17), (1, 65), (2, -1)):
        bad = wire.clone()
        bad[row] = length
        with pytest.raises(InvalidInputError):
            staging.splice_payload(words, blocks, raw, bad)


def test_splice_payload_short_rows_and_its_row_table():
    """Runs of rows of 0-3 bytes (a 16-byte piece of the payload spans
    several) equal a slice loop; ``splice_rows`` gives each row's end, the
    running sum of the lengths, and its raw flag; lengths on the card's
    side or of another type are refused (they are the host's)."""
    rng = np.random.default_rng(5)
    words, blocks, lens, byte_lens, raw = _random_triple(rng, 500, 8, 2)
    wire = torch.from_numpy(rng.integers(0, 4, 500).astype(np.int32))
    got = staging.splice_payload(words, blocks, raw, wire)
    coded = words_to_bytes(words).numpy()
    want = b"".join(blocks[i, : wire[i]].numpy().tobytes() if raw[i]
                    else coded[i, : wire[i]].tobytes() for i in range(500))
    assert got.numpy().tobytes() == want and got.shape[0] % 16
    ends, flags = staging.splice_rows(raw, wire, torch.device("cpu"))
    assert ends.dtype == torch.int64 and ends.tolist() == np.cumsum(wire.numpy()).tolist()
    assert torch.equal(flags, raw)
    for bad in (wire.to(torch.int64), wire.view(1, -1)):
        with pytest.raises(ValueError):
            staging.splice_payload(words, blocks, raw, bad)
    with pytest.raises(ValueError):
        staging.splice_payload(words, blocks, raw.to(torch.int32), wire)


@pytest.mark.parametrize("params,delta,k", [(None, 16, 256), (Parameters.default(), 7, 512)])
def test_multi_chunk_encode_equals_the_reference(params, delta, k, monkeypatch):
    """Lane chunks of 128 blocks: 300 blocks with raw blocks in several
    chunks and a short last block encode to the JAX package's archive and
    one chunk's archive, and decode back (a range of blocks at a time:
    its raw rows, then its coded blocks' words)."""
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
    assert {key.split(" ", 1)[0] for key in timings} == {"pass1", "pass2", "header"}
    header, _ = container.parse_archive(arch, with_streams=False)
    assert 25 <= sum(header.block_raw) < 300
    timings = {}
    assert api.decode(arch, device="cpu", _timings=timings) == data
    assert {key.split(" ", 1)[0] for key in timings} == {"parse", "upload", "kernels",
                                                         "crc+fetch"}
    # Each range of 128 blocks gathers its raw blocks' bytes, then its
    # coded blocks' words (K3's input).
    raw = np.asarray(header.block_raw)
    want = []
    for s0 in range(0, 300, 128):
        r = raw[s0 : s0 + 128]
        want += [(int(r.sum()), False)] * bool(r.any()) + [(int((~r).sum()), True)] * bool(
            (~r).any())
    assert gathers == want
    assert [w for _, w in gathers] == [False, True] * 3


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
    """A list of devices is each of its devices in order (each takes its
    own shares; a CUDA device without an index is card 0); a list of CPU
    devices stays on the CPU and gives the one-device archive."""
    assert api._cards(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert api._cards(["cpu"]) == api._cards("cpu") == [torch.device("cpu")]
    assert api._cards(["cuda", "cuda:1"]) == [torch.device("cuda", 0), torch.device("cuda", 1)]
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


def test_staging_checks_hold_the_histogram():
    """``cuda_checks.compare_staging`` holds S4 beside S1-S3 (the smoke's
    kernel table reads its entry); on the CPU its glue runs and every
    staging kernel is equal to its plain version."""
    from redux_tpu_torch import cuda_checks

    assert "histogram" in cuda_checks.STAGING
    res = cuda_checks.check_staging(torch.device("cpu"), n_blocks=16)
    for case in res.values():
        assert all(case[k]["max_abs_err"] == 0 for k in cuda_checks.STAGING)
        assert case["histogram"]["bytes"] == case["crc32"]["bytes"] - 4
        assert all(case[k]["library_ms"] is None for k in cuda_checks.STAGING)


def test_smoke_main_path_names_every_kernel_the_main_route_launches():
    """Every launch counter is a kernel of ``chip_smoke.MAIN_PATH`` or one
    that only the fused or sharded routes launch: the smoke's main route
    requires each counter on its path to move and each other to stay 0."""
    import importlib.util
    import pathlib

    import redux_tpu_torch

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    counters = set(redux_tpu_torch.launch_counts())
    assert set(smoke.MAIN_PATH) <= counters
    assert counters - set(smoke.MAIN_PATH) == {"encode_fused", "encode_m"}
