"""The port's serial codec layer against the reference's: bit I/O, the
linear, Fenwick and dense models, the sequential codec (oracle) and the
native C++ codec.  Inputs come from numpy seeds; every comparison is exact
(tolerance 0: byte and integer equality)."""

import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from redux_tpu import bitio as ref_bitio
from redux_tpu import errors as ref_errors
from redux_tpu import native as ref_native
from redux_tpu import oracle as ref_oracle
from redux_tpu.models import dense as ref_dense
from redux_tpu.models.fenwick import AdaptiveFenwickModel as RefFenwick
from redux_tpu.models.linear import AdaptiveLinearModel as RefLinear
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch import bitio, errors, native, oracle
from redux_tpu_torch.models import AdaptiveFenwickModel, AdaptiveLinearModel, DenseModel
from redux_tpu_torch.models.dense import prior_init_cum, uniform_init_cum
from redux_tpu_torch.ops.encode import encode_blocks_ranked
from redux_tpu_torch.ops.coder import max_block_words
from redux_tpu_torch.params import Parameters
from redux_tpu_torch.testdata import incompressible, text_like

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"


def _ref(p: Parameters) -> RefParameters:
    return RefParameters(p.symbol_bits, p.freq_bits, p.code_bits)


def _outcome(fn):
    """``("ok", value)`` or ``("raise", error class name)``."""
    try:
        return ("ok", fn())
    except (errors.ReduxError, ref_errors.ReduxError) as e:
        return ("raise", type(e).__name__)


# -- bit I/O ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bit_writer_and_reader_match_reference(seed):
    rng = np.random.default_rng(seed)
    widths = [int(w) for w in rng.integers(0, 65, 300)]
    values = [int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2)) >> (64 - w)
              if w else 0 for w in widths]
    bufs, writers = [io.BytesIO(), io.BytesIO()], []
    for mod, buf in zip((bitio, ref_bitio), bufs):
        w = mod.BitWriter(buf)
        counts = []
        for v, n in zip(values, widths):
            w.write_bits(v, n)
            counts.append(w.count)
        w.flush_bits()
        writers.append((buf.getvalue(), counts, w.count))
    assert writers[0] == writers[1]
    assert bitio.pack_bits(zip(values, widths)) == ref_bitio.pack_bits(zip(values, widths)) \
        == writers[0][0]
    stream = writers[0][0]
    readers = [mod.BitReader(io.BytesIO(stream)) for mod in (bitio, ref_bitio)]
    for v, n in zip(values, widths):
        got = [r.read_bits(n) for r in readers]
        assert got == [v, v]
        assert readers[0].count == readers[1].count
    # Past the end: the padding bits, then EOF in both.
    tail = [_outcome(lambda r=r: [r.read_bits(8) for _ in range(3)]) for r in readers]
    assert tail[0] == tail[1] == ("raise", "EofError")


def test_bit_io_errors_match_reference():
    cases = [
        lambda mod: mod.BitReader(io.BytesIO(b"\x01")).read_bits(65),      # width
        lambda mod: mod.BitReader(io.BytesIO(b"\x01")).read_bits(9),       # EOF
        lambda mod: mod.BitReader(io.BytesIO(b"")).read_bits(1),           # EOF at once
        lambda mod: mod.BitWriter(io.BytesIO()).write_bits(4, 2),          # too wide
        lambda mod: mod.BitWriter(io.BytesIO()).write_bits(1, 0),          # too wide for 0
        lambda mod: mod.BitWriter(io.BytesIO()).write_bits(0, 65),         # width
        lambda mod: mod.BitReader(io.BytesIO(b"\xff" * 9)).read_bits(64),  # 64 bits is legal
        lambda mod: mod.BitReader(io.BytesIO(b"\xff")).read_bits(0),       # 0 bits is legal
    ]
    for case in cases:
        assert _outcome(lambda: case(bitio)) == _outcome(lambda: case(ref_bitio))
    assert _outcome(lambda: cases[0](bitio)) == ("raise", "InvalidInputError")
    assert _outcome(lambda: cases[1](bitio)) == ("raise", "EofError")
    assert _outcome(lambda: cases[3](bitio)) == ("raise", "InvalidInputError")


# -- models -------------------------------------------------------------------

FREEZE = Parameters(8, 14, 16)  # freq_max 16383: the freeze after ~16126 updates


def _model_trace(model, ops):
    """Every result of a sequence of get_frequency / get_symbol calls (or the
    error class), and the totals along the way."""
    out = []
    for op, x in ops:
        fn = model.get_frequency if op == "f" else model.get_symbol
        out.append((_outcome(lambda: fn(x)), model.total_frequency()))
    out.append(model.get_freq_table())
    return out


def _ops(rng, n, top):
    syms = rng.integers(0, 257, n)
    kinds = rng.random(n) < 0.5
    ops = []
    for i in range(n):
        if kinds[i]:
            ops.append(("f", int(syms[i])))
        else:
            ops.append(("s", int(rng.integers(0, top + i + 1))))  # below the total
    ops += [("f", 257), ("f", 258), ("s", 10**9)]  # EOF, past EOF, past the total
    return ops


@pytest.mark.parametrize("kind", ["linear", "fenwick", "dense"])
def test_models_match_reference_across_the_freeze(kind):
    rng = np.random.default_rng(5)
    n = 17000  # crosses freq_max at (8, 14, 16)
    ops = _ops(rng, n, 257)
    rp = _ref(FREEZE)
    mine, ref = {
        "linear": (AdaptiveLinearModel(FREEZE), RefLinear(rp)),
        "fenwick": (AdaptiveFenwickModel(FREEZE), RefFenwick(rp)),
        "dense": (DenseModel(FREEZE), ref_dense.DenseModel(rp)),
    }[kind]
    got, exp = _model_trace(mine, ops), _model_trace(ref, ops)
    assert got == exp
    assert mine.total_frequency() == FREEZE.freq_max  # the freeze was reached


def test_dense_model_prior_and_delta_match_reference():
    rng = np.random.default_rng(6)
    p = Parameters.tpu_wide()
    rp = _ref(p)
    hist = np.bincount(np.frombuffer(text_like(50000, 6), np.uint8), minlength=256)
    extra = ref_dense.quantize_prior(hist, rp, 1 << 17)
    row = prior_init_cum(extra, p)
    ops = _ops(rng, 3000, int(row[-1]))
    got = _model_trace(DenseModel(p, row, 16), ops)
    exp = _model_trace(ref_dense.DenseModel(rp, ref_dense.prior_init_cum(extra, rp), 16), ops)
    assert got == exp
    # The same rejections: a wrong shape, no adaptation headroom, delta 0.
    for args in ((row[:-1], 1), (np.full_like(row, p.freq_max), 1), (row, 0)):
        assert _outcome(lambda: DenseModel(p, *args)) == ("raise", "InvalidInputError")
        with pytest.raises(ref_errors.InvalidInputError):
            ref_dense.DenseModel(rp, *args)


# -- the sequential codec -----------------------------------------------------


def _inputs():
    rng = np.random.default_rng(8)
    return [
        b"",
        b"a",
        bytes(rng.integers(0, 256, 700, dtype=np.uint8)),
        text_like(3000, 8),
        b"\x00" * 900 + b"\xff" * 300,
    ]


@pytest.mark.parametrize("cfg", [(8, 30, 32), (8, 14, 16), (8, 20, 22), (4, 10, 12)])
def test_oracle_streams_match_reference(cfg):
    p = Parameters(*cfg)
    rp = _ref(p)
    for data in _inputs():
        mine = oracle.compress_bytes(data, AdaptiveFenwickModel(p))
        assert mine == ref_oracle.compress_bytes(data, RefFenwick(rp))
        back = oracle.decompress_bytes(mine, AdaptiveLinearModel(p))
        assert back == ref_oracle.decompress_bytes(mine, RefLinear(rp))
        if p.symbol_bits == 8:
            assert back == data
    data = _inputs()[3]
    assert oracle.compress_bytes(data) == ref_oracle.compress_bytes(data)  # (8,30,32) default
    src, dst = io.BytesIO(data), io.BytesIO()
    counts = oracle.compress(src, dst)
    assert counts == ref_oracle.compress(io.BytesIO(data), io.BytesIO())
    assert oracle.decompress(io.BytesIO(dst.getvalue()), io.BytesIO()) == \
        ref_oracle.decompress(io.BytesIO(dst.getvalue()), io.BytesIO())


def test_oracle_errors_match_reference():
    good = oracle.compress_bytes(text_like(400, 9))
    for bad in (good[:3], good[: len(good) // 2], b"", b"\x01"):
        assert _outcome(lambda: oracle.decompress_bytes(bad)) == \
            _outcome(lambda: ref_oracle.decompress_bytes(bad))


@pytest.mark.parametrize("name", sorted(p.name for p in GOLDEN.glob("*.rdx")))
def test_oracle_decodes_the_golden_streams(name):
    """The committed reference-format streams (``tests/golden/*.rdx``, named
    by their parameters) decode to the reference oracle's bytes."""
    cfg = tuple(int(x) for x in name[:-4].split("_")[-3:])
    stream = (GOLDEN / name).read_bytes()
    mine = oracle.decompress_bytes(stream, AdaptiveFenwickModel(Parameters(*cfg)))
    assert mine == ref_oracle.decompress_bytes(stream, RefFenwick(RefParameters(*cfg)))
    assert len(mine) > 0
    assert oracle.compress_bytes(mine, AdaptiveFenwickModel(Parameters(*cfg))) == stream


def _block_case(name):
    p = Parameters.tpu_wide() if name != "8_30_32" else Parameters.default()
    data = text_like(2500, 10) + incompressible(300, 10)
    hist = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    extra = ref_dense.quantize_prior(hist, _ref(p), 1 << 17)
    row = prior_init_cum(extra, p) if name != "uniform" else uniform_init_cum(p)
    delta = {"uniform": 1, "prior_delta16": 16, "8_30_32": 7}[name]
    return data, p, row, delta


@pytest.mark.parametrize("name", ["uniform", "prior_delta16", "8_30_32"])
def test_compress_block_matches_reference_and_the_plain_kernels(name):
    data, p, row, delta = _block_case(name)
    mine = oracle.compress_block(data, p, row, delta)
    assert mine == ref_oracle.compress_block(data, _ref(p), row, delta)
    assert oracle.decompress_block(mine, len(data), p, row, delta) == data
    assert ref_oracle.decompress_block(mine, len(data), _ref(p), row, delta) == data
    # The plain K1 -> K2 versions code the same block to the same stream.
    k = len(data)
    n_words = max_block_words(int(row[-1]) + delta * k, p.symbol_count, p, k)
    words, bl, ovf = encode_blocks_ranked(
        torch.from_numpy(np.frombuffer(data, np.uint8).copy()[None, :]),
        torch.tensor([k], dtype=torch.int32), torch.from_numpy(row.astype(np.int32)), p,
        n_words, delta)
    assert not bool(ovf[0])
    stream = words[0].numpy().view(np.uint32).astype(">u4").tobytes()[: int(bl[0])]
    assert stream == mine


# -- the native codec ---------------------------------------------------------


@pytest.mark.parametrize("cfg", [(8, 30, 32), (8, 20, 22), (4, 10, 12)])
def test_native_entries_match_reference_and_oracle(cfg):
    p = Parameters(*cfg)
    rp = _ref(p)
    for data in _inputs():
        stream = native.compress_bytes(data, p)
        assert stream == ref_native.compress_bytes(data, rp)
        assert stream == oracle.compress_bytes(data, AdaptiveFenwickModel(p))
        assert native.decompress_bytes(stream, p) == ref_native.decompress_bytes(stream, rp)
        if p.symbol_bits == 8:
            assert native.decompress_bytes(stream, p) == data
            assert native.decompress_bytes(stream, p, nsyms=len(data)) == data
        if p.symbol_bits != 8:
            continue
        hist = np.bincount(np.frombuffer(data, np.uint8), minlength=256) if data else None
        extra = (None if hist is None or p.freq_bits < 20
                 else ref_dense.quantize_prior(hist, rp, 1 << 17)[:256])
        row = uniform_init_cum(p)
        if extra is not None:
            full = np.zeros(p.symbol_count, np.int64)
            full[:256] = extra
            row = prior_init_cum(full, p)
        for delta in (1, 16):
            block = native.compress_block_v2(data, p, extra, delta)
            assert block == ref_native.compress_block_v2(data, rp, extra, delta)
            assert block == oracle.compress_block(data, p, row, delta)
            assert native.decompress_block_v2(block, len(data), p, extra, delta) == data
            assert native.decompress_block_v2(block, len(data), p, extra, delta) == \
                ref_native.decompress_block_v2(block, len(data), rp, extra, delta)


def test_native_errors_match_reference():
    p, rp = Parameters.default(), RefParameters.default()
    good = native.compress_bytes(text_like(2000, 11), p)
    cases = [
        lambda mod, pp: mod.decompress_bytes(good[:5], pp),               # EOF
        lambda mod, pp: mod.decompress_bytes(good, pp, nsyms=5000),      # EOF before nsyms
        lambda mod, pp: mod.decompress_bytes(good, pp, max_out=10),       # output too big
        lambda mod, pp: mod.decompress_block_v2(b"\x00\x01", 3, pp),      # 8,30,32 ok
    ]
    for case in cases:
        assert _outcome(lambda: case(native, p)) == _outcome(lambda: case(ref_native, rp))


def test_native_library_lands_in_the_build_directory():
    lib = native.build()
    assert lib.parent == ROOT / "build" / "redux_tpu_torch"
    assert lib.name.startswith("libredux_native_") and lib.is_file()
    native.get_lib()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No compiler: the build raises NativeUnavailable (a RuntimeError), and
    the routes raise with it instead of falling back to the oracle."""
    from redux_tpu_torch import api

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeUnavailable, match="native build failed"):
        native.get_lib()
    assert issubclass(native.NativeUnavailable, RuntimeError)
    with pytest.raises(native.NativeUnavailable):
        api.encode_compact(b"abc", 4)
    with pytest.raises(native.NativeUnavailable):
        api.decode_auto(b"\x01\x02\x03", device="cpu")
    assert list(tmp_path.iterdir()) == []  # no partial library left behind


def test_concurrent_builds_both_succeed(tmp_path):
    """Two processes building into one empty directory at once both load a
    whole library and code with it."""
    code = (
        "import pathlib, sys; from redux_tpu_torch import native; "
        "native.BUILD_DIR = pathlib.Path(sys.argv[1]); "
        "out = native.compress_bytes(b'concurrent build ' * 50); "
        "assert native.decompress_bytes(out) == b'concurrent build ' * 50; print(len(out))"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se
    assert outs[0][0] == outs[1][0]
    libs = [f.name for f in tmp_path.iterdir()]
    assert len(libs) == 1 and libs[0].endswith(".so"), libs
