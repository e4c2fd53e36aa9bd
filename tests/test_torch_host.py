"""The PyTorch port's host modules against the reference package.

The port carries its own copies of the reference's host code (parameters,
model initial rows, the RXT v2 container, errors) because the reference
package imports JAX.  These tests hold the copies to the originals: same
fields, same arrays, same archive bytes, same errors.
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from redux_tpu import api as ref_api
from redux_tpu import container as ref_container
from redux_tpu import errors as ref_errors
from redux_tpu.models import dense as ref_dense
from redux_tpu.params import Parameters as RefParameters

import redux_tpu_torch
from redux_tpu_torch import container, convert, errors
from redux_tpu_torch.models import dense
from redux_tpu_torch.params import Parameters

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _params_or_error(cls, s, f, c):
    try:
        return dataclasses.asdict(cls(s, f, c))
    except Exception as e:  # noqa: BLE001 - the error class is compared
        return type(e).__name__


@pytest.mark.parametrize("s", [0, 1, 2, 8, 9])
def test_parameters_parity_grid(s):
    for f in range(0, 36, 3):
        for c in range(0, 66, 5):
            assert _params_or_error(Parameters, s, f, c) == _params_or_error(RefParameters, s, f, c)
            if isinstance(_params_or_error(Parameters, s, f, c), dict):
                p, r = Parameters(s, f, c), RefParameters(s, f, c)
                assert (p.fits_u32, p.fits_wide32) == (r.fits_u32, r.fits_wide32)


def test_named_configurations():
    for name in ("default", "tpu32", "tpu_wide"):
        assert dataclasses.asdict(getattr(Parameters, name)()) == dataclasses.asdict(
            getattr(RefParameters, name)()
        )


def test_errors_match_reference():
    pairs = [
        (errors.EofError(), ref_errors.EofError()),
        (errors.InvalidInputError(), ref_errors.InvalidInputError()),
        (errors.InvalidInputError("detail"), ref_errors.InvalidInputError("detail")),
        (errors.ReduxIOError("disk"), ref_errors.ReduxIOError("disk")),
    ]
    for mine, ref in pairs:
        assert str(mine) == str(ref)
        assert type(mine).__name__ == type(ref).__name__
    assert errors.EofError() == errors.EofError()
    assert errors.EofError() != errors.InvalidInputError()


@pytest.mark.parametrize("params", [Parameters.tpu_wide(), Parameters.tpu32(), Parameters(8, 14, 16)])
def test_dense_rows_match_reference(params):
    rp = RefParameters(params.symbol_bits, params.freq_bits, params.code_bits)
    np.testing.assert_array_equal(dense.uniform_init_cum(params), ref_dense.uniform_init_cum(rp))
    rng = np.random.default_rng(params.freq_bits)
    hists = [
        np.zeros(256, np.int64),
        rng.integers(0, 1000, 256),
        np.where(rng.random(256) < 0.1, rng.integers(0, 10**7, 256), 0),
        np.eye(256, dtype=np.int64)[65] * 123456,
    ]
    for hist in hists:
        for budget in (100, 1 << 12, 1 << 17, params.freq_max // 2):
            got = dense.quantize_prior(hist, params, budget)
            exp = ref_dense.quantize_prior(hist, rp, budget)
            np.testing.assert_array_equal(got, exp)
            np.testing.assert_array_equal(
                dense.prior_init_cum(got, params), ref_dense.prior_init_cum(exp, rp)
            )


def _archive_args(rng, with_prior, n_blocks=5, block_size=100):
    orig_len = block_size * (n_blocks - 1) + 37
    streams = [bytes(rng.integers(0, 256, rng.integers(0, 90), dtype=np.uint8))
               for _ in range(n_blocks)]
    raw = [bool(x) for x in rng.integers(0, 2, n_blocks)]
    prior = rng.integers(0, 0x10000, 256).astype(np.int64) if with_prior else None
    return streams, raw, prior, orig_len, block_size


@pytest.mark.parametrize("with_prior", [False, True])
def test_archive_bytes_and_parse_match_reference(with_prior):
    rng = np.random.default_rng(7 + with_prior)
    streams, raw, prior, orig_len, bs = _archive_args(rng, with_prior)
    p, rp = Parameters.tpu_wide(), RefParameters.tpu_wide()
    mine = container.build_archive(p, bs, orig_len, streams, prior, 16, 0xDEADBEEF, raw)
    ref = ref_container.build_archive(rp, bs, orig_len, streams, prior, 16, 0xDEADBEEF, raw)
    assert mine == ref
    joined = container.build_archive(
        p, bs, orig_len, [], prior, 16, 0xDEADBEEF, raw,
        payload=b"".join(streams), stream_lens=[len(s) for s in streams],
    )
    assert joined == ref
    h, got_streams = container.parse_archive(ref)
    rh, ref_streams = ref_container.parse_archive(ref)
    assert got_streams == ref_streams == streams
    for field in ("block_size", "orig_len", "block_byte_lens", "delta", "crc32",
                  "block_raw", "n_blocks", "block_lens"):
        assert getattr(h, field) == getattr(rh, field), field
    assert dataclasses.asdict(h.params) == dataclasses.asdict(rh.params)
    np.testing.assert_array_equal(h.stream_offs, rh.stream_offs)
    if with_prior:
        np.testing.assert_array_equal(h.prior_extra, rh.prior_extra)
    else:
        assert h.prior_extra is None and rh.prior_extra is None
    assert container.is_rxt_archive(ref) and not container.is_rxt_archive(b"RXT0")


def test_archive_rejections_match_reference():
    rng = np.random.default_rng(3)
    streams, raw, prior, orig_len, bs = _archive_args(rng, True)
    good = ref_container.build_archive(RefParameters.tpu_wide(), bs, orig_len, streams,
                                       prior, 16, 1, raw)
    bad = [
        good[:10],                       # shorter than the header
        b"RXT2" + good[4:],              # wrong magic
        good[:4] + b"\x03" + good[5:],   # wrong version
        good[:6] + b"\x07" + good[7:],   # symbol_bits 7
        good[:9] + b"\x00" + good[10:],  # delta 0
        good[:-1],                       # truncated payload
        good[:40],                       # truncated length table
    ]
    for arch in bad:
        with pytest.raises(ref_errors.InvalidInputError):
            ref_container.parse_archive(arch)
        with pytest.raises(errors.InvalidInputError):
            container.parse_archive(arch)
    for delta in (0, 256):
        with pytest.raises(errors.InvalidInputError):
            container.build_archive(Parameters.tpu_wide(), 4, 0, [], None, delta)


def test_crc_matches_reference():
    data = bytes(range(256)) * 7
    assert container.compute_crc(data) == ref_container.compute_crc(data)
    h, _ = container.parse_archive(
        container.build_archive(Parameters.tpu_wide(), 4096, 0, [], None, 16, container.compute_crc(b""))
    )
    container.verify_crc(h, b"")
    with pytest.raises(errors.InvalidInputError):
        container.verify_crc(h, b"x")


@pytest.mark.parametrize("use_prior", [False, True])
def test_convert_init_cum_matches_reference(use_prior):
    rp = RefParameters.tpu_wide()
    p = convert.params_from_reference(rp.symbol_bits, rp.freq_bits, rp.code_bits)
    assert dataclasses.asdict(p) == dataclasses.asdict(rp)
    prior = None
    if use_prior:
        hist = np.bincount(np.frombuffer(b"convert me " * 50, np.uint8), minlength=256)
        prior = ref_dense.quantize_prior(hist, rp, 1 << 17)[:256]
    ref_row = ref_api._init_cum(rp, prior)
    t = convert.init_cum_from_numpy(ref_row, p, "cpu")
    assert t.dtype == __import__("torch").int32
    np.testing.assert_array_equal(t.numpy(), ref_row)
    from redux_tpu_torch import api

    np.testing.assert_array_equal(api._init_cum(p, prior), ref_row)


def test_convert_rejects_bad_rows():
    p = Parameters.tpu_wide()
    row = np.arange(p.symbol_count + 1, dtype=np.int32)
    for bad in (row[:-1], row[::-1].copy(), row + 1, np.full_like(row, p.freq_max) * (row > 0),
                row.astype(np.float32)):
        with pytest.raises(errors.InvalidInputError):
            convert.init_cum_from_numpy(bad, p, "cpu")


def test_port_imports_neither_jax_nor_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|redux_tpu)(\.|\s|$)")
    for path in [*sorted((ROOT / "redux_tpu_torch").rglob("*.py")), ROOT / "chip_smoke.py"]:
        for no, line in enumerate(path.read_text().splitlines(), 1):
            assert not pattern.match(line), f"{path.name}:{no}: {line}"
    code = (
        "import sys; import redux_tpu_torch, redux_tpu_torch.parallel, redux_tpu_torch.ops.encode_m, "
        "redux_tpu_torch.cuda_checks, redux_tpu_torch.parallel.mesh; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'redux_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
    assert set(redux_tpu_torch.launch_counts()) == {
        "model_values", "encode", "decode", "encode_fused", "encode_m"}


def test_build_report_names_each_kernel(tmp_path, monkeypatch):
    """``_build.resource_usage`` turns ptxas's ``-v`` report of the build
    into one line a kernel entry, template argument included."""
    from redux_tpu_torch import _build

    lib = tmp_path / "libk.so"
    lib.with_suffix(".ptxas.txt").write_text(
        "== decode.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN41_GLOBAL__N__0ea6ff2b_9_decode_cu_8cfa941d13decode_kernelILb1EEEvPKjPKiS4_Ph' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 74 registers, used 0 barriers, 32896 bytes smem\n"
        "== model_values.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN48_GLOBAL__N__b73a3eb3_15_model_values_cu_b2ef55d719model_values_kernelEPKhPKi' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 0 barriers, 9216 bytes smem\n")
    monkeypatch.setattr(_build, "build", lambda: lib)
    assert _build.resource_usage() == [
        "decode.cu decode_kernel<true>: Used 74 registers, used 0 barriers, 32896 bytes smem; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "model_values.cu model_values_kernel: Used 32 registers, used 0 barriers, 9216 bytes "
        "smem; 0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
    ]
