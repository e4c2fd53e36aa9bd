"""The port's command line against the reference's: the same stdout bytes,
stderr lines and exit codes for the cases of ``tests/test_cli.py`` that need
no corpus.  Both CLIs run in-process (``main(argv)`` with stdin, stdout and
stderr swapped for buffers); the port with ``--device cpu``.  One test
runs ``python -m redux_tpu_torch.cli`` in a subprocess.  Inputs come from
``redux_tpu_torch.testdata``; every comparison is exact."""

import io
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

from redux_tpu import cli as ref_cli
from redux_tpu import oracle as ref_oracle

from redux_tpu_torch import cli
from redux_tpu_torch.testdata import incompressible, text_like

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(main, argv, stdin=b""):
    """``(exit code, stdout bytes, stderr text)`` of ``main(argv)``."""
    out, err = io.BytesIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "stdin", types.SimpleNamespace(buffer=io.BytesIO(stdin)))
        mp.setattr(sys, "stdout", types.SimpleNamespace(buffer=out))
        mp.setattr(sys, "stderr", err)
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(argv, stdin=b""):
    """The port's run (with ``--device cpu``) and the reference's, which must
    agree on every output."""
    mine = _run(cli.main, [*argv, "--device", "cpu"], stdin)
    ref = _run(ref_cli.main, argv, stdin)
    assert mine == ref, (mine[0], mine[2], ref[0], ref[2])
    return mine


def test_usage_exit_code_1():
    for argv in ([], ["-x"], ["-c", "-i"], ["-c", "-o"], ["-c", "--format", "zip"],
                 ["-c", "--block-size", "0"], ["-c", "--params", "8,30"], ["-i", "f"]):
        rc, out, err = _run(cli.main, argv)
        ref = _run(ref_cli.main, argv)
        assert rc == ref[0] == 1 and out == ref[1] == b""
        assert err == ref[2].rstrip("\n") + " [--device cuda|cpu]\n"
    for argv in (["-c", "--device", "gpu"], ["-c", "--device"]):
        assert _run(cli.main, argv)[0] == 1


def test_missing_input_file_exit_code_2(tmp_path):
    rc, _, err = _both(["-c", "-i", str(tmp_path / "nope.bin")])
    assert rc == 2 and err.startswith("Error while opening input file")
    rc, _, err = _both(["-c", "-o", str(tmp_path / "no" / "dir"), "--format", "redux"], b"x")
    assert rc == 2 and err.startswith("Error while opening output file")


def test_codec_error_exit_code_3():
    rc, _, err = _both(["-d"], b"\x01")
    assert rc == 3 and err == "Decompression error: Unexpected end of file\n"
    bad = bytearray(_run(cli.main, ["-c", "--block-size", "512", "--device", "cpu"],
                         text_like(1500, 24))[1])
    bad[-5] ^= 0xFF
    rc, _, err = _both(["-d"], bytes(bad))
    assert rc == 3 and err.startswith("Decompression error: Invalid data")


def test_stdin_stdout_roundtrip():
    data = b"stdin/stdout roundtrip data " * 40
    rc, arch, err = _both(["-c", "--block-size", "512"], data)
    assert rc == 0 and err.startswith("Compressed 1120 bytes into") and "ratio" in err
    rc, back, err = _both(["-d"], arch)
    assert rc == 0 and back == data and err.startswith("Decompressed 1120 bytes")


def test_file_roundtrip(tmp_path):
    src, comp, out = tmp_path / "in.bin", tmp_path / "c.rxt", tmp_path / "out.bin"
    data = text_like(2000, 25) + incompressible(600, 25)
    src.write_bytes(data)
    rc, _, err = _run(cli.main, ["-c", "-i", str(src), "-o", str(comp), "--block-size", "512",
                                 "--device", "cpu"])
    assert rc == 0 and err.startswith("Compressed 2600 bytes")
    ref_comp = tmp_path / "ref.rxt"
    assert _run(ref_cli.main, ["-c", "-i", str(src), "-o", str(ref_comp),
                               "--block-size", "512"])[2] == err
    assert comp.read_bytes() == ref_comp.read_bytes()
    rc, _, err = _run(cli.main, ["-d", "-i", str(comp), "-o", str(out), "--device", "cpu"])
    assert rc == 0 and out.read_bytes() == data


def test_reference_format_roundtrip():
    data = b"reference single-stream format" * 10
    rc, stream, _ = _both(["-c", "--format", "redux"], data)
    assert rc == 0 and stream == ref_oracle.compress_bytes(data)
    rc, back, _ = _both(["-d"], stream)
    assert rc == 0 and back == data
    rc, stream, _ = _both(["-c", "--format", "redux"], b"")
    assert rc == 0 and stream == ref_oracle.compress_bytes(b"")
    assert _both(["-d"], b"")[0] == 3  # an empty stream ends before its EOF symbol


def test_custom_params():
    data = b"custom parameter roundtrip" * 20
    rc, arch, _ = _both(["-c", "--params", "8,15,17", "--block-size", "512"], data)
    assert rc == 0
    rc, back, _ = _both(["-d"], arch)
    assert rc == 0 and back == data
    rc, _, err = _both(["-c", "--params", "8,9,16"], b"x")
    assert rc == 1 and err.startswith("Invalid parameters:")


def test_no_prior_flag():
    data = bytes(range(256)) * 24
    rc, arch, _ = _both(["-c", "--no-prior", "--block-size", "512"], data)
    assert rc == 0
    assert _both(["-d"], arch)[1] == data


def test_auto_format():
    """At the CLI's (8,30,32) the block archive candidates run at (8,30,32)
    and the compact ones at (8,20,22); the bare stream never competes."""
    data = text_like(4500, 26)
    rc, arch, _ = _both(["-c", "--format", "auto", "--block-size", "512"], data)
    assert rc == 0
    rc, back, _ = _both(["-d"], arch)
    assert rc == 0 and back == data


def test_cuda_without_a_card_exits_3(monkeypatch):
    """``--device cuda`` (the default) with no card exits 3 on the block
    archive's routes, with the RuntimeError's message; it does not run on
    the CPU instead.  The host-only routes run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = text_like(1200, 27)
    for argv in (["-c"], ["-c", "--format", "auto"], ["-c", "--device", "cuda"]):
        rc, out, err = _run(cli.main, argv, data)
        assert rc == 3 and out == b"" and err.startswith("Compression error: redux_tpu_torch:")
        assert "torch.cuda.is_available() is false" in err
    arch = _run(cli.main, ["-c", "--block-size", "512", "--device", "cpu"], data)[1]
    rc, _, err = _run(cli.main, ["-d"], arch)
    assert rc == 3 and err.startswith("Decompression error: redux_tpu_torch:")
    rc, stream, _ = _run(cli.main, ["-c", "--format", "redux"], data)
    assert rc == 0 and _run(cli.main, ["-d"], stream)[1] == data


def test_module_runs_without_jax(tmp_path):
    """``python -m redux_tpu_torch.cli --device cpu`` round-trips a file, and
    the process imports neither JAX nor the reference package."""
    src = tmp_path / "in.bin"
    data = text_like(3000, 28)
    src.write_bytes(data)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    imported = set()
    for argv in (["-c", "-i", str(src), "-o", str(tmp_path / "c"), "--block-size", "1024"],
                 ["-d", "-i", str(tmp_path / "c"), "-o", str(tmp_path / "out")]):
        r = subprocess.run([sys.executable, "-X", "importtime", "-m", "redux_tpu_torch.cli",
                            *argv, "--device", "cpu"], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stderr[-2000:]
        imported |= {line.rsplit("|", 1)[1].strip() for line in r.stderr.splitlines()
                     if line.startswith("import time:") and "|" in line}
    assert (tmp_path / "out").read_bytes() == data
    assert "redux_tpu_torch" in imported and "torch" in imported
    bad = sorted(m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "redux_tpu"))
    assert not bad, bad
