"""The whole slice on the CPU: ``redux_tpu_torch.api.encode`` emits the
reference's archive bytes, each package decodes the other's archives, and
corrupted archives raise InvalidInputError in both."""

import pytest
import torch

from redux_tpu import api as ref_api
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch import api
from redux_tpu_torch.errors import InvalidInputError
from redux_tpu_torch.params import Parameters
from redux_tpu_torch.testdata import incompressible, text_like


def _case(name):
    if name == "empty":
        return b"", {}
    if name == "small_no_prior":  # under 4096 bytes: no prior, one partial block
        return text_like(3000, 1), {}
    if name == "partial_last_block":
        return text_like(10000, 2), {"block_size": 2048}
    if name == "raw_blocks":  # incompressible blocks are stored raw
        return incompressible(3072, 3) + text_like(5000, 3), {"block_size": 1024}
    if name == "one_byte":
        return b"a" * 20000, {}
    if name == "delta1":
        return text_like(8192, 4), {"block_size": 1024, "delta": 1}
    if name == "delta255":
        return text_like(8192, 5), {"block_size": 1024, "delta": 255}
    if name == "tpu32":
        return incompressible(1024, 6) + text_like(7168, 6), {"block_size": 1024, "params": (8, 15, 17)}
    if name == "cli_default_8_30_32":  # the reference's int64 XLA path
        return text_like(5000, 9) + incompressible(1500, 9), {
            "block_size": 2048, "delta": 7, "params": (8, 30, 32)}
    if name == "tpu_wide_explicit_no_prior":
        return text_like(6000, 7), {"block_size": 1536, "params": (8, 20, 22), "use_prior": False}
    raise KeyError(name)


CASES = ["empty", "small_no_prior", "partial_last_block", "raw_blocks", "one_byte",
         "delta1", "delta255", "tpu32", "cli_default_8_30_32", "tpu_wide_explicit_no_prior"]


def _encode_both(name):
    data, kw = _case(name)
    mine_kw, ref_kw = dict(kw), dict(kw)
    if "params" in kw:
        mine_kw["params"] = Parameters(*kw["params"])
        ref_kw["params"] = RefParameters(*kw["params"])
    return data, api.encode(data, device="cpu", **mine_kw), ref_api.encode(data, **ref_kw)


@pytest.mark.parametrize("name", CASES)
def test_encode_bytes_equal_and_cross_decode(name):
    data, mine, ref = _encode_both(name)
    assert mine == ref
    assert api.decode(ref, device="cpu") == data
    assert ref_api.decode(mine) == data


def test_raw_blocks_are_stored_raw():
    from redux_tpu_torch import container

    data, mine, _ = _encode_both("raw_blocks")
    header, _ = container.parse_archive(mine)
    assert any(header.block_raw) and not all(header.block_raw)


def test_corrupt_and_truncated_archives_raise():
    data, kw = _case("partial_last_block")
    arch = ref_api.encode(data, **kw)
    flipped = bytearray(arch)
    flipped[-100] ^= 0x5A
    for bad in (bytes(flipped), arch[:-7], arch[:20]):
        with pytest.raises(InvalidInputError):
            api.decode(bad, device="cpu")
        with pytest.raises(ref_api.InvalidInputError):
            ref_api.decode(bad)


def test_matches_reference_pallas_branch(monkeypatch):
    """The reference's Pallas branch (interpret mode, single device) emits
    and reads the same archives as the port."""
    monkeypatch.setenv("REDUX_TPU_FORCE_PALLAS", "1")
    monkeypatch.setattr(ref_api, "_dp_mesh", lambda: None)
    data = text_like(4000, 8) + incompressible(2100, 8) + b"tail" * 300
    ref = ref_api.encode(data, block_size=2048)
    mine = api.encode(data, block_size=2048, device="cpu")
    assert mine == ref
    assert ref_api.decode(mine) == data
    assert api.decode(ref, device="cpu") == data


def test_auto_block_size_follows_reference_quantum():
    """The port's auto block size is the reference's at the reference's
    default decode quantum (1024 lanes x 1 phase)."""
    from redux_tpu.ops.pallas_decode import LANES, PHASES

    for n in (1 << 21, 9_700_000, 64 << 20, (64 << 20) + 12345, 1 << 30):
        assert api._auto_block_size(n, LANES * PHASES) == ref_api._auto_block_size(n)
    assert api._auto_block_size(64 << 20) == 4096
    assert -(-(64 << 20) // api._auto_block_size(64 << 20)) == 16384


def test_default_device_is_the_card(monkeypatch):
    """``encode(data)`` / ``decode(arch)`` with no ``device`` never run the
    plain versions: without CUDA they raise; with CUDA they launch the
    kernels and give the CPU path's bytes."""
    import redux_tpu_torch
    from redux_tpu_torch.ops import decode as dec_op
    from redux_tpu_torch.ops import model as model_op

    data = text_like(9000, 10) + incompressible(1500, 10)
    arch_cpu = api.encode(data, device="cpu", block_size=2048)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran without device='cpu'")

    monkeypatch.setattr(model_op, "model_lohi_plain", refuse)
    monkeypatch.setattr(dec_op, "decode_blocks_plain", refuse)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            redux_tpu_torch.encode(data, block_size=2048)
        with pytest.raises(RuntimeError, match="cuda"):
            redux_tpu_torch.decode(arch_cpu)
        return
    redux_tpu_torch.reset_launch_counts()
    arch = redux_tpu_torch.encode(data, block_size=2048)
    assert redux_tpu_torch.decode(arch) == data
    counts = redux_tpu_torch.launch_counts()
    assert counts["model_values"] > 0 and counts["decode"] > 0, counts
    assert arch == arch_cpu


def test_rejects_what_the_reference_rejects():
    with pytest.raises(InvalidInputError):
        api.encode(b"abc", params=Parameters(4, 10, 12))  # container is byte-only
    with pytest.raises(ref_api.InvalidInputError):
        ref_api.encode(b"abc", params=RefParameters(8, 30, 34))  # products past 62 bits
    with pytest.raises(InvalidInputError):
        api.encode(b"abc", params=Parameters(8, 30, 34))
