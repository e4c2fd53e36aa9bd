"""Container fuzz of the port: a corrupted archive raises, never lies.

Counterpart: ``tests/test_fuzz_container.py``, the same pattern against
``redux_tpu_torch.api.decode`` on the CPU (the plain version of K3),
as ``cuda_checks.corruptions`` makes it: every truncation of the header
and a strided sweep of the payload, single bit flips (bits 0, 3 and 7)
in every header byte and at 120 random payload positions, random
garbage.  Each corrupted archive must
raise a ``ReduxError`` or give back the exact input.  The archive is
cut to 64-byte blocks (4.6 KB of input, a prior, raw blocks): the plain
decoder takes one step a position, so a CPU decode costs a sixty-fourth
of one at the reference test's 4 KiB blocks.
``chip_smoke.py`` phase 11 runs the same pattern through K3 on the card
on a 1 MiB archive.
"""

import struct

import numpy as np
import pytest

from redux_tpu_torch import api, container, cuda_checks
from redux_tpu_torch.errors import InvalidInputError, ReduxError
from redux_tpu_torch.testdata import text_like


@pytest.fixture(scope="module")
def archive():
    rng = np.random.default_rng(7)
    base = (b"the quick brown fox jumps over the lazy dog. " * 100)[:3600]
    noise = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    data = base + noise
    arc = api.encode(data, block_size=64, device="cpu")
    header, _ = container.parse_archive(arc)
    assert header.prior_extra is not None and any(header.block_raw) and not all(header.block_raw)
    return data, arc


def _outcomes(data, arc, kind):
    """Decode each archive of ``kind`` in the reference's pattern
    (``cuda_checks.corruptions``); "raised" for a ReduxError, "exact" for
    the input back, and a failure for anything else."""
    out = []
    for k, bad in cuda_checks.corruptions(arc):
        if k != kind:
            continue
        try:
            got = api.decode(bad, device="cpu")
        except ReduxError:
            out.append("raised")
        else:
            assert got == data, "corruption returned WRONG bytes without an error"
            out.append("exact")
    return out


def test_truncation_everywhere(archive):
    data, arc = archive
    outcomes = _outcomes(data, arc, "truncation")
    assert outcomes == ["raised"] * (64 + len(range(64, len(arc), 97)))


def test_single_bit_flips(archive):
    data, arc = archive
    outcomes = _outcomes(data, arc, "bit flip")
    assert len(outcomes) == 3 * (64 + 120)
    assert outcomes.count("raised") > len(outcomes) // 2


def test_random_garbage(archive):
    data, arc = archive
    assert _outcomes(data, arc, "garbage") == ["raised"] * 8


def test_stream_longer_than_the_decoder_row_raises(monkeypatch):
    """Block 0's stored length raised by the sum of the others and theirs
    set to 0: the payload still adds up, but block 0's stream is longer
    than the decoder's row (``n_words + 2`` words) can hold.  The port
    raises InvalidInputError before it sizes any array from it."""
    data = text_like(64 << 10, 0)
    arc = api.encode(data, device="cpu")
    header, _ = container.parse_archive(arc)
    lens = list(header.block_byte_lens)
    assert not any(header.block_raw) and len(lens) == 16
    n_words = api._static_words(header.params, header.block_size, header.delta)
    assert sum(lens) > 4 * (n_words + 2)
    buf = bytearray(arc)
    struct.pack_into(f"<{len(lens)}I", buf, container.HEADER_BYTES,
                     sum(lens), *[0] * (len(lens) - 1))
    launches = []
    real = api.decode_blocks
    monkeypatch.setattr(api, "decode_blocks", lambda *a: launches.append(1) or real(*a))
    with pytest.raises(InvalidInputError):
        api.decode(bytes(buf), device="cpu")
    assert launches == []
    # Block 0 at the row's bound itself, the rest spread over the other
    # blocks so that none passes it: the archive is staged and decoded
    # (and then fails its crc), so the check rejects only what cannot fit.
    cut = 4 * (n_words + 2)
    rest = np.diff(np.linspace(0, sum(lens) - cut, len(lens), dtype=np.int64))
    assert rest.max() <= cut and rest.sum() + cut == sum(lens)
    struct.pack_into(f"<{len(lens)}I", buf, container.HEADER_BYTES, cut, *rest.tolist())
    with pytest.raises(InvalidInputError):
        api.decode(bytes(buf), device="cpu")
    assert launches == [1]
