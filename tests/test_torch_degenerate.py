"""An input on which the v2 coder narrows to an empty interval.

At (8,20,22) with the uniform row and delta 255, the model's total freezes
at ``2**20 + 241``, above the least range after renormalisation
(``2**20 + 2``), so a byte of frequency 1 can narrow to nothing.
``scripts/degenerate_search.py`` found this input (seed 1): a
``text_like`` prefix past the freeze, three steering bytes, then byte 0,
which the block has not seen.  Every encoder codes the same bytes there
(the port's, the reference's XLA and Pallas paths, the oracle, the native
codec), and the archive does not decode: both packages raise
InvalidInputError on its crc32.  The port is held to the reference on it.
"""

import numpy as np
import pytest
import torch

from redux_tpu import api as ref_api
from redux_tpu import errors as ref_errors
from redux_tpu.params import Parameters as RefParameters

from redux_tpu_torch import api, native, oracle
from redux_tpu_torch.errors import InvalidInputError
from redux_tpu_torch.models.dense import DenseModel
from redux_tpu_torch.params import Parameters
from redux_tpu_torch.testdata import text_like

DELTA = 255
RECIPE = {"seed": 1, "prefix": 7186, "continuation": [111, 100, 116], "byte": 0}
KW = {"block_size": 8192, "delta": DELTA, "use_prior": False}


def _input() -> bytes:
    text = text_like(RECIPE["prefix"], RECIPE["seed"])
    return text + bytes(RECIPE["continuation"]) + bytes([RECIPE["byte"]])


class _Null:
    def write_bits(self, symbol, bits):
        pass


def test_the_interval_is_empty_at_the_last_byte():
    p = Parameters.tpu_wide()
    data = _input()
    model = DenseModel(p, None, DELTA)
    codec = oracle.Codec(model)
    for b in data[:-1]:
        codec.compress_symbol(b, _Null())
    total = model.total_frequency()
    assert total == p.freq_max + DELTA - (p.freq_max - 257) % DELTA == (1 << 20) + 241
    rng = codec.high - codec.low + 1
    lo, hi = int(model.cum[data[-1]]), int(model.cum[data[-1] + 1])
    assert hi - lo == 1 and data[-1] not in data[:-1]
    assert rng < total and rng * hi // total == rng * lo // total  # high = low - 1


def test_port_codes_the_reference_archive_and_neither_decodes_it():
    data = _input()
    mine = api.encode(data, params=Parameters.tpu_wide(), device="cpu", **KW)
    assert mine == ref_api.encode(data, params=RefParameters.tpu_wide(), **KW)
    with pytest.raises(InvalidInputError):
        api.decode(mine, device="cpu")
    with pytest.raises(ref_errors.InvalidInputError):
        ref_api.decode(mine)
    # The serial coders write the archive's stream, and it decodes to other bytes.
    p = Parameters.tpu_wide()
    block = oracle.compress_block(data, p, None, DELTA)
    assert block == native.compress_block_v2(data, p, None, DELTA)
    assert block in mine
    assert oracle.decompress_block(block, len(data), p, None, DELTA) != data


def test_the_plain_coder_follows_the_oracle_through_the_empty_interval():
    """K1 -> K2's plain versions give the oracle's stream byte for byte."""
    from redux_tpu_torch.ops.encode import encode_blocks_ranked

    p = Parameters.tpu_wide()
    data = _input()
    k = len(data)
    words, bl, ovf = encode_blocks_ranked(
        torch.from_numpy(np.frombuffer(data, np.uint8).copy()[None, :]),
        torch.tensor([k], dtype=torch.int32), torch.arange(258, dtype=torch.int32), p,
        k // 4 + 16, DELTA)
    stream = words[0].numpy().view(np.uint32).astype(">u4").tobytes()[: int(bl[0])]
    assert not bool(ovf[0]) and stream == oracle.compress_block(data, p, None, DELTA)
