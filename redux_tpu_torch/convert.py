"""State carried across from the reference package.

The codec has no weights.  Its model state is the :class:`Parameters`
triple and the initial cumulative row every block starts from (what
``redux_tpu.api._init_cum`` returns: an int32 ``(symbol_count + 1,)``
array).  The archive bytes are the other state that crosses: both
packages decode each other's archives.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import InvalidInputError
from .params import Parameters


def params_from_reference(symbol_bits: int, freq_bits: int, code_bits: int) -> Parameters:
    """The port's :class:`Parameters` for the reference's ``(s, f, c)`` triple."""
    return Parameters(int(symbol_bits), int(freq_bits), int(code_bits))


def init_cum_from_numpy(init_cum: np.ndarray, params: Parameters,
                        device: torch.device | str) -> torch.Tensor:
    """The initial cumulative row as an int32 tensor on ``device``.

    Raises :class:`InvalidInputError` unless the row has shape
    ``(symbol_count + 1,)``, starts at 0, is nondecreasing, and leaves
    adaptation headroom (``init_cum[-1] < freq_max``).
    """
    row = np.asarray(init_cum)
    if row.shape != (params.symbol_count + 1,) or row.dtype.kind not in "iu":
        raise InvalidInputError("initial row must be (symbol_count + 1,) integers")
    row = row.astype(np.int64)
    if row[0] != 0 or (np.diff(row) < 0).any():
        raise InvalidInputError("initial row must start at 0 and be nondecreasing")
    if row[-1] >= params.freq_max:
        raise InvalidInputError("initial total must stay below freq_max")
    return torch.from_numpy(row.astype(np.int32)).to(device)
