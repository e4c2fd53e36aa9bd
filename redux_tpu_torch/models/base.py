"""The model interface between the sequential codec and a probability model.

Counterpart: ``redux_tpu/models/base.py::Model``, itself the upstream
library's ``Model`` trait (``src/model/mod.rs``).  The codec
(:mod:`redux_tpu_torch.oracle`) talks to a model only through these four
methods.
"""

from __future__ import annotations

import abc
from typing import List, Tuple

from ..params import Parameters


class Model(abc.ABC):
    """Probability model driving the arithmetic coder."""

    params: Parameters

    @abc.abstractmethod
    def total_frequency(self) -> int:
        """The current total of the cumulative frequencies."""

    @abc.abstractmethod
    def get_frequency(self, symbol: int) -> Tuple[int, int]:
        """Cumulative range ``(low, high)`` of ``symbol``; adapts."""

    @abc.abstractmethod
    def get_symbol(self, value: int) -> Tuple[int, int, int]:
        """Inverse lookup ``(symbol, low, high)`` of ``value``; adapts."""

    @abc.abstractmethod
    def get_freq_table(self) -> List[Tuple[int, int]]:
        """Every symbol's ``(low, high)``, for debugging."""
