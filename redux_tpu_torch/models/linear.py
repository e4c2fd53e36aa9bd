"""Adaptive linear (dense-array) frequency model.

Counterpart: ``redux_tpu/models/linear.py::AdaptiveLinearModel`` (the
upstream ``AdaptiveLinearModel``, ``src/model/adaptive_linear.rs``):

* ``freq`` holds ``symbol_count + 1`` cumulative frequencies, initially
  ``freq[i] = i`` (every symbol, EOF included, starts at frequency 1);
* ``get_frequency(symbol)`` returns ``(freq[sym], freq[sym+1])``, then
  updates; ``get_symbol(value)`` scans for the first ``i`` with
  ``value < freq[i+1]``, then updates;
* the update adds 1 to every entry above the symbol while
  ``total_frequency() < freq_max`` (the freeze).

Simple and slow on purpose: the oracle that the tree model and the dense
rows are held to.
"""

from __future__ import annotations

from typing import List, Tuple

from ..errors import InvalidInputError
from ..params import Parameters
from .base import Model


class AdaptiveLinearModel(Model):
    """Dense cumulative-frequency model."""

    def __init__(self, params: Parameters):
        self.params = params
        self.freq = list(range(params.symbol_count + 1))

    def _update(self, symbol: int) -> None:
        if self.total_frequency() < self.params.freq_max:
            for i in range(symbol + 1, len(self.freq)):
                self.freq[i] += 1

    def total_frequency(self) -> int:
        return self.freq[self.params.symbol_count]

    def get_frequency(self, symbol: int) -> Tuple[int, int]:
        if symbol > self.params.symbol_eof:
            raise InvalidInputError()
        res = (self.freq[symbol], self.freq[symbol + 1])
        self._update(symbol)
        return res

    def get_symbol(self, value: int) -> Tuple[int, int, int]:
        for i in range(len(self.freq) - 1):
            if value < self.freq[i + 1]:
                res = (i, self.freq[i], self.freq[i + 1])
                self._update(i)
                return res
        raise InvalidInputError()

    def get_freq_table(self) -> List[Tuple[int, int]]:
        return [
            (self.freq[i], self.freq[i + 1]) for i in range(self.params.symbol_count)
        ]
