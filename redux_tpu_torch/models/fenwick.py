"""Adaptive Fenwick-tree (binary indexed tree) frequency model.

Counterpart: ``redux_tpu/models/fenwick.py::AdaptiveFenwickModel`` (the
upstream production model ``AdaptiveTreeModel``,
``src/model/adaptive_tree.rs``), and the model of the reference CLI:

* ``symbol_count + 1`` nodes, 1-based, initially ``tree[i] = last_one(i)``
  (one count per symbol), the total cached in ``count``;
* ``get_frequency`` walks the shared tree path once for both bounds;
* ``get_symbol`` descends top-down from mask ``symbol_eof`` and rejects
  ``value >= high``;
* the update is a +1 walk from ``symbol + 1``, frozen at ``freq_max``.
"""

from __future__ import annotations

from typing import List, Tuple

from ..errors import InvalidInputError
from ..params import Parameters
from .base import Model


def _last_one(x: int) -> int:
    """Lowest set bit: ``10110100 -> 00000100``."""
    return x & (-x)


class AdaptiveFenwickModel(Model):
    """Fenwick cumulative-frequency model."""

    def __init__(self, params: Parameters):
        self.params = params
        n = params.symbol_count
        self.tree = [_last_one(i) for i in range(n + 1)]
        self.count = n

    def _get_frequency_single(self, symbol: int) -> int:
        i = symbol
        s = self.tree[0]
        while i > 0:
            s += self.tree[i]
            i -= _last_one(i)
        return s

    def _get_frequency_range(self, symbol: int) -> Tuple[int, int]:
        sumh = suml = 0
        h, low = symbol + 1, symbol
        while h != low:
            if h > low:
                sumh += self.tree[h]
                h -= _last_one(h)
            else:
                suml += self.tree[low]
                low -= _last_one(low)
        sumr = self._get_frequency_single(h)
        return (suml + sumr, sumh + sumr)

    def _update(self, symbol: int) -> None:
        if self.total_frequency() < self.params.freq_max:
            i = symbol
            while i <= self.params.symbol_count:
                self.tree[i] += 1
                i += _last_one(i)
            self.count += 1

    def total_frequency(self) -> int:
        return self.count

    def get_frequency(self, symbol: int) -> Tuple[int, int]:
        if symbol > self.params.symbol_eof:
            raise InvalidInputError()
        result = self._get_frequency_range(symbol)
        self._update(symbol + 1)
        return result

    def get_symbol(self, value: int) -> Tuple[int, int, int]:
        m = self.params.symbol_eof
        i = 0
        v = value
        while m > 0 and i < self.params.symbol_eof:
            ti = i + m
            tv = self.tree[ti]
            if v >= tv:
                i = ti
                v -= tv
            m >>= 1
        low, high = self._get_frequency_range(i)
        if value >= high:
            raise InvalidInputError()
        self._update(i + 1)
        return (i, low, high)

    def get_freq_table(self) -> List[Tuple[int, int]]:
        return [
            (self._get_frequency_single(i), self._get_frequency_single(i + 1))
            for i in range(self.params.symbol_count)
        ]
