"""The dense adaptive model of one block (numpy).

Counterpart: ``redux_tpu/models/dense.py`` — ``uniform_init_cum``,
``quantize_prior``, ``prior_init_cum`` and ``DenseModel``, the same
arithmetic.  The model state of one block is one cumulative row of
``symbol_count + 1`` entries; the functions build the row every block
starts from, and :class:`DenseModel` adapts it symbol by symbol for the
sequential codec (:func:`redux_tpu_torch.oracle.compress_block`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..errors import InvalidInputError
from ..params import Parameters
from .base import Model


def uniform_init_cum(params: Parameters) -> np.ndarray:
    """Uniform initial row ``init_cum[i] = i``, shape ``(symbol_count + 1,)`` int64."""
    return np.arange(params.symbol_count + 1, dtype=np.int64)


def quantize_prior(hist: np.ndarray, params: Parameters, budget: int) -> np.ndarray:
    """Quantize a byte histogram into per-symbol extra counts for warm start.

    Largest-remainder apportionment of ``budget - symbol_count`` counts over
    the histogram, each clamped to u16 (the archive stores them so).
    Returns ``(symbol_count,)`` int64.
    """
    n = params.symbol_count
    extra = np.zeros(n, dtype=np.int64)
    total = int(hist.sum())
    if total <= 0:
        return extra
    head = max(0, budget - n)
    if head <= 0:
        return extra
    ideal = hist.astype(np.float64) * head / total
    fl = np.floor(ideal).astype(np.int64)
    short = head - int(fl.sum())
    if short > 0:
        order = np.argsort(-(ideal - fl), kind="stable")[:short]
        fl[order] += 1
    extra[: hist.shape[0]] = np.minimum(fl, 0xFFFF)
    return extra


def prior_init_cum(extra: np.ndarray, params: Parameters) -> np.ndarray:
    """Initial row from warm-start counts: ``cum[i] = i + sum(extra[:i])``."""
    n = params.symbol_count
    cum = np.zeros(n + 1, dtype=np.int64)
    cum[1:] = np.cumsum(1 + extra)
    return cum


class DenseModel(Model):
    """The per-block model of the RXT v2 format: one cumulative row, an
    adaptation increment ``delta`` and the freeze at ``freq_max``.

    With the uniform row (``init_cum=None``) and ``delta=1`` it behaves
    as the linear and Fenwick models do; with a warm-start row it is the
    block model of an archive with a prior.
    """

    def __init__(
        self,
        params: Parameters,
        init_cum: np.ndarray | None = None,
        delta: int = 1,
    ):
        self.params = params
        if init_cum is None:
            init_cum = uniform_init_cum(params)
        if init_cum.shape != (params.symbol_count + 1,):
            raise InvalidInputError()
        if int(init_cum[-1]) >= params.freq_max:
            # A row so heavy that adaptation is frozen from the start.
            raise InvalidInputError()
        if delta < 1:
            raise InvalidInputError()
        self.delta = delta
        self.cum = init_cum.astype(np.int64).copy()
        self._iota = np.arange(params.symbol_count + 1, dtype=np.int64)

    def _update(self, symbol: int) -> None:
        if self.total_frequency() < self.params.freq_max:
            self.cum += self.delta * (self._iota > symbol)

    def total_frequency(self) -> int:
        return int(self.cum[self.params.symbol_count])

    def get_frequency(self, symbol: int) -> Tuple[int, int]:
        if symbol > self.params.symbol_eof:
            raise InvalidInputError()
        res = (int(self.cum[symbol]), int(self.cum[symbol + 1]))
        self._update(symbol)
        return res

    def get_symbol(self, value: int) -> Tuple[int, int, int]:
        # The first i with value < cum[i+1].
        if value >= self.total_frequency():
            raise InvalidInputError()
        i = int(np.sum(self.cum[1:] <= value))
        res = (i, int(self.cum[i]), int(self.cum[i + 1]))
        self._update(i)
        return res

    def get_freq_table(self) -> List[Tuple[int, int]]:
        return [
            (int(self.cum[i]), int(self.cum[i + 1]))
            for i in range(self.params.symbol_count)
        ]
