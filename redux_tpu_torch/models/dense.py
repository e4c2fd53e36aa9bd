"""Initial cumulative rows of the dense adaptive model (numpy).

Counterpart: ``redux_tpu/models/dense.py`` — ``uniform_init_cum``,
``quantize_prior`` and ``prior_init_cum``, the same arithmetic.  The
model state of one block is one cumulative row of ``symbol_count + 1``
entries; these functions build the row every block starts from.
"""

from __future__ import annotations

import numpy as np

from ..params import Parameters


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
