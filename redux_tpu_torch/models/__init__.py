"""Probability models of the PyTorch port (counterpart: ``redux_tpu/models``).

* :class:`~redux_tpu_torch.models.linear.AdaptiveLinearModel` — the dense
  array oracle;
* :class:`~redux_tpu_torch.models.fenwick.AdaptiveFenwickModel` — the
  tree model of the reference CLI;
* :mod:`~redux_tpu_torch.models.dense` — the per-block rows of the RXT
  format (initial rows, warm-start priors, :class:`DenseModel`).

All share the four methods of :class:`~redux_tpu_torch.models.base.Model`.
"""

from .base import Model
from .dense import DenseModel, prior_init_cum, uniform_init_cum
from .fenwick import AdaptiveFenwickModel
from .linear import AdaptiveLinearModel

__all__ = [
    "Model",
    "AdaptiveLinearModel",
    "AdaptiveFenwickModel",
    "DenseModel",
    "uniform_init_cum",
    "prior_init_cum",
]
