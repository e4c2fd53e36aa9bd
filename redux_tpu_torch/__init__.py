"""redux_tpu_torch — the RXT v2 block codec on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``redux_tpu`` (JAX on a TPU), which stays the reference: for the
same input and configuration this package emits the same archive bytes,
and each package decodes the other's archives.  It imports torch and
numpy, never JAX.

``encode(data)`` / ``decode(archive)`` run on the card by default
(``device="cuda"``): the kernels K1 model values, K2 coder, K3 decoder, or
K4, the fused model + coder, under ``encode(data, fused=True)`` (or
``REDUX_TPU_ENC_FUSED=1`` where ``fused`` is not given), and the
staging kernels around them (``ops.staging``: S1 row gather, S2 payload
splice, S3 crc32, S4 byte histogram): the data crosses the bus once each way (an input of
several lane chunks twice on its way in), and ``decode`` holds two ranges
of blocks' worth on the card whatever the input's size.  Without a CUDA
device they raise.  ``device="cpu"`` runs the kernels' plain PyTorch
versions, as the tests do; a list of devices shards the blocks over them
(``redux_tpu_torch.parallel``).  K5 (``ops.encode_m``) is the independent
model-in-kernel encoder, as in the reference.

``compress`` / ``decompress`` / ``compress_bytes`` / ``decompress_bytes``
are the reference's package-level stream API: the sequential codec of
:mod:`redux_tpu_torch.oracle` (reference-format streams, host code).
``api.encode_auto`` / ``decode_auto`` and the compact archive are the
other routes, and ``python -m redux_tpu_torch.cli`` the command line.
"""

from __future__ import annotations

import torch

from . import _build
from .api import decode, encode
from .errors import EofError, InvalidInputError, ReduxError, ReduxIOError
from .oracle import compress, compress_bytes, decompress, decompress_bytes
from .params import Parameters

__all__ = [
    "encode", "decode", "compress", "decompress", "compress_bytes", "decompress_bytes",
    "Parameters", "launch_counts", "reset_launch_counts",
    "ReduxError", "EofError", "InvalidInputError", "ReduxIOError",
]


_KERNEL_NAMES = ("model_values", "encode", "decode", "encode_fused", "encode_m", "gather_rows",
                 "splice_payload", "crc32", "histogram")


def launch_counts(device=None) -> dict:
    """Kernel launches since the last reset, by kernel: summed over every
    device, or on ``device`` alone (a CUDA device; no index is card 0)."""
    index = None if device is None else torch.device(device).index or 0
    return {k: sum(c for (name, i), c in _build.card_launches.items()
                   if name == k and index in (None, i)) for k in _KERNEL_NAMES}


def reset_launch_counts() -> None:
    _build.card_launches.clear()
