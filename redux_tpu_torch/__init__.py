"""redux_tpu_torch — the RXT v2 block codec on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``redux_tpu`` (JAX on a TPU), which stays the reference: for the
same input and configuration this package emits the same archive bytes,
and each package decodes the other's archives.  It imports torch and
numpy, never JAX.

``encode(data)`` / ``decode(archive)`` run on the card by default
(``device="cuda"``): the kernels K1 model values, K2 coder, K3 decoder, or
K4, the fused model + coder, under ``REDUX_TPU_ENC_FUSED=1``.  Without a
CUDA device they raise.  ``device="cpu"`` runs the kernels' plain PyTorch
versions, as the tests do; a list of devices shards the blocks over them
(``redux_tpu_torch.parallel``).  K5 (``ops.encode_m``) is the independent
model-in-kernel encoder, as in the reference.
"""

from __future__ import annotations

from .api import decode, encode
from .errors import EofError, InvalidInputError, ReduxError, ReduxIOError
from .ops import decode as _decode_op
from .ops import encode as _encode_op
from .ops import encode_m as _encode_m_op
from .ops import model as _model_op
from .params import Parameters

__all__ = [
    "encode", "decode", "Parameters", "launch_counts", "reset_launch_counts",
    "ReduxError", "EofError", "InvalidInputError", "ReduxIOError",
]


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel."""
    return {
        "model_values": _model_op.launches,
        "encode": _encode_op.launches,
        "decode": _decode_op.launches,
        "encode_fused": _encode_op.fused_launches,
        "encode_m": _encode_m_op.launches,
    }


def reset_launch_counts() -> None:
    _model_op.launches = 0
    _encode_op.launches = 0
    _decode_op.launches = 0
    _encode_op.fused_launches = 0
    _encode_m_op.launches = 0
