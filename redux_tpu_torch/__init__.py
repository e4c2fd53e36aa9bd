"""redux_tpu_torch — the RXT v2 block codec on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``redux_tpu`` (JAX on a TPU), which stays the reference: for the
same input and configuration this package emits the same archive bytes,
and each package decodes the other's archives.  It imports torch and
numpy, never JAX.

``encode(data)`` / ``decode(archive)`` run on the card by default
(``device="cuda"``): the kernels K1 model values, K2 coder, K3 decoder, or
K4, the fused model + coder, under ``REDUX_TPU_ENC_FUSED=1``, and the
staging kernels around them (``ops.staging``: S1 row gather, S2 payload
splice, S3 crc32): the data crosses the bus once each way (an input of
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

from .api import decode, encode
from .errors import EofError, InvalidInputError, ReduxError, ReduxIOError
from .oracle import compress, compress_bytes, decompress, decompress_bytes
from .ops import decode as _decode_op
from .ops import encode as _encode_op
from .ops import encode_m as _encode_m_op
from .ops import model as _model_op
from .ops import staging as _staging_op
from .params import Parameters

__all__ = [
    "encode", "decode", "compress", "decompress", "compress_bytes", "decompress_bytes",
    "Parameters", "launch_counts", "reset_launch_counts",
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
        "gather_rows": _staging_op.gather_launches,
        "splice_payload": _staging_op.splice_launches,
        "crc32": _staging_op.crc_launches,
    }


def reset_launch_counts() -> None:
    _model_op.launches = 0
    _encode_op.launches = 0
    _decode_op.launches = 0
    _encode_op.fused_launches = 0
    _encode_m_op.launches = 0
    _staging_op.gather_launches = 0
    _staging_op.splice_launches = 0
    _staging_op.crc_launches = 0
