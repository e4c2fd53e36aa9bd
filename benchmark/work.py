"""The table of peaks and the work each kernel class must do, counted
from the archive format, never from the program's intermediates.

A roofline share is the least time the card could take for the work
(the larger of its bytes over the memory's peak and its operations over
the integer peak) over the device time the class's kernels took, summed
over the cards.  Work a later design could fuse away (K1's lo/hi planes,
staged word matrices) is not counted, so fusing kernels reads the same
work in less time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# NVIDIA H100 SXM5 80GB: HBM3 bandwidth from the data sheet; int32 rate
# from the Hopper white paper's 64 INT32 lanes an SM a clock, 132 SMs,
# 1.98 GHz boost clock.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 64 * 132 * 1.98e9

# Integer operations a symbol: model lookup and update with the interval
# split and renormalisation (encode), the same with the symbol search
# (decode).
ENC_OPS_PER_SYMBOL = 42
DEC_OPS_PER_SYMBOL = 50

# Device op names (the profiler's, without parameters) of each class.
ENC_CODER = r"\b(model_values_kernel|encode_kernel|encode_fused_kernel)\b"
DEC_CODER = r"\bdecode_kernel\b"
ENC_STAGING = r"\b(splice_payload_kernel|crc32_kernel)\b|Histogram|bincount"
DEC_STAGING = r"\b(gather_rows_kernel|crc32_kernel)\b"


class ArchiveWork(NamedTuple):
    """What one archive's round trip must move, from its block table."""

    n: int  # input bytes, every one coded by the encoder
    payload: int  # payload bytes, coded streams and raw blocks
    coded_payload: int  # bytes of the coded streams
    coded_symbols: int  # symbols of the blocks stored coded (the decoder's)


def archive_work(archive: bytes) -> ArchiveWork:
    n, nb = int.from_bytes(archive[16:24], "little"), int.from_bytes(archive[24:28], "little")
    k = int.from_bytes(archive[12:16], "little")
    packed = np.frombuffer(archive, dtype="<u4", count=nb, offset=32).astype(np.int64)
    stored, raw = packed & ((1 << 31) - 1), packed >= 1 << 31
    lens = np.minimum(k, n - k * np.arange(nb, dtype=np.int64))
    return ArchiveWork(n, int(stored.sum()), int(stored[~raw].sum()), int(lens[~raw].sum()))


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT32_OPS_PER_S)


def enc_coder(w: ArchiveWork) -> float:
    """Every input symbol read and coded once, each coded word written once."""
    return least_seconds(w.n + w.coded_payload, ENC_OPS_PER_SYMBOL * w.n)


def dec_coder(w: ArchiveWork) -> float:
    """Each coded stream read once, each decoded symbol written once."""
    return least_seconds(w.coded_payload + w.coded_symbols, DEC_OPS_PER_SYMBOL * w.coded_symbols)


def enc_staging(w: ArchiveWork) -> float:
    """The input read once, the payload written once."""
    return least_seconds(w.n + w.payload, 0)


def dec_staging(w: ArchiveWork) -> float:
    """The payload read once, the output read once for its CRC."""
    return least_seconds(w.payload + w.n, 0)
