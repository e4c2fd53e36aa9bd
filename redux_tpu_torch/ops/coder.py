"""Word/byte helpers and shared integer arithmetic of the coder.

Counterpart: ``redux_tpu/ops/coder.py`` — ``max_block_words``
(:60-71), ``words_to_bytes_device`` and ``bytes_to_words_device``
(:888-911).  Words are u32 bit patterns held in int32 tensors; streams are
big-endian.

The plain (CPU) versions of the kernels compute in int64 with explicit
32-bit masks, because CPU torch lacks most uint32 arithmetic and has no
count-leading-zeros; :func:`bit_length` emulates it exactly for values
below 2**53.
"""

from __future__ import annotations

import math

import torch

from ..params import Parameters

M32 = 0xFFFFFFFF


def max_block_words(max_count: int, n_symbols: int, params: Parameters, k: int) -> int:
    """Upper bound (in u32 words) on one block's compressed size."""
    bps = max(1, math.ceil(math.log2(max(2, max_count)))) + 2
    total_bits = (k + 1) * bps + params.code_bits + 8
    return total_bits // 32 + 2


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 words -> (B, 4W) uint8, big-endian byte order."""
    b, w = words.shape
    le = words.contiguous().view(torch.uint8).view(b, w, 4)  # host order: little-endian
    return le.flip(-1).reshape(b, 4 * w)


def bytes_to_words(byts: torch.Tensor) -> torch.Tensor:
    """(B, 4W) uint8 -> (B, W) int32 words, big-endian byte order."""
    b, n = byts.shape
    return byts.view(b, n // 4, 4).flip(-1).contiguous().view(torch.int32).view(b, n // 4)


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    """Raise ValueError unless ``t`` has this dtype, shape (None = any) and
    device and is contiguous — what the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def kernel_device(device: torch.device) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def check_code_bits(params: Parameters) -> None:
    """The kernels keep the interval in 64 bits: ``code_bits <= 32`` and
    products ``range * count < 2**62`` (the reference's own limits)."""
    if params.code_bits > 32 or params.code_bits + params.freq_bits > 62:
        raise ValueError(
            "the coder supports code_bits <= 32 and code_bits + freq_bits <= 62"
        )


def tfreeze(init_total: int, params: Parameters, delta: int) -> int:
    """First position whose update is frozen: ``max(ceil((freq_max - init_total) / delta), 0)``."""
    return max(-(-(params.freq_max - init_total) // delta), 0)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit length of nonnegative int64 values below 2**53 (0 -> 0)."""
    return torch.frexp(x.double()).exponent.to(torch.int64)


def mask(n: torch.Tensor) -> torch.Tensor:
    """``2**n - 1`` for int64 n in [0, 62]."""
    return (torch.ones_like(n) << n) - 1


def renorm_plain(low, high, cb: int, active):
    """Closed-form E1/E2 + E3 renormalisation, vectorised over blocks.

    Returns ``(low, high, n1, n3)``; inactive blocks keep their interval
    and report ``n1 = n3 = 0``.
    """
    cmax = (1 << cb) - 1
    zero = torch.zeros_like(low)
    n1 = torch.where(active, cb - bit_length(low ^ high), zero).clamp(min=0)
    low1 = (low << n1) & cmax
    high1 = ((high << n1) | mask(n1)) & cmax
    a = 32 - bit_length(((low1 << (33 - cb)) & M32) ^ M32)
    b = 32 - bit_length((high1 << (33 - cb)) & M32)
    n3 = torch.where(active, torch.minimum(torch.minimum(a, b), torch.full_like(a, cb - 1)), zero)
    low2 = (low1 << n3) & (cmax >> 1)
    high2 = (((high1 << n3) | mask(n3)) & (cmax >> 1)) | (1 << (cb - 1))
    return torch.where(active, low2, low), torch.where(active, high2, high), n1, n3
