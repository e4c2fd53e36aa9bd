"""Arithmetic-coding parameter set.

Counterpart: ``redux_tpu/params.py::Parameters`` (same validation, same
derived fields, same named configurations).  Everything derives from
``(symbol_bits, freq_bits, code_bits)``; valid sets satisfy::

    symbol >= 1  and  freq >= symbol + 2  and  code >= freq + 2
    and  code + freq <= 64
"""

from __future__ import annotations

import dataclasses

from .errors import InvalidInputError

DEFAULT_SYMBOL_BITS = 8
DEFAULT_FREQ_BITS = 30
DEFAULT_CODE_BITS = 32

TPU32_SYMBOL_BITS = 8
TPU32_FREQ_BITS = 15
TPU32_CODE_BITS = 17

TPUW_SYMBOL_BITS = 8
TPUW_FREQ_BITS = 20
TPUW_CODE_BITS = 22


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Validated arithmetic-coder parameters."""

    symbol_bits: int
    freq_bits: int
    code_bits: int

    symbol_eof: int = dataclasses.field(init=False)
    symbol_count: int = dataclasses.field(init=False)
    freq_max: int = dataclasses.field(init=False)
    code_min: int = dataclasses.field(init=False)
    code_one_fourth: int = dataclasses.field(init=False)
    code_half: int = dataclasses.field(init=False)
    code_three_fourths: int = dataclasses.field(init=False)
    code_max: int = dataclasses.field(init=False)

    def __post_init__(self) -> None:
        s, f, c = self.symbol_bits, self.freq_bits, self.code_bits
        if s < 1 or f < s + 2 or c < f + 2 or 64 < c + f:
            raise InvalidInputError()
        object.__setattr__(self, "symbol_eof", 1 << s)
        object.__setattr__(self, "symbol_count", (1 << s) + 1)
        object.__setattr__(self, "freq_max", (1 << f) - 1)
        object.__setattr__(self, "code_min", 0)
        object.__setattr__(self, "code_one_fourth", 1 << (c - 2))
        object.__setattr__(self, "code_half", 2 << (c - 2))
        object.__setattr__(self, "code_three_fourths", 3 << (c - 2))
        object.__setattr__(self, "code_max", (1 << c) - 1)

    @property
    def fits_u32(self) -> bool:
        """True when every coder product fits in 32 bits (``code + freq <= 32``)."""
        return self.code_bits + self.freq_bits <= 32

    @property
    def fits_wide32(self) -> bool:
        """True when the reference's dual-u32 path applies
        (``code_bits <= 23`` and ``code_bits + freq_bits <= 44``)."""
        return self.code_bits <= 23 and self.code_bits + self.freq_bits <= 44

    @classmethod
    def default(cls) -> "Parameters":
        """Reference CLI configuration ``(8, 30, 32)``."""
        return cls(DEFAULT_SYMBOL_BITS, DEFAULT_FREQ_BITS, DEFAULT_CODE_BITS)

    @classmethod
    def tpu32(cls) -> "Parameters":
        """32-bit configuration ``(8, 15, 17)``."""
        return cls(TPU32_SYMBOL_BITS, TPU32_FREQ_BITS, TPU32_CODE_BITS)

    @classmethod
    def tpu_wide(cls) -> "Parameters":
        """Production configuration ``(8, 20, 22)``."""
        return cls(TPUW_SYMBOL_BITS, TPUW_FREQ_BITS, TPUW_CODE_BITS)
