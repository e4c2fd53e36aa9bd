"""Library-wide error types of the PyTorch port.

Counterpart: ``redux_tpu/errors.py`` (``ReduxError``, ``EofError``,
``InvalidInputError``, ``ReduxIOError``).  A copy rather than an import:
importing anything under ``redux_tpu`` imports JAX, which the port's
machines do not have.  Same classes, messages and class-only equality.
"""

from __future__ import annotations


class ReduxError(Exception):
    """Base class for all codec errors."""

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ReduxError) and type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self))


class EofError(ReduxError):
    """The input stream has ended unexpectedly."""

    def __str__(self) -> str:
        return "Unexpected end of file"


class InvalidInputError(ReduxError):
    """Invalid data or configuration on the input.

    ``detail`` (optional) appends context after the base message; equality
    stays class-only regardless of detail.
    """

    def __init__(self, detail: str | None = None):
        super().__init__(detail)
        self.detail = detail

    def __str__(self) -> str:
        base = "Invalid data found while processing input"
        return f"{base}: {self.detail}" if self.detail else base


class ReduxIOError(ReduxError):
    """An I/O error occurred."""

    def __init__(self, cause: Exception | str | None = None):
        super().__init__(cause)
        self.cause = cause

    def __str__(self) -> str:
        return f"I/O error: {self.cause}"
