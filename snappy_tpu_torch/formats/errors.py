"""Typed error model for the codec core.

JAX counterpart: snappy_tpu/formats/errors.py (a copy).

The core codec layers are exception-free and return ``Result`` values with
typed error enums; only the stream adapter layer converts them into
exceptions.  This mirrors the reference's layering invariant
(nim-snappy snappy/codec.nim:56-64 for the enums,
nim-snappy snappy/exceptions.nim for the stream-layer hierarchy).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Generic, TypeVar, Union

T = TypeVar("T")


class CodecError(enum.Enum):
    """Raw (block) format error codes (codec.nim:56-58)."""

    buffer_too_small = "buffer_too_small"
    invalid_input = "invalid_input"


class FrameError(enum.Enum):
    """Framed format error codes (codec.nim:60-64)."""

    buffer_too_small = "buffer_too_small"
    invalid_input = "invalid_input"
    crc_mismatch = "crc_mismatch"
    unknown_chunk = "unknown_chunk"


@dataclass(frozen=True)
class Ok(Generic[T]):
    value: T

    def is_ok(self) -> bool:
        return True

    def is_err(self) -> bool:
        return False

    def unwrap(self) -> T:
        return self.value

    @property
    def error(self):
        raise ValueError("Ok result has no error")


@dataclass(frozen=True)
class Err:
    error: Union[CodecError, FrameError]

    def is_ok(self) -> bool:
        return False

    def is_err(self) -> bool:
        return True

    def unwrap(self):
        raise SnappyDecodingError(f"unwrap of error result: {self.error}")


Result = Union[Ok[T], Err]


# Stream-layer exception hierarchy (exceptions.nim:3-15) -------------------


class SnappyError(Exception):
    """Base class for stream-layer snappy errors."""


class SnappyDecodingError(SnappyError):
    pass


class SnappyEncodingError(SnappyError):
    pass


class UnexpectedEofError(SnappyDecodingError):
    pass


class MalformedSnappyData(SnappyDecodingError):
    pass


class InputTooLarge(SnappyEncodingError):
    pass


def raise_input_too_large() -> None:
    raise InputTooLarge("input too large to be compressed (> 2^32-1 bytes)")
