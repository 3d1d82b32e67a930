"""LEB128 / varint codec for the raw-format uncompressed-length prefix.

JAX counterpart: snappy_tpu/formats/varint.py (a copy).

Spec parity: the raw snappy stream starts with the uncompressed length as a
little-endian base-128 varint of at most 5 bytes for a uint32
(nim-snappy snappy.nim:47-50 writes it via stew/leb128;
nim-snappy snappy/codec.nim:129-138 reads it).
"""

from __future__ import annotations

from typing import Optional, Tuple


def encode_uint32(value: int) -> bytes:
    """Encode ``value`` (0 <= value < 2**32) as a LEB128 varint."""
    if not 0 <= value <= 0xFFFF_FFFF:
        raise ValueError("varint value out of uint32 range")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_uint32(data) -> Tuple[Optional[int], int]:
    """Decode a LEB128 varint as uint32 from the head of ``data``.

    This is the *decode-path* rule: the reference's ``uncompress`` reads the
    length prefix as ``uint32.fromBytes(input, Leb128)``
    (nim-snappy snappy.nim:92), which rejects encodings longer than 5
    bytes and values above 2^32-1 — stricter than the 10-byte uint64 scanner
    ``uncompressedLen`` (codec.nim:129-138) used only for sizing.  All actual
    decoding (raw body, framed inner varints) must use this rule so accept /
    reject decisions are identical across host, device, and oracle backends.

    Returns ``(value, bytes_read)`` or ``(None, 0)``.
    """
    value = 0
    shift = 0
    for i in range(min(len(data), 5)):
        b = int(data[i])
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            if value >> 32:
                return None, 0  # overflows uint32
            return value, i + 1
        shift += 7
    return None, 0  # truncated, or longer than the 5-byte uint32 limit


def decode_uint64(data, max_bytes: int = 10) -> Tuple[Optional[int], int]:
    """Decode a LEB128 varint as uint64 from the head of ``data``.

    Returns ``(value, bytes_read)``; ``(None, 0)`` when the input is empty,
    truncated mid-varint, or the varint overflows 64 bits / uses more than
    ``max_bytes`` bytes.  A uint64 return mirrors ``uncompressedLen``
    (codec.nim:129-138), which reads up to 10 bytes; values above 2^32-1 are
    rejected later by the raw-format length check.
    """
    value = 0
    shift = 0
    for i in range(min(len(data), max_bytes)):
        b = int(data[i])  # accept numpy arrays without wrapping arithmetic
        if shift >= 64 or (shift == 63 and (b & 0x7F) > 1):
            return None, 0  # overflow
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            if value >> 64:
                return None, 0
            return value, i + 1
        shift += 7
    return None, 0  # truncated (or too long)
