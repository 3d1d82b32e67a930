"""In-memory public API of the port: the raw and framed formats.

JAX counterpart: snappy_tpu/api.py.  Ported: the raw calls ``encode``,
``decode``, ``encode_batch``, ``decode_batch``, ``compress_into``,
``uncompress_into`` and ``uncompressed_len`` (api.py:55-176), the framed
conveniences ``encode_framed`` and ``decode_framed`` (snappy.nim:157-167,
269-290) and the sizing helpers.  ``compress_framed_into`` and the
resumable ``uncompress_framed_into`` come with a later slice.

Every call takes ``device`` (``cuda`` by default; ``cpu`` runs the
kernels' plain versions).  The ``*_into`` functions are exception-free and
return ``Result`` values with the reference's typed enums (codec.nim:56-64);
the bytes-returning conveniences yield an empty result on any failure, as
the reference's seq-returning functions do (snappy.nim:112-128, 269-290).
The one exception: a read-only output buffer passed to an ``*_into``
function raises ``TypeError`` up front, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Union

from . import config, engine
from .formats import constants as C
from .formats import framing, varint
from .formats.errors import CodecError, Err, Ok, Result, raise_input_too_large


def _require_writable(out) -> None:
    if memoryview(out).readonly:
        raise TypeError(
            "output buffer is read-only; pass a bytearray or writable memoryview"
        )


# ---------------------------------------------------------------------------
# Raw format
# ---------------------------------------------------------------------------


def encode(data: bytes, level: int = 1, device: config.DeviceLike = None) -> bytes:
    """Compress ``data`` to the raw snappy format (snappy.nim:66-82).

    ``level``: 1 = the reference's greedy matcher, >= 2 = two-way hash
    buckets (denser); the bytes equal the JAX package's at each level.
    Raises :class:`InputTooLarge` for inputs over 2^32-1 bytes."""
    out = engine.raw_compress(bytes(data), level=level, device=device)
    if out is None:
        raise_input_too_large()
    return out


def compress_into(
    data: bytes, out: Union[bytearray, memoryview], device: config.DeviceLike = None
) -> Result[int]:
    """Compress into a caller buffer; returns the written length or
    ``buffer_too_small`` / ``invalid_input`` (snappy.nim:27-64)."""
    _require_writable(out)
    if len(data) > C.MAX_UNCOMPRESSED_LEN:
        return Err(CodecError.invalid_input)
    if len(out) < C.max_compressed_len(len(data)):
        return Err(CodecError.buffer_too_small)
    enc = engine.raw_compress(bytes(data), device=device)
    if enc is None:
        return Err(CodecError.invalid_input)
    out[: len(enc)] = enc
    return Ok(len(enc))


def decode(
    data: bytes, max_size: int = C.MAX_UNCOMPRESSED_LEN, device: config.DeviceLike = None
) -> bytes:
    """Decompress a raw snappy stream; ``b""`` on any failure, including
    outputs larger than ``max_size`` (snappy.nim:112-128)."""
    out, _reason = engine.raw_uncompress(bytes(data), max_size, device=device)
    return out if out is not None else b""


def encode_batch(datas, level: int = 1, device: config.DeviceLike = None) -> List[bytes]:
    """Compress many independent payloads with one encoder launch; one
    ``b""`` per oversized payload, and per payload the bytes of
    :func:`encode`."""
    res = engine.raw_compress_batch([bytes(d) for d in datas], level=level, device=device)
    return [enc if enc is not None else b"" for enc in res]


def decode_batch(
    datas, max_size: int = C.MAX_UNCOMPRESSED_LEN, device: config.DeviceLike = None
) -> List[bytes]:
    """Decompress many independent raw streams at once; one ``b""`` per
    failed stream (the :func:`decode` contract element-wise).  Streams of
    any size share the decoder's launches: large ones split at their
    64 KiB output-block boundaries by the native tag scan."""
    res = engine.raw_uncompress_batch([bytes(d) for d in datas], max_size, device=device)
    return [out if out is not None else b"" for out, _ in res]


def uncompress_into(
    data: bytes, out: Union[bytearray, memoryview], device: config.DeviceLike = None
) -> Result[int]:
    """Decompress into a caller buffer; the written length or a typed error
    (snappy.nim:84-110).  A declared length larger than ``out`` gives
    ``buffer_too_small``."""
    _require_writable(out)
    # The reference reads the uint32 varint first (snappy.nim:92-94): a
    # malformed one is invalid_input even where the buffer is too small.
    declared, _read = varint.decode_uint32(bytes(data[:8]))
    if declared is None:
        return Err(CodecError.invalid_input)
    if declared > len(out):
        return Err(CodecError.buffer_too_small)
    payload, _reason = engine.raw_uncompress(bytes(data), C.MAX_UNCOMPRESSED_LEN, device=device)
    if payload is None:
        return Err(CodecError.invalid_input)
    out[: len(payload)] = payload
    return Ok(len(payload))


def uncompressed_len(data: bytes):
    """Declared output size of a raw stream (codec.nim:129-138)."""
    return framing.uncompressed_len(data)


# ---------------------------------------------------------------------------
# Framed format
# ---------------------------------------------------------------------------


def encode_framed(data: bytes, level: int = 1, device: config.DeviceLike = None) -> bytes:
    """Compress to the framed format with per-chunk masked CRC32C
    (snappy.nim:157-167).  ``level`` as in :func:`encode`."""
    return engine.framed_compress(bytes(data), level=level, device=device)


def decode_framed(
    data: bytes,
    max_size: int = C.MAX_UNCOMPRESSED_LEN,
    check_integrity: bool = True,
    device: config.DeviceLike = None,
) -> bytes:
    """Decompress a framed stream; ``b""`` on any failure
    (snappy.nim:269-290)."""
    out, _reason = engine.framed_uncompress(
        bytes(data), max_size, check_integrity, device=device
    )
    return out if out is not None else b""


def uncompressed_len_framed(data: bytes):
    """Total decoded size of a framed stream, or None when malformed
    (codec.nim:178-214)."""
    return framing.uncompressed_len_framed(data)


def is_framed_stream(data: bytes) -> bool:
    return framing.is_snappy_framed_stream(data)
