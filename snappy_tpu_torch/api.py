"""In-memory public API of the port: the raw and framed formats.

JAX counterpart: snappy_tpu/api.py: the raw calls ``encode``, ``decode``,
``encode_batch``, ``decode_batch``, ``compress_into``, ``uncompress_into``
and ``uncompressed_len``, the framed calls ``encode_framed``,
``decode_framed``, ``compress_framed_into`` and the resumable
``uncompress_framed_into``, the sizing helpers and the deprecated aliases
``compress`` and ``uncompress``.

Every call runs on the configured backend (config.py: ``device`` by
default, or ``host``, the native C runtime), and takes ``device``, which
matters only on the device backend (``cuda`` by default; ``cpu`` runs the
kernels' plain versions).  As in the JAX package, the host backend's
``uncompress_into``, ``compress_framed_into`` and
``uncompress_framed_into`` write straight into the caller's buffer.  The
``*_into`` functions are exception-free and return ``Result`` values with
the reference's typed enums (codec.nim:56-64);
the bytes-returning conveniences yield an empty result on any failure, as
the reference's seq-returning functions do (snappy.nim:112-128, 269-290).
The one exception: a read-only output buffer passed to an ``*_into``
function raises ``TypeError`` up front, as in the JAX package.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple, Union

import numpy as np

from . import config, engine
from .formats import constants as C
from .formats import framing, varint
from .formats.errors import CodecError, Err, FrameError, Ok, Result, raise_input_too_large
from .ops import host_codec

_FRAME_REASONS = {
    "invalid": FrameError.invalid_input,
    "crc": FrameError.crc_mismatch,
    "unknown_chunk": FrameError.unknown_chunk,
    "too_large": FrameError.invalid_input,
}


def _require_writable(out) -> None:
    if memoryview(out).readonly:
        raise TypeError(
            "output buffer is read-only; pass a bytearray or writable memoryview"
        )


def _host_view(out) -> Optional[np.ndarray]:
    """``out`` (writable: ``_require_writable`` passed) as a uint8 array
    where the configured backend is the host, else None (the engine
    path)."""
    return np.frombuffer(out, dtype=np.uint8) if config.resolve_backend() == "host" else None


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
    declared, read = varint.decode_uint32(bytes(data[:8]))
    if declared is None:
        return Err(CodecError.invalid_input)
    if declared > len(out):
        return Err(CodecError.buffer_too_small)
    out_arr = _host_view(out)
    if out_arr is not None:
        if not host_codec.decode_raw_body_into(memoryview(data)[read:], declared, out_arr):
            return Err(CodecError.invalid_input)
        return Ok(declared)
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


def compress_framed_into(
    data: bytes, out: Union[bytearray, memoryview], device: config.DeviceLike = None
) -> Result[int]:
    """Framed compress into a caller buffer (snappy.nim:130-155): the
    written length, or ``buffer_too_small`` when ``out`` is shorter than
    ``max_compressed_len_framed(len(data))``."""
    _require_writable(out)
    if len(out) < C.max_compressed_len_framed(len(data)):
        return Err(FrameError.buffer_too_small)
    out_arr = _host_view(out)
    if out_arr is not None:
        return Ok(host_codec.framed_compress_into(bytes(data), out_arr))
    enc = engine.framed_compress(bytes(data), device=device)
    out[: len(enc)] = enc
    return Ok(len(enc))


def _walk_chunk(
    data: bytes, read: int, room: int, check_integrity: bool, device: config.DeviceLike
) -> Tuple[str, int]:
    """The reference walk's step over the one chunk at ``read``
    (snappy.nim:199-265): ("take", its output length), ("stop", 0) where it
    does not fit ``room``, or (reason, 0).  The inner varint of a
    compressed chunk is the strict uint32 one, clamped to the chunk; an
    uncompressed chunk that is rejected or does not fit has its CRC checked
    first (snappy.nim:244-251), on ``device`` (K1)."""
    n = len(data)
    if n - read < 4:
        return "invalid", 0
    cid, data_len = framing.decode_frame_header(data[read : read + 4])
    if n - read - 4 < data_len:
        return "invalid", 0
    data_pos = read + 4
    if cid == C.CHUNK_COMPRESSED:
        if data_len < 4:
            return "invalid", 0
        inner, _ = varint.decode_uint32(data[data_pos + 4 : data_pos + 4 + min(5, data_len - 4)])
        if inner is None or inner > C.MAX_UNCOMPRESSED_FRAME_DATA_LEN:
            return "invalid", 0
        return ("stop", 0) if inner > room else ("take", inner)
    if cid == C.CHUNK_UNCOMPRESSED:
        if data_len < 4:
            return "invalid", 0
        inner = data_len - 4
        if inner > C.MAX_UNCOMPRESSED_FRAME_DATA_LEN or inner > room:
            if check_integrity:
                stored = int.from_bytes(data[data_pos : data_pos + 4], "little")
                payload = data[data_pos + 4 : data_pos + data_len]
                if engine.masked_crc32c(payload, device=device) != stored:
                    return "crc", 0
            return ("invalid", 0) if inner > C.MAX_UNCOMPRESSED_FRAME_DATA_LEN else ("stop", 0)
        return "take", inner
    if cid < C.CHUNK_RESERVED_SKIPPABLE_LO:
        return "unknown_chunk", 0
    return "take", 0  # skippable chunk (the 0xff stream identifier too)


def uncompress_framed_into(
    data: bytes,
    out: Union[bytearray, memoryview],
    check_header: bool = True,
    check_integrity: bool = True,
    device: config.DeviceLike = None,
) -> Result[Tuple[int, int]]:
    """Resumable framed decompression (snappy.nim:169-267).

    Decodes chunks into ``out`` until the input is exhausted or the next
    chunk would not fit, then returns ``Ok((read, written))``: ``read`` is
    the input offset of the first chunk not taken, ``written`` the bytes
    written into ``out``.  When ``read < len(data)`` the output filled up:
    the caller calls again with ``data[read:]``, a fresh buffer and
    ``check_header=False``.  ``check_integrity=False`` skips the CRCs.

    The walk keeps the reference's order (api.py:279-390): a chunk that
    does not fit stops it before its body is read, and a walk-time error
    is reported only after the chunks before it decoded cleanly (an
    earlier chunk's decode or CRC error wins).  It runs on the native
    header scan: the records of the valid chunks give the taken prefix by
    a cumulative sum over the budget, and only the chunk where the walk
    stops (the budget, or the first malformed chunk) takes the
    reference's per-chunk rules in Python.  On the host backend the whole
    walk and the decode are native (``host_codec.framed_resume_decode``),
    with the same results."""
    _require_writable(out)
    data = bytes(data)
    read = 0
    if check_header:
        if len(data) < len(C.FRAMING_HEADER) or not framing.is_snappy_framed_stream(data):
            return Err(FrameError.invalid_input)
        read = len(C.FRAMING_HEADER)
    budget = len(out)
    out_arr = _host_view(out)
    if out_arr is not None:
        r, w, reason = host_codec.framed_resume_decode(data, read, out_arr, budget, check_integrity)
        return Err(_FRAME_REASONS[reason]) if r is None else Ok((r, w))
    rec, whole = host_codec.scan_frames_prefix(data, read)
    ends = np.cumsum(rec[:, 3])
    k = int(np.searchsorted(ends, budget, side="right"))  # records 0..k-1 fit
    taken = [
        framing.ChunkInfo(int(cid), int(hp), int(hp) + 4, int(dl), int(u))
        for cid, hp, dl, u in rec[:k].tolist()
    ]
    written = int(ends[k - 1]) if k else 0
    if k:
        read = taken[-1].data_pos + taken[-1].data_len
    walk_err: Optional[str] = None
    if k < len(rec) or not whole:
        # The walk stops at this chunk: it does not fit, or it is the first
        # malformed one.  A chunk the scan refuses is one the walk refuses
        # too (its rules are stricter), so the step never takes it.
        verdict, _ = _walk_chunk(data, read, budget - written, check_integrity, device)
        if verdict not in ("stop", "take"):
            walk_err = verdict
    if taken:
        got, reason = engine.framed_uncompress_chunks_into(
            data, taken, np.frombuffer(out, dtype=np.uint8), check_integrity, device=device
        )
        if got is None:
            return Err(_FRAME_REASONS[reason])
    if walk_err is not None:
        return Err(_FRAME_REASONS[walk_err])
    return Ok((read, written))


def uncompressed_len_framed(data: bytes):
    """Total decoded size of a framed stream, or None when malformed
    (codec.nim:178-214)."""
    return framing.uncompressed_len_framed(data)


def is_framed_stream(data: bytes) -> bool:
    return framing.is_snappy_framed_stream(data)


# Deprecated aliases (the reference keeps equivalent deprecated seq-based
# templates, snappy.nim:292-297).


def compress(data: bytes, device: config.DeviceLike = None) -> bytes:
    """Deprecated alias of :func:`encode`."""
    warnings.warn("use snappy_tpu_torch.encode", DeprecationWarning, stacklevel=2)
    return encode(data, device=device)


def uncompress(data: bytes, device: config.DeviceLike = None) -> bytes:
    """Deprecated alias of :func:`decode`."""
    warnings.warn("use snappy_tpu_torch.decode", DeprecationWarning, stacklevel=2)
    return decode(data, device=device)
