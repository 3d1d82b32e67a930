"""Synchronous stream adapters over file-like objects.

JAX counterpart: snappy_tpu/streams/sync.py.  Role parity
with the reference's stream layer (faststreams.nim, streams.nim): chunked
compression of an input stream into an output stream, streaming framed
decompression with bounded memory, and the exception-based error model
(exceptions.nim): the codec core stays Result-based; only this layer
raises.

The raw format has no streaming decompressor, as in the reference: a raw
copy may reach the whole decoded history (faststreams.nim:60-62).

Each call reads 8 MiB windows (``batch_frames`` 64 KiB frames) and runs
each through the kernels in one batch.  64 KiB blocks are independent and
the windows align to them, so ``compress`` and ``compress_framed`` give the
bytes of the one-shot ``api.encode`` and ``api.encode_framed``.  Every
call runs on the configured backend (config.py), and takes ``device``,
which matters only on the device backend (``cuda`` by default; ``cpu``
runs the plain versions).  On the host backend a window decodes by
re-entering the native resumable walk (``host_codec.framed_resume_decode``)
into a bounded output buffer.
"""

from __future__ import annotations

import io
import threading
from typing import BinaryIO, Iterator

import numpy as np

from .. import config, engine
from ..formats import constants as C
from ..formats import framing, varint
from ..formats.errors import MalformedSnappyData, UnexpectedEofError, raise_input_too_large
from ..ops import host_codec

_DEFAULT_BATCH = 128  # frames per window: 8 MiB of payload
_WINDOW = 8 << 20  # compressed bytes read per decode window
_tls = threading.local()  # grow-only decode window buffers


def compress(
    src: BinaryIO,
    src_len: int,
    dst: BinaryIO,
    batch_frames: int = _DEFAULT_BATCH,
    level: int = 1,
    device: config.DeviceLike = None,
) -> int:
    """Raw-format compress of exactly ``src_len`` bytes of ``src`` to
    ``dst``; returns bytes written.  The raw format needs the length up
    front for its varint header (faststreams.nim:27)."""
    if src_len > C.MAX_UNCOMPRESSED_LEN:
        raise_input_too_large()
    header = varint.encode_uint32(src_len)
    dst.write(header)
    written = len(header)
    remaining = src_len
    while remaining > 0:
        want = min(remaining, C.MAX_BLOCK_LEN * batch_frames)
        buf = src.read(want)
        if len(buf) != want:
            raise UnexpectedEofError(f"input stream ended {remaining - len(buf)} bytes early")
        # one batch of this window's blocks; the window's own varint goes
        enc = engine.raw_compress(buf, level=level, device=device)
        _, read = varint.decode_uint64(enc)
        dst.write(enc[read:])
        written += len(enc) - read
        remaining -= len(buf)
    return written


def compress_framed(
    src: BinaryIO,
    dst: BinaryIO,
    batch_frames: int = _DEFAULT_BATCH,
    level: int = 1,
    device: config.DeviceLike = None,
) -> int:
    """Framed-format compress of a stream of any length
    (faststreams.nim:64-83); returns bytes written."""
    dst.write(C.FRAMING_HEADER)
    written = len(C.FRAMING_HEADER)
    while True:
        buf = src.read(C.MAX_UNCOMPRESSED_FRAME_DATA_LEN * batch_frames)
        if not buf:
            break
        enc = engine.framed_compress(buf, with_header=False, level=level, device=device)
        dst.write(enc)
        written += len(enc)
    return written


def whole_chunks(buf, avail: int) -> int:
    """Length of the longest run of whole chunks at the start of
    ``buf[:avail]``."""
    pos = 0
    while avail - pos >= 4:
        _, data_len = framing.decode_frame_header(buf[pos : pos + 4])
        if avail - pos < 4 + data_len:
            break
        pos += 4 + data_len
    return pos


def _out_buf(size: int) -> np.ndarray:
    """The thread's grow-only output buffer, of at least ``size`` bytes."""
    out_buf = getattr(_tls, "out", None)
    if out_buf is None or out_buf.size < size:
        out_buf = _tls.out = np.empty((max(size, 2 * _WINDOW),), dtype=np.uint8)
    return out_buf


def decode_window(blob, check_integrity: bool, device: config.DeviceLike) -> Iterator[memoryview]:
    """Decode ``blob`` (whole chunks) into the thread's output buffer,
    yielding the decoded bytes in order: the whole window at once on the
    device backend; on the host backend a piece per re-entry of the native
    resumable walk, which the buffer bounds (JAX sync.py:137-180).  Each
    piece is valid until the next.  Raises MalformedSnappyData."""
    if config.resolve_backend() == "host":
        out_buf = _out_buf(0)
        roff = 0
        while roff < len(blob):
            r, w, reason = host_codec.framed_resume_decode(
                blob, roff, out_buf, out_buf.size, check_integrity
            )
            if r is None or (r == roff and w == 0):
                raise MalformedSnappyData(f"framed decode failed ({reason})")
            yield memoryview(out_buf.data)[:w]
            roff = r
        return
    chunks = framing.scan_frames(blob)
    if chunks is None:
        reason = engine._scan_failure_reason(blob, 0)
        raise MalformedSnappyData(f"invalid framed chunk ({reason})")
    out_buf = _out_buf(sum(c.uncompressed_len for c in chunks))
    w, reason = engine.framed_uncompress_chunks_into(
        blob, chunks, out_buf, check_integrity, device=device
    )
    if w is None:
        raise MalformedSnappyData(f"framed decode failed ({reason})")
    yield memoryview(out_buf.data)[:w]


def uncompress_framed(
    src: BinaryIO,
    dst: BinaryIO,
    check_integrity: bool = True,
    device: config.DeviceLike = None,
) -> int:
    """Streaming framed decompress (faststreams.nim:89-147); returns bytes
    written.  Raises MalformedSnappyData or UnexpectedEofError on
    malformed input; memory stays bounded by the window."""
    magic = src.read(len(C.FRAMING_HEADER))
    if len(magic) < len(C.FRAMING_HEADER):
        raise UnexpectedEofError("stream shorter than the framing header")
    if not framing.is_snappy_framed_stream(magic):
        raise MalformedSnappyData("missing snappy framing header")

    # A persistent read buffer: the incomplete trailing chunk (< 64 KiB +
    # margin) moves to its head and the next read lands after it.  The
    # buffers are thread-local and grow-only, so back-to-back calls reuse
    # warm pages.
    rbuf = getattr(_tls, "rbuf", None)
    if rbuf is None:
        rbuf = _tls.rbuf = bytearray(_WINDOW + (1 << 17))
    rmv = memoryview(rbuf)
    written = 0
    tail_len = 0
    use_readinto = hasattr(src, "readinto")
    while True:
        n_read = -1
        if use_readinto:
            try:
                n_read = src.readinto(rmv[tail_len : tail_len + _WINDOW]) or 0
            except (NotImplementedError, OSError):
                use_readinto = False  # file-likes that only implement read
        if n_read < 0:
            data = src.read(_WINDOW)
            n_read = len(data)
            rmv[tail_len : tail_len + n_read] = data
        avail = tail_len + n_read
        at_eof = n_read == 0
        pos = whole_chunks(rmv, avail)
        if pos:
            for decoded in decode_window(rmv[:pos], check_integrity, device):
                dst.write(decoded)
                written += len(decoded)
        tail_len = avail - pos
        if pos and tail_len:
            # bytes() detour: the regions may overlap
            rmv[:tail_len] = bytes(rmv[pos:avail])
        if at_eof:
            if tail_len:
                raise UnexpectedEofError(f"{tail_len} trailing bytes are not a whole chunk")
            return written


# The openArray-style overloads (faststreams.nim:56-58, 85-87)


def compress_bytes(data: bytes, device: config.DeviceLike = None) -> bytes:
    out = io.BytesIO()
    compress(io.BytesIO(data), len(data), out, device=device)
    return out.getvalue()


def compress_framed_bytes(data: bytes, device: config.DeviceLike = None) -> bytes:
    out = io.BytesIO()
    compress_framed(io.BytesIO(data), out, device=device)
    return out.getvalue()


def uncompress_framed_bytes(
    data: bytes, check_integrity: bool = True, device: config.DeviceLike = None
) -> bytes:
    out = io.BytesIO()
    uncompress_framed(io.BytesIO(data), out, check_integrity, device=device)
    return out.getvalue()
