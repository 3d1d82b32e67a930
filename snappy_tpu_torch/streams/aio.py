"""Asynchronous stream adapters (asyncio).

JAX counterpart: snappy_tpu/streams/aio.py.  The
reference generates the sync and async variants of its streaming framed
decompressor from one body (faststreams.nim:89-147, ``fsMultiSync``);
these wrappers give the async surface over asyncio StreamReader / Writer
pairs, with the windows, the backends and the error model of
``streams/sync.py``.  The kernels, or the host runtime, run inside the
coroutine, synchronously.
"""

from __future__ import annotations

import asyncio

from .. import config, engine
from ..formats import constants as C
from ..formats import framing, varint
from ..formats.errors import MalformedSnappyData, UnexpectedEofError, raise_input_too_large
from .sync import _DEFAULT_BATCH, _WINDOW, decode_window, whole_chunks


async def compress(
    reader: asyncio.StreamReader,
    src_len: int,
    writer: asyncio.StreamWriter,
    batch_frames: int = _DEFAULT_BATCH,
    device: config.DeviceLike = None,
) -> int:
    """Async raw-format compress of exactly ``src_len`` bytes."""
    if src_len > C.MAX_UNCOMPRESSED_LEN:
        raise_input_too_large()
    header = varint.encode_uint32(src_len)
    writer.write(header)
    written = len(header)
    remaining = src_len
    while remaining > 0:
        want = min(remaining, C.MAX_BLOCK_LEN * batch_frames)
        try:
            buf = await reader.readexactly(want)
        except asyncio.IncompleteReadError as e:
            raise UnexpectedEofError("input stream ended early") from e
        enc = engine.raw_compress(buf, device=device)
        _, read = varint.decode_uint64(enc)
        writer.write(enc[read:])
        await writer.drain()
        written += len(enc) - read
        remaining -= len(buf)
    return written


async def compress_framed(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    batch_frames: int = _DEFAULT_BATCH,
    device: config.DeviceLike = None,
) -> int:
    """Async framed-format compress of a stream of any length."""
    writer.write(C.FRAMING_HEADER)
    written = len(C.FRAMING_HEADER)
    while True:
        buf = await reader.read(C.MAX_UNCOMPRESSED_FRAME_DATA_LEN * batch_frames)
        if not buf:
            break
        enc = engine.framed_compress(buf, with_header=False, device=device)
        writer.write(enc)
        await writer.drain()
        written += len(enc)
    return written


async def uncompress_framed(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    check_integrity: bool = True,
    device: config.DeviceLike = None,
) -> int:
    """Async streaming framed decompress (the async twin the reference
    gets from fsMultiSync)."""
    try:
        magic = await reader.readexactly(len(C.FRAMING_HEADER))
    except asyncio.IncompleteReadError as e:
        raise UnexpectedEofError("stream shorter than the framing header") from e
    if not framing.is_snappy_framed_stream(magic):
        raise MalformedSnappyData("missing snappy framing header")

    written = 0
    pending = bytearray()
    while True:
        data = await reader.read(_WINDOW)
        at_eof = not data
        pending.extend(data)
        pos = whole_chunks(pending, len(pending))
        if pos:
            for decoded in decode_window(bytes(memoryview(pending)[:pos]), check_integrity, device):
                writer.write(bytes(decoded))
                await writer.drain()
                written += len(decoded)
            del pending[:pos]
        if at_eof:
            if pending:
                raise UnexpectedEofError(f"{len(pending)} trailing bytes are not a whole chunk")
            return written
