"""Frame header packing/parsing and stream scanners.

JAX counterpart: snappy_tpu/formats/framing.py.  A copy, except that a
failed build of the native header pass behind ``scan_frames`` raises
instead of falling back to the Python walk, and that two pieces of
format knowledge the JAX package keeps in its engine live here:
``scan_failure_reason`` (snappy_tpu/engine.py ``_scan_failure_reason``)
and ``frame_stream``, the chunk writer of ``framed_compress``.

Spec parity with nim-snappy snappy/codec.nim:129-214 (``uncompressedLen``,
``decodeFrameHeader``, ``isSnappyFramedStream``, ``uncompressedLenFramed``).
These are host-side scanners used to size output buffers and to find chunk
boundaries before the chunk payloads go to the device kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from . import constants as C
from . import varint

# Streams at least this long scan chunk headers through the native C pass
# (below it the Python walk's fixed overhead wins and keeps the Python
# path exercised).
_NATIVE_SCAN_MIN = 1 << 20


def uncompressed_len(data) -> Optional[int]:
    """Read the raw-format uncompressed length prefix (codec.nim:129-138).

    Returns the uint64 value, or None on empty/truncated/overflowing varint.
    """
    value, read = varint.decode_uint64(data)
    if read <= 0:
        return None
    return value


def decode_frame_header(data) -> Tuple[int, int]:
    """Split a 4-byte little-endian chunk header word into (id, 24-bit len).

    Parity: codec.nim:166-172.
    """
    if len(data) < 4:
        raise ValueError("frame header needs at least 4 bytes")
    word = data[0] | (data[1] << 8) | (data[2] << 16) | (data[3] << 24)
    return word & 0xFF, word >> 8


def encode_frame_header(chunk_id: int, data_len: int) -> bytes:
    """Pack a chunk header: 1-byte id + 3-byte little-endian payload length."""
    if not 0 <= data_len < (1 << 24):
        raise ValueError("frame data length out of 24-bit range")
    word = (chunk_id & 0xFF) | (data_len << 8)
    return bytes([word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF, (word >> 24) & 0xFF])


def is_snappy_framed_stream(data) -> bool:
    """Sniff the 10-byte stream identifier (codec.nim:174-176)."""
    return bytes(data[: len(C.FRAMING_HEADER)]) == C.FRAMING_HEADER


@dataclass(frozen=True)
class ChunkInfo:
    """One chunk of a framed stream, located by ``scan_frames``."""

    id: int
    header_pos: int  # offset of the 4-byte header in the stream
    data_pos: int  # offset of the payload (incl. 4-byte CRC if present)
    data_len: int  # payload length (incl. CRC for data chunks)
    uncompressed_len: int  # contribution to the decoded output


def scan_frames(data, start: int = 0) -> Optional[List[ChunkInfo]]:
    """Walk all chunk headers of a framed stream, validating sizes.

    Returns None on any malformed structure: truncated header/payload,
    compressed chunk without CRC or with an invalid inner varint, any known
    chunk whose uncompressed payload exceeds 64 KiB.  Reserved chunks are
    recorded (unskippable handling is the caller's policy).  This is the
    scanner behind ``uncompressed_len_framed`` (parity: codec.nim:178-214) and
    the chunk table used by the framed decoder.
    """
    n = len(data)
    if n - start >= _NATIVE_SCAN_MIN:
        from ..ops import host_codec

        rec = host_codec.scan_frames_records(data, start)
        if rec is None:
            return None
        return [
            ChunkInfo(int(cid), int(hp), int(hp) + 4, int(dl), int(u))
            for cid, hp, dl, u in rec.tolist()
        ]
    read = start
    chunks: List[ChunkInfo] = []
    while n - read > 0:
        if n - read < 4:
            return None
        cid, data_len = decode_frame_header(data[read : read + 4])
        if n - read < data_len + 4:
            return None
        data_pos = read + 4
        if cid == C.CHUNK_COMPRESSED:
            if data_len < 4:
                return None
            inner = uncompressed_len(data[data_pos + 4 : data_pos + data_len])
            if inner is None:
                return None
            unc = inner
        elif cid == C.CHUNK_UNCOMPRESSED:
            if data_len < 4:
                return None
            unc = data_len - 4
        elif cid < C.CHUNK_RESERVED_SKIPPABLE_LO:
            # Reserved unskippable chunk: scanning cannot size the stream.
            # (codec.nim:203 returns error; decode-time policy differs.)
            return None
        else:
            unc = 0
        if unc > C.MAX_UNCOMPRESSED_FRAME_DATA_LEN:
            return None
        chunks.append(ChunkInfo(cid, read, data_pos, data_len, unc))
        read += 4 + data_len
    return chunks


def scan_failure_reason(data, start: int) -> str:
    """Why ``scan_frames(data, start)`` failed: walk the chunk headers again
    and tell a reserved unskippable chunk (``unknown_chunk``) from any other
    fault (``invalid``)."""
    n = len(data)
    read = start
    while n - read >= 4:
        cid, data_len = decode_frame_header(data[read : read + 4])
        if n - read < data_len + 4:
            return "invalid"
        if C.CHUNK_RESERVED_UNSKIPPABLE_LO <= cid <= C.CHUNK_RESERVED_UNSKIPPABLE_HI:
            return "unknown_chunk"
        read += 4 + data_len
    return "invalid"


def frame_stream(data, crcs, buf, starts, totals, with_header: bool) -> bytes:
    """The framed stream of ``data`` (snappy.nim:130-155,
    encoder.nim:385-426) from what the device stage computed of its 64 KiB
    frames: frame k's masked CRC ``crcs[k]`` and its encoded block
    ``buf[starts[k] : starts[k] + totals[k]]`` (uint8, without the varint
    header).  The stream identifier where ``with_header``, then a chunk a
    frame: compressed if the frame is at least MIN_NON_LITERAL_BLOCK_SIZE
    bytes and the encoded block alone (the varint header excluded, as the
    reference compares blockLen at encoder.nim:408) saves at least 1/8 of
    it, else stored, the frame's own bytes."""
    parts = [C.FRAMING_HEADER] if with_header else []
    n = len(data)
    for k in range(len(totals)):
        lo = k * C.MAX_BLOCK_LEN
        flen = min(C.MAX_BLOCK_LEN, n - lo)
        total = int(totals[k])
        crc = int(crcs[k]).to_bytes(4, "little")
        if flen >= C.MIN_NON_LITERAL_BLOCK_SIZE and total <= flen - flen // 8:
            blob = varint.encode_uint32(flen) + buf[starts[k] : starts[k] + total].tobytes()
            parts += [encode_frame_header(C.CHUNK_COMPRESSED, 4 + len(blob)), crc, blob]
        else:
            parts += [encode_frame_header(C.CHUNK_UNCOMPRESSED, 4 + flen), crc, data[lo : lo + flen]]
    return b"".join(parts)


def uncompressed_len_framed(data) -> Optional[int]:
    """Total decoded size of a framed stream via a full chunk pre-scan.

    Parity: codec.nim:178-214.  Returns None for malformed streams.
    """
    chunks = scan_frames(data)
    if chunks is None:
        return None
    return sum(c.uncompressed_len for c in chunks)
