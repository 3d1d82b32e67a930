"""Snappy wire-format constants.

JAX counterpart: snappy_tpu/formats/constants.py (a copy: importing
anything under snappy_tpu pulls in jax).

Spec parity: these mirror the format constants of the reference implementation
(nim-snappy snappy/codec.nim:9-53) and Google's Snappy format description
(format_description.txt) / framing spec (nim-snappy snappy/framing_format.txt).

The values are dictated by the wire format itself — they are not tunables.
"""

# Raw ("block") format ------------------------------------------------------

# Longest payload the raw format can carry: the stream prefix is a uint32
# varint of the uncompressed length (codec.nim:10).
MAX_UNCOMPRESSED_LEN = 0xFFFF_FFFF

# Encoders process input in independent blocks of this size; copy offsets
# never reach outside the current block (codec.nim:14).
MAX_BLOCK_LEN = 65536

# Tag byte low 2 bits (codec.nim:21-24).
TAG_LITERAL = 0x00
TAG_COPY1 = 0x01  # 2-byte copy tag: 3-bit length, 11-bit offset
TAG_COPY2 = 0x02  # 3-byte copy tag: 6-bit length, 16-bit offset
TAG_COPY4 = 0x03  # 5-byte copy tag: 6-bit length, 32-bit offset

# The encoder never emits a match this close to the end of a block; inputs
# shorter than this are emitted as a single literal (codec.nim:26, 53).
INPUT_MARGIN = 15
MIN_NON_LITERAL_BLOCK_SIZE = 17

# Framed format -------------------------------------------------------------

# Chunk ids (framing_format.txt:80-135, codec.nim:29-31).
CHUNK_COMPRESSED = 0x00
CHUNK_UNCOMPRESSED = 0x01
CHUNK_PADDING = 0xFE
CHUNK_STREAM_HEADER = 0xFF

# Reserved ranges: 0x02-0x7f must abort decoding ("unskippable"),
# 0x80-0xfd are skippable (framing_format.txt:100-135).
CHUNK_RESERVED_UNSKIPPABLE_LO = 0x02
CHUNK_RESERVED_UNSKIPPABLE_HI = 0x7F
CHUNK_RESERVED_SKIPPABLE_LO = 0x80
CHUNK_RESERVED_SKIPPABLE_HI = 0xFD

# The 10-byte stream identifier: chunk id 0xff, 24-bit length 6, "sNaPpY"
# (codec.nim:33-34, framing_format.txt:63-73).
FRAMING_HEADER = bytes([0xFF, 0x06, 0x00, 0x00, 0x73, 0x4E, 0x61, 0x50, 0x70, 0x59])

# Uncompressed payload of one frame chunk is capped at 64 KiB
# (framing_format.txt:88-91, codec.nim:18).
MAX_UNCOMPRESSED_FRAME_DATA_LEN = 65536

# Framed chunks carry a 4-byte masked CRC32C before the payload.
FRAME_CRC_LEN = 4
FRAME_HEADER_LEN = 4  # 1-byte id + 3-byte little-endian payload length

# CRC32C masking constant (framing_format.txt:39-58).
CRC_MASK_DELTA = 0xA282_EAD8


def max_compressed_len(uncompressed_len: int) -> int:
    """Worst-case raw-format compressed size for ``uncompressed_len`` bytes.

    Returns 0 when the input cannot be represented (> 2^32-1), matching the
    reference contract (codec.nim:92-127).  The bound is
    ``32 + n + n/6``: 5 bytes of varint header, and in the worst case one
    4-byte copy tag per 6 matched bytes plus literal overhead, with slack so
    fast emit paths may overshoot by up to 16 bytes.
    """
    n = uncompressed_len
    if n > MAX_UNCOMPRESSED_LEN:
        return 0
    return 32 + n + n // 6


# Worst-case compressed size of a single 64 KiB block / frame payload
# (codec.nim:216-219).
MAX_COMPRESSED_BLOCK_LEN = max_compressed_len(MAX_BLOCK_LEN)
MAX_COMPRESSED_FRAME_DATA_LEN = max_compressed_len(MAX_UNCOMPRESSED_FRAME_DATA_LEN)


def max_compressed_len_framed(uncompressed_len: int) -> int:
    """Worst-case framed-format size for ``uncompressed_len`` bytes,
    including scratch space used during compression.

    Contract parity with codec.nim:140-164: frames that do not compress are
    stored verbatim, capping each frame at payload+8 framing bytes, except
    that one full frame of compression scratch (``max_compressed_len`` of a
    64 KiB frame) is budgeted so the encoder can always *attempt* compression
    of the final (possibly short) frame in place.
    """
    if uncompressed_len <= 0:
        return len(FRAMING_HEADER)
    max_frame_len = MAX_UNCOMPRESSED_FRAME_DATA_LEN + 8
    frames = (
        uncompressed_len + MAX_UNCOMPRESSED_FRAME_DATA_LEN - 1
    ) // MAX_UNCOMPRESSED_FRAME_DATA_LEN
    max_frames_len = (frames - 1) * max_frame_len + (
        max_compressed_len(MAX_UNCOMPRESSED_FRAME_DATA_LEN) + 8
    )
    return max_frames_len + len(FRAMING_HEADER)
