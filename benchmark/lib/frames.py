"""Messages cut into 64 KiB frames, and framed streams cut into chunks.

Every message is framed on its own, as a framed stream or a response
chunk is: frame ``k`` of a message holds its bytes ``[k * B, (k + 1) *
B)``.  Frames are numbered over all messages in order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

STREAM_IDENTIFIER = bytes([0xFF, 0x06, 0x00, 0x00, 0x73, 0x4E, 0x61, 0x50, 0x70, 0x59])
COMPRESSED, UNCOMPRESSED = 0x00, 0x01


@dataclass
class Table:
    start: np.ndarray  # int64 [F]: offset of the frame in the payload
    length: np.ndarray  # int64 [F]
    first: np.ndarray  # int64 [M + 1]: first frame of each message, then F


def table(sizes: List[int], frame: int) -> Table:
    sizes_a = np.asarray(sizes, dtype=np.int64)
    counts = np.maximum(1, -(-sizes_a // frame))
    first = np.zeros(len(sizes_a) + 1, dtype=np.int64)
    first[1:] = np.cumsum(counts)
    msg_start = np.concatenate(([0], np.cumsum(sizes_a)[:-1]))
    message = np.repeat(np.arange(len(sizes_a)), counts)
    k = np.arange(first[-1]) - first[message]
    start = msg_start[message] + k * frame
    length = np.minimum(frame, sizes_a[message] - k * frame)
    return Table(start, length, first)


def rows(data: torch.Tensor, t: Table, frame: int) -> torch.Tensor:
    """uint8 [F, frame] on data's device: each frame's bytes, then zeros."""
    out = torch.zeros((len(t.length), frame), dtype=torch.uint8, device=data.device)
    full = t.length == frame
    # runs of full frames that are contiguous in the payload: one copy each
    breaks = np.flatnonzero(~full[1:] | ~full[:-1] | (t.start[1:] != t.start[:-1] + frame)) + 1
    for lo, hi in zip(np.concatenate(([0], breaks)), np.concatenate((breaks, [len(full)]))):
        if full[lo]:
            s = int(t.start[lo])
            out[lo:hi] = data[s : s + (hi - lo) * frame].view(hi - lo, frame)
        else:
            for f in range(lo, hi):
                s, n = int(t.start[f]), int(t.length[f])
                out[f, :n] = data[s : s + n]
    return out


@dataclass
class Chunk:
    kind: int  # COMPRESSED or UNCOMPRESSED
    crc: int  # the stored masked CRC32C
    lo: int  # the chunk's data after the CRC: stream[lo:hi]
    hi: int


def chunks(stream: bytes) -> List[Chunk]:
    """The data chunks of one framed stream, in order; raises where the
    stream is not one identifier followed by whole chunks of known kinds."""
    if not stream.startswith(STREAM_IDENTIFIER):
        raise ValueError("no stream identifier")
    out, pos = [], len(STREAM_IDENTIFIER)
    while pos < len(stream):
        kind = stream[pos]
        n = int.from_bytes(stream[pos + 1 : pos + 4], "little")
        lo, hi = pos + 4, pos + 4 + n
        if hi > len(stream) or kind not in (COMPRESSED, UNCOMPRESSED) or n < 4:
            raise ValueError(f"chunk of kind {kind:#x} and {n} bytes at {pos}")
        out.append(Chunk(kind, int.from_bytes(stream[lo : lo + 4], "little"), lo + 4, hi))
        pos = hi
    return out


def varint(buf: bytes, pos: int):
    """(value, bytes read) of the little-endian base-128 varint at pos."""
    value = shift = 0
    for k in range(5):
        b = buf[pos + k]
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, k + 1
        shift += 7
    raise ValueError("varint longer than 5 bytes")
