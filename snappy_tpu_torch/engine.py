"""Framed encode and decode around the kernels: batching and assembly.

JAX counterpart: snappy_tpu/engine.py, its framed parts (``_split_blocks``,
``framed_compress``, ``framed_uncompress``, ``framed_uncompress_chunks``,
``_framed_uncompress_device``, ``_scan_failure_reason`` and the device
``masked_crc32c``).

Each call launches each kernel once over all its chunks: the JAX engine's
512-chunk slabs and power-of-two shape buckets were there to bound TPU
compile shapes, which PyTorch does not have.  Frames are parsed and the
stream is assembled on the host; CRC, decode and encode run on ``device``
(``cuda`` by default, see config.py).  Nothing here raises on malformed
input: callers get (value, reason) results, which the API layer converts.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import config
from .formats import constants as C
from .formats import framing, varint
from .ops import crc32c, decode_chunks, encode_blocks

_BLOCK = C.MAX_BLOCK_LEN  # 65536

# The next queue item that adds level 2 (K3 at ways=2).
_LEVEL2_TODO = "level >= 2 is not ported yet (ROADMAP queue 1 item 4: K3 ways=2)"


def _split_blocks(arr: np.ndarray, dev: torch.device):
    """64 KiB frames of ``arr`` as (uint8 [nf, 65536] zero-padded, int32
    lengths [nf]) on ``dev``: one host copy, one upload."""
    n = len(arr)
    nf = max(1, -(-n // _BLOCK))
    host = torch.zeros(nf * _BLOCK, dtype=torch.uint8)
    host.numpy()[:n] = arr
    flens = np.full(nf, _BLOCK, dtype=np.int32)
    flens[-1] = n - (nf - 1) * _BLOCK
    return host.view(nf, _BLOCK).to(dev), torch.from_numpy(flens).to(dev)


def framed_compress(
    data: bytes, level: int = 1, device: config.DeviceLike = None
) -> bytes:
    """Framed-format compress (snappy.nim:130-155, encoder.nim:385-426):
    per 64 KiB frame, masked CRC + compressed payload if it saves >= 1/8 of
    the frame, else the verbatim payload."""
    if level != 1:
        raise ValueError(_LEVEL2_TODO)
    dev = config.resolve_device(device)
    if not data:
        return C.FRAMING_HEADER
    parts: List[bytes] = [C.FRAMING_HEADER]
    arr = np.frombuffer(data, dtype=np.uint8)
    frames, flens = _split_blocks(arr, dev)
    crcs = crc32c.masked_crc32c_chunks(frames, flens)
    enc, totals = encode_blocks.encode_blocks(frames, flens)
    crcs = crcs.cpu().numpy()
    enc = enc.cpu().numpy()
    totals = totals.cpu().numpy()
    flens = flens.cpu().numpy()
    for k in range(len(flens)):
        flen = int(flens[k])
        crc_bytes = int(crcs[k]).to_bytes(4, "little")
        # Keep the compressed form only if the encoded block alone (the
        # varint header excluded, as the reference compares blockLen at
        # encoder.nim:408) saves >= 1/8 of the frame, and the frame was big
        # enough to try (encoder.nim:401-426).
        if flen >= C.MIN_NON_LITERAL_BLOCK_SIZE and int(totals[k]) <= flen - flen // 8:
            blob = varint.encode_uint32(flen) + enc[k, : totals[k]].tobytes()
            parts.append(framing.encode_frame_header(C.CHUNK_COMPRESSED, 4 + len(blob)))
            parts.append(crc_bytes)
            parts.append(blob)
        else:
            parts.append(framing.encode_frame_header(C.CHUNK_UNCOMPRESSED, 4 + flen))
            parts.append(crc_bytes)
            parts.append(data[k * _BLOCK : k * _BLOCK + flen])
    return b"".join(parts)


def masked_crc32c(payload: bytes, device: config.DeviceLike = None) -> int:
    """Masked CRC32C of one buffer of any length on ``device`` (one row of
    exactly its length: no power-of-two padding)."""
    dev = config.resolve_device(device)
    n = len(payload)
    row = torch.zeros((1, max(n, 1)), dtype=torch.uint8)
    row.numpy()[0, :n] = np.frombuffer(payload, dtype=np.uint8)
    lens = torch.tensor([n], dtype=torch.int32)
    return int(crc32c.masked_crc32c_chunks(row.to(dev), lens.to(dev))[0])


def _framed_uncompress_device(
    data: bytes,
    chunks: List[framing.ChunkInfo],
    check_integrity: bool,
    out_arr: np.ndarray,
    dev: torch.device,
) -> Tuple[Optional[int], str]:
    """Decode scanned chunks, writing payloads at their final offsets in
    ``out_arr``.  Compressed chunks decode in one kernel launch, then one
    CRC launch over the decoded rows; uncompressed chunks take one CRC
    launch.  Semantics parity: snappy.nim:199-265.  Returns (written, "ok")
    or (None, reason)."""
    arr = np.frombuffer(data, dtype=np.uint8)

    # Error ORDER parity: the reference processes chunks strictly one at a
    # time (snappy.nim:199-265), so the error reported must belong to the
    # EARLIEST bad chunk.  The walk below stops at the first failure it can
    # see on the host; decode and CRC failures are found batched, so every
    # candidate error carries its chunk INDEX and the smallest one wins.
    deferred: Tuple[int, str] = (len(chunks), "")  # (chunk index, reason)
    comp_jobs = []  # (chunk_idx, out_offset, body_lo, body_hi, declared, crc)
    ucrc_jobs = []  # (chunk_idx, payload_lo, payload_hi, stored_crc)
    pos = 0
    for idx, ch in enumerate(chunks):
        if ch.id in (C.CHUNK_COMPRESSED, C.CHUNK_UNCOMPRESSED):
            if ch.data_len < 4:
                deferred = (idx, "invalid")
                break
            stored = int.from_bytes(data[ch.data_pos : ch.data_pos + 4], "little")
            lo, hi = ch.data_pos + 4, ch.data_pos + ch.data_len
            if ch.id == C.CHUNK_COMPRESSED:
                declared, read = varint.decode_uint32(arr[lo : min(hi, lo + 5)])
                if declared is None or declared > C.MAX_UNCOMPRESSED_FRAME_DATA_LEN:
                    deferred = (idx, "invalid")
                    break
                comp_jobs.append((idx, pos, lo + read, hi, declared, stored))
                pos += declared
            else:
                if hi - lo > C.MAX_UNCOMPRESSED_FRAME_DATA_LEN:
                    deferred = (idx, "invalid")
                    break
                if check_integrity:
                    ucrc_jobs.append((idx, lo, hi, stored))
                out_arr[pos : pos + hi - lo] = arr[lo:hi]
                pos += hi - lo
        elif ch.id == C.CHUNK_STREAM_HEADER:
            pass
        elif ch.id < C.CHUNK_RESERVED_SKIPPABLE_LO:
            deferred = (idx, "unknown_chunk")
            break
        # reserved skippable: ignore payload

    err = deferred

    def consider(idx: int, reason: str):
        nonlocal err
        if idx < err[0]:
            err = (idx, reason)

    if comp_jobs:
        n = len(comp_jobs)
        offsets = np.zeros(n + 1, dtype=np.int64)
        offsets[1:] = np.cumsum([hi - lo for _, _, lo, hi, _, _ in comp_jobs])
        comp = np.concatenate([arr[lo:hi] for _, _, lo, hi, _, _ in comp_jobs])
        declared = torch.tensor([j[4] for j in comp_jobs], dtype=torch.int32)
        declared = declared.to(dev)
        out = torch.empty((n, _BLOCK), dtype=torch.uint8, device=dev)
        ok, _written = decode_chunks.decode_chunks(
            torch.from_numpy(comp).to(dev), torch.from_numpy(offsets).to(dev),
            declared, out,
        )
        ok = ok.cpu().numpy()
        if check_integrity:
            crcs = crc32c.masked_crc32c_chunks(out, declared).cpu().numpy()
        out_h = out.cpu().numpy()
        for k, (idx, off, _, _, decl, stored) in enumerate(comp_jobs):
            if not ok[k]:
                consider(idx, "invalid")
                break
            if check_integrity and int(crcs[k]) != stored:
                consider(idx, "crc")
                break
            out_arr[off : off + decl] = out_h[k, :decl]

    # Uncompressed-chunk CRCs in one launch.  Only chunks EARLIER than the
    # current earliest error can still matter.
    ucrc_jobs = [j for j in ucrc_jobs if j[0] < err[0]]
    if ucrc_jobs:
        payloads = torch.zeros((len(ucrc_jobs), _BLOCK), dtype=torch.uint8)
        rows = payloads.numpy()
        for k, (_, lo, hi, _) in enumerate(ucrc_jobs):
            rows[k, : hi - lo] = arr[lo:hi]
        lens = torch.tensor([hi - lo for _, lo, hi, _ in ucrc_jobs], dtype=torch.int32)
        got = crc32c.masked_crc32c_chunks(payloads.to(dev), lens.to(dev))
        got = got.cpu().numpy()
        for k, (idx, _, _, stored) in enumerate(ucrc_jobs):
            if int(got[k]) != stored:
                consider(idx, "crc")
                break

    if err[0] < len(chunks):
        return None, err[1]
    return pos, "ok"


def framed_uncompress_chunks(
    data: bytes,
    chunks: List[framing.ChunkInfo],
    check_integrity: bool = True,
    device: config.DeviceLike = None,
) -> Tuple[Optional[List[bytes]], str]:
    """Decode a list of scanned chunks; returns ([payload], "ok") or
    (None, reason) with reason in {"invalid", "crc", "unknown_chunk"}."""
    dev = config.resolve_device(device)
    total = sum(ch.uncompressed_len for ch in chunks)
    out_arr = np.empty((total,), dtype=np.uint8)
    written, reason = _framed_uncompress_device(data, chunks, check_integrity, out_arr, dev)
    if written is None:
        return None, reason
    return [out_arr[:written].tobytes()], "ok"


def framed_uncompress(
    data: bytes,
    max_size: int = C.MAX_UNCOMPRESSED_LEN,
    check_integrity: bool = True,
    device: config.DeviceLike = None,
) -> Tuple[Optional[bytes], str]:
    """Whole-stream framed decode.  Returns (payload, "ok") or (None,
    reason); reason in {"invalid", "crc", "unknown_chunk", "too_large"}."""
    dev = config.resolve_device(device)
    if not framing.is_snappy_framed_stream(data):
        return None, "invalid"
    start = len(C.FRAMING_HEADER)
    chunks = framing.scan_frames(data, start)
    if chunks is None:
        # Distinguish the unskippable-reserved case for error parity.
        return None, _scan_failure_reason(data, start)
    total = sum(c.uncompressed_len for c in chunks)
    if total > max_size:
        return None, "too_large"
    out_arr = np.empty((total,), dtype=np.uint8)
    written, reason = _framed_uncompress_device(data, chunks, check_integrity, out_arr, dev)
    if written is None:
        return None, reason
    return out_arr[:written].tobytes(), "ok"


def _scan_failure_reason(data: bytes, start: int) -> str:
    """Re-walk headers to classify a scan failure (invalid vs unknown chunk)."""
    n = len(data)
    read = start
    while n - read >= 4:
        cid, data_len = framing.decode_frame_header(data[read : read + 4])
        if n - read < data_len + 4:
            return "invalid"
        if C.CHUNK_RESERVED_UNSKIPPABLE_LO <= cid <= C.CHUNK_RESERVED_UNSKIPPABLE_HI:
            return "unknown_chunk"
        read += 4 + data_len
    return "invalid"
