"""Raw and framed encode and decode around the kernels: batching and
assembly, and the routing to the host backend.

JAX counterpart: snappy_tpu/engine.py: ``raw_compress``,
``raw_compress_batch``, ``raw_uncompress``, ``raw_uncompress_batch``,
``_split_blocks``, ``framed_compress``, ``framed_uncompress``,
``framed_uncompress_chunks``, ``framed_uncompress_chunks_into``,
``_framed_uncompress_device``, ``_scan_failure_reason`` and
``masked_crc32c``.  Each public function takes ``backend`` (None: the
configured one, see config.py); on ``host`` it calls the native runtime
(ops/host_codec.py) where the JAX engine does, and ``device`` matters
only on the device backend.

Each call launches each kernel once over all its rows: the JAX engine's
512-chunk slabs and power-of-two shape buckets were there to bound TPU
compile shapes, which PyTorch does not have.  Streams are parsed and
assembled on the host; CRC, decode and encode run on ``device`` (``cuda``
by default, see config.py).  Nothing here raises on malformed input:
callers get (value, reason) results, which the API layer converts.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import config
from .formats import constants as C
from .formats import framing, varint
from .ops import crc32c, decode_chunks, decode_stream, encode_blocks, host_codec

_BLOCK = C.MAX_BLOCK_LEN  # 65536
_BIG = decode_chunks.MAX_OUT  # 131072: K2's big-window shape


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


# ---------------------------------------------------------------------------
# Raw format
# ---------------------------------------------------------------------------


def raw_compress(
    data: bytes, level: int = 1, device: config.DeviceLike = None,
    backend: Optional[str] = None,
) -> Optional[bytes]:
    """Raw-format compress: varint header + the block tag streams
    (snappy.nim:27-64); None for input over MAX_UNCOMPRESSED_LEN.  Level
    >= 2 encodes with two-way hash buckets (engine.py:222).  The backends
    give the same bytes."""
    if config.resolve_backend(backend) == "host":
        return host_codec.raw_compress(data, level)
    return raw_compress_batch([data], level, device, "device")[0]


def raw_compress_batch(
    datas: List[bytes], level: int = 1, device: config.DeviceLike = None,
    backend: Optional[str] = None,
) -> List[Optional[bytes]]:
    """Compress many payloads with one encoder launch over the 64 KiB
    blocks of all of them (on the host backend, one payload after the
    other).  Returns one stream (or None for oversized input) per payload,
    byte-identical to ``raw_compress`` of that payload alone (the block
    split is per payload)."""
    if config.resolve_backend(backend) == "host":
        return [host_codec.raw_compress(d, level) for d in datas]
    dev = config.resolve_device(device)
    results: List[Optional[bytes]] = [None] * len(datas)
    plan = []  # (result index, first block row, block count)
    rows = 0
    for i, data in enumerate(datas):
        n = len(data)
        if n > C.MAX_UNCOMPRESSED_LEN:
            continue
        if n == 0:
            results[i] = varint.encode_uint32(0)
            continue
        plan.append((i, rows, -(-n // _BLOCK)))
        rows += plan[-1][2]
    if not plan:
        return results
    # The kernel reads only the first lens[k] bytes of row k: no zero fill.
    host = torch.empty((rows, _BLOCK), dtype=torch.uint8)
    flat = host.numpy().reshape(-1)
    lens = np.full(rows, _BLOCK, dtype=np.int32)
    for i, r0, k in plan:
        n = len(datas[i])
        flat[r0 * _BLOCK : r0 * _BLOCK + n] = np.frombuffer(datas[i], dtype=np.uint8)
        lens[r0 + k - 1] = n - (k - 1) * _BLOCK
    enc, enc_len = encode_blocks.encode_blocks(
        host.to(dev), torch.from_numpy(lens).to(dev), level
    )
    # Each row's bytes, concatenated in row order on the device: one copy
    # of exactly the encoded bytes to the host.
    streams = _pack_rows(enc, enc_len).cpu().numpy()
    ends = np.cumsum(enc_len.cpu().numpy().astype(np.int64))
    for i, r0, k in plan:
        lo = int(ends[r0 - 1]) if r0 else 0
        results[i] = varint.encode_uint32(len(datas[i])) + streams[lo : ends[r0 + k - 1]].tobytes()
    return results


def _pack_rows(rows: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The first ``lens[k]`` bytes of each row, end to end, on the rows'
    device."""
    keep = torch.arange(rows.shape[1], device=rows.device) < lens[:, None]
    return rows.masked_select(keep)


def _declared(data: bytes, max_size: int) -> Tuple[Optional[int], int, str]:
    """(declared length, varint length, "ok") of a raw stream, or (None, 0,
    reason).  The sizing varint is read as uint64 (codec.nim:129-138), the
    decode's own as the stricter 5-byte uint32 (snappy.nim:92)."""
    declared64, _ = varint.decode_uint64(data)
    if declared64 is None or declared64 > C.MAX_UNCOMPRESSED_LEN:
        return None, 0, "invalid"
    if declared64 > max_size:
        return None, 0, "too_large"
    declared, read = varint.decode_uint32(data)
    if declared is None:
        return None, 0, "invalid"
    return declared, read, "ok"


def _decode_segments(
    bodies: List[memoryview], in_offs: List[np.ndarray], seg_declared: List[int],
    width: int, dev: torch.device,
) -> Tuple[np.ndarray, np.ndarray]:
    """One K2 launch over the segments of ``bodies`` (body ``k`` splits at
    ``in_offs[k]``, nseg + 1 offsets) into rows of ``width`` bytes.
    Returns (ok bool [rows], out uint8 [rows, width]) on the host."""
    total = sum(len(b) for b in bodies)
    comp = torch.empty(total, dtype=torch.uint8)
    np.concatenate([np.frombuffer(b, dtype=np.uint8) for b in bodies], out=comp.numpy())
    base = np.cumsum([0] + [len(b) for b in bodies])
    offsets = np.concatenate([base[k] + in_offs[k][:-1] for k in range(len(bodies))] + [base[-1:]])
    offsets = offsets.astype(np.int64)
    declared = np.asarray(seg_declared, dtype=np.int32)
    out = torch.empty((len(declared), width), dtype=torch.uint8, device=dev)
    ok, _written = decode_chunks.decode_chunks(
        comp.to(dev), torch.from_numpy(offsets).to(dev), torch.from_numpy(declared).to(dev),
        out, host_values=(offsets, declared),
    )
    return ok.cpu().numpy(), out.cpu().numpy()


def raw_uncompress(
    data: bytes,
    max_size: int = C.MAX_UNCOMPRESSED_LEN,
    device: config.DeviceLike = None,
    backend: Optional[str] = None,
) -> Tuple[Optional[bytes], str]:
    """Raw-format uncompress (snappy.nim:84-128).  Returns (payload, "ok")
    or (None, reason); reason in {"invalid", "too_large"}.

    The host backend decodes with ``host_codec.raw_uncompress``.  On the
    device backend, a stream of at most 128 KiB out takes K2 at the
    big-window shape, any larger one the streaming decoder in the mode that
    ``SNAPPY_TPU_STREAM_MODE`` names (engine.py:357-386): K4 in grid mode
    (the default), K5 in scan mode.  Scan mode's ``unsupported`` verdict (a
    copy reaching more than 64 KiB behind its window) routes the stream to
    K4, which serves every copy, as the JAX engine routes it to the XLA
    decoder.  The JAX engine also required the body to fit K2's comp
    capacity (``len(body) <= 4 * RAW_C_WORDS``); the port's K2 takes
    ragged input of any length, so that condition is gone, and the verdict
    cannot change, since both decoders are exact.  K4 and K5 keep 64-bit
    cursors, so the JAX engine's int32 guard (declared and body below
    2^31 - 2^21) is gone too."""
    if config.resolve_backend(backend) == "host":
        return host_codec.raw_uncompress(data, max_size)
    dev = config.resolve_device(device)
    declared, read, reason = _declared(data, max_size)
    if declared is None:
        return None, reason
    body = memoryview(data)[read:]
    if declared == 0:
        return (b"", "ok") if len(body) == 0 else (None, "invalid")
    if len(body) == 0:
        return None, "invalid"
    if declared <= _BIG:
        ok, out = _decode_segments([body], [np.array([0, len(body)])], [declared], _BIG, dev)
        return (out[0, :declared].tobytes(), "ok") if ok[0] else (None, "invalid")
    out, reason = decode_stream.decode_raw_stream_bytes(body, declared, device=dev)
    if reason == "unsupported":
        out, reason = decode_stream.decode_raw_stream_bytes(body, declared, mode="grid", device=dev)
    return (out, "ok") if reason == "ok" else (None, "invalid")


def raw_uncompress_batch(
    datas: List[bytes],
    max_size: int = C.MAX_UNCOMPRESSED_LEN,
    device: config.DeviceLike = None,
    backend: Optional[str] = None,
) -> List[Tuple[Optional[bytes], str]]:
    """Decode many independent raw streams: one K2 launch at the chunk
    shape over every one-block stream and every 64 KiB segment of the
    larger streams that the native tag scan splits, and one K2 launch at
    the big-window shape over the unsplittable streams of at most 128 KiB.
    Anything else goes through ``raw_uncompress``, and so does a split
    stream whose segment fails its in-chunk check (a legal copy reaching
    across a block boundary, which the split does not model): the
    whole-stream decoder is authoritative for its bytes and verdict
    (engine.py:511-518).  As in ``raw_uncompress``, the JAX engine's comp
    capacity conditions (``len(body) <= 4 * C_WORDS`` for a one-block
    stream, ``len(segment) > C_CAP`` refusing a split) are gone: K2 takes
    ragged input.  Returns one (payload or None, reason) per stream.  The
    host backend decodes one stream after the other with
    ``host_codec.raw_uncompress``."""
    if config.resolve_backend(backend) == "host":
        return [host_codec.raw_uncompress(d, max_size) for d in datas]
    dev = config.resolve_device(device)
    results: List[Optional[Tuple[Optional[bytes], str]]] = [None] * len(datas)
    seg_jobs = []  # (result index, body, in_offs, declared): the chunk shape
    big_jobs = []  # (result index, body, declared): the big-window shape
    for i, data in enumerate(datas):
        declared, read, reason = _declared(data, max_size)
        if declared is None:
            results[i] = (None, reason)
            continue
        body = memoryview(data)[read:]
        if declared == 0:
            results[i] = (b"", "ok") if len(body) == 0 else (None, "invalid")
            continue
        if len(body) == 0:
            results[i] = (None, "invalid")
            continue
        if declared <= _BLOCK:
            seg_jobs.append((i, body, np.array([0, len(body)]), declared))
            continue
        offs = host_codec.scan_raw_blocks(body, declared)
        # One segment per output block, or the split is not used: the scan
        # checks for straddling ops only at op starts, so an op over the
        # last boundary ends the stream with one segment too few.  (The
        # JAX engine lets such a split through when its segments fit
        # C_CAP and then reports a valid stream invalid.)
        if offs is not None and len(offs) - 1 == -(-declared // _BLOCK):
            seg_jobs.append((i, body, offs, declared))
        elif declared <= _BIG:
            big_jobs.append((i, body, declared))
        else:
            results[i] = raw_uncompress(data, max_size, dev, "device")

    if seg_jobs:
        seg_declared = []
        for _, _, offs, declared in seg_jobs:
            seg_declared += [min(_BLOCK, declared - k * _BLOCK) for k in range(len(offs) - 1)]
        ok, out = _decode_segments(
            [j[1] for j in seg_jobs], [j[2] for j in seg_jobs], seg_declared, _BLOCK, dev
        )
        r0 = 0
        for i, _, offs, declared in seg_jobs:
            r1 = r0 + len(offs) - 1
            if ok[r0:r1].all():
                results[i] = (out[r0:r1].reshape(-1)[:declared].tobytes(), "ok")
            elif r1 - r0 == 1:
                results[i] = (None, "invalid")
            else:
                results[i] = raw_uncompress(datas[i], max_size, dev, "device")
            r0 = r1
    if big_jobs:
        ok, out = _decode_segments(
            [j[1] for j in big_jobs], [np.array([0, len(j[1])]) for j in big_jobs],
            [j[2] for j in big_jobs], _BIG, dev,
        )
        for k, (i, _, declared) in enumerate(big_jobs):
            results[i] = (out[k, :declared].tobytes(), "ok") if ok[k] else (None, "invalid")
    return results  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Framed format
# ---------------------------------------------------------------------------


def framed_compress(
    data: bytes, with_header: bool = True, level: int = 1, device: config.DeviceLike = None,
    backend: Optional[str] = None,
) -> bytes:
    """Framed-format compress (snappy.nim:130-155, encoder.nim:385-426):
    per 64 KiB frame, masked CRC + compressed payload if it saves >= 1/8 of
    the frame, else the verbatim payload.  ``with_header=False`` leaves out
    the stream identifier (the stream adapters write it once).  The
    backends give the same bytes."""
    if config.resolve_backend(backend) == "host":
        return host_codec.framed_compress(data, with_header, level)
    dev = config.resolve_device(device)
    head = [C.FRAMING_HEADER] if with_header else []
    if not data:
        return b"".join(head)
    parts: List[bytes] = head
    arr = np.frombuffer(data, dtype=np.uint8)
    frames, flens = _split_blocks(arr, dev)
    crcs = crc32c.masked_crc32c_chunks(frames, flens)
    enc, totals = encode_blocks.encode_blocks(frames, flens, level)
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


def masked_crc32c(
    payload: bytes, device: config.DeviceLike = None, backend: Optional[str] = None
) -> int:
    """Masked CRC32C of one buffer of any length: on the device backend on
    ``device`` (one row of exactly its length: no power-of-two padding),
    on the host backend by the host C CRC."""
    if config.resolve_backend(backend) == "host":
        return host_codec.masked_crc32c(payload)
    dev = config.resolve_device(device)
    n = len(payload)
    row = torch.zeros((1, max(n, 1)), dtype=torch.uint8)
    row.numpy()[0, :n] = np.frombuffer(payload, dtype=np.uint8)
    lens = torch.tensor([n], dtype=torch.int32)
    return int(crc32c.masked_crc32c_chunks(row.to(dev), lens.to(dev))[0])


def _decode_bodies(
    arr: np.ndarray, bodies: List[Tuple[int, int]], declared_h: np.ndarray,
    check_integrity: bool, dev: torch.device,
):
    """One K2 launch over the tag streams ``arr[lo:hi]`` of ``bodies`` into
    64 KiB rows, then (``check_integrity``) one K1 launch over the decoded
    rows.  ``declared_h``: int32, one per body.  Returns (ok, out, masked
    CRCs or None, declared) on ``dev``."""
    offsets = np.zeros(len(bodies) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([hi - lo for lo, hi in bodies])
    comp = np.concatenate([arr[lo:hi] for lo, hi in bodies] + [arr[:0]])
    declared = torch.from_numpy(declared_h).to(dev)
    out = torch.empty((len(bodies), _BLOCK), dtype=torch.uint8, device=dev)
    ok, _written = decode_chunks.decode_chunks(
        torch.from_numpy(comp).to(dev), torch.from_numpy(offsets).to(dev),
        declared, out, host_values=(offsets, declared_h),
    )
    crcs = crc32c.masked_crc32c_chunks(out, declared) if check_integrity else None
    return ok, out, crcs, declared


def _crc_payloads(arr: np.ndarray, spans: List[Tuple[int, int]], dev: torch.device) -> torch.Tensor:
    """One K1 launch over the payloads ``arr[lo:hi]`` of ``spans`` (each at
    most 64 KiB), staged in zero-padded rows.  Returns uint32 on ``dev``."""
    rows = torch.zeros((len(spans), _BLOCK), dtype=torch.uint8)
    rows_h = rows.numpy()
    for k, (lo, hi) in enumerate(spans):
        rows_h[k, : hi - lo] = arr[lo:hi]
    lens = torch.tensor([hi - lo for lo, hi in spans], dtype=torch.int32)
    return crc32c.masked_crc32c_chunks(rows.to(dev), lens.to(dev))


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
        ok, out, crcs, _ = _decode_bodies(
            arr, [(lo, hi) for _, _, lo, hi, _, _ in comp_jobs],
            np.array([j[4] for j in comp_jobs], dtype=np.int32), check_integrity, dev,
        )
        ok = ok.cpu().numpy()
        if check_integrity:
            crcs = crcs.cpu().numpy()
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
        got = _crc_payloads(arr, [(lo, hi) for _, lo, hi, _ in ucrc_jobs], dev).cpu().numpy()
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
    backend: Optional[str] = None,
) -> Tuple[Optional[List[bytes]], str]:
    """Decode a list of scanned chunks; returns ([payload], "ok") or
    (None, reason) with reason in {"invalid", "crc", "unknown_chunk"}."""
    if config.resolve_backend(backend) == "host":
        blob, reason = host_codec.framed_uncompress_scanned(data, chunks, check_integrity)
        return (None, reason) if blob is None else ([blob], "ok")
    dev = config.resolve_device(device)
    total = sum(ch.uncompressed_len for ch in chunks)
    out_arr = np.empty((total,), dtype=np.uint8)
    written, reason = _framed_uncompress_device(data, chunks, check_integrity, out_arr, dev)
    if written is None:
        return None, reason
    return [out_arr[:written].tobytes()], "ok"


def framed_uncompress_chunks_into(
    data: bytes,
    chunks: List[framing.ChunkInfo],
    out_arr: np.ndarray,
    check_integrity: bool = True,
    device: config.DeviceLike = None,
    backend: Optional[str] = None,
) -> Tuple[Optional[int], str]:
    """Decode scanned chunks straight into ``out_arr`` (uint8, room for
    every chunk's output) at their final offsets.  Returns (written, "ok")
    or (None, reason)."""
    if config.resolve_backend(backend) == "host":
        blob, reason = host_codec.framed_uncompress_scanned(data, chunks, check_integrity, out_arr)
        return (None, reason) if blob is None else (sum(c.uncompressed_len for c in chunks), "ok")
    dev = config.resolve_device(device)
    return _framed_uncompress_device(data, chunks, check_integrity, out_arr, dev)


def framed_uncompress(
    data: bytes,
    max_size: int = C.MAX_UNCOMPRESSED_LEN,
    check_integrity: bool = True,
    require_header: bool = True,
    device: config.DeviceLike = None,
    backend: Optional[str] = None,
) -> Tuple[Optional[bytes], str]:
    """Whole-stream framed decode.  Returns (payload, "ok") or (None,
    reason); reason in {"invalid", "crc", "unknown_chunk", "too_large"}.
    With ``require_header=False`` the stream may start at its first chunk,
    without the stream identifier (snappy_tpu/engine.py:880-893).  The
    header and scan checks are the same on both backends."""
    host = config.resolve_backend(backend) == "host"
    dev = None if host else config.resolve_device(device)
    start = 0
    if require_header:
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
    if host:
        return host_codec.framed_uncompress_scanned(data, chunks, check_integrity)
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
