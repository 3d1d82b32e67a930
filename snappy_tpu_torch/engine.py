"""Raw and framed encode and decode around the kernels: batching and
assembly, and the routing to the host backend.

JAX counterpart: snappy_tpu/engine.py: ``raw_compress``,
``raw_compress_batch``, ``raw_uncompress``, ``raw_uncompress_batch``,
``_split_blocks`` (``split_frames``), ``framed_compress``,
``framed_uncompress``, ``framed_uncompress_chunks``,
``framed_uncompress_chunks_into``, ``_framed_uncompress_device`` and
``masked_crc32c``; its ``_scan_failure_reason`` is
``formats.framing.scan_failure_reason``.  Each public function takes
``backend`` (None: the configured one, see config.py); on ``host`` it
calls the native runtime (ops/host_codec.py) where the JAX engine does,
and ``device`` matters only on the device backend.

Each call launches each kernel once over all its rows: the JAX engine's
512-chunk slabs and power-of-two shape buckets were there to bound TPU
compile shapes, which PyTorch does not have.  Streams are parsed and
assembled on the host; CRC, decode and encode run on ``device`` (``cuda``
by default, see config.py).  Nothing here raises on malformed input:
callers get (value, reason) results, which the API layer converts.

The array route (``config.device_kernel()`` other than ``scalar``, the
JAX engine's ``SNAPPY_TPU_DEVICE_KERNEL=xla``) encodes with
ops/encode_array.py and decodes with ops/decode_array.py where the scalar
route runs K2-K5: every raw stream in one whole-stream decode, framed
chunks and blocks in slabs of rows that bound the device memory (the JAX
engine's power-of-two batch buckets bounded compile shapes; the results
do not depend on either).  ``level`` is ignored there, as in the JAX
engine.  K1 takes the CRCs on both routes.  A failure on the array route
raises: nothing falls back to the kernels.

An encode's stages are the layer's interface to its callers (the flagship
step in entry.py and the sharded encodes in parallel/mesh.py):
``split_frames`` stages a payload's frames, ``encode_frames`` launches K1
and the encoder over them, ``pack_rows`` packs the encoded rows on the
card and ``read_streams`` brings them back; ``formats.framing.frame_stream``
writes the framed stream from them.

The framed paths' stages are telemetry spans (telemetry.py):
``engine.scan``, ``engine.decode`` (the device part of a framed decode),
``engine.stage`` (host staging of bodies and rows), ``engine.upload``,
``read.engine`` (the read-backs: a framed encode's CRCs, packed bytes
and totals are its 3), ``engine.assemble`` and ``engine.tobytes``; the
raw batch decode's are ``engine.decode_batch`` around ``engine.plan``,
``engine.stage``, ``engine.upload``, ``read.engine`` and
``engine.assemble``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import config, telemetry
from .formats import constants as C
from .formats import framing, varint
from .ops import (
    crc32c, decode_array, decode_chunks, decode_stream, encode_array, encode_blocks, host_codec,
)

_BLOCK = C.MAX_BLOCK_LEN  # 65536
_BIG = decode_chunks.MAX_OUT  # 131072: K2's big-window shape
# The array encoder's row: max_compressed_len(65536) rounded up to 128
# (snappy_tpu/engine.py:29).
_MAX_COMP_BLOCK = -(-C.max_compressed_len(_BLOCK) // 128) * 128
_ARRAY_SLAB = 1 << 23  # elements of a slab of rows on the array route


def _array_route() -> bool:
    """The array route, read at each call (engine._use_scalar_kernels)."""
    return config.device_kernel() != "scalar"


def _slab_rows(width: int) -> int:
    return max(1, _ARRAY_SLAB // width)


def split_frames(arr: np.ndarray, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 64 KiB frames of ``arr`` as (uint8 [nf, 65536] zero-padded, int32
    lengths [nf]) on ``dev``, at least one frame: one host copy, one upload.
    The rows ``encode_frames`` takes, for the framed and sharded encodes."""
    n = len(arr)
    nf = max(1, -(-n // _BLOCK))
    with telemetry.span("engine.stage"):
        host = torch.zeros(nf * _BLOCK, dtype=torch.uint8)
        host.numpy()[:n] = arr
        flens = np.full(nf, _BLOCK, dtype=np.int32)
        flens[-1] = n - (nf - 1) * _BLOCK
    with telemetry.span("engine.upload"):
        return host.view(nf, _BLOCK).to(dev), torch.from_numpy(flens).to(dev)


def encode_frames(
    frames: torch.Tensor, flens: torch.Tensor, level: int = 1, crc: bool = True,
    width: int = _MAX_COMP_BLOCK,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The device stage of an encode: of the blocks ``frames[i, :flens[i]]``
    (uint8 [N, B], B <= 65536, int32 lengths, on one device), the masked
    CRC32C of each (K1, where ``crc``; else None), and its raw tag stream
    as (uint8 [N, W] enc, int32 totals): K3 at ``level`` (W = ENC_CAP),
    or on the array route the array encoder over slabs of rows into W =
    ``width`` columns, ``level`` ignored (engine.py:234-236, :596-598).
    Launches only: no read, no copy to the host, no synchronize.  Returns
    (crcs, enc, totals) on the frames' device, row i's stream in ``enc[i,
    :totals[i]]``."""
    crcs = crc32c.masked_crc32c_chunks(frames, flens) if crc else None
    if not _array_route():
        enc, totals = encode_blocks.encode_blocks(frames, flens, level)
        return crcs, enc, totals
    n = frames.shape[0]
    enc = torch.empty((n, width), dtype=torch.uint8, device=frames.device)
    totals = torch.empty(n, dtype=torch.int32, device=frames.device)
    col = torch.arange(frames.shape[1], device=frames.device)
    step = _slab_rows(width)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        # the array encoder's match lengths see the bytes past a block's
        # end before they are cut to it: zero them, as the JAX engine pads
        block = frames[lo:hi].masked_fill(col >= flens[lo:hi, None], 0)
        enc[lo:hi], totals[lo:hi] = encode_array.encode_blocks(block, flens[lo:hi], width)
    return crcs, enc, totals


def pack_rows(rows: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The first ``lens[k]`` bytes of each row of ``rows`` (uint8 [N, W]),
    end to end in row order, on the rows' device: what a read-back or an
    all-gather of the rows needs to move, and no more."""
    keep = torch.arange(rows.shape[1], device=rows.device) < lens[:, None]
    return rows.masked_select(keep)


def read_streams(enc: torch.Tensor, totals: torch.Tensor) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``encode_frames``' streams on the host as (buf, starts, totals): row
    k's bytes are ``buf[starts[k] : starts[k] + totals[k]]``.  The rows are
    packed on the card (``pack_rows``), so one copy brings back exactly the
    encoded bytes, and one more the totals; the caller's ``read.engine``
    span holds both reads."""
    buf = pack_rows(enc, totals).cpu().numpy()
    totals = totals.cpu().numpy().astype(np.int64)
    starts = np.zeros(len(totals), dtype=np.int64)
    np.cumsum(totals[:-1], out=starts[1:])
    return buf, starts, totals


# ---------------------------------------------------------------------------
# Raw format
# ---------------------------------------------------------------------------


def raw_compress(
    data: bytes, level: int = 1, device: config.DeviceLike = None,
    backend: Optional[str] = None,
) -> Optional[bytes]:
    """Raw-format compress: varint header + the block tag streams
    (snappy.nim:27-64); None for input over MAX_UNCOMPRESSED_LEN.  Level
    >= 2 encodes with two-way hash buckets (engine.py:222); the array route
    ignores it.  The backends give the same bytes, the array route others."""
    if config.resolve_backend(backend) == "host":
        return host_codec.raw_compress(data, level)
    return raw_compress_batch([data], level, device, "device")[0]


def raw_compress_batch(
    datas: List[bytes], level: int = 1, device: config.DeviceLike = None,
    backend: Optional[str] = None,
) -> List[Optional[bytes]]:
    """Compress many payloads with one encoder launch over the 64 KiB
    blocks of all of them (on the array route, the array encoder over
    slabs of those blocks, where the JAX engine goes payload by payload;
    on the host backend, one payload after the other).  Returns one
    stream (or None for oversized input) per payload, byte-identical to
    ``raw_compress`` of that payload alone (the block split is per
    payload)."""
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
    _, enc, totals = encode_frames(host.to(dev), torch.from_numpy(lens).to(dev), level, crc=False)
    with telemetry.span("read.engine", reads=2):
        streams, starts, totals = read_streams(enc, totals)
    for i, r0, k in plan:
        lo, hi = starts[r0], starts[r0 + k - 1] + totals[r0 + k - 1]
        results[i] = varint.encode_uint32(len(datas[i])) + streams[lo:hi].tobytes()
    return results


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
    bodies: List[np.ndarray], in_offs: List[np.ndarray], seg_declared: List[int], dev: torch.device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One K2 launch, in its ragged form, over the segments of ``bodies``
    (body ``k`` splits at ``in_offs[k]``, nseg + 1 offsets): segment ``j``
    decodes into a slot of ``seg_declared[j]`` bytes rounded up to 16 of one
    buffer, so the full 64 KiB segments of a split body and its last one
    lie end to end.  One read brings back the verdicts, one the slots: the
    decoded bytes and at most 15 more a segment.  Returns (ok bool [segs],
    out uint8 [slot bytes], slot offsets int64 [segs + 1]) on the host."""
    with telemetry.span("engine.stage"):
        total = sum(len(b) for b in bodies)
        comp = torch.empty(total, dtype=torch.uint8)
        np.concatenate(bodies, out=comp.numpy())
        base = np.cumsum([0] + [len(b) for b in bodies])
        offsets = np.concatenate([base[k] + in_offs[k][:-1] for k in range(len(bodies))] + [base[-1:]])
        offsets = offsets.astype(np.int64)
        declared = np.asarray(seg_declared, dtype=np.int32)
        slots = np.zeros(len(declared) + 1, dtype=np.int64)
        np.cumsum((declared.astype(np.int64) + 15) & ~15, out=slots[1:])
        index = torch.from_numpy(np.concatenate([offsets, slots]))
    with telemetry.span("engine.upload"):
        comp, index, declared_d = comp.to(dev), index.to(dev), torch.from_numpy(declared).to(dev)
    n = len(declared)
    out = torch.empty(int(slots[-1]), dtype=torch.uint8, device=dev)
    ok, _written = decode_chunks.decode_chunks(
        comp, index[: n + 1], declared_d, out, host_values=(offsets, declared, slots), out_offsets=index[n + 1 :],
    )
    with telemetry.span("read.engine", reads=2):
        return ok.cpu().numpy(), out.cpu().numpy(), slots


def _raw_uncompress_array(body: memoryview, declared: int, dev: torch.device) -> Tuple[Optional[bytes], str]:
    """One whole-stream array decode of a raw body (engine.py:374-386).
    The JAX engine pads the body and the output to powers of two; here
    they are exact, since the verdict and a valid stream's bytes do not
    depend on the padding.  A tag yields at most 64 bytes from 3 input
    bytes and every byte of a valid body is in a tag, so a declared length
    above 64/3 of the body is invalid without a decode: the array decoder
    would say so too, after allocating the declared length."""
    if 3 * declared > 64 * len(body):
        return None, "invalid"
    if declared >= 1 << 31 or len(body) >= 1 << 31:
        raise ValueError("the array route decodes raw streams below 2^31 bytes "
                         "(the JAX engine's int32 lengths)")
    comp = torch.from_numpy(np.frombuffer(body, dtype=np.uint8).copy()).to(dev)
    out, ok, _written = decode_array.decode_raw(comp, len(body), declared, declared)
    if not bool(ok):
        return None, "invalid"
    return out.cpu().numpy().tobytes(), "ok"


def raw_uncompress(
    data: bytes,
    max_size: int = C.MAX_UNCOMPRESSED_LEN,
    device: config.DeviceLike = None,
    backend: Optional[str] = None,
) -> Tuple[Optional[bytes], str]:
    """Raw-format uncompress (snappy.nim:84-128).  Returns (payload, "ok")
    or (None, reason); reason in {"invalid", "too_large"}.

    The host backend decodes with ``host_codec.raw_uncompress``.  On the
    array route every stream takes one whole-stream array decode.  On the
    scalar route, a stream of at most 128 KiB out takes K2 at the
    big-window shape, any larger one the streaming decoder in the mode that
    ``SNAPPY_TPU_TORCH_STREAM_MODE`` names (engine.py:357-386): K4 in grid mode
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
    if _array_route():
        return _raw_uncompress_array(body, declared, dev)
    if declared <= _BIG:
        body = np.frombuffer(body, dtype=np.uint8)
        ok, out, _ = _decode_segments([body], [np.array([0, len(body)])], [declared], dev)
        return (out[:declared].tobytes(), "ok") if ok[0] else (None, "invalid")
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
    the big-window shape over the unsplittable streams of at most 128 KiB;
    both in K2's ragged form, so each reads back only the decoded bytes
    (``_decode_segments``) and every stream is cut from that one buffer.
    On the array route every stream goes through ``raw_uncompress``.
    Anything else goes through ``raw_uncompress``, and so does a split
    stream whose segment fails its in-chunk check (a legal copy reaching
    across a block boundary, which the split does not model): the
    whole-stream decoder is authoritative for its bytes and verdict
    (engine.py:511-518).  As in ``raw_uncompress``, the JAX engine's comp
    capacity conditions (``len(body) <= 4 * C_WORDS`` for a one-block
    stream, ``len(segment) > C_CAP`` refusing a split) are gone: K2 takes
    ragged input.  Returns one (payload or None, reason) per stream.  The
    host backend decodes one stream after the other with
    ``host_codec.raw_uncompress``.

    On the kernel route the call is the span ``engine.decode_batch``: in it
    ``engine.plan`` (each stream's header, the split scans, the job lists),
    then for each launch ``engine.stage``, ``engine.upload``, ``k2`` and
    ``read.engine``, and ``engine.assemble`` (each stream's bytes); the
    counters ``engine.batch_streams`` and ``engine.batch_fallbacks`` (split
    streams decoded again alone) count on any device."""
    if config.resolve_backend(backend) == "host":
        return [host_codec.raw_uncompress(d, max_size) for d in datas]
    dev = config.resolve_device(device)
    if _array_route():  # stream by stream (engine.py:452-454)
        return [raw_uncompress(d, max_size, dev, "device") for d in datas]
    telemetry.count("engine.batch_streams", len(datas))
    with telemetry.span("engine.decode_batch"):
        results: List[Optional[Tuple[Optional[bytes], str]]] = [None] * len(datas)
        seg_jobs = []  # (result index, body, in_offs, declared): the chunk shape
        big_jobs = []  # (result index, body, declared): the big-window shape
        alone = []  # result indices decoded by raw_uncompress
        with telemetry.span("engine.plan"):
            for i, data in enumerate(datas):
                declared, read, reason = _declared(data, max_size)
                if declared is None:
                    results[i] = (None, reason)
                    continue
                # a NumPy view, which the garbage collector does not track:
                # tracked objects held for the call, one a stream, would reach
                # its oldest generation and set off its full passes
                body = np.frombuffer(data, dtype=np.uint8, offset=read)
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
                # One segment per output block, or the split is not used: the
                # scan checks for straddling ops only at op starts, so an op
                # over the last boundary ends the stream with one segment too
                # few.  (The JAX engine lets such a split through when its
                # segments fit C_CAP and then reports a valid stream invalid.)
                if offs is not None and len(offs) - 1 == -(-declared // _BLOCK):
                    seg_jobs.append((i, body, offs, declared))
                elif declared <= _BIG:
                    big_jobs.append((i, body, declared))
                else:
                    alone.append(i)
            seg_declared = []
            for _, _, offs, declared in seg_jobs:
                seg_declared += [min(_BLOCK, declared - k * _BLOCK) for k in range(len(offs) - 1)]

        if seg_jobs:
            ok, out, slots = _decode_segments([j[1] for j in seg_jobs], [j[2] for j in seg_jobs], seg_declared, dev)
            again = []
            with telemetry.span("engine.assemble"):
                r0 = 0
                for i, _, offs, declared in seg_jobs:
                    r1 = r0 + len(offs) - 1
                    if ok[r0:r1].all():
                        lo = int(slots[r0])
                        results[i] = (out[lo : lo + declared].tobytes(), "ok")
                    elif r1 - r0 == 1:
                        results[i] = (None, "invalid")
                    else:
                        again.append(i)
                    r0 = r1
            telemetry.count("engine.batch_fallbacks", len(again))
            alone += again
        if big_jobs:
            ok, out, slots = _decode_segments(
                [j[1] for j in big_jobs], [np.array([0, len(j[1])]) for j in big_jobs],
                [j[2] for j in big_jobs], dev,
            )
            with telemetry.span("engine.assemble"):
                for k, (i, _, declared) in enumerate(big_jobs):
                    lo = int(slots[k])
                    results[i] = (out[lo : lo + declared].tobytes(), "ok") if ok[k] else (None, "invalid")
        for i in alone:
            results[i] = raw_uncompress(datas[i], max_size, dev, "device")
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
    if not data:
        return C.FRAMING_HEADER if with_header else b""
    frames, flens = split_frames(np.frombuffer(data, dtype=np.uint8), dev)
    crcs, enc, totals = encode_frames(frames, flens, level)
    with telemetry.span("read.engine", reads=3):
        crcs = crcs.cpu().numpy()
        buf, starts, totals = read_streams(enc, totals)
    with telemetry.span("engine.assemble"):
        return framing.frame_stream(data, crcs, buf, starts, totals, with_header)


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
    64 KiB rows (on the array route the array decoder, ``_decode_rows_array``),
    then (``check_integrity``) one K1 launch over the decoded rows.
    ``declared_h``: int32, one per body.  Returns (ok, out, masked CRCs or
    None, declared) on ``dev``."""
    if _array_route():
        declared = torch.from_numpy(declared_h).to(dev)
        ok, out = _decode_rows_array(arr, bodies, declared_h, dev)
    else:
        with telemetry.span("engine.stage"):
            offsets = np.zeros(len(bodies) + 1, dtype=np.int64)
            offsets[1:] = np.cumsum([hi - lo for lo, hi in bodies])
            comp = np.concatenate([arr[lo:hi] for lo, hi in bodies] + [arr[:0]])
        with telemetry.span("engine.upload"):
            declared = torch.from_numpy(declared_h).to(dev)
            comp_d, offsets_d = torch.from_numpy(comp).to(dev), torch.from_numpy(offsets).to(dev)
        out = torch.empty((len(bodies), _BLOCK), dtype=torch.uint8, device=dev)
        ok, _written = decode_chunks.decode_chunks(
            comp_d, offsets_d, declared, out, host_values=(offsets, declared_h))
    crcs = crc32c.masked_crc32c_chunks(out, declared) if check_integrity else None
    return ok, out, crcs, declared


def _decode_rows_array(
    arr: np.ndarray, bodies: List[Tuple[int, int]], declared_h: np.ndarray, dev: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The array decoder over the tag streams ``arr[lo:hi]`` of ``bodies``
    into 64 KiB rows (decode_jax.decode_chunks at u_pad 65536,
    engine.py:824-839), in slabs of rows zero-padded to the slab's longest
    body.  Returns (ok bool [N], out uint8 [N, 65536]) on ``dev``."""
    n = len(bodies)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    out = torch.empty((n, _BLOCK), dtype=torch.uint8, device=dev)
    lens = np.array([hi - lo for lo, hi in bodies], dtype=np.int64)
    step = _slab_rows(max(int(lens.max(initial=0)), _BLOCK))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        comp = np.zeros((hi - lo, max(1, int(lens[lo:hi].max()))), dtype=np.uint8)
        for k, (b_lo, b_hi) in enumerate(bodies[lo:hi]):
            comp[k, : b_hi - b_lo] = arr[b_lo:b_hi]
        out[lo:hi], ok[lo:hi], _written = decode_array.decode_chunks(
            torch.from_numpy(comp).to(dev), lens[lo:hi], declared_h[lo:hi], _BLOCK)
    return ok, out


def _crc_payloads(arr: np.ndarray, spans: List[Tuple[int, int]], dev: torch.device) -> torch.Tensor:
    """One K1 launch over the payloads ``arr[lo:hi]`` of ``spans`` (each at
    most 64 KiB), staged in zero-padded rows.  Returns uint32 on ``dev``."""
    with telemetry.span("engine.stage"):
        rows = torch.zeros((len(spans), _BLOCK), dtype=torch.uint8)
        rows_h = rows.numpy()
        for k, (lo, hi) in enumerate(spans):
            rows_h[k, : hi - lo] = arr[lo:hi]
        lens = torch.tensor([hi - lo for lo, hi in spans], dtype=torch.int32)
    with telemetry.span("engine.upload"):
        rows, lens = rows.to(dev), lens.to(dev)
    return crc32c.masked_crc32c_chunks(rows, lens)


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
    with telemetry.span("engine.decode"):
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
        with telemetry.span("engine.stage"):  # the walk, and the stored chunks' payloads
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
            with telemetry.span("read.engine", reads=3 if check_integrity else 2):
                ok = ok.cpu().numpy()
                if check_integrity:
                    crcs = crcs.cpu().numpy()
                out_h = out.cpu().numpy()
            with telemetry.span("engine.assemble"):
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
            got = _crc_payloads(arr, [(lo, hi) for _, lo, hi, _ in ucrc_jobs], dev)
            with telemetry.span("read.engine", reads=1):
                got = got.cpu().numpy()
            with telemetry.span("engine.assemble"):
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
    with telemetry.span("engine.scan"):
        chunks = framing.scan_frames(data, start)
    if chunks is None:
        # Distinguish the unskippable-reserved case for error parity.
        return None, framing.scan_failure_reason(data, start)
    total = sum(c.uncompressed_len for c in chunks)
    if total > max_size:
        return None, "too_large"
    if host:
        return host_codec.framed_uncompress_scanned(data, chunks, check_integrity)
    out_arr = np.empty((total,), dtype=np.uint8)
    written, reason = _framed_uncompress_device(data, chunks, check_integrity, out_arr, dev)
    if written is None:
        return None, reason
    with telemetry.span("engine.tobytes"):
        return out_arr[:written].tobytes(), "ok"
