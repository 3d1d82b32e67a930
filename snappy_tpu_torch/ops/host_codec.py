"""The native host runtime: the host backend's raw and framed encode and
decode, the raw tag-stream block scan, the framed header scan, the host C
block encoder, the host C tag decoder and the host C masked CRC32C.

JAX counterpart: snappy_tpu/ops/host_codec.py: its build, ``raw_compress``
(2 MiB spans on a thread pool), ``decode_tags`` and ``decode_tags_into``,
``scan_raw_blocks`` with the parallel ``_scan_blocks``,
``decode_raw_body_into`` (block-parallel where the scan proves it),
``raw_uncompress``, ``framed_compress`` and ``framed_compress_into``,
``framed_uncompress_scanned`` with ``_run_decode_jobs``, the resumable
``framed_resume_decode``, ``scan_frames_records`` and the sanitizer build
(``sanitize_flags``).  The C sources in ``native/``, the library's and the
two test drivers (``DRIVERS``), are byte-identical copies of
``snappy_tpu/ops/native/*.c`` (a test pins them).

``cc -O3 -march=native -fPIC`` compiles them, as the JAX package does
by default, plus ``sanitize_flags()`` and ``SNAPPY_TPU_TORCH_CFLAGS``, and
``cc -shared`` links them at first use, into ``build/snappy_tpu_torch/``
through ``_build._build`` (named by a hash of the sources, the commands
and the CPU, under the kernels' file lock); ctypes loads the result.
Unlike the JAX module, a failed build raises: the host backend, the batch
decoder and the frame scan need the library, and no caller reroutes
around it.  The native CRC
is always there, so the JAX module's ``crc32c_native.using_native()``
checks have no counterpart.  ctypes calls release the GIL, so the spans,
slabs and segments run on host threads.
"""

from __future__ import annotations

import ctypes
import functools
import os
import platform
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..formats import constants as C
from ..formats import framing, varint
from . import _build

NATIVE = Path(__file__).parent / "native"
SOURCES = ("snappy_codec.c", "crc32c.c")
# Test drivers beside the library, not in it (testing/sanitize.py builds them).
DRIVERS = ("sanitize_driver.c", "fuzz_driver.c")

# The parallel (speculative) scan pays above ~4 MB of compressed body
# (host_codec.py:343-349), and so does the block-parallel decode, whose
# scan is most of its time; the span cap keeps per-span output sums in
# uint32.
_PAR_SCAN_MIN = 4 << 20
_PAR_DECODE_MIN = _PAR_SCAN_MIN
_SCAN_SPAN_MAX = 32 << 20
# Encode work per task: 32 blocks = 2 MiB (host_codec.py:261-264).
_SPAN_BLOCKS = 32
_SPAN = _SPAN_BLOCKS * C.MAX_BLOCK_LEN
# Worst case of one framed chunk: 8 framing bytes and the verbatim frame.
_FRAME_CAP = 8 + C.MAX_UNCOMPRESSED_FRAME_DATA_LEN

_P = ctypes.c_void_p
_S = ctypes.c_size_t
_L = ctypes.c_long
_ARGS = {
    "stpu_raw_scan_blocks": (_L, [_P, _S, _S, _P, _L]),
    "stpu_scan_span_index": (None, [_P, _S, ctypes.c_int64, ctypes.c_int64, _P, _P, _L, _P, _P, _P, _P]),
    "stpu_raw_scan_stitch": (_L, [_P, _S, _S, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L]),
    "stpu_decode_raw_segments": (ctypes.c_int, [_P, _P, _L, _L, _P, _S]),
    "stpu_scan_frames": (_L, [_P, _S, _S, _P, _S]),
    "stpu_framed_count": (_L, [_P, _S, _S]),
    "stpu_framed_walk": (_L, [
        _P, _S, _S, ctypes.c_uint64, ctypes.c_int, _P, _P, _P, _P, _P, _P, _L, _P, _P, _P,
    ]),
    "stpu_encode_block": (ctypes.c_uint32, [_P, ctypes.c_uint32, _P, _P]),
    "stpu_encode_block_l2": (ctypes.c_uint32, [_P, ctypes.c_uint32, _P, _P]),
    "stpu_encode_span_level": (_S, [_P, _S, _P, ctypes.c_int]),
    "stpu_encode_framed_slab_level": (_S, [_P, _S, _S, _P, ctypes.c_int]),
    "stpu_decode_tags": (ctypes.c_int, [_P, _S, _P, _S, _P]),
    "stpu_decode_framed_slab": (ctypes.c_int, [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P, ctypes.c_int]),
    "snappy_tpu_masked_crc32c": (ctypes.c_uint32, [_P, _S]),
}


def _cpu_id() -> str:
    """What ``-march=native`` reads: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo") as f:
            return "".join(sorted({ln for ln in f if ln.startswith(("model name", "flags"))}))
    except OSError:
        return platform.processor()


def sanitize_flags() -> List[str]:
    """ASan+UBSan build flags where ``SNAPPY_TPU_TORCH_SANITIZE`` is set
    (the counterpart of ``SNAPPY_TPU_SANITIZE``, host_codec.py:59-72), else
    none.  ``lib()`` and ``_build.twin_lib()`` compile and link with them;
    a process loads such a library only with libasan preloaded
    (``testing/sanitize.py`` runs the suites so)."""
    if not os.environ.get("SNAPPY_TPU_TORCH_SANITIZE"):
        return []
    return ["-fsanitize=address,undefined", "-fno-sanitize-recover=all", "-g"]


def build_cmds() -> Tuple[List[str], List[str]]:
    """The native library's compile and link commands, with the sanitizer
    flags and ``SNAPPY_TPU_TORCH_CFLAGS`` (split on spaces; the
    counterpart of ``SNAPPY_TPU_CFLAGS``, host_codec.py:80)."""
    cc = os.environ.get("CC", "cc")
    flags = sanitize_flags() + os.environ.get("SNAPPY_TPU_TORCH_CFLAGS", "").split()
    return [cc, "-O3", "-march=native", "-fPIC", *flags], [cc, "-shared", *flags]


def library_path() -> Path:
    """Build the native library unless it is there; its path.  A
    sanitized build is named ``host_codec_san_<hash>.so``."""
    compile_cmd, link_cmd = build_cmds()
    return _build._build(
        "host_codec_san" if sanitize_flags() else "host_codec", compile_cmd, link_cmd,
        [NATIVE / f for f in SOURCES], salt=_cpu_id(),
    )


@functools.cache
def lib() -> ctypes.CDLL:
    """The native library; raises if it cannot be built."""
    dll = ctypes.CDLL(str(library_path()))
    for name, (restype, argtypes) in _ARGS.items():
        fn = getattr(dll, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return dll


_scratch = threading.local()


def _scratch_buf(size: int) -> np.ndarray:
    """A grow-only buffer of the thread (no page faults from fresh
    allocations on the hot encode path)."""
    buf = getattr(_scratch, "buf", None)
    if buf is None or buf.size < size:
        buf = _scratch.buf = np.empty((max(size, 1 << 20),), dtype=np.uint8)
    return buf


def _arena_buf(size: int) -> np.ndarray:
    """The thread's payload-scale staging arena: grows to fit, and is made
    anew when a request is under a quarter of it (one 1 GiB call does not
    pin 1 GiB for the life of the process)."""
    buf = getattr(_scratch, "arena", None)
    if buf is None or buf.size < size or buf.size > 4 * size:
        buf = _scratch.arena = np.empty((size,), dtype=np.uint8)
    return buf


@functools.cache
def _pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max_workers=min(32, os.cpu_count() or 4))


def _scan_blocks(src: np.ndarray, declared: int, in_offs: np.ndarray,
                 cap: int, n_workers: int) -> int:
    """Locate the 64 KiB output-block boundaries of a raw tag stream (the
    parallel speculative scan for large bodies, one sequential pass
    otherwise).  Returns the segment count, or < 0 (see
    stpu_raw_scan_blocks)."""
    dll = lib()
    n = int(src.size)
    if n < _PAR_SCAN_MIN or n_workers < 2:
        return dll.stpu_raw_scan_blocks(src.ctypes.data, n, declared, in_offs.ctypes.data, cap)
    nspans = max(n_workers, -(-n // _SCAN_SPAN_MAX))
    span_lo = np.array([n * k // nspans for k in range(nspans + 1)], np.int64)
    # Every 8th op is recorded and ops take >= 2 input bytes: a hard bound.
    caps = [(int(span_lo[k + 1] - span_lo[k]) // 16) + 2 for k in range(nspans)]
    rec_off = np.zeros((nspans + 1,), np.int64)
    np.cumsum(caps, out=rec_off[1:])
    pos = np.empty((int(rec_off[-1]),), np.uint32)
    cum = np.empty((int(rec_off[-1]),), np.uint32)
    n_rec = np.zeros((nspans,), np.int64)
    exit_pos = np.zeros((nspans,), np.int64)
    exit_cum = np.zeros((nspans,), np.int64)
    errs = np.zeros((nspans,), np.int32)

    def index_span(k: int) -> None:
        dll.stpu_scan_span_index(
            src.ctypes.data, n, int(span_lo[k]), int(span_lo[k + 1]),
            pos.ctypes.data + 4 * int(rec_off[k]), cum.ctypes.data + 4 * int(rec_off[k]),
            caps[k], n_rec.ctypes.data + 8 * k, exit_pos.ctypes.data + 8 * k,
            exit_cum.ctypes.data + 8 * k, errs.ctypes.data + 4 * k,
        )

    list(_pool().map(index_span, range(nspans)))
    return dll.stpu_raw_scan_stitch(
        src.ctypes.data, n, declared, nspans, span_lo.ctypes.data, pos.ctypes.data,
        cum.ctypes.data, rec_off.ctypes.data, n_rec.ctypes.data, exit_pos.ctypes.data,
        exit_cum.ctypes.data, errs.ctypes.data, in_offs.ctypes.data, cap,
    )


def encode_block(data, level: int = 1) -> bytes:
    """The host C encoding of one block of at most 64 KiB (any buffer), no
    varint header: ``stpu_encode_block`` at level 1, ``stpu_encode_block_l2``
    (two-way buckets) at level >= 2.  These are the bytes that the block
    encoder kernel (K3) must give."""
    src = np.frombuffer(data, dtype=np.uint8)
    n = len(src)
    if n > C.MAX_BLOCK_LEN:
        raise ValueError("a block holds at most 65536 bytes")
    # max_compressed_len plus the 16 bytes a short literal's burst may write
    out = np.empty((C.max_compressed_len(n) + 16,), dtype=np.uint8)
    table = np.empty((2 << 14,), dtype=np.uint16)
    fn = lib().stpu_encode_block_l2 if level >= 2 else lib().stpu_encode_block
    return out[: fn(src.ctypes.data, n, out.ctypes.data, table.ctypes.data)].tobytes()


def decode_tags(body, out_len: int) -> Tuple[Optional[bytes], int]:
    """The host C decoder (``stpu_decode_tags``) on one raw tag stream (no
    varint header) into at most ``out_len`` bytes: (the output, written),
    or (None, 0) for a malformed stream, as
    ``snappy_tpu.ops.host_codec.decode_tags`` gives them.  The chunk
    decoder (K2) says ok exactly when this gives bytes and written equals
    ``out_len``, and then the same bytes."""
    src = np.frombuffer(bytes(body), dtype=np.uint8)
    out = np.empty((out_len,), dtype=np.uint8)
    written = ctypes.c_size_t(0)
    rc = lib().stpu_decode_tags(
        src.ctypes.data if len(src) else None, len(src),
        out.ctypes.data if out_len else None, out_len, ctypes.byref(written),
    )
    if rc != 0:
        return None, 0
    return out[: written.value].tobytes(), written.value


def masked_crc32c(data) -> int:
    """The host C masked CRC32C (``snappy_tpu_masked_crc32c``) of any
    buffer: the value that the CRC kernel (K1) must give for it."""
    src = np.frombuffer(data, dtype=np.uint8)
    return int(lib().snappy_tpu_masked_crc32c(src.ctypes.data if len(src) else None, len(src)))


def scan_raw_blocks(body: bytes, declared: int) -> Optional[np.ndarray]:
    """Locate the 64 KiB output-block boundaries of a raw tag stream.

    Returns int64 ``in_offs`` with nseg + 1 entries (``in_offs[k]`` = body
    offset of output byte ``k * 65536``, ``in_offs[nseg] = len(body)``),
    or None when the stream is malformed or cannot be split there (an op
    straddles a boundary).  The scan proves the tag-alignment half of the
    split; the chunk decoder's offset > written check proves that no copy
    reaches across a boundary."""
    if declared <= 0:
        return None
    src = np.frombuffer(body, dtype=np.uint8)
    cap = declared // C.MAX_BLOCK_LEN + 2
    in_offs = np.empty((cap,), dtype=np.int64)
    nseg = _scan_blocks(src, declared, in_offs, cap, min(32, os.cpu_count() or 1))
    if nseg < 1:
        return None
    return in_offs[: nseg + 1]


def scan_frames_prefix(data, start: int = 0) -> Tuple[np.ndarray, bool]:
    """The framed-header scan (stpu_scan_frames) in one C pass: int64
    [n, 4] records (id, header_pos, data_len, uncompressed_len) of the
    longest run of whole, valid chunks from ``start`` on (the rules of
    ``formats.framing.scan_frames``), and whether that run reaches the end
    of the stream.  Where it does not, the chunk after the last record is
    the first malformed one: the C scan writes each record before it reads
    the next header, so the records written before it failed are the
    run."""
    buf = data if isinstance(data, np.ndarray) else np.frombuffer(data, dtype=np.uint8)
    n = len(buf)
    dll = lib()
    # The scan records at most the chunks whose payload fits, which
    # stpu_framed_count counts, and stops at the next one.
    cap = dll.stpu_framed_count(buf.ctypes.data, n, start) + 1
    rec = np.empty((cap, 4), dtype=np.int64)
    rec[:, 0] = -1
    r = dll.stpu_scan_frames(buf.ctypes.data, n, start, rec.ctypes.data, cap)
    if r >= 0:
        return rec[:r], True
    return rec[: int(np.argmax(rec[:, 0] < 0))], False


def scan_frames_records(data, start: int = 0) -> Optional[np.ndarray]:
    """The records of ``scan_frames_prefix`` when every chunk from
    ``start`` on is valid, else None."""
    rec, whole = scan_frames_prefix(data, start)
    return rec if whole else None


# ---------------------------------------------------------------------------
# The host backend: whole payloads on the host threads
# ---------------------------------------------------------------------------


def _spans(n: int) -> List[Tuple[int, int]]:
    return [(s, min(n, s + _SPAN)) for s in range(0, n, _SPAN)]


def _fan_out(fn, items) -> list:
    """``fn`` over ``items``: on the pool where there are several."""
    items = list(items)
    if len(items) <= 1:
        return [fn(x) for x in items]
    return list(_pool().map(fn, items))


def raw_compress(data, level: int = 1) -> Optional[bytes]:
    """Raw-format compress on the host threads: the varint header, then
    each 2 MiB span's block tag streams (``stpu_encode_span_level``).
    Level 1 is the greedy matcher, level >= 2 the two-way buckets; the
    bytes equal the block encoder kernel's (K3).  None for input over
    MAX_UNCOMPRESSED_LEN."""
    dll = lib()
    n = len(data)
    if n > C.MAX_UNCOMPRESSED_LEN:
        return None
    header = varint.encode_uint32(n)
    if n == 0:
        return header
    buf = np.frombuffer(data, dtype=np.uint8)

    def work(span: Tuple[int, int]) -> bytes:
        lo, hi = span
        out = _scratch_buf(C.max_compressed_len(C.MAX_BLOCK_LEN) * -(-(hi - lo) // C.MAX_BLOCK_LEN))
        written = dll.stpu_encode_span_level(buf[lo:].ctypes.data, hi - lo, out.ctypes.data, level)
        return out[:written].tobytes()

    return header + b"".join(_fan_out(work, _spans(n)))


def decode_tags_into(body, out_len: int, out_arr: np.ndarray) -> bool:
    """Decode one raw tag stream (no varint header) straight into
    ``out_arr``: True iff it is valid and gives exactly ``out_len`` bytes
    (the raw format's written == declared rule, snappy.nim:107-108)."""
    if out_arr.dtype != np.uint8 or out_arr.size < out_len:
        raise ValueError(f"out_arr must be uint8 with room for {out_len} bytes")
    src = np.frombuffer(body, dtype=np.uint8)
    written = ctypes.c_size_t(0)
    rc = lib().stpu_decode_tags(
        src.ctypes.data if len(src) else None, len(src),
        out_arr.ctypes.data if out_len else None, out_len, ctypes.byref(written),
    )
    return rc == 0 and written.value == out_len


def decode_raw_body_into(body, declared: int, out_arr: np.ndarray) -> bool:
    """Decode one raw tag stream into ``out_arr``: block-parallel over the
    host threads where the body is large and the scan splits it at its
    64 KiB output blocks (``stpu_decode_raw_segments``), else sequential.
    True iff the stream is valid and gives exactly ``declared`` bytes.  A
    failing segment (a copy that legally reaches across a block boundary,
    which no block encoder emits) falls back to the sequential decoder,
    which is authoritative for both the bytes and the verdict."""
    if out_arr.dtype != np.uint8 or out_arr.size < declared:
        raise ValueError(f"out_arr must be uint8 with room for {declared} bytes")
    dll = lib()
    src = np.frombuffer(body, dtype=np.uint8)
    n_workers = min(32, os.cpu_count() or 1)
    if src.size >= _PAR_DECODE_MIN and n_workers > 1:
        cap = declared // C.MAX_BLOCK_LEN + 2
        in_offs = np.empty((cap,), dtype=np.int64)
        nseg = _scan_blocks(src, declared, in_offs, cap, n_workers)
        if nseg >= 2:
            slab = -(-nseg // (n_workers * 4))

            def work(lo: int) -> int:
                return dll.stpu_decode_raw_segments(
                    src.ctypes.data, in_offs.ctypes.data, lo, min(nseg, lo + slab),
                    out_arr.ctypes.data, declared,
                )

            if all(rc == 0 for rc in _fan_out(work, range(0, nseg, slab))):
                return True
    return decode_tags_into(body, declared, out_arr)


def raw_uncompress(data, max_size: int) -> Tuple[Optional[bytes], str]:
    """Raw-format uncompress on the host: (payload, "ok") or (None,
    reason), reason in {"invalid", "too_large"}, with the device path's
    validation: the sizing varint is read as uint64 (codec.nim:129-138),
    the decode's own as the stricter 5-byte uint32 (snappy.nim:92)."""
    declared64, _ = varint.decode_uint64(data)
    if declared64 is None or declared64 > C.MAX_UNCOMPRESSED_LEN:
        return None, "invalid"
    if declared64 > max_size:
        return None, "too_large"
    declared, read = varint.decode_uint32(data)
    if declared is None:
        return None, "invalid"
    body = memoryview(data)[read:]
    if declared == 0:
        return (b"", "ok") if len(body) == 0 else (None, "invalid")
    out = np.empty((declared,), dtype=np.uint8)
    if not decode_raw_body_into(body, declared, out):
        return None, "invalid"
    return out.tobytes(), "ok"


def framed_compress(data, with_header: bool = True, level: int = 1) -> bytes:
    """Framed-format compress on the host threads: per 64 KiB frame, the
    masked CRC and the compressed payload if it saves >= 1/8, else the
    verbatim payload (encoder.nim:385-426), the whole loop in C per 2 MiB
    slab (``stpu_encode_framed_slab_level``)."""
    dll = lib()
    n = len(data)
    head = C.FRAMING_HEADER if with_header else b""
    if n == 0:
        return head
    buf = np.frombuffer(data, dtype=np.uint8)

    def work(span: Tuple[int, int]) -> bytes:
        lo, hi = span
        out = _scratch_buf(-(-(hi - lo) // C.MAX_BLOCK_LEN) * _FRAME_CAP)
        written = dll.stpu_encode_framed_slab_level(buf.ctypes.data, lo, hi, out.ctypes.data, level)
        return out[:written].tobytes()

    return head + b"".join(_fan_out(work, _spans(n)))


def framed_compress_into(data, out_arr: np.ndarray, with_header: bool = True,
                         level: int = 1) -> Optional[int]:
    """Framed compress straight into ``out_arr`` (uint8): the length
    written, or None where ``out_arr`` is shorter than
    ``max_compressed_len_framed(len(data))``, which bounds what the slabs
    can write.  The slabs compress in
    parallel into the thread's staging arena at fixed worst-case offsets,
    then move to their final offsets in parallel (``ctypes.memmove``
    releases the GIL)."""
    dll = lib()
    n = len(data)
    if out_arr.dtype != np.uint8:
        raise ValueError("out_arr must be uint8")
    if out_arr.size < C.max_compressed_len_framed(n):
        return None
    pos = 0
    if with_header:
        out_arr[: len(C.FRAMING_HEADER)] = np.frombuffer(C.FRAMING_HEADER, np.uint8)
        pos = len(C.FRAMING_HEADER)
    if n == 0:
        return pos
    buf = np.frombuffer(data, dtype=np.uint8)
    spans = _spans(n)
    span_cap = _SPAN_BLOCKS * _FRAME_CAP
    arena = _arena_buf(span_cap * len(spans))

    def work(k: int) -> int:
        lo, hi = spans[k]
        return dll.stpu_encode_framed_slab_level(
            buf.ctypes.data, lo, hi, arena.ctypes.data + k * span_cap, level)

    lens = _fan_out(work, range(len(spans)))
    offsets = np.cumsum([pos] + lens).tolist()
    assert offsets[-1] <= out_arr.size, "framed slabs above their worst case"

    def move(k: int) -> None:
        ctypes.memmove(out_arr.ctypes.data + offsets[k], arena.ctypes.data + k * span_cap, lens[k])

    _fan_out(move, range(len(spans)))
    return offsets[-1]


def framed_uncompress_scanned(
    data, chunks: List[framing.ChunkInfo], check_integrity: bool = True,
    out: Optional[np.ndarray] = None,
) -> Tuple[Optional[bytes], str]:
    """Decode scanned chunks (``framing.scan_frames``) on the host
    threads, each at its final offset of one output buffer (``out`` where
    the caller gives one, else a new one), whole slabs of chunks through
    the native decode and CRC loop (snappy.nim:199-265).  Returns
    (payload, "ok"), or (b"", "ok") with the payload in ``out`` where the
    caller gave it, or (None, reason) with reason in {"invalid", "crc",
    "unknown_chunk"}: the earliest bad chunk's."""
    buf = np.frombuffer(data, dtype=np.uint8)
    total = sum(ch.uncompressed_len for ch in chunks)
    caller_buffer = out is not None
    if not caller_buffer:
        out = np.empty((total,), dtype=np.uint8)
    elif out.dtype != np.uint8 or out.size < total:
        raise ValueError(f"out must be uint8 with room for {total} bytes")
    jobs = []  # (kind, src_off, src_len, declared, out_off, stored_crc)
    pos = 0
    for ch in chunks:
        if ch.id in (C.CHUNK_COMPRESSED, C.CHUNK_UNCOMPRESSED):
            if ch.data_len < 4:
                return None, "invalid"
            stored = int.from_bytes(buf[ch.data_pos : ch.data_pos + 4].tobytes(), "little")
            lo, n = ch.data_pos + 4, ch.data_len - 4
            if ch.id == C.CHUNK_COMPRESSED:
                declared, read = varint.decode_uint32(buf[lo : lo + min(5, n)])
                if declared is None or declared > C.MAX_UNCOMPRESSED_FRAME_DATA_LEN:
                    return None, "invalid"
                jobs.append((0, lo + read, n - read, declared, pos, stored))
                pos += declared
            else:
                jobs.append((1, lo, n, n, pos, stored))
                pos += n
        elif ch.id != C.CHUNK_STREAM_HEADER and ch.id < C.CHUNK_RESERVED_SKIPPABLE_LO:
            return None, "unknown_chunk"
    if not jobs:
        return b"", "ok"
    cols = np.array(jobs, dtype=np.int64)
    reason = _run_decode_jobs(
        buf, cols[:, 0].astype(np.uint8), *(np.ascontiguousarray(cols[:, k]) for k in (1, 2, 3, 4)),
        cols[:, 5].astype(np.uint32), len(jobs), out, check_integrity,
    )
    if reason != "ok":
        return None, reason
    return (b"", "ok") if caller_buffer else (out[:total].tobytes(), "ok")


def _run_decode_jobs(buf: np.ndarray, kinds, src_off, src_len, declared, out_off, stored,
                     nj: int, out: np.ndarray, check_integrity: bool) -> str:
    """The chunk jobs in slabs over the host threads through the native
    loop (``stpu_decode_framed_slab``: decode or copy, then the CRC, each
    written at its final offset).  Returns "ok", "invalid" or "crc": the
    first failing slab's, which holds the earliest failing chunk."""
    dll = lib()
    slab = -(-nj // (min(32, os.cpu_count() or 4) * 4))

    def work(lo: int) -> int:
        return dll.stpu_decode_framed_slab(
            buf.ctypes.data, kinds.ctypes.data + lo, src_off.ctypes.data + 8 * lo,
            src_len.ctypes.data + 8 * lo, declared.ctypes.data + 8 * lo,
            out_off.ctypes.data + 8 * lo, stored.ctypes.data + 4 * lo,
            min(nj, lo + slab) - lo, out.ctypes.data, 1 if check_integrity else 0,
        )

    for rc in _fan_out(work, range(0, nj, slab)):
        if rc == 1:
            return "invalid"
        if rc == 2:
            return "crc"
    return "ok"


_WALK_STATUS = {0: "ok", 1: "ok", 2: "invalid", 3: "crc", 4: "unknown_chunk"}


def framed_resume_decode(
    data, start: int, out: np.ndarray, budget: int, check_integrity: bool = True,
) -> Tuple[Optional[int], int, str]:
    """The reference's resumable walk (snappy.nim:199-265), all native:
    one C pass (``stpu_framed_walk``) checks the chunk headers from
    ``start`` on and stops at the first chunk that does not fit
    ``budget``, then the taken prefix decodes into ``out`` at its final
    offsets on the host threads.  Returns (read, written, "ok"), or (None,
    0, reason) with reason in {"invalid", "crc", "unknown_chunk"}.  A
    decode or CRC failure in the taken prefix wins over a failure the
    walk found after it."""
    dll = lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    cap = dll.stpu_framed_count(buf.ctypes.data, len(buf), start) + 1
    kinds = np.empty((cap,), np.uint8)
    src_off, src_len, declared, out_off = (np.empty((cap,), np.int64) for _ in range(4))
    stored = np.empty((cap,), np.uint32)
    status, read_end, total = ctypes.c_int(0), ctypes.c_int64(0), ctypes.c_int64(0)
    nj = dll.stpu_framed_walk(
        buf.ctypes.data, len(buf), start, budget, 1 if check_integrity else 0,
        kinds.ctypes.data, src_off.ctypes.data, src_len.ctypes.data, declared.ctypes.data,
        out_off.ctypes.data, stored.ctypes.data, cap,
        ctypes.byref(status), ctypes.byref(read_end), ctypes.byref(total),
    )
    if nj > 0:
        if out.dtype != np.uint8 or out.size < total.value:
            raise ValueError(f"out must be uint8 with room for {total.value} bytes")
        reason = _run_decode_jobs(buf, kinds, src_off, src_len, declared, out_off, stored,
                                  nj, out, check_integrity)
        if reason != "ok":
            return None, 0, reason
    reason = _WALK_STATUS[status.value]
    if reason != "ok":
        return None, 0, reason
    return int(read_end.value), int(total.value), "ok"
