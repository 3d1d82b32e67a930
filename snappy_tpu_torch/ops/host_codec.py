"""The native host runtime: the raw tag-stream block scan, the framed
header scan, the host C block encoder, the host C tag decoder and the host C
masked CRC32C.

JAX counterpart: snappy_tpu/ops/host_codec.py (its build,
``scan_raw_blocks`` with the parallel ``_scan_blocks``,
host_codec.py:352-434, ``scan_frames_records``, host_codec.py:821,
``decode_tags``, host_codec.py:303, and the per-block entries under
``raw_compress``).  The C sources in ``native/`` are byte-identical copies
of ``snappy_tpu/ops/native/*.c`` (a test pins them).

``cc -O3 -fPIC`` compiles them and ``cc -shared`` links them at first
use, into ``build/snappy_tpu_torch/`` through ``_build._build``
(hash-named, under the kernels' file lock); ctypes loads the result.  Unlike the JAX
module, a failed build raises: the batch decoder and the frame scan need
the library, and no caller reroutes around it.  ctypes calls release the GIL, so the parallel
scan's spans run on host threads.
"""

from __future__ import annotations

import ctypes
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..formats import constants as C
from . import _build

NATIVE = Path(__file__).parent / "native"
SOURCES = ("snappy_codec.c", "crc32c.c")

# The parallel (speculative) scan pays above ~4 MB of compressed body
# (host_codec.py:343-349); the span cap keeps per-span output sums in
# uint32.
_PAR_SCAN_MIN = 4 << 20
_SCAN_SPAN_MAX = 32 << 20

_P = ctypes.c_void_p
_ARGS = {
    "stpu_raw_scan_blocks": (ctypes.c_long, [_P, ctypes.c_size_t, ctypes.c_size_t, _P, ctypes.c_long]),
    "stpu_scan_span_index": (None, [
        _P, ctypes.c_size_t, ctypes.c_int64, ctypes.c_int64, _P, _P,
        ctypes.c_long, _P, _P, _P, _P,
    ]),
    "stpu_raw_scan_stitch": (ctypes.c_long, [
        _P, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_long, _P, _P, _P,
        _P, _P, _P, _P, _P, _P, ctypes.c_long,
    ]),
    "stpu_scan_frames": (ctypes.c_long, [_P, ctypes.c_size_t, ctypes.c_size_t, _P, ctypes.c_size_t]),
    "stpu_framed_count": (ctypes.c_long, [_P, ctypes.c_size_t, ctypes.c_size_t]),
    "stpu_encode_block": (ctypes.c_uint32, [_P, ctypes.c_uint32, _P, _P]),
    "stpu_encode_block_l2": (ctypes.c_uint32, [_P, ctypes.c_uint32, _P, _P]),
    "stpu_decode_tags": (ctypes.c_int, [_P, ctypes.c_size_t, _P, ctypes.c_size_t, _P]),
    "snappy_tpu_masked_crc32c": (ctypes.c_uint32, [_P, ctypes.c_size_t]),
}


@functools.cache
def lib() -> ctypes.CDLL:
    """The native library; raises if it cannot be built."""
    cc = os.environ.get("CC", "cc")
    so = _build._build(
        "host_codec", [cc, "-O3", "-fPIC"], [cc, "-shared"], [NATIVE / f for f in SOURCES]
    )
    dll = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _ARGS.items():
        fn = getattr(dll, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return dll


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
