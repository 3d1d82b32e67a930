"""In-memory public API of the port: the framed format.

JAX counterpart: snappy_tpu/api.py.  This slice ports the framed
conveniences ``encode_framed`` and ``decode_framed`` (snappy.nim:157-167,
269-290) and the sizing helpers; the raw format, the ``*_into`` calls and
the batch calls come with later slices (ROADMAP queue 1 items 5 and 7).

Every call takes ``device`` (``cuda`` by default; ``cpu`` runs the
kernels' plain versions).  ``decode_framed`` returns ``b""`` on any
failure, as the reference's seq-returning functions do.
"""

from __future__ import annotations

from . import config, engine
from .formats import constants as C
from .formats import framing


def encode_framed(data: bytes, level: int = 1, device: config.DeviceLike = None) -> bytes:
    """Compress to the framed format with per-chunk masked CRC32C
    (snappy.nim:157-167).  Only ``level=1`` is ported; ``level >= 2``
    raises ``ValueError``."""
    return engine.framed_compress(bytes(data), level=level, device=device)


def decode_framed(
    data: bytes,
    max_size: int = C.MAX_UNCOMPRESSED_LEN,
    check_integrity: bool = True,
    device: config.DeviceLike = None,
) -> bytes:
    """Decompress a framed stream; ``b""`` on any failure
    (snappy.nim:269-290)."""
    out, _reason = engine.framed_uncompress(
        bytes(data), max_size, check_integrity, device=device
    )
    return out if out is not None else b""


def uncompressed_len_framed(data: bytes):
    """Total decoded size of a framed stream, or None when malformed
    (codec.nim:178-214)."""
    return framing.uncompressed_len_framed(data)


def is_framed_stream(data: bytes) -> bool:
    return framing.is_snappy_framed_stream(data)
