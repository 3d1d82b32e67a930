"""Derive the array route's pinned digests from the JAX package on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/pin_array_digests.py

Prints the length and SHA-256 of the JAX package's framed and raw streams
of ``snappy_tpu_torch.testing.payloads.mixed_payload()`` on its array
route (``SNAPPY_TPU_DEVICE_KERNEL=xla``, ``backend="device"``): the values
of ``payloads.FRAMED_XLA_SHA256`` / ``FRAMED_XLA_LEN`` and
``RAW_XLA_SHA256`` / ``RAW_XLA_LEN``.  The level is not passed: the route
ignores it.

Both formats encode every 64 KiB block on its own, so the script encodes
the payload in pieces of ``--frames`` blocks and joins them: the framed
stream is the stream identifier and each piece's chunks, the raw stream
the payload's varint and each piece's block streams.  That gives the
bytes of one call over the whole payload with a fraction of its memory
(about 14.5 GB of host memory for the whole 48 MiB at once).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

os.environ["SNAPPY_TPU_DEVICE_KERNEL"] = "xla"
os.environ.pop("SNAPPY_TPU_SCALAR_INTERPRET", None)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from snappy_tpu import engine  # noqa: E402
from snappy_tpu.formats import constants as C  # noqa: E402
from snappy_tpu.formats import varint  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402


def array_streams(payload: bytes, frames: int):
    """(framed, raw) streams of ``payload`` on the JAX array route, in
    pieces of ``frames`` blocks."""
    step = frames * C.MAX_BLOCK_LEN
    framed = [C.FRAMING_HEADER]
    raw = [varint.encode_uint32(len(payload))]
    for lo in range(0, len(payload), step):
        piece = payload[lo : lo + step]
        framed.append(engine.framed_compress(piece, with_header=False, backend="device"))
        raw.append(payloads.body_of(engine.raw_compress(piece, backend="device")))
    return b"".join(framed), b"".join(raw)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=32, help="64 KiB blocks a piece")
    args = ap.parse_args()
    assert not engine._use_scalar_kernels(), "the JAX engine is not on its array route"
    t = time.perf_counter()
    framed, raw = array_streams(payloads.mixed_payload(), args.frames)
    for name, s in (("FRAMED_XLA", framed), ("RAW_XLA", raw)):
        print(f'{name}_LEN = {len(s)}')
        print(f'{name}_SHA256 = "{hashlib.sha256(s).hexdigest()}"')
    print(f"# {time.perf_counter() - t:.1f} s")


if __name__ == "__main__":
    main()
