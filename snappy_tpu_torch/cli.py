"""Command-line utility: compress or decompress files with the port.

JAX counterpart: snappy_tpu/cli.py, with the same flags and one more,
``--device`` (``cuda`` by default; ``cpu`` runs the kernels' plain
versions).  Framed files are compatible with other snappy tools (e.g.
``snzip``):

    python -m snappy_tpu_torch.cli file            # -> file.sz
    python -m snappy_tpu_torch.cli -d file.sz      # -> file
    python -m snappy_tpu_torch.cli --raw -l 2 file # -> file.rawsz
    python -m snappy_tpu_torch.cli -d --raw file.rawsz

A raw decode goes through ``api.decode``: streams over 128 KiB take the
streaming decoder that ``SNAPPY_TPU_TORCH_STREAM_MODE`` names (``grid``, the
default, or ``scan``), each in two launches where the host's block index
finds the stream's 64 KiB windows and in one launch elsewhere.
"""

from __future__ import annotations

import argparse
import sys
import time

from . import api
from .formats import framing


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="snappy_tpu_torch", description="Snappy codec on CUDA")
    from . import __version__

    p.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("--raw", action="store_true", help="use the raw block format (no framing)")
    p.add_argument("--no-crc", action="store_true", help="skip CRC verification")
    p.add_argument(
        "-l", "--level", type=int, default=1, choices=(1, 2),
        help="compression level: 1 fast (default), 2 denser",
    )
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("input")
    args = p.parse_args(argv)

    if args.input == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(args.input, "rb") as f:
            data = f.read()

    t0 = time.perf_counter()
    if args.decompress:
        if args.raw or not framing.is_snappy_framed_stream(data):
            out = api.decode(data, device=args.device)
        else:
            out = api.decode_framed(data, check_integrity=not args.no_crc, device=args.device)
        if out == b"" and len(data) > 1:
            print("error: malformed snappy input", file=sys.stderr)
            return 1
        default_name = args.input[:-3] if args.input.endswith(".sz") else args.input + ".out"
    else:
        if args.raw:
            out = api.encode(data, level=args.level, device=args.device)
        else:
            out = api.encode_framed(data, level=args.level, device=args.device)
        default_name = args.input + (".rawsz" if args.raw else ".sz")
    dt = time.perf_counter() - t0

    dest = args.output or default_name
    if dest == "-":
        sys.stdout.buffer.write(out)
    else:
        with open(dest, "wb") as f:
            f.write(out)
    if args.verbose:
        big = max(len(data), len(out))
        print(
            f"{len(data)} -> {len(out)} bytes ({len(out) / max(1, len(data)):.3f}) in "
            f"{1e3 * dt:.1f} ms ({big / dt / 1e9:.2f} GB/s)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
