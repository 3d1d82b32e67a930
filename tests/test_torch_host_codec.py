"""The port's native host runtime against the JAX package's.

The port's C sources, the library's and the sanitizer and fuzz drivers,
are byte-identical copies of snappy_tpu's, and its
raw block scan (``scan_raw_blocks``, with the parallel speculative scan
above ``_PAR_SCAN_MIN``) returns the JAX package's offsets, or None where
it does, on split streams, on streams with an op across a 64 KiB output
boundary and on malformed streams.
"""

import random
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from snappy_tpu import engine  # noqa: E402
from snappy_tpu.formats import varint  # noqa: E402
from snappy_tpu.ops import host_codec as jax_host  # noqa: E402

from snappy_tpu_torch.ops import host_codec  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402
from snappy_tpu_torch.testing.payloads import copy2, literal  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", host_codec.SOURCES + host_codec.DRIVERS)
def test_native_sources_are_byte_identical(name):
    ours = (REPO / "snappy_tpu_torch" / "ops" / "native" / name).read_bytes()
    assert ours == (REPO / "snappy_tpu" / "ops" / "native" / name).read_bytes()


def raw(data: bytes, level: int = 1):
    enc = engine.raw_compress(data, backend="host", level=level)
    declared, read = varint.decode_uint32(enc)
    return enc[read:], declared


def both(body: bytes, declared: int):
    ours = host_codec.scan_raw_blocks(body, declared)
    want = jax_host.scan_raw_blocks(body, declared)
    if want is None:
        assert ours is None
    else:
        assert ours is not None and np.array_equal(ours, want)
    return ours


@pytest.mark.parametrize("size,level", [(65537, 1), (200_000, 1), (300_000, 2), (5 * 65536, 1)])
def test_split_streams(size, level):
    body, declared = raw(payloads.mixed_payload(size, seed=size % 7), level)
    offs = both(body, declared)
    assert offs is not None and len(offs) - 1 == -(-size // 65536)
    assert offs[0] == 0 and offs[-1] == len(body)


@pytest.mark.parametrize("op", ["literal", "copy"])
def test_op_straddling_a_boundary_is_refused(op):
    p = payloads.mixed_payload(100_000, seed=2)
    if op == "literal":
        body = raw(p[:65000])[0] + literal(p[65000:66000]) + raw(p[66000:])[0]
    else:
        body = raw(p[:65530])[0] + copy2(100, 20) + raw(p[65550:])[0]
    assert both(body, len(p)) is None


def test_malformed_streams():
    body, declared = raw(payloads.mixed_payload(150_000, seed=4))
    cases = [(body[:-5], declared), (body, declared + 1), (body, declared - 1), (b"\xfc", 70_000), (body, 0)]
    rng = random.Random(3)
    for _ in range(4):
        b = bytearray(body)
        b[rng.randrange(len(b))] ^= 0xFF
        cases.append((bytes(b), declared))
    for b, d in cases:
        both(b, d)
    assert host_codec.scan_raw_blocks(body[:-5], declared) is None


def test_parallel_scan_above_threshold():
    """A body above _PAR_SCAN_MIN takes the parallel speculative scan."""
    size = host_codec._PAR_SCAN_MIN + (1 << 20)
    body, declared = raw(payloads._random(payloads.Rand(9), size).tobytes())
    assert len(body) >= host_codec._PAR_SCAN_MIN
    offs = both(body, declared)
    assert offs is not None and len(offs) - 1 == -(-size // 65536)
    bad = bytearray(body)
    bad[len(bad) // 2] = 0xFC  # a 4-byte literal length far past the end
    both(bytes(bad), declared)
