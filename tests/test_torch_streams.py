"""The port's framed ``*_into`` functions and stream adapters against the
JAX package.

``uncompress_framed_into`` and ``compress_framed_into`` (api.py), the sync
adapters (streams/sync.py) and the asyncio adapters (streams/aio.py) run
on the CPU (the kernels' plain versions) and are held against the JAX
package's same functions on its host backend (the native C codec, set by
monkeypatching ``snappy_tpu.config``): the same bytes, the same
``(read, written)`` at fuzzed buffer sizes and across re-entry, the same
error reasons and the same exception types.  ``payloads.framed_vectors``
pins the expected results, which chip_smoke.py checks on the card.
"""

import asyncio
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import snappy_tpu as jax_api  # noqa: E402
from snappy_tpu import config as jax_config  # noqa: E402
from snappy_tpu.streams import aio as jax_aio  # noqa: E402
from snappy_tpu.streams import sync as jax_sync  # noqa: E402

from snappy_tpu_torch import api  # noqa: E402
from snappy_tpu_torch.formats import constants as C  # noqa: E402
from snappy_tpu_torch.formats.errors import MalformedSnappyData, UnexpectedEofError  # noqa: E402
from snappy_tpu_torch.streams import aio, sync  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

CPU = "cpu"
VECTORS = payloads.framed_vectors()
PAYLOAD = payloads.mixed_payload(200_000, seed=5)


@pytest.fixture(autouse=True)
def jax_host(monkeypatch):
    """The JAX package on its host backend for this test, restored after."""
    monkeypatch.setattr(jax_config, "_backend", "host")


@pytest.fixture(scope="module")
def stream():
    jax_config.set_backend("host")
    try:
        return jax_api.encode_framed(PAYLOAD)
    finally:
        jax_config.set_backend("auto")


def outcome(res, out):
    if res.is_ok():
        read, written = res.value
        return ("ok", read, written, bytes(out[:written]))
    return ("err", res.error.name)


@pytest.mark.parametrize("k", range(len(VECTORS)), ids=[v[0] for v in VECTORS])
def test_uncompress_framed_into_vectors(k):
    name, data, budget, check_integrity, expected = VECTORS[k]
    ours_out, jax_out = bytearray(budget), bytearray(budget)
    ours = outcome(api.uncompress_framed_into(data, ours_out, True, check_integrity, device=CPU), ours_out)
    theirs = outcome(jax_api.uncompress_framed_into(data, jax_out, True, check_integrity), jax_out)
    assert ours == theirs
    assert ours[:3] == expected if expected[0] == "ok" else ours == expected


def test_uncompress_framed_into_fuzzed_budgets(stream):
    budgets = [int(b) for b in payloads.Rand(9).ints(0, len(PAYLOAD) + 2, 10)]
    for budget in budgets + [0, 65535, 65536, len(PAYLOAD)]:
        ours_out, jax_out = bytearray(budget), bytearray(budget)
        ours = outcome(api.uncompress_framed_into(stream, ours_out, device=CPU), ours_out)
        assert ours == outcome(jax_api.uncompress_framed_into(stream, jax_out), jax_out), budget


def resume(fn, data: bytes, size: int):
    """Re-enter with data[read:], a fresh buffer and check_header=False
    until the input is used up: the (read, written) steps and the output."""
    steps, got, first = [], b"", True
    while data:
        out = bytearray(size)
        res = fn(data, out, first)
        assert res.is_ok(), res
        read, written = res.value
        steps.append((read, written))
        assert read or written, "no progress"
        got += bytes(out[:written])
        data, first = data[read:], False
    return steps, got


@pytest.mark.parametrize("size", [65536, 100_000, 1 << 17])
def test_uncompress_framed_into_resumes(stream, size):
    ours = resume(lambda d, o, h: api.uncompress_framed_into(d, o, h, device=CPU), stream, size)
    assert ours == resume(lambda d, o, h: jax_api.uncompress_framed_into(d, o, h), stream, size)
    assert ours[1] == PAYLOAD


def test_into_functions_refuse_read_only_buffers():
    for fn in (api.uncompress_framed_into, api.compress_framed_into):
        with pytest.raises(TypeError):
            fn(C.FRAMING_HEADER, memoryview(bytes(64)), device=CPU)


def test_compress_framed_into(stream):
    out = bytearray(C.max_compressed_len_framed(len(PAYLOAD)))
    res = api.compress_framed_into(PAYLOAD, out, device=CPU)
    want = jax_api.compress_framed_into(PAYLOAD, bytearray(len(out)))
    assert res.is_ok() and res.value == want.value == len(stream)
    assert bytes(out[: res.value]) == stream
    small = bytearray(len(out) - 1)
    assert api.compress_framed_into(PAYLOAD, small, device=CPU).error.name == "buffer_too_small"
    assert jax_api.compress_framed_into(PAYLOAD, small).error.name == "buffer_too_small"


def test_deprecated_aliases():
    with pytest.warns(DeprecationWarning):
        enc = api.compress(PAYLOAD[:1000], device=CPU)
    with pytest.warns(DeprecationWarning):
        assert api.uncompress(enc, device=CPU) == PAYLOAD[:1000]


# ---------------------------------------------------------------------------
# Stream adapters
# ---------------------------------------------------------------------------


class Dribble(io.RawIOBase):
    """A reader that returns at most 700 bytes a call, without readinto."""

    def __init__(self, data):
        self.data, self.pos = data, 0

    def read(self, n=-1):
        take = min(700, len(self.data) - self.pos, n if n is not None and n >= 0 else 700)
        out = self.data[self.pos : self.pos + take]
        self.pos += take
        return out


def test_sync_compress_equals_jax_and_one_shot():
    dst = io.BytesIO()
    n = sync.compress(io.BytesIO(PAYLOAD), len(PAYLOAD), dst, batch_frames=1, device=CPU)
    jdst = io.BytesIO()
    jax_sync.compress(io.BytesIO(PAYLOAD), len(PAYLOAD), jdst, batch_frames=1)
    assert dst.getvalue() == jdst.getvalue() == api.encode(PAYLOAD, device=CPU)
    assert n == len(dst.getvalue())
    assert sync.compress_bytes(PAYLOAD, device=CPU) == dst.getvalue()


def test_sync_framed_roundtrip_equals_jax(stream):
    dst = io.BytesIO()
    n = sync.compress_framed(io.BytesIO(PAYLOAD), dst, batch_frames=2, device=CPU)
    assert dst.getvalue() == stream and n == len(stream)
    jdst = io.BytesIO()
    jax_sync.compress_framed(io.BytesIO(PAYLOAD), jdst, batch_frames=2)
    assert jdst.getvalue() == stream
    assert sync.compress_framed_bytes(PAYLOAD, device=CPU) == stream
    out = io.BytesIO()
    assert sync.uncompress_framed(Dribble(stream), out, device=CPU) == len(PAYLOAD)
    assert out.getvalue() == PAYLOAD
    assert sync.uncompress_framed_bytes(stream, device=CPU) == PAYLOAD


def malformed_streams(stream):
    bad_crc = bytearray(stream)
    bad_crc[len(C.FRAMING_HEADER) + 4] ^= 0x55  # chunk 0's stored CRC
    unknown = bytearray(stream)
    unknown[len(C.FRAMING_HEADER)] = 0x40
    return {
        "bad_magic": b"not snappy framing!!",
        "short": b"\xff\x06",
        "truncated": stream[:-3],
        "bad_crc": bytes(bad_crc),
        "unknown_chunk": bytes(unknown),
    }


@pytest.mark.parametrize("name", ["bad_magic", "short", "truncated", "bad_crc", "unknown_chunk"])
def test_sync_uncompress_exceptions_equal_jax(stream, name):
    data = malformed_streams(stream)[name]
    with pytest.raises((MalformedSnappyData, UnexpectedEofError)) as ours:
        sync.uncompress_framed(io.BytesIO(data), io.BytesIO(), device=CPU)
    with pytest.raises(Exception) as theirs:
        jax_sync.uncompress_framed(io.BytesIO(data), io.BytesIO())
    assert type(ours.value).__name__ == type(theirs.value).__name__


def test_sync_uncompress_accepts_a_bad_crc_unchecked(stream):
    data = malformed_streams(stream)["bad_crc"]
    assert sync.uncompress_framed_bytes(data, check_integrity=False, device=CPU) == PAYLOAD
    assert jax_sync.uncompress_framed_bytes(data, check_integrity=False) == PAYLOAD


def test_sync_compress_short_source():
    with pytest.raises(UnexpectedEofError):
        sync.compress(io.BytesIO(b"too short"), 14, io.BytesIO(), device=CPU)
    with pytest.raises(Exception) as theirs:
        jax_sync.compress(io.BytesIO(b"too short"), 14, io.BytesIO())
    assert type(theirs.value).__name__ == "UnexpectedEofError"


def run_pipe(feed: bytes, coro_factory):
    """Drive an aio coroutine with an in-memory StreamReader and a sink."""

    async def run():
        reader = asyncio.StreamReader()
        reader.feed_data(feed)
        reader.feed_eof()
        collected = bytearray()

        class Sink:
            def write(self, data):
                collected.extend(data)

            async def drain(self):
                await asyncio.sleep(0)

        n = await coro_factory(reader, Sink())
        return n, bytes(collected)

    return asyncio.run(run())


def test_aio_equals_jax(stream):
    n, enc = run_pipe(PAYLOAD, lambda r, w: aio.compress_framed(r, w, batch_frames=2, device=CPU))
    assert enc == stream == run_pipe(PAYLOAD, lambda r, w: jax_aio.compress_framed(r, w, 2))[1]
    assert n == len(enc)
    n, raw = run_pipe(PAYLOAD, lambda r, w: aio.compress(r, len(PAYLOAD), w, 1, device=CPU))
    assert raw == run_pipe(PAYLOAD, lambda r, w: jax_aio.compress(r, len(PAYLOAD), w, 1))[1]
    assert raw == api.encode(PAYLOAD, device=CPU) and n == len(raw)
    n, out = run_pipe(stream, lambda r, w: aio.uncompress_framed(r, w, device=CPU))
    assert out == PAYLOAD and n == len(PAYLOAD)


@pytest.mark.parametrize("name", ["bad_magic", "short", "truncated", "bad_crc", "unknown_chunk"])
def test_aio_exceptions_equal_jax(stream, name):
    data = malformed_streams(stream)[name]
    with pytest.raises((MalformedSnappyData, UnexpectedEofError)) as ours:
        run_pipe(data, lambda r, w: aio.uncompress_framed(r, w, device=CPU))
    with pytest.raises(Exception) as theirs:
        run_pipe(data, jax_aio.uncompress_framed)
    assert type(ours.value).__name__ == type(theirs.value).__name__


def test_sync_window_buffers_are_reused(stream):
    sync.uncompress_framed_bytes(stream, device=CPU)
    first = sync._tls.out
    sync.uncompress_framed_bytes(stream, device=CPU)
    assert sync._tls.out is first and isinstance(first, np.ndarray)


def test_exports_equal_jax():
    import inspect

    import snappy_tpu_torch

    def public(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_") and not inspect.ismodule(v)}

    assert public(snappy_tpu_torch) == public(jax_api)
    assert snappy_tpu_torch.__version__ == jax_api.__version__


@pytest.fixture(scope="module")
def big_stream():
    jax_config.set_backend("host")
    try:
        return jax_api.encode_framed(payloads.mixed_payload(3_000_000, seed=6))
    finally:
        jax_config.set_backend("auto")


def test_native_frame_scan_equals_python_walk(big_stream, monkeypatch):
    from snappy_tpu.formats import framing as jax_framing

    from snappy_tpu_torch.formats import framing
    from snappy_tpu_torch.ops import host_codec

    start = len(C.FRAMING_HEADER)
    assert len(big_stream) - start >= framing._NATIVE_SCAN_MIN
    native = framing.scan_frames(big_stream, start)
    assert [tuple(vars(c).values()) for c in native] == [
        tuple(vars(c).values()) for c in jax_framing.scan_frames(big_stream, start)
    ]
    cuts = [len(big_stream) - 1, native[7].data_pos + 3, native[3].header_pos + 2]
    bad = bytearray(big_stream)
    bad[native[5].header_pos] = 0x41  # a reserved unskippable chunk
    monkeypatch.setattr(framing, "_NATIVE_SCAN_MIN", 1 << 40)  # the Python walk
    assert framing.scan_frames(big_stream, start) == native
    for data in [big_stream[:c] for c in cuts] + [bytes(bad)]:
        want = framing.scan_frames(data, start)
        assert want is None and host_codec.scan_frames_records(data, start) is None
        rec, whole = host_codec.scan_frames_prefix(data, start)
        assert not whole
        # the prefix is every chunk before the first malformed one
        nxt = int(rec[-1, 1] + 4 + rec[-1, 2])
        assert framing.scan_frames(data[:nxt], start) is not None
        assert len(framing.scan_frames(data[:nxt], start)) == len(rec)
