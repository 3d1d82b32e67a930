"""The backend choice (config.py) and the host backend through the port's
entry points.

* The choice: the default is ``device``, read from
  ``SNAPPY_TPU_TORCH_BACKEND`` and never from the JAX package's
  ``SNAPPY_TPU_BACKEND``; ``set_backend`` refuses an unknown name; ``auto``
  is ``host`` where the native library builds; no backend falls back to
  the other.
* The engine (``backend="host"``), the API, and the sync and asyncio
  adapters on the configured host backend, against the JAX package on its
  host backend: the same bytes, ``Result``s, ``(read, written)`` pairs,
  reasons and raised error types.
* The port's host bytes equal its device backend's (``device="cpu"``, the
  kernels' plain versions) at levels 1 and 2, raw and framed, as
  tests/test_backends.py holds the JAX package's.
"""

import asyncio
import importlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import snappy_tpu as jax_api  # noqa: E402
from snappy_tpu import config as jax_config  # noqa: E402
from snappy_tpu import engine as jax_engine  # noqa: E402
from snappy_tpu.formats import framing as jax_framing  # noqa: E402
from snappy_tpu.streams import aio as jax_aio  # noqa: E402
from snappy_tpu.streams import sync as jax_sync  # noqa: E402

from snappy_tpu_torch import api, config, engine  # noqa: E402
from snappy_tpu_torch.formats import constants as C  # noqa: E402
from snappy_tpu_torch.formats import framing, varint  # noqa: E402
from snappy_tpu_torch.formats.errors import MalformedSnappyData, UnexpectedEofError  # noqa: E402
from snappy_tpu_torch.ops import host_codec  # noqa: E402
from snappy_tpu_torch.streams import aio, sync  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

CPU = "cpu"
H = C.FRAMING_HEADER
PAYLOAD = payloads.mixed_payload(300_000, seed=7)
VECTORS = payloads.framed_vectors()


@pytest.fixture(autouse=True)
def backends(monkeypatch):
    """The port's backend restored after each test; the JAX package on
    its host backend."""
    monkeypatch.setattr(config, "_backend", config.get_backend())
    monkeypatch.setattr(jax_config, "_backend", "host")


@pytest.fixture
def host():
    config.set_backend("host")


@pytest.fixture(scope="module")
def stream():
    return host_codec.framed_compress(PAYLOAD)


# ---------------------------------------------------------------------------
# The choice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env,want", [
    (None, "device"), ("host", "host"), ("device", "device"), ("auto", "auto"),
    ("gpu", "device"), ("", "device"),
])
def test_backend_from_the_variable(monkeypatch, env, want):
    """The port reads its own variable; the JAX package's does not move it,
    and an unknown value gives the default."""
    monkeypatch.setenv("SNAPPY_TPU_BACKEND", "host")
    if env is None:
        monkeypatch.delenv("SNAPPY_TPU_TORCH_BACKEND", raising=False)
    else:
        monkeypatch.setenv("SNAPPY_TPU_TORCH_BACKEND", env)
    importlib.reload(config)
    assert config.get_backend() == want
    assert config.resolve_backend() == ("host" if want == "auto" else want)


def test_default_is_the_device():
    assert config.DEFAULT_BACKEND == "device"
    config.set_backend(config.DEFAULT_BACKEND)
    assert config.resolve_backend() == "device"
    if not torch.cuda.is_available():
        # the device backend's default device is the card: no silent CPU
        for call in (lambda: api.encode(b"abc"), lambda: api.decode(b"\x00"),
                     lambda: api.encode_framed(b"abc"), lambda: api.decode_framed(H)):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


@pytest.mark.parametrize("name", ["gpu", "", "HOST", None, "cuda"])
def test_set_backend_refuses_an_unknown_name(name):
    config.set_backend("host")
    with pytest.raises(ValueError):
        config.set_backend(name)
    assert config.get_backend() == "host"
    with pytest.raises(ValueError):
        config.resolve_backend(name if name is not None else "none")


def test_resolve_backend():
    config.set_backend("device")
    assert config.resolve_backend() == "device"
    assert config.resolve_backend("host") == "host"
    assert config.resolve_backend("auto") == "host"
    config.set_backend("auto")
    assert config.get_backend() == "auto" and config.resolve_backend() == "host"
    assert config.resolve_backend("device") == "device"


def broken_library():
    raise RuntimeError("building host_codec failed")


HOST_CALLS = {
    "raw_compress": lambda: engine.raw_compress(b"abc" * 50, backend="host"),
    "raw_uncompress": lambda: engine.raw_uncompress(b"\x03\x08abc", backend="host"),
    "framed_compress": lambda: engine.framed_compress(b"abc" * 50, backend="host"),
    "framed_uncompress": lambda: engine.framed_uncompress(
        H + payloads.data_chunk(b"abc" * 50, False), backend="host"),
    "masked_crc32c": lambda: engine.masked_crc32c(b"abc", backend="host"),
}


@pytest.mark.parametrize("name", sorted(HOST_CALLS))
def test_host_backend_without_its_library_raises(monkeypatch, name):
    """A failed build raises on the host backend; nothing runs on the
    device instead, and ``auto`` still resolves to the host."""
    HOST_CALLS[name]()  # the library builds here
    monkeypatch.setattr(host_codec, "lib", broken_library)
    with pytest.raises(RuntimeError, match="host_codec"):
        HOST_CALLS[name]()
    assert config.resolve_backend("auto") == "host"


def test_device_backend_never_calls_the_host_runtime(monkeypatch):
    """With the backend left at its default, every entry point runs the
    kernels (their plain versions on the CPU), never the host codec."""
    config.set_backend("device")

    def refuse(*args, **kwargs):
        raise AssertionError("the device backend called the host runtime")

    for name in ("raw_compress", "raw_uncompress", "decode_raw_body_into", "decode_tags_into",
                 "framed_compress", "framed_compress_into", "framed_uncompress_scanned",
                 "framed_resume_decode", "masked_crc32c", "encode_block", "decode_tags"):
        monkeypatch.setattr(host_codec, name, refuse)
    p = PAYLOAD[:150_000]
    raw = api.encode(p, device=CPU)
    assert api.decode(raw, device=CPU) == p
    assert api.decode_batch([raw, b"\x05\x00"], device=CPU) == [p, b""]
    assert api.encode_batch([p], device=CPU) == [raw]
    framed = api.encode_framed(p, device=CPU)
    assert api.decode_framed(framed, device=CPU) == p
    out = bytearray(len(p))
    assert api.uncompress_into(raw, out, device=CPU).value == len(p) and out == p
    assert api.compress_into(p, bytearray(C.max_compressed_len(len(p))), device=CPU).value == len(raw)
    into = bytearray(C.max_compressed_len_framed(len(p)))
    assert api.compress_framed_into(p, into, device=CPU).value == len(framed)
    assert api.uncompress_framed_into(framed, out, device=CPU).value == (len(framed), len(p))
    assert sync.uncompress_framed_bytes(framed, device=CPU) == p
    assert engine.masked_crc32c(p, device=CPU) == jax_engine.masked_crc32c(p, backend="host")


def test_explicit_device_backend_under_a_host_setting(monkeypatch):
    """``backend="device"`` holds through the engine's inner calls (a raw
    stream that the batch hands to the whole-stream decoder) while the
    configured backend is the host."""
    config.set_backend("host")
    for name in ("raw_compress", "raw_uncompress", "decode_raw_body_into", "framed_compress",
                 "framed_uncompress_scanned", "masked_crc32c"):
        monkeypatch.setattr(host_codec, name, lambda *a, **k: pytest.fail("the host runtime ran"))
    body, declared, want = payloads.window_cases()[-1]  # a literal across a boundary: no split
    far = varint.encode_uint32(declared) + body
    p = PAYLOAD[:70_000]
    raw = engine.raw_compress(p, device=CPU, backend="device")
    assert engine.raw_uncompress_batch([far, raw], device=CPU, backend="device") == [(want, "ok"), (p, "ok")]
    assert engine.framed_uncompress(engine.framed_compress(p, device=CPU, backend="device"),
                                    device=CPU, backend="device") == (p, "ok")


# ---------------------------------------------------------------------------
# The engine on backend="host"
# ---------------------------------------------------------------------------

SIZES = [0, 1, 70_000, 300_000, 3 << 20]


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("size", SIZES)
def test_engine_compress(size, level):
    p = payloads.mixed_payload(size, seed=3) if size else b""
    raw = engine.raw_compress(p, level, backend="host")
    assert raw == jax_engine.raw_compress(p, backend="host", level=level)
    for with_header in (True, False):
        assert engine.framed_compress(p, with_header, level, backend="host") == \
            jax_engine.framed_compress(p, with_header, backend="host", level=level)
    assert engine.raw_compress_batch([p, b"", p[:999]], level, backend="host") == \
        jax_engine.raw_compress_batch([p, b"", p[:999]], backend="host", level=level)


RAW_STREAMS = [s for s, _ in payloads.mutation_streams(40, seed=5)] + payloads.MALFORMED_RAW


@pytest.mark.parametrize("max_size", [C.MAX_UNCOMPRESSED_LEN, 100_000])
def test_engine_raw_uncompress(max_size):
    for s in RAW_STREAMS:
        assert engine.raw_uncompress(s, max_size, backend="host") == \
            jax_engine.raw_uncompress(s, max_size, backend="host"), s[:16]
    assert engine.raw_uncompress_batch(RAW_STREAMS, max_size, backend="host") == \
        jax_engine.raw_uncompress_batch(RAW_STREAMS, max_size, backend="host")


def framed_streams(stream):
    chunks = framing.scan_frames(stream, len(H))
    bad_crc = bytearray(stream)
    bad_crc[chunks[2].data_pos] ^= 0x55
    unknown = stream + payloads.frame(0x40, b"")
    return {
        "valid": stream,
        "bad_crc": bytes(bad_crc),
        "unknown_chunk": unknown,
        "truncated": stream[:-5],
        "bad_magic": b"x" + stream[1:],
        "header_only": H,
        "empty": b"",
        "headerless": stream[len(H):],
    }


@pytest.mark.parametrize("name", ["valid", "bad_crc", "unknown_chunk", "truncated", "bad_magic",
                                  "header_only", "empty", "headerless"])
def test_engine_framed_uncompress(stream, name):
    data = framed_streams(stream)[name]
    for max_size in (C.MAX_UNCOMPRESSED_LEN, len(PAYLOAD) - 1):
        for check_integrity in (True, False):
            for require_header in (True, False):
                args = (data, max_size, check_integrity, require_header)
                assert engine.framed_uncompress(*args, backend="host") == \
                    jax_engine.framed_uncompress(*args, backend="host"), args[1:]


def test_engine_framed_uncompress_chunks(stream):
    chunks = framing.scan_frames(stream, len(H))
    jchunks = jax_framing.scan_frames(stream, len(H))
    want = jax_engine.framed_uncompress_chunks(stream, jchunks, backend="host")
    assert engine.framed_uncompress_chunks(stream, chunks, backend="host") == want == ([PAYLOAD], "ok")
    out = np.zeros(len(PAYLOAD), np.uint8)
    assert engine.framed_uncompress_chunks_into(stream, chunks, out, backend="host") == \
        jax_engine.framed_uncompress_chunks_into(stream, jchunks, np.zeros_like(out), backend="host")
    assert out.tobytes() == PAYLOAD


@pytest.mark.parametrize("size", [0, 1, 65536, 300_000])
def test_engine_masked_crc32c(size):
    p = PAYLOAD[:size]
    assert engine.masked_crc32c(p, backend="host") == jax_engine.masked_crc32c(p, backend="host") \
        == engine.masked_crc32c(p, device=CPU, backend="device")


# ---------------------------------------------------------------------------
# The API on the configured host backend
# ---------------------------------------------------------------------------


def result(res, out=None):
    if not res.is_ok():
        return ("err", res.error.name)
    value = res.value
    n = value[1] if isinstance(value, tuple) else value
    return ("ok", value, None if out is None else bytes(out[:n]))


def test_api_raw(host):
    for level in (1, 2):
        assert api.encode(PAYLOAD, level) == jax_api.encode(PAYLOAD, level)
    batch = [PAYLOAD, PAYLOAD[:70_000], b""]
    assert api.encode_batch(batch, 2) == jax_api.encode_batch(batch, 2)
    assert api.decode_batch(RAW_STREAMS) == jax_api.decode_batch(RAW_STREAMS)
    for s in RAW_STREAMS:
        assert api.decode(s) == jax_api.decode(s)
    raw = api.encode(PAYLOAD)
    assert api.decode(raw, max_size=len(PAYLOAD) - 1) == jax_api.decode(raw, len(PAYLOAD) - 1) == b""


@pytest.mark.parametrize("room", [0, 299_999, 300_000, 400_000])
def test_api_into_raw(host, room):
    raw = api.encode(PAYLOAD)
    for data in [raw, raw[:-9], b"\x80\x80\x80\x80\x80\x01", b"\x00", b"\x00\x00a"] + RAW_STREAMS[:10]:
        ours, theirs = bytearray(room), bytearray(room)
        assert result(api.uncompress_into(data, ours), ours) == \
            result(jax_api.uncompress_into(data, theirs), theirs)
    for p in (PAYLOAD, b"", PAYLOAD[:1000]):
        ours, theirs = bytearray(room), bytearray(room)
        assert result(api.compress_into(p, ours), ours) == result(jax_api.compress_into(p, theirs), theirs)


def test_api_framed(host, stream):
    for level in (1, 2):
        assert api.encode_framed(PAYLOAD, level) == jax_api.encode_framed(PAYLOAD, level)
    for data in framed_streams(stream).values():
        for check_integrity in (True, False):
            assert api.decode_framed(data, check_integrity=check_integrity) == \
                jax_api.decode_framed(data, check_integrity=check_integrity)
    assert api.decode_framed(stream, max_size=len(PAYLOAD) - 1) == b""


@pytest.mark.parametrize("extra", [-1, 0, 1000])
def test_api_compress_framed_into(host, extra):
    for p in (PAYLOAD, b"", PAYLOAD[:65537]):
        room = C.max_compressed_len_framed(len(p)) + extra
        ours, theirs = bytearray(room), bytearray(room)
        assert result(api.compress_framed_into(p, ours), ours) == \
            result(jax_api.compress_framed_into(p, theirs), theirs)


def walk_budgets(data: bytes, budget: int):
    return sorted({0, 1, 65536, max(1, len(data) // 2), budget})


@pytest.mark.parametrize("k", range(len(VECTORS)), ids=[v[0] for v in VECTORS])
def test_api_uncompress_framed_into_vectors(k):
    """The host walk against the JAX host walk and against the port's own
    device walk (``device="cpu"``), at several budgets."""
    name, data, budget, check_integrity, expected = VECTORS[k]
    for b in walk_budgets(data, budget):
        got = {}
        for backend in ("host", "device"):
            config.set_backend(backend)
            out = bytearray(b)
            got[backend] = result(api.uncompress_framed_into(data, out, True, check_integrity, device=CPU), out)
        theirs = bytearray(b)
        want = result(jax_api.uncompress_framed_into(data, theirs, True, check_integrity), theirs)
        assert got["host"] == got["device"] == want, (name, b)
        if b == budget:
            assert want[:2] == (expected[0], tuple(expected[1:])) if expected[0] == "ok" else want == expected


@pytest.mark.parametrize("size", [65536, 100_000, 1 << 20])
def test_api_uncompress_framed_into_reentry(host, stream, size):
    def steps(fn):
        data, first, seen, got = stream, True, [], b""
        while data:
            out = bytearray(size)
            res = fn(data, out, first)
            read, written = res.value
            seen.append((read, written))
            got += bytes(out[:written])
            data, first = data[read:], False
        return seen, got

    ours = steps(api.uncompress_framed_into)
    assert ours == steps(jax_api.uncompress_framed_into) and ours[1] == PAYLOAD


def test_api_into_refuses_read_only_buffers(host):
    for fn in (api.uncompress_framed_into, api.compress_framed_into, api.uncompress_into):
        with pytest.raises(TypeError):
            fn(H, memoryview(bytes(64)))


# ---------------------------------------------------------------------------
# The stream adapters on the configured host backend
# ---------------------------------------------------------------------------


def run_pipe(feed: bytes, coro_factory):
    async def run():
        reader = asyncio.StreamReader()
        reader.feed_data(feed)
        reader.feed_eof()
        sink = bytearray()

        class Sink:
            def write(self, data):
                sink.extend(data)

            async def drain(self):
                await asyncio.sleep(0)

        n = await coro_factory(reader, Sink())
        return n, bytes(sink)

    return asyncio.run(run())


def test_sync_adapters(host, stream):
    for fn, jfn in ((lambda s, d: sync.compress(s, len(PAYLOAD), d, batch_frames=2),
                     lambda s, d: jax_sync.compress(s, len(PAYLOAD), d, batch_frames=2)),
                    (lambda s, d: sync.compress_framed(s, d, batch_frames=3),
                     lambda s, d: jax_sync.compress_framed(s, d, batch_frames=3))):
        ours, theirs = io.BytesIO(), io.BytesIO()
        assert fn(io.BytesIO(PAYLOAD), ours) == jfn(io.BytesIO(PAYLOAD), theirs)
        assert ours.getvalue() == theirs.getvalue()
    assert sync.compress_framed_bytes(PAYLOAD) == stream
    dst = io.BytesIO()
    assert sync.uncompress_framed(io.BytesIO(stream), dst) == len(PAYLOAD)
    assert dst.getvalue() == PAYLOAD == jax_sync.uncompress_framed_bytes(stream)


def test_sync_window_reenters_a_bounded_buffer(host, stream, monkeypatch):
    """A 100,000-byte output buffer: each window re-enters the walk until
    it is used up; a buffer smaller than a chunk makes no progress and
    raises with the reason."""
    monkeypatch.setattr(sync._tls, "out", np.empty(100_000, np.uint8), raising=False)
    calls = []
    walk = host_codec.framed_resume_decode

    def counted(*args):
        calls.append(args[1])
        return walk(*args)

    monkeypatch.setattr(host_codec, "framed_resume_decode", counted)
    assert sync.uncompress_framed_bytes(stream) == PAYLOAD
    assert len(calls) >= len(PAYLOAD) // 100_000
    monkeypatch.setattr(sync._tls, "out", np.empty(1000, np.uint8))
    with pytest.raises(MalformedSnappyData, match="framed decode failed"):
        sync.uncompress_framed_bytes(stream)


def malformed_streams(stream):
    s = framed_streams(stream)
    return {"bad_magic": s["bad_magic"], "short": b"\xff\x06", "truncated": s["truncated"],
            "bad_crc": s["bad_crc"], "unknown_chunk": s["unknown_chunk"],
            "torn_varint": dict((v[0], v[1]) for v in VECTORS)["torn_varint_small_budget"]}


def outcome(fn):
    """("ok", output) or ("err", the exception's type name)."""
    try:
        return ("ok", fn())
    except Exception as e:  # the port's and the JAX package's error types
        return ("err", type(e).__name__)


STREAM_CASES = ["bad_magic", "short", "truncated", "bad_crc", "unknown_chunk", "torn_varint"]


@pytest.mark.parametrize("name", STREAM_CASES)
@pytest.mark.parametrize("check_integrity", [True, False])
def test_sync_errors_equal_jax(host, stream, name, check_integrity):
    data = malformed_streams(stream)[name]
    ours = outcome(lambda: sync.uncompress_framed_bytes(data, check_integrity))
    assert ours == outcome(lambda: jax_sync.uncompress_framed_bytes(data, check_integrity))
    assert ours[0] == "err" or (name, check_integrity) == ("bad_crc", False)


def test_aio_adapters(host, stream):
    n, enc = run_pipe(PAYLOAD, lambda r, w: aio.compress_framed(r, w, batch_frames=2))
    assert enc == stream == run_pipe(PAYLOAD, lambda r, w: jax_aio.compress_framed(r, w, 2))[1]
    n, raw = run_pipe(PAYLOAD, lambda r, w: aio.compress(r, len(PAYLOAD), w, 1))
    assert raw == run_pipe(PAYLOAD, lambda r, w: jax_aio.compress(r, len(PAYLOAD), w, 1))[1]
    n, out = run_pipe(stream, aio.uncompress_framed)
    assert out == PAYLOAD and n == len(PAYLOAD)


@pytest.mark.parametrize("name", STREAM_CASES)
@pytest.mark.parametrize("check_integrity", [True, False])
def test_aio_errors_equal_jax(host, stream, name, check_integrity):
    data = malformed_streams(stream)[name]
    ours = outcome(lambda: run_pipe(data, lambda r, w: aio.uncompress_framed(r, w, check_integrity)))
    assert ours == outcome(lambda: run_pipe(data, lambda r, w: jax_aio.uncompress_framed(r, w, check_integrity)))
    assert ours[0] == "err" or (name, check_integrity) == ("bad_crc", False)


# ---------------------------------------------------------------------------
# Host bytes against device bytes
# ---------------------------------------------------------------------------

KINDS = {
    "mixed": PAYLOAD[:150_000],
    "runs": b"\x42" * 70_000,
    "period": (b"two way buckets " * 6000)[:90_000],
    "random": np.random.default_rng(21).integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
}


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_host_bytes_equal_device_bytes(kind, level):
    p = KINDS[kind]
    raw = engine.raw_compress(p, level, backend="host")
    assert raw == engine.raw_compress(p, level, device=CPU, backend="device")
    framed = engine.framed_compress(p, level=level, backend="host")
    assert framed == engine.framed_compress(p, level=level, device=CPU, backend="device")
    assert engine.raw_uncompress(raw, device=CPU, backend="device") == (p, "ok")
    assert engine.framed_uncompress(framed, backend="host") == (p, "ok")
