"""The port's array route against the JAX package's, end to end, on the CPU.

With ``SNAPPY_TPU_TORCH_DEVICE_KERNEL=xla`` the port's device backend
encodes with ops/encode_array.py and decodes with ops/decode_array.py;
with ``SNAPPY_TPU_DEVICE_KERNEL=xla`` (and no scalar interpreter) the JAX
engine takes its array route, encode_jax and decode_jax.  The engine, the
API, the batch calls, the sync and asyncio adapters,
``uncompress_framed_into``, the CLI and a one-rank mesh give the same
bytes, verdicts and error order on both, every port call on
``device="cpu"``.  The variable is read at each call, any value but
``scalar`` selects the route, and the JAX variable alone leaves the port
on K3's bytes.
"""

from __future__ import annotations

import io

import pytest

from snappy_tpu import api as jax_api
from snappy_tpu import cli as jax_cli
from snappy_tpu import config as jax_config
from snappy_tpu import engine as jax_engine
from snappy_tpu.parallel import mesh as jax_mesh
from snappy_tpu.streams import aio as jax_aio
from snappy_tpu.streams import sync as jax_sync
from snappy_tpu_torch import api, cli, engine
from snappy_tpu_torch.formats import constants as C
from snappy_tpu_torch.formats import framing, varint
from snappy_tpu_torch.ops import decode_chunks, decode_stream, encode_blocks, host_codec
from snappy_tpu_torch.parallel import mesh
from snappy_tpu_torch.streams import aio, sync
from snappy_tpu_torch.testing import payloads

CPU = "cpu"
PAYLOAD = payloads.mixed_payload(200_000, 5)
SMALL = [b"", b"a", payloads.mixed_payload(100, 6), payloads.mixed_payload(70_000, 9)]
# four frames for the error-order cases: two compressed, one verbatim (random
# bytes), one compressed
MIXED = PAYLOAD[:131072] + payloads.Rand(23).bytes(65536).tobytes() + PAYLOAD[131072:160000]

from test_torch_streams import run_pipe  # noqa: E402


@pytest.fixture(scope="module")
def route():
    """Both packages on their array route for the module; the JAX engine on
    its device backend."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SNAPPY_TPU_DEVICE_KERNEL", "xla")
        mp.delenv("SNAPPY_TPU_SCALAR_INTERPRET", raising=False)
        mp.setenv("SNAPPY_TPU_TORCH_DEVICE_KERNEL", "xla")
        mp.setattr(jax_config, "_backend", "device")
        assert not jax_engine._use_scalar_kernels() and engine._array_route()
        yield


@pytest.fixture(scope="module")
def streams(route):
    """The JAX array route's framed and raw streams of PAYLOAD, and its
    framed stream of MIXED."""
    return (jax_engine.framed_compress(PAYLOAD, backend="device"),
            jax_engine.raw_compress(PAYLOAD, backend="device"),
            jax_engine.framed_compress(MIXED, backend="device"))


@pytest.fixture
def no_kernels(monkeypatch):
    """The route never hands anything to K2, K3, K4 or K5."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel's wrapper was called on the array route")

    for mod, name in ((encode_blocks, "encode_blocks"), (decode_chunks, "decode_chunks"),
                      (decode_stream, "decode_raw_stream_bytes"), (decode_stream, "decode_stream")):
        monkeypatch.setattr(mod, name, refuse)


def test_raw_compress_equals_jax(route, streams, no_kernels):
    for data in SMALL:
        assert engine.raw_compress(data, device=CPU) == jax_engine.raw_compress(data, backend="device")
    for level in (1, 2):  # the route ignores the level
        assert engine.raw_compress(PAYLOAD, level, CPU) == streams[1], level
    assert streams[1] != host_codec.raw_compress(PAYLOAD, 1), "the array matcher gives other bytes"


def test_framed_compress_equals_jax(route, streams, no_kernels):
    for data in SMALL:
        assert engine.framed_compress(data, device=CPU) == jax_engine.framed_compress(data, backend="device")
    assert engine.framed_compress(PAYLOAD, False, 1, CPU) == jax_engine.framed_compress(
        PAYLOAD, False, backend="device") == streams[0][len(C.FRAMING_HEADER) :]
    assert api.encode_framed(PAYLOAD, level=2, device=CPU) == streams[0] == jax_api.encode_framed(PAYLOAD)


def test_raw_uncompress_equals_jax(route, streams, no_kernels):
    cases = [jax_engine.raw_compress(d, backend="device") for d in SMALL] + [
        streams[1], host_codec.raw_compress(PAYLOAD, 1), host_codec.raw_compress(PAYLOAD, 2)]
    cases += payloads.MALFORMED_RAW
    cases += [varint.encode_uint32(1000) + payloads.literal(b"a"),  # declared above 64/3 of the body
              varint.encode_uint32(65) + payloads.literal(b"a") + payloads.copy2(1, 64)]
    for s in cases:
        got = engine.raw_uncompress(s, device=CPU)
        assert got == jax_engine.raw_uncompress(s, backend="device"), s[:12]
    assert engine.raw_uncompress(streams[1], device=CPU) == (PAYLOAD, "ok")
    assert engine.raw_uncompress(cases[-1], device=CPU) == (b"a" * 65, "ok")
    # a declared length past 2^31 that JAX's int32 scalar cannot hold: the
    # body's size alone says invalid
    assert engine.raw_uncompress(varint.encode_uint32(0xFFFFFFFF) + b"\x00a", device=CPU) == (None, "invalid")
    assert engine.raw_uncompress(streams[1], 1000, CPU) == jax_engine.raw_uncompress(
        streams[1], 1000, backend="device") == (None, "too_large")


def test_decode_and_encode_batch_equal_jax(route, streams, no_kernels):
    good = [jax_engine.raw_compress(d, backend="device") for d in SMALL[1:]]
    batch = good + [streams[1], host_codec.raw_compress(PAYLOAD, 1)] + payloads.MALFORMED_RAW[:8]
    got = api.decode_batch(batch, device=CPU)
    assert got == jax_api.decode_batch(batch)
    assert got[: len(good) + 2] == SMALL[1:] + [PAYLOAD, PAYLOAD]
    datas = SMALL + [PAYLOAD]
    enc = api.encode_batch(datas, device=CPU)
    assert enc == jax_api.encode_batch(datas) == [api.encode(d, device=CPU) for d in datas]


def test_sync_and_aio_adapters_equal_jax(route, streams, no_kernels):
    framed, raw, _ = streams
    dst = io.BytesIO()
    sync.compress_framed(io.BytesIO(PAYLOAD), dst, batch_frames=2, device=CPU)
    want = io.BytesIO()
    jax_sync.compress_framed(io.BytesIO(PAYLOAD), want, 2)
    assert dst.getvalue() == want.getvalue() == framed
    dst = io.BytesIO()
    sync.compress(io.BytesIO(PAYLOAD), len(PAYLOAD), dst, batch_frames=2, device=CPU)
    assert dst.getvalue() == raw
    dst = io.BytesIO()
    sync.uncompress_framed(io.BytesIO(framed), dst, device=CPU)
    assert dst.getvalue() == PAYLOAD
    assert run_pipe(PAYLOAD, lambda r, w: aio.compress_framed(r, w, batch_frames=2, device=CPU))[1] == \
        run_pipe(PAYLOAD, lambda r, w: jax_aio.compress_framed(r, w, 2))[1] == framed
    assert run_pipe(PAYLOAD, lambda r, w: aio.compress(r, len(PAYLOAD), w, 1, device=CPU))[1] == raw
    assert run_pipe(framed, lambda r, w: aio.uncompress_framed(r, w, device=CPU))[1] == PAYLOAD


def _into(fn, data: bytes, size: int):
    steps, parts, first = [], [], True
    while data:
        buf = bytearray(size)
        res = fn(data, buf, first)
        if not res.is_ok():
            return steps, res.error.name
        read, written = res.value
        steps.append((read, written))
        parts.append(bytes(buf[:written]))
        data, first = data[read:], False
    return steps, b"".join(parts)


def test_uncompress_framed_into_equals_jax(route, streams, no_kernels):
    for name, data, budget, check, expected in payloads.framed_vectors():
        res = api.uncompress_framed_into(data, bytearray(budget), True, check, device=CPU)
        got_v = ("ok",) + tuple(res.value) if res.is_ok() else ("err", res.error.name)
        assert got_v[: len(expected)] == expected, (name, got_v)
        if name == "oversized_uncompressed":
            # the JAX device backend's CRC of a 65,537-byte chunk raises in
            # crc32c_jax (its shift tables stop short), on either route
            with pytest.raises(IndexError):
                jax_api.uncompress_framed_into(data, bytearray(budget), True, check)
            continue
        want = jax_api.uncompress_framed_into(data, bytearray(budget), True, check)
        want_v = ("ok",) + tuple(want.value) if want.is_ok() else ("err", want.error.name)
        assert got_v == want_v, (name, got_v, want_v)
    ours = _into(lambda d, b, f: api.uncompress_framed_into(d, b, f, device=CPU), streams[0], 100_000)
    theirs = _into(jax_api.uncompress_framed_into, streams[0], 100_000)
    assert ours == theirs and ours[1] == PAYLOAD and len(ours[0]) >= 2


def _corrupt(s: bytes, bad_crc, bad_tags) -> bytes:
    s = bytearray(s)
    if bad_crc is not None:
        s[bad_crc.data_pos] ^= 0x55
    if bad_tags is not None:
        _, read = varint.decode_uint32(bytes(s[bad_tags.data_pos + 4 : bad_tags.data_pos + 9]))
        p = bad_tags.data_pos + 4 + read
        s[p : p + 2] = b"\x01\xff"  # a copy before any output: invalid
    return bytes(s)


def _error_cases(framed: bytes):
    chunks = framing.scan_frames(framed, len(C.FRAMING_HEADER))
    comp = [c for c in chunks if c.id == C.CHUNK_COMPRESSED]
    verbatim = [c for c in chunks if c.id == C.CHUNK_UNCOMPRESSED]
    assert len(comp) >= 2 and verbatim, "the payload needs two compressed chunks and a verbatim one"
    a, b = comp[0], comp[1]
    late = max(verbatim, key=lambda c: c.data_pos)
    return [("crc@a + invalid@b", _corrupt(framed, a, b), True),
            ("invalid@a + crc@b", _corrupt(framed, b, a), True),
            ("invalid@a + verbatim crc", _corrupt(framed, late, a), True),
            ("crc@a unchecked", _corrupt(framed, a, None), False),
            ("crc@a", _corrupt(framed, a, None), True)]


def test_framed_error_order_equals_jax(route, streams, no_kernels):
    reasons = []
    for name, s, check in _error_cases(streams[2]):
        got = engine.framed_uncompress(s, check_integrity=check, device=CPU)
        assert got == jax_engine.framed_uncompress(s, check_integrity=check, backend="device"), name
        reasons.append(got[1])
    assert reasons == ["crc", "invalid", "invalid", "ok", "crc"], reasons
    assert engine.framed_compress(MIXED, device=CPU) == streams[2]
    assert engine.framed_uncompress(streams[2], device=CPU) == (MIXED, "ok")


def test_one_rank_mesh_equals_jax(route, streams, no_kernels):
    m, jm = mesh.Mesh(None, CPU), jax_mesh.default_mesh(1)
    framed = mesh.sharded_framed_compress(PAYLOAD, m)
    assert framed == jax_mesh.sharded_framed_compress(PAYLOAD, jm) == streams[0]
    assert mesh.sharded_raw_compress(PAYLOAD, m) == jax_mesh.sharded_raw_compress(PAYLOAD, jm) == streams[1]
    assert mesh.sharded_framed_uncompress(framed, m) == (PAYLOAD, "ok")
    reasons = []
    for name, s, check in _error_cases(streams[2]):
        got = mesh.sharded_framed_uncompress(s, m, check)
        assert got == jax_mesh.sharded_framed_uncompress(s, jm, check), name
        reasons.append(got[1])
    # the JAX mesh checks every verbatim CRC before any compressed chunk
    assert reasons == ["crc", "invalid", "crc", "ok", "crc"], reasons


def test_cli_equals_jax(route, streams, tmp_path, no_kernels):
    src = tmp_path / "payload"
    src.write_bytes(PAYLOAD)
    for args, want in ((["-l", "2"], streams[0]), (["--raw"], streams[1])):
        dest = tmp_path / "port.out"
        assert cli.main(args + ["--device", CPU, "-o", str(dest), str(src)]) == 0
        jdest = tmp_path / "jax.out"
        assert jax_cli.main(args + ["-o", str(jdest), str(src)]) == 0
        assert dest.read_bytes() == jdest.read_bytes() == want
        back = tmp_path / "port.back"
        raw = [a for a in args if a == "--raw"]
        assert cli.main(["-d"] + raw + ["--device", CPU, "-o", str(back), str(dest)]) == 0
        assert back.read_bytes() == PAYLOAD


def test_the_variable_is_read_at_each_call(route, streams, monkeypatch):
    data = PAYLOAD[:70_000]
    k3 = host_codec.framed_compress(data, True, 1)
    array = jax_engine.framed_compress(data, backend="device")
    assert k3 != array
    for value, want in (("xla", array), ("scalar", k3), ("anything", array), ("", array)):
        monkeypatch.setenv("SNAPPY_TPU_TORCH_DEVICE_KERNEL", value)
        assert engine.framed_compress(data, device=CPU) == want, value
    monkeypatch.delenv("SNAPPY_TPU_TORCH_DEVICE_KERNEL")
    assert engine.framed_compress(data, device=CPU) == k3


def test_the_jax_variable_alone_leaves_the_port_on_k3(route, monkeypatch):
    monkeypatch.delenv("SNAPPY_TPU_TORCH_DEVICE_KERNEL")
    assert jax_engine.raw_compress(PAYLOAD, backend="device") != host_codec.raw_compress(PAYLOAD, 1)
    assert engine.raw_compress(PAYLOAD, device=CPU) == host_codec.raw_compress(PAYLOAD, 1)
    assert engine.raw_compress(PAYLOAD, 2, CPU) == host_codec.raw_compress(PAYLOAD, 2)


def test_the_host_backend_ignores_the_variable(route, streams):
    assert engine.raw_compress(PAYLOAD, backend="host") == host_codec.raw_compress(PAYLOAD, 1)
    assert engine.raw_uncompress(streams[1], backend="host") == (PAYLOAD, "ok")

