"""The port's raw format, end to end through its API, against snappy_tpu.

With ``device="cpu"`` (the kernels' plain versions), ``encode``,
``encode_batch`` and ``compress_into`` at levels 1 and 2 give the JAX
package's bytes, and ``decode``, ``decode_batch`` and ``uncompress_into``
its payloads and verdicts, on valid, malformed, truncated and far-copy
streams; ``decode_batch`` also on a reduced serving batch.  The digests
that chip_smoke.py checks on the card are recomputed here from the JAX
package.
"""

import hashlib

import pytest

torch = pytest.importorskip("torch")

import snappy_tpu  # noqa: E402
from snappy_tpu import engine as jax_engine  # noqa: E402
from snappy_tpu.testing import corpus  # noqa: E402

import snappy_tpu_torch as port  # noqa: E402
from snappy_tpu_torch import engine  # noqa: E402
from snappy_tpu_torch.formats import varint  # noqa: E402
from snappy_tpu_torch.formats.errors import CodecError, InputTooLarge  # noqa: E402
from snappy_tpu_torch.ops import decode_chunks, decode_stream, host_codec  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402
from snappy_tpu_torch.testing.payloads import body_of, copy2, literal  # noqa: E402

SIZES = [0, 17, 65535, 65536, 65537, 200_000]


def host_raw(data: bytes, level: int = 1) -> bytes:
    return jax_engine.raw_compress(data, backend="host", level=level)


def test_pinned_digests_recomputed_from_jax_package():
    payload = payloads.mixed_payload()
    for level, digest in ((1, payloads.RAW_L1_SHA256), (2, payloads.RAW_L2_SHA256)):
        stream = jax_engine.raw_compress(payload, backend="host", level=level)
        assert hashlib.sha256(stream).hexdigest() == digest, level
    stream = jax_engine.framed_compress(payload, backend="host", level=2)
    assert hashlib.sha256(stream).hexdigest() == payloads.FRAMED_L2_SHA256
    # the serving batch's large stream splits into one segment per block
    body = jax_engine.raw_compress(payload, backend="host", level=1)
    declared, read = varint.decode_uint32(body)
    offs = host_codec.scan_raw_blocks(body[read:], declared)
    assert len(offs) - 1 == payloads.MAIN_PATH_FRAMES + 1


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("size", SIZES)
def test_encode_decode_match_jax_package(size, level):
    payload = payloads.mixed_payload(size, seed=size % 5)
    ours = port.encode(payload, level=level, device="cpu")
    assert ours == host_raw(payload, level) == snappy_tpu.encode(payload, level=level)
    assert port.decode(ours, device="cpu") == snappy_tpu.decode(ours) == payload
    assert port.uncompressed_len(ours) == snappy_tpu.uncompressed_len(ours) == size


@pytest.mark.parametrize("level", [1, 2])
def test_encode_batch_matches_jax_package(level):
    datas = [payloads.mixed_payload(n, seed=3) for n in SIZES] + [b"x"]
    ours = port.encode_batch(datas, level=level, device="cpu")
    assert ours == snappy_tpu.encode_batch(datas, level=level)
    assert ours == [port.encode(d, level=level, device="cpu") for d in datas]
    assert port.decode_batch(ours, device="cpu") == datas


def test_oversized_input(monkeypatch):
    class Huge(bytes):
        def __len__(self):
            return 1 << 32

    assert engine.raw_compress_batch([Huge(), b"ab"], device="cpu") == [None, host_raw(b"ab")]
    assert port.compress_into(Huge(), bytearray(8), device="cpu").error == CodecError.invalid_input
    monkeypatch.setattr(engine, "raw_compress", lambda *a, **k: None)
    with pytest.raises(InputTooLarge):
        port.encode(b"x", device="cpu")


def malformed_streams():
    """Malformed raw streams: the pinned vectors, truncations of a
    multi-block stream, a far copy reaching before the output, and the
    reference corpus's baddata files where the corpus is present."""
    good = host_raw(payloads.mixed_payload(150_000, seed=6))
    streams = list(payloads.MALFORMED_RAW)
    streams += [good[:-1], good[: len(good) // 2], good + b"\x00", good[:3]]
    head = bytes(range(256)) * 300
    streams.append(varint.encode_uint32(len(head) + 8) + literal(head) + bytes([3 | (7 << 2)]) + (len(head) + 1).to_bytes(4, "little"))
    if corpus.corpus_root() is not None:
        streams += [corpus.read_data(f"baddata{k}.snappy") for k in (1, 2, 3)]
    return streams


def test_malformed_streams_match_jax_package():
    streams = malformed_streams()
    for s in streams:
        assert engine.raw_uncompress(s, device="cpu") == jax_engine.raw_uncompress(s, backend="host"), s[:12]
    got = engine.raw_uncompress_batch(streams, device="cpu")
    assert got == [jax_engine.raw_uncompress(s, backend="host") for s in streams]
    assert port.decode_batch(streams, device="cpu") == snappy_tpu.decode_batch(streams)


def test_far_copy_and_unsplittable_streams():
    """A legal copy reaching across a block boundary: the block split's
    segment fails and the whole-stream decoder (K4's plain version) takes
    it; an op straddling a boundary is refused by the scan and takes K2's
    big window; a stream over 128 KiB that the scan refuses takes K4."""
    last = body_of(host_raw(b"a" * 60_000)) + literal(b"b" * 10_000)
    assert len(host_codec.scan_raw_blocks(last, 70_000)) == 2  # one segment for two blocks
    p = payloads.mixed_payload(200_000, seed=7)
    head = body_of(host_raw(p[:65536])) + body_of(host_raw(p[65536:131072]))
    p2 = p[:131072] + p[131072 - 65000 : 131072 - 65000 + 40] + p[131112:]
    far = varint.encode_uint32(len(p2)) + head + copy2(65000, 40) + body_of(host_raw(p[131112:]))
    straddle = (varint.encode_uint32(100_000) + body_of(host_raw(p[:60_000]))
                + literal(p[60_000:70_000]) + body_of(host_raw(p[70_000:100_000])))
    big_straddle = varint.encode_uint32(150_000) + body_of(host_raw(p[:60_000])) + literal(p[60_000:150_000])
    # the last op straddles the last boundary: the scan finds one segment
    # too few, so the split is not used
    last_straddle = varint.encode_uint32(70_000) + body_of(host_raw(p[:60_000])) + literal(p[60_000:70_000])
    streams = [far, straddle, big_straddle, last_straddle]
    want = [p2, p[:100_000], p[:150_000], p[:70_000]]
    for s, w in zip(streams, want):
        assert jax_engine.raw_uncompress(s, backend="host") == (w, "ok")
    assert port.decode_batch(streams, device="cpu") == want
    assert [port.decode(s, device="cpu") for s in streams] == want


def test_decode_batch_routes_and_counts():
    """Routing of a batch on the CPU: a CPU tensor runs the plain versions,
    so no launch is counted, and the results equal the JAX package's."""
    enc = lambda ps: [host_raw(x) for x in ps]  # noqa: E731
    streams, expect = payloads.serving_batch(enc, n_small=6, big=300_000)
    before = (decode_chunks.LAUNCHES, decode_chunks.LAUNCHES_BIG, decode_stream.LAUNCHES)
    got = engine.raw_uncompress_batch(streams, device="cpu")
    assert before == (decode_chunks.LAUNCHES, decode_chunks.LAUNCHES_BIG, decode_stream.LAUNCHES)
    assert got == [jax_engine.raw_uncompress(s, backend="host") for s in streams]
    assert [g for g, _ in got] == expect
    assert [r for _, r in got].count("invalid") == 4


def test_reduced_serving_batch_matches_jax_package():
    streams, expect = payloads.serving_batch(
        lambda ps: port.encode_batch(ps, device="cpu"), n_small=8, big=200_000
    )
    assert len(streams) == 8 + payloads.SERVING_STRADDLE + 1 + 4
    assert port.decode_batch(streams, device="cpu") == snappy_tpu.decode_batch(streams)
    assert port.decode_batch(streams, device="cpu") == [e if e is not None else b"" for e in expect]


def test_too_large_and_max_size():
    s = host_raw(payloads.mixed_payload(70_000, seed=1))
    assert engine.raw_uncompress(s, max_size=69_999, device="cpu") == (None, "too_large")
    assert engine.raw_uncompress_batch([s, s], max_size=69_999, device="cpu") == [(None, "too_large")] * 2
    assert port.decode(s, max_size=69_999, device="cpu") == snappy_tpu.decode(s, max_size=69_999) == b""
    over = varint.encode_uint32(0xFFFFFFFF)[:4] + b"\xff\x7f"  # a uint64 varint above 2^32 - 1
    assert engine.raw_uncompress(over, device="cpu") == jax_engine.raw_uncompress(over, backend="host")


@pytest.mark.parametrize("size", [0, 17, 65537])
def test_compress_into_and_uncompress_into(size):
    payload = payloads.mixed_payload(size, seed=2)
    out = bytearray(port.max_compressed_len(size))
    res = port.compress_into(payload, out, device="cpu")
    want = snappy_tpu.compress_into(payload, bytearray(len(out)))
    assert res.is_ok() and res.value == want.value
    stream = bytes(out[: res.value])
    assert stream == host_raw(payload)
    small = bytearray(port.max_compressed_len(size) - 1)
    assert port.compress_into(payload, small, device="cpu").error == CodecError.buffer_too_small
    dst = bytearray(size)
    res = port.uncompress_into(stream, dst, device="cpu")
    assert res.is_ok() and res.value == size and bytes(dst) == payload
    if size:
        assert port.uncompress_into(stream, bytearray(size - 1), device="cpu").error == CodecError.buffer_too_small
    assert port.uncompress_into(stream[:-1] if size else b"\x80", bytearray(size + 8), device="cpu").error == CodecError.invalid_input
    assert port.uncompress_into(b"\xff" * 6 + stream, bytearray(size + 8), device="cpu").error == CodecError.invalid_input
    with pytest.raises(TypeError):
        port.compress_into(payload, bytes(len(out)), device="cpu")
    with pytest.raises(TypeError):
        port.uncompress_into(stream, bytes(size), device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the no-card refusal")
    s = host_raw(b"abc" * 100)
    for call in (lambda: port.encode(b"x" * 100), lambda: port.decode(s),
                 lambda: port.encode_batch([b"x"]), lambda: port.decode_batch([s], device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
