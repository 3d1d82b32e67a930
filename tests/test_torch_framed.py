"""The port's framed encode -> decode slice against the JAX package (exact).

Encode: the port's bytes (device="cpu", the kernels' plain versions) equal
the JAX package's level-1 and level-2 framed bytes (host C, which equals
its TPU kernels).  Decode: the port's (payload, reason) equals the JAX device
backend's on valid streams and on the error-order cases.  The pinned
digest that chip_smoke.py checks on the card is recomputed here from the
JAX package.
"""

import hashlib

import pytest

torch = pytest.importorskip("torch")

import snappy_tpu  # noqa: E402
from snappy_tpu import engine as jax_engine  # noqa: E402

import snappy_tpu_torch as port  # noqa: E402
from snappy_tpu_torch import engine  # noqa: E402
from snappy_tpu_torch.formats import constants as C  # noqa: E402
from snappy_tpu_torch.formats import framing, varint  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

from test_oracle import MALFORMED_RAW  # noqa: E402


def test_golden_digest_recomputed_from_jax_package():
    payload = payloads.mixed_payload()
    assert len(payload) == payloads.MAIN_PATH_BYTES
    stream = jax_engine.framed_compress(payload, backend="host", level=1)
    assert hashlib.sha256(stream).hexdigest() == payloads.GOLDEN_SHA256
    chunks = framing.scan_frames(stream, len(C.FRAMING_HEADER))
    assert len(chunks) == payloads.MAIN_PATH_FRAMES + 1
    data = [c for c in chunks if c.id in (C.CHUNK_COMPRESSED, C.CHUNK_UNCOMPRESSED)]
    # chip_smoke.py corrupts frames 5 and 9, which must be compressed
    assert data[5].id == data[9].id == C.CHUNK_COMPRESSED


def test_malformed_vectors_copy_is_pinned():
    assert payloads.MALFORMED_RAW == MALFORMED_RAW


@pytest.mark.parametrize(
    "size,seed",
    [(0, 0), (1, 0), (16, 0), (17, 0), (100, 0), (65536, 0), (65537, 0), (3 * 65536 + 1000, 1)],
)
def test_encode_matches_jax_package(size, seed):
    payload = payloads.mixed_payload(size, seed=seed)
    ours = port.encode_framed(payload, device="cpu")
    assert ours == jax_engine.framed_compress(payload, backend="host", level=1)
    assert port.decode_framed(ours, device="cpu") == payload


def _base():
    """A 6-frame stream whose frames 0 and 1 are stored verbatim."""
    payload = payloads.mixed_payload(6 * 65536 + 500, seed=1)
    stream = jax_engine.framed_compress(payload, backend="host", level=1)
    chunks = framing.scan_frames(stream, len(C.FRAMING_HEADER))
    assert [c.id for c in chunks][:3] == [1, 1, 0]
    return payload, stream, chunks


def _bad_crc(s: bytearray, ch) -> None:
    s[ch.data_pos] ^= 0x55


def _bad_tags(s: bytearray, ch) -> None:
    _, read = varint.decode_uint32(bytes(s[ch.data_pos + 4 : ch.data_pos + 9]))
    p = ch.data_pos + 4 + read
    s[p : p + 2] = b"\x01\xff"  # a copy before any output


def _hdr(cid, n):
    return framing.encode_frame_header(cid, n)


def _case(name):
    payload, stream, ch = _base()
    s = bytearray(stream)
    if name == "valid":
        pass
    elif name == "crc_compressed":
        _bad_crc(s, ch[3])
    elif name == "crc_uncompressed":
        _bad_crc(s, ch[1])
    elif name == "invalid_tags":
        _bad_tags(s, ch[4])
    elif name == "crc_then_invalid":
        _bad_crc(s, ch[2]), _bad_tags(s, ch[4])
    elif name == "invalid_then_crc":
        _bad_tags(s, ch[2]), _bad_crc(s, ch[4])
    elif name == "ucrc_then_invalid":
        _bad_crc(s, ch[1]), _bad_tags(s, ch[3])
    elif name == "invalid_then_ucrc":
        _bad_tags(s, ch[2])
        s += _hdr(C.CHUNK_UNCOMPRESSED, 4 + 3) + b"\x00\x00\x00\x00abc"  # wrong CRC
    elif name == "truncated":
        s = s[: ch[3].data_pos + 100]
    elif name == "declares_131k":
        # a 64 KiB chunk body whose inner varint declares 131072 bytes
        body = varint.encode_uint32(131072) + bytes(stream[ch[2].data_pos + 4 + 3 : ch[2].data_pos + ch[2].data_len])
        s = bytearray(C.FRAMING_HEADER + _hdr(0, 4 + len(body)) + bytes(4) + body)
    elif name == "truncated_varint":
        s = bytearray(C.FRAMING_HEADER + _hdr(0, 5) + bytes(4) + b"\x80")
    elif name == "short_declared":
        # a valid tag stream of frame 2 under a declared length one larger
        _, read = varint.decode_uint32(bytes(s[ch[2].data_pos + 4 : ch[2].data_pos + 9]))
        body = bytes(s[ch[2].data_pos + 4 + read : ch[2].data_pos + ch[2].data_len])
        body = varint.encode_uint32(ch[2].uncompressed_len + 1) + body
        s = bytearray(C.FRAMING_HEADER + _hdr(0, 4 + len(body)) + bytes(4) + body)
    elif name == "unskippable":
        s += _hdr(0x03, 2) + b"\x00\x00"
    elif name == "skippable_padding":
        s = bytearray(C.FRAMING_HEADER + _hdr(0x9A, 2) + b"zz" + _hdr(C.CHUNK_PADDING, 1) + b"\x00"
                      + bytes(stream[len(C.FRAMING_HEADER):]))
    elif name == "no_header":
        s = s[len(C.FRAMING_HEADER):]
    return payload, bytes(s)


CASES = [
    "valid", "crc_compressed", "crc_uncompressed", "invalid_tags",
    "crc_then_invalid", "invalid_then_crc", "ucrc_then_invalid",
    "invalid_then_ucrc", "truncated", "declares_131k", "truncated_varint",
    "short_declared", "unskippable", "skippable_padding", "no_header",
]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("check_integrity", [True, False])
def test_decode_matches_jax_device_backend(name, check_integrity):
    payload, stream = _case(name)
    want = jax_engine.framed_uncompress(stream, check_integrity=check_integrity, backend="device")
    got = engine.framed_uncompress(stream, check_integrity=check_integrity, device="cpu")
    assert got == want
    if name in ("valid", "skippable_padding"):
        assert got == (payload, "ok")


def _headerless(kind):
    """Streams for require_header: frames without the stream identifier,
    a stream with it, and headerless streams whose first chunk is padding
    or has a bad CRC."""
    payload, stream, ch = _base()
    frames = bytes(stream[len(C.FRAMING_HEADER):])
    if kind == "no_identifier":
        return frames
    if kind == "with_identifier":
        return stream
    if kind == "padding_first":
        return _hdr(C.CHUNK_PADDING, 3) + b"\x00\x00\x00" + frames
    s = bytearray(frames)  # "bad_crc_first"
    s[ch[0].data_pos - len(C.FRAMING_HEADER)] ^= 0x55
    return bytes(s)


@pytest.mark.parametrize("kind", ["no_identifier", "with_identifier", "padding_first", "bad_crc_first"])
@pytest.mark.parametrize("require_header", [True, False])
def test_require_header_matches_jax_host_backend(kind, require_header):
    stream = _headerless(kind)
    want = jax_engine.framed_uncompress(stream, require_header=require_header, backend="host")
    got = engine.framed_uncompress(stream, require_header=require_header, device="cpu")
    assert got == want
    if require_header and kind != "with_identifier":
        assert got == (None, "invalid")
    if not require_header and kind in ("no_identifier", "padding_first"):
        assert got == (payloads.mixed_payload(6 * 65536 + 500, seed=1), "ok")
    if not require_header and kind == "bad_crc_first":
        assert got == (None, "crc")


def test_error_order_reasons():
    expect = {
        "crc_then_invalid": "crc", "invalid_then_crc": "invalid",
        "ucrc_then_invalid": "crc", "crc_compressed": "crc",
        "invalid_tags": "invalid", "unskippable": "unknown_chunk",
        "declares_131k": "invalid",
    }
    for name, reason in expect.items():
        assert engine.framed_uncompress(_case(name)[1], device="cpu") == (None, reason), name
    payload, stream = _case("crc_compressed")
    assert port.decode_framed(stream, device="cpu") == b""
    assert port.decode_framed(stream, check_integrity=False, device="cpu") == payload


def test_too_large_and_sizing():
    payload, stream = _case("valid")
    assert engine.framed_uncompress(stream, max_size=len(payload) - 1, device="cpu") == (None, "too_large")
    assert port.uncompressed_len_framed(stream) == snappy_tpu.uncompressed_len_framed(stream) == len(payload)
    assert port.is_framed_stream(stream) and not port.is_framed_stream(stream[1:])
    assert port.max_compressed_len(65536) == snappy_tpu.max_compressed_len(65536)
    assert port.max_compressed_len_framed(10**6) == snappy_tpu.max_compressed_len_framed(10**6)


def test_uncompress_chunks():
    payload, stream = _case("valid")
    chunks = framing.scan_frames(stream, len(C.FRAMING_HEADER))
    assert engine.framed_uncompress_chunks(stream, chunks, device="cpu") == ([payload], "ok")


@pytest.mark.parametrize("n", [0, 5, 70_000])
def test_masked_crc32c_matches_jax_package(n):
    data = payloads.mixed_payload(n, seed=3)
    assert port.masked_crc32c(data, device="cpu") == snappy_tpu.masked_crc32c(data)


@pytest.mark.parametrize("size", [0, 100, 65537, 3 * 65536 + 1000])
def test_level_2_matches_jax_package(size):
    payload = payloads.mixed_payload(size, seed=4)
    ours = port.encode_framed(payload, level=2, device="cpu")
    assert ours == jax_engine.framed_compress(payload, backend="host", level=2)
    assert port.decode_framed(ours, device="cpu") == payload


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.encode_framed(b"x" * 100, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.encode_framed(b"x" * 100)  # the default device is cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        port.decode_framed(port.encode_framed(b"x" * 100, device="cpu"), device="cuda")
