"""The port's host runtime (ops/host_codec.py: the host backend's whole-
payload encode and decode) against the JAX package's, on the same inputs.

Each binding is held against ``snappy_tpu.ops.host_codec``'s function of
the same name: the same bytes, lengths, verdicts, reasons and ``(read,
written)`` results, exactly.  The inputs are made from seeds with numpy
(``testing/payloads.py``); the thresholds of the parallel paths are
lowered where a test needs them to run at a small size.
"""

import functools
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from snappy_tpu.formats import framing as jax_framing  # noqa: E402
from snappy_tpu.ops import host_codec as jax_host  # noqa: E402

from snappy_tpu_torch.formats import constants as C  # noqa: E402
from snappy_tpu_torch.formats import framing, varint  # noqa: E402
from snappy_tpu_torch.ops import host_codec  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

H = C.FRAMING_HEADER
MAX = C.MAX_UNCOMPRESSED_LEN
# Empty, one byte, one block and one more, the mixed payload, and 5 MiB:
# three 2 MiB spans on the pool.
SIZES = [0, 1, 65536, 65537, 300_000, 5 << 20]


@functools.cache
def payload(size: int) -> bytes:
    return payloads.mixed_payload(size, seed=size % 11 + 2) if size else b""


@pytest.fixture
def parallel(monkeypatch):
    """The block-parallel raw decode at any size, on 4 threads, in both
    packages; counts the port's segment-decode calls."""
    monkeypatch.setattr(host_codec, "_PAR_DECODE_MIN", 0)
    monkeypatch.setattr(jax_host, "_PAR_DECODE_MIN", 0)
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    dll = host_codec.lib()
    native = dll.stpu_decode_raw_segments
    calls = []

    def counted(*args):
        calls.append(args[2:4])
        return native(*args)

    monkeypatch.setattr(dll, "stpu_decode_raw_segments", counted, raising=False)
    return calls


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("size", SIZES)
def test_raw_compress(size, level):
    p = payload(size)
    ours = host_codec.raw_compress(p, level)
    assert ours == jax_host.raw_compress(p, level)
    assert host_codec.raw_uncompress(ours, MAX) == ((p, "ok") if p else (b"", "ok"))


def raw_cases():
    cases = [(f"malformed{k}", s) for k, s in enumerate(payloads.MALFORMED_RAW)]
    cases += [(f"mutation{k}_{kind}", s) for k, (s, kind) in enumerate(payloads.mutation_streams(60))]
    valid = host_codec.raw_compress(payload(200_000))
    cases += [
        ("valid", valid),
        ("declared_0_with_body", b"\x00\x00a"),
        ("declared_0", b"\x00"),
        ("declared_past_body", varint.encode_uint32(300_000) + valid[3:]),
        ("truncated", valid[: len(valid) // 2]),
    ]
    return cases


RAW_CASES = raw_cases()


@pytest.mark.parametrize("k", range(len(RAW_CASES)), ids=[c[0] for c in RAW_CASES])
def test_raw_uncompress_and_decode_raw_body_into(k):
    stream = RAW_CASES[k][1]
    assert host_codec.raw_uncompress(stream, MAX) == jax_host.raw_uncompress(stream, MAX)
    declared, read = varint.decode_uint32(stream)
    if declared is not None and declared <= 1 << 20:
        ours, theirs = np.zeros(declared, np.uint8), np.zeros(declared, np.uint8)
        body = stream[read:]
        ok = host_codec.decode_raw_body_into(body, declared, ours)
        assert ok == jax_host.decode_raw_body_into(body, declared, theirs)
        if ok:
            assert np.array_equal(ours, theirs)
        assert host_codec.decode_tags_into(body, declared, ours) == ok


def test_raw_uncompress_max_size():
    stream = host_codec.raw_compress(payload(70_000))
    for max_size in (0, 69_999, 70_000):
        assert host_codec.raw_uncompress(stream, max_size) == jax_host.raw_uncompress(stream, max_size)
    assert host_codec.raw_uncompress(stream, 69_999) == (None, "too_large")


@pytest.mark.parametrize("k", range(len(payloads.window_cases())))
def test_decode_raw_body_into_parallel(parallel, k):
    """The block-parallel path on the window cases: copies that reach an
    earlier 64 KiB block make a segment fail, and the sequential decoder
    gives the bytes and the verdict, as in the JAX package."""
    body, declared, want = payloads.window_cases()[k]
    ours, theirs = np.zeros(declared, np.uint8), np.zeros(declared, np.uint8)
    ok = host_codec.decode_raw_body_into(body, declared, ours)
    assert ok == jax_host.decode_raw_body_into(body, declared, theirs)
    assert np.array_equal(ours, theirs) if ok else True
    if want is not None:
        assert ok and ours.tobytes() == want
    stream = varint.encode_uint32(declared) + body
    assert host_codec.raw_uncompress(stream, MAX) == jax_host.raw_uncompress(stream, MAX)
    # the split streams (every case but the literal across a boundary)
    # went through the segment decoder
    assert bool(parallel) == (k != len(payloads.window_cases()) - 1)


def test_decode_raw_body_into_parallel_boundary_copy_falls_back(parallel):
    """A copy-4 at the start of window 2 reaching into window 0: the
    segment fails, and the sequential decoder returns the payload."""
    body, declared, want = payloads.window_cases()[3]
    out = np.zeros(declared, np.uint8)
    assert host_codec.decode_raw_body_into(body, declared, out) and out.tobytes() == want
    assert parallel, "the parallel path did not run"
    src, offs = np.frombuffer(body, np.uint8), host_codec.scan_raw_blocks(body, declared)
    alone = np.zeros(declared, np.uint8)
    rc = host_codec.lib().stpu_decode_raw_segments(
        src.ctypes.data, offs.ctypes.data, 2, 3, alone.ctypes.data, declared)
    assert rc != 0, "window 2's segment decodes alone"


def test_decode_into_refuses_a_short_buffer():
    stream = host_codec.raw_compress(b"abc" * 100)
    with pytest.raises(ValueError):
        host_codec.decode_raw_body_into(stream[2:], 300, np.zeros(299, np.uint8))
    with pytest.raises(ValueError):
        host_codec.decode_tags_into(stream[2:], 300, np.zeros(300, np.int8))


@pytest.mark.parametrize("with_header", [True, False])
@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("size", SIZES)
def test_framed_compress_and_into(size, level, with_header):
    p = payload(size)
    ours = host_codec.framed_compress(p, with_header, level)
    assert ours == jax_host.framed_compress(p, with_header, level)
    room = C.max_compressed_len_framed(size)
    out, jout = np.zeros(room, np.uint8), np.zeros(room, np.uint8)
    n = host_codec.framed_compress_into(p, out, with_header, level)
    assert n == jax_host.framed_compress_into(p, jout, with_header, level) == len(ours)
    assert out[:n].tobytes() == ours
    short = np.zeros(room - 1, np.uint8)
    assert host_codec.framed_compress_into(p, short, with_header, level) is None
    assert jax_host.framed_compress_into(p, short, with_header, level) is None


def scanned_cases():
    p = payload(200_000)
    s = host_codec.framed_compress(p)
    chunks = framing.scan_frames(s, len(H))
    bad_crc = bytearray(s)
    bad_crc[chunks[1].data_pos] ^= 0x55
    bad_body = bytearray(s)
    comp = [c for c in chunks if c.id == C.CHUNK_COMPRESSED][0]
    _, read = varint.decode_uint32(s[comp.data_pos + 4 : comp.data_pos + 9])
    bad_body[comp.data_pos + 4 + read : comp.data_pos + 6 + read] = b"\x01\xff"
    # the scan refuses an unskippable reserved chunk: record it by hand
    unknown = chunks + [framing.ChunkInfo(0x40, len(s), len(s) + 4, 0, 0)]
    mixed = dict((v[0], v[1]) for v in payloads.framed_vectors())["skippable_and_padding"]
    return [
        ("valid", s, chunks),
        ("bad_crc", bytes(bad_crc), chunks),
        ("bad_body", bytes(bad_body), chunks),
        ("unknown_unskippable", s + payloads.frame(0x40, b""), unknown),
        ("skippable_and_padding", mixed, framing.scan_frames(mixed, len(H))),
        ("short_chunk", H + payloads.frame(C.CHUNK_COMPRESSED, b"\0\0"),
         [framing.ChunkInfo(0, 10, 14, 2, 0)]),
        ("none", s, []),
    ]


SCANNED = scanned_cases()


@pytest.mark.parametrize("check_integrity", [True, False])
@pytest.mark.parametrize("k", range(len(SCANNED)), ids=[c[0] for c in SCANNED])
def test_framed_uncompress_scanned(k, check_integrity):
    _, s, chunks = SCANNED[k]
    jchunks = [jax_framing.ChunkInfo(c.id, c.header_pos, c.data_pos, c.data_len, c.uncompressed_len)
               for c in chunks]
    ours = host_codec.framed_uncompress_scanned(s, chunks, check_integrity)
    assert ours == jax_host.framed_uncompress_scanned(s, jchunks, check_integrity)
    total = sum(c.uncompressed_len for c in chunks)
    out, jout = np.zeros(total, np.uint8), np.zeros(total, np.uint8)
    into = host_codec.framed_uncompress_scanned(s, chunks, check_integrity, out=out)
    assert into == jax_host.framed_uncompress_scanned(s, jchunks, check_integrity, out=jout)
    if ours[0] is not None:
        assert into == (b"", "ok") and out.tobytes() == ours[0]


def test_framed_uncompress_scanned_verdicts():
    got = {name: host_codec.framed_uncompress_scanned(s, ch)[1] for name, s, ch in SCANNED}
    assert got == {"valid": "ok", "bad_crc": "crc", "bad_body": "invalid",
                   "unknown_unskippable": "unknown_chunk", "skippable_and_padding": "ok",
                   "short_chunk": "invalid", "none": "ok"}
    _, s, chunks = SCANNED[1]
    assert host_codec.framed_uncompress_scanned(s, chunks, False)[0] == payload(200_000)


VECTORS = payloads.framed_vectors()


def budgets(data: bytes, budget: int):
    """0, one chunk, the middle of the stream's output, and the vector's own."""
    return sorted({0, 65536, max(1, len(data) // 2), budget})


@pytest.mark.parametrize("k", range(len(VECTORS)), ids=[v[0] for v in VECTORS])
def test_framed_resume_decode_vectors(k):
    name, data, budget, check_integrity, _ = VECTORS[k]
    start = len(H) if data.startswith(H) else 0
    for b in budgets(data, budget):
        for at in (start, len(data)):
            out, jout = np.zeros(b, np.uint8), np.zeros(b, np.uint8)
            ours = host_codec.framed_resume_decode(data, at, out, b, check_integrity)
            assert ours == jax_host.framed_resume_decode(data, at, jout, b, check_integrity), (name, b, at)
            assert np.array_equal(out[: ours[1]], jout[: ours[1]])


@pytest.mark.parametrize("budget", [0, 1, 65536, 100_000, 150_000, 1 << 20])
def test_framed_resume_decode_reentry(budget):
    """Re-entered from each ``read`` until the stream is used up: the same
    steps and the same bytes as the JAX walk."""
    p = payload(300_000)
    s = host_codec.framed_compress(p)
    steps = {}
    for name, fn in (("ours", host_codec.framed_resume_decode), ("jax", jax_host.framed_resume_decode)):
        read, got, seen = len(H), b"", []
        while read < len(s):
            out = np.zeros(budget, np.uint8)
            r, w, reason = fn(s, read, out, budget, True)
            seen.append((r, w, reason))
            if r is None or r == read:
                break
            got += out[:w].tobytes()
            read = r
        steps[name] = (seen, got)
    assert steps["ours"] == steps["jax"]
    if budget >= 65536:
        assert steps["ours"][1] == p
