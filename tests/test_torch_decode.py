"""The port's chunk decoder (kernel K2) against the JAX package (exact).

The plain version is held against the TPU kernel itself, run through the
Pallas interpreter (decode_scalar.decode_chunks_words with interpret=True)
on streams of 2 KiB or less, and against the host C decoder on 64 KiB
chunks; at the big-window shape (W = 131072) against the TPU kernel at
that shape (decode_scalar.decode_raw_batch_words, interpreted).  Verdicts
(ok), written counts and bytes must be equal.  The CUDA kernel's source
compiled by g++ (the twin) is held against the plain version on the same
inputs.
"""

import random
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snappy_tpu import engine  # noqa: E402
from snappy_tpu.formats import varint  # noqa: E402
from snappy_tpu.ops import decode_scalar, host_codec  # noqa: E402

from snappy_tpu_torch.ops import _build, decode_chunks  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

from test_scalar_kernels import PAYLOADS  # noqa: E402


def tag_stream(data: bytes) -> bytes:
    enc = engine.raw_compress(data, backend="host")
    _, read = varint.decode_uint32(enc)
    return enc[read:]


def copy2(off: int, n: int) -> bytes:
    return bytes([2 | ((n - 1) << 2)]) + off.to_bytes(2, "little")


def literal(data: bytes) -> bytes:
    n = len(data) - 1
    if n < 60:
        return bytes([n << 2]) + data
    if n < 256:
        return bytes([60 << 2, n]) + data
    return bytes([61 << 2, n & 0xFF, n >> 8]) + data


def watch_list():
    """The ROADMAP watch list at chunk scale: copies at offsets 1-3 and
    self-overlapping copies at 4 <= offset < 8, over lengths around the
    emit strides; one literal longer than a comp slice; a copy-4 tag."""
    rng = random.Random(7)
    cases = []
    for off in (1, 2, 3, 4, 5, 7, 8, 16):
        for n in (1, 4, 9, 17, 64):
            head = bytes(rng.randrange(1, 256) for _ in range(off + 2))
            out = bytearray(head)
            for _ in range(n):
                out.append(out[-off])
            cases.append((literal(head) + copy2(off, n) + literal(b"xyz"), len(out) + 3))
    long_lit = bytes(rng.randrange(256) for _ in range(1900))
    cases.append((literal(long_lit), len(long_lit)))
    cases.append((literal(b"abcd") + bytes([3 | (11 << 2)]) + (4).to_bytes(4, "little"), 16))
    return cases


def small_cases():
    """(tag stream, declared) pairs of 2 KiB or less: valid streams,
    malformed vectors, truncations and seeded byte mutations."""
    valid = [(tag_stream(p), len(p)) for p in PAYLOADS] + watch_list()
    cases = list(valid) + payloads.malformed_chunks()
    rng = random.Random(11)
    for body, n in valid:
        if len(body) > 2:
            cases.append((body[: len(body) // 2], n))
            cases.append((body[:-1], n))
            mutant = bytearray(body)
            for _ in range(3):
                mutant[rng.randrange(len(mutant))] = rng.randrange(256)
            cases.append((bytes(mutant), n))
    cases.append((valid[2][0], valid[2][1] + 1))  # declared one byte too many
    return cases


def run_plain(cases):
    comp, offsets = ragged([b for b, _ in cases])
    declared = torch.tensor([n for _, n in cases], dtype=torch.int32)
    out = torch.empty((len(cases), 65536), dtype=torch.uint8)
    ok, written = decode_chunks.decode_chunks(comp, offsets, declared, out)
    return ok.numpy(), written.numpy(), out.numpy()


def ragged(bodies):
    offsets = np.zeros(len(bodies) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(b) for b in bodies])
    comp = np.frombuffer(b"".join(bodies), dtype=np.uint8).copy()
    return torch.from_numpy(comp), torch.from_numpy(offsets)


def test_plain_matches_tpu_kernel_interpreted():
    cases = small_cases()
    meta, comp_words = decode_scalar.pack_chunks([b for b, _ in cases], [n for _, n in cases])
    out_w, status = decode_scalar.decode_chunks_words(meta, comp_words, len(cases), interpret=True)
    status = np.asarray(status)
    want = np.ascontiguousarray(np.asarray(out_w)).view(np.uint8)

    comp, offsets, declared = decode_chunks.from_jax_packed(meta, comp_words)
    out = torch.empty((len(cases), 65536), dtype=torch.uint8)
    ok, written = decode_chunks.decode_chunks(comp, offsets, declared, out)
    ok, written, out = ok.numpy(), written.numpy(), out.numpy()
    assert np.array_equal(ok, status[:, 0, 0] == 1)
    assert np.array_equal(written, status[:, 0, 1])
    for k, w in enumerate(written):
        assert np.array_equal(out[k, :w], want[k, 0, :w]), k
        assert not out[k, w:].any(), k
    assert ok[: len(PAYLOADS)].all() and ok.sum() < len(cases)


def big_cases():
    """64 KiB chunks: the smoke blocks and frames of the mixed payload,
    their truncations, and seeded mutations."""
    blocks = [b for _, b in payloads.smoke_blocks()]
    mixed = payloads.mixed_payload(4 * 65536, seed=5)
    blocks += [mixed[k : k + 65536] for k in range(0, len(mixed), 65536)]
    valid = [(tag_stream(b), len(b)) for b in blocks]
    cases = list(valid)
    rng = random.Random(13)
    for body, n in valid:
        if len(body) > 8:
            cases.append((body[: len(body) - 3], n))
            mutant = bytearray(body)
            mutant[rng.randrange(len(mutant))] ^= 1 << rng.randrange(8)
            cases.append((bytes(mutant), n))
    return cases


def test_plain_matches_host_c_on_64k_chunks():
    cases = big_cases()
    ok, written, out = run_plain(cases)
    for k, (body, n) in enumerate(cases):
        host, host_written = host_codec.decode_tags(body, n)
        host_ok = host is not None and host_written == n
        assert ok[k] == host_ok, k
        if host_ok:
            assert out[k, :n].tobytes() == host, k


def test_body_longer_than_max_compressed_len():
    """Ragged input has no per-chunk capacity: 65535 one-byte copy-4 tags
    make a valid body of 327,677 bytes for a 64 KiB chunk."""
    body = literal(b"q") + (bytes([3]) + (1).to_bytes(4, "little")) * 65535
    ok, written, out = run_plain([(body, 65536)])
    assert ok[0] and written[0] == 65536 and (out[0] == ord("q")).all()


def test_from_jax_packed_roundtrip():
    cases = small_cases()[:5]
    meta, comp_words = decode_scalar.pack_chunks([b for b, _ in cases], [n for _, n in cases])
    comp, offsets, declared = decode_chunks.from_jax_packed(meta, comp_words)
    assert declared.tolist() == [n for _, n in cases]
    assert [comp[offsets[k] : offsets[k + 1]].numpy().tobytes() for k in range(5)] == [
        b for b, _ in cases
    ]


def test_wrapper_rejects_bad_inputs():
    comp, offsets = ragged([b"\x00a"])
    decl = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(TypeError):
        decode_chunks.decode_chunks(comp, offsets.to(torch.int32), decl, torch.empty((1, 64), dtype=torch.uint8))
    with pytest.raises(ValueError):
        decode_chunks.decode_chunks(comp, offsets, decl, torch.empty((1, 131088), dtype=torch.uint8))
    with pytest.raises(ValueError):
        decode_chunks.decode_chunks(comp, offsets, torch.tensor([65], dtype=torch.int32),
                                    torch.empty((1, 64), dtype=torch.uint8))


@pytest.mark.parametrize("host", [False, True])
@pytest.mark.parametrize("bad", ["offsets_past_end", "offsets_negative", "offsets_decrease", "declared_over_w", "declared_negative"])
def test_wrapper_rejects_bad_values(bad, host):
    """Each value refusal, from the tensors themselves and from the host
    arrays a caller passes as ``host_values``."""
    offsets = np.array([0, 2, 4], dtype=np.int64)
    declared = np.array([1, 1], dtype=np.int32)
    if bad == "offsets_past_end":
        offsets[-1] = 5
    elif bad == "offsets_negative":
        offsets[0] = -1
    elif bad == "offsets_decrease":
        offsets[1] = 5
    elif bad == "declared_over_w":
        declared[1] = 65
    else:
        declared[0] = -1
    comp = torch.from_numpy(np.frombuffer(b"\x00a\x00b", dtype=np.uint8).copy())
    out = torch.empty((2, 64), dtype=torch.uint8)
    kw = {"host_values": (offsets, declared)} if host else {}
    with pytest.raises(ValueError):
        decode_chunks.decode_chunks(comp, torch.from_numpy(offsets), torch.from_numpy(declared), out, **kw)


def test_wrapper_accepts_good_values():
    comp = torch.from_numpy(np.frombuffer(b"\x00a\x00b", dtype=np.uint8).copy())
    offsets, declared = np.array([0, 2, 4], dtype=np.int64), np.array([1, 1], dtype=np.int32)
    out = torch.empty((2, 64), dtype=torch.uint8)
    ok, written = decode_chunks.decode_chunks(
        comp, torch.from_numpy(offsets), torch.from_numpy(declared), out, host_values=(offsets, declared))
    assert ok.all() and written.tolist() == [1, 1] and out[:, 0].tolist() == [97, 98]


BIG = decode_chunks.MAX_OUT


def run_plain_big(cases):
    comp, offsets = ragged([b for b, _ in cases])
    declared = torch.tensor([n for _, n in cases], dtype=torch.int32)
    out = torch.empty((len(cases), BIG), dtype=torch.uint8)
    ok, written = decode_chunks.decode_chunks(comp, offsets, declared, out)
    return ok.numpy(), written.numpy(), out.numpy()


def test_big_window_plain_matches_tpu_kernel_interpreted():
    cases = payloads.big_window_cases()
    meta, comp_words = decode_scalar.pack_raw_batch([b for b, _ in cases], [n for _, n in cases])
    out_w, status = decode_scalar.decode_raw_batch_words(meta, comp_words, len(cases), interpret=True)
    status = np.asarray(status)
    want = np.ascontiguousarray(np.asarray(out_w)).view(np.uint8)
    ok, written, out = run_plain_big(cases)
    assert np.array_equal(ok, status[:, 0, 0] == 1)
    assert np.array_equal(written, status[:, 0, 1])
    for k, w in enumerate(written):
        assert np.array_equal(out[k, :w], want[k, 0, :w]), k
        assert not out[k, w:].any(), k
    assert ok[:3].all() and not ok[3:5].any()


def test_big_window_counts_its_own_launches():
    """The wrapper counts launches at W <= 65536 and W > 65536 apart (a CPU
    tensor runs the plain version and counts nothing)."""
    before = (decode_chunks.LAUNCHES, decode_chunks.LAUNCHES_BIG)
    run_plain_big(payloads.big_window_cases()[:1])
    assert (decode_chunks.LAUNCHES, decode_chunks.LAUNCHES_BIG) == before


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the CPU twin")
    return _build.twin_lib()


def test_big_window_twin_matches_plain(twin):
    cases = payloads.big_window_cases()
    comp, offsets = ragged([b for b, _ in cases])
    declared = np.array([n for _, n in cases], dtype=np.int32)
    comp, offsets = comp.numpy(), offsets.numpy()
    out = np.full((len(cases), BIG), 0xAA, dtype=np.uint8)
    ok = np.zeros(len(cases), dtype=np.uint8)
    written = np.zeros(len(cases), dtype=np.int32)
    rc = twin.stpu_twin_decode_chunks(
        comp.ctypes.data, offsets.ctypes.data, declared.ctypes.data, len(cases),
        out.ctypes.data, BIG, ok.ctypes.data, written.ctypes.data,
    )
    assert rc == 0
    pok, pwritten, pout = run_plain_big(cases)
    assert np.array_equal(ok.astype(bool), pok)
    assert np.array_equal(written, pwritten)
    assert np.array_equal(out, pout)


@pytest.mark.parametrize("which", ["small", "big"])
def test_twin_matches_plain(twin, which):
    cases = small_cases() if which == "small" else big_cases()
    comp, offsets = ragged([b for b, _ in cases])
    declared = np.array([n for _, n in cases], dtype=np.int32)
    comp, offsets = comp.numpy(), offsets.numpy()
    out = np.full((len(cases), 65536), 0xAA, dtype=np.uint8)
    ok = np.zeros(len(cases), dtype=np.uint8)
    written = np.zeros(len(cases), dtype=np.int32)
    rc = twin.stpu_twin_decode_chunks(
        comp.ctypes.data, offsets.ctypes.data, declared.ctypes.data, len(cases),
        out.ctypes.data, 65536, ok.ctypes.data, written.ctypes.data,
    )
    assert rc == 0
    pok, pwritten, pout = run_plain(cases)
    assert np.array_equal(ok.astype(bool), pok)
    assert np.array_equal(written, pwritten)
    assert np.array_equal(out, pout)
