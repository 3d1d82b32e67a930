"""The plain reference: CRC32C, the masked CRC, the decoder and the level-1 encoder."""

import numpy as np
import pytest
import torch

from benchmark.reference import crc32c, snappy


def test_crc32c_check_value():
    assert crc32c.crc32c(b"123456789") == 0xE3069283
    assert crc32c.crc32c(b"") == 0


def test_masked_crc_of_fixed_vectors():
    # RFC 3720 B.4: 32 bytes of zeros, and of 0xFF
    assert crc32c.crc32c(bytes(32)) == 0x8A9136AA
    assert crc32c.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert crc32c.masked_crc32c(b"") == 0xA282EAD8
    assert crc32c.mask(0xE3069283) == ((0xE3069283 >> 15 | 0xE3069283 << 17) + 0xA282EAD8) & 0xFFFFFFFF
    # the host C runtime's masked CRC, which the framed streams carry
    from snappy_tpu_torch.ops import host_codec

    for data in (b"", b"a", b"123456789", bytes(range(256)) * 300):
        assert crc32c.masked_crc32c(data) == host_codec.masked_crc32c(data)


@pytest.mark.parametrize("width", [0, 1, 31, 32, 33, 100, 4096 + 7])
def test_rows_equal_the_byte_loop(width):
    rng = np.random.default_rng(width)
    rows = torch.from_numpy(rng.integers(0, 256, (9, max(width, 1)), dtype=np.uint8))
    lens = rng.integers(0, width + 1, 9)
    got = crc32c.masked_crc32c_rows(rows, lens, block_rows=4)
    want = [crc32c.masked_crc32c(rows[i, : lens[i]].numpy().tobytes()) for i in range(9)]
    assert got.tolist() == want


VECTORS = [
    (b"", b""),
    (b"\x2chello world!", b"hello world!"),  # one literal of 12
    (b"\x00a\x05\x01", b"aaaaaa"),  # copy-1 of offset 1, self-overlapping
    (b"\x08abc" + bytes([(2 << 2) | 2, 3, 0]), b"abcabc"),  # copy-2
    (b"\x08abc" + bytes([(2 << 2) | 3, 3, 0, 0, 0]), b"abcabc"),  # copy-4
]


@pytest.mark.parametrize("body,want", VECTORS)
def test_decoder_fixed_vectors(body, want):
    assert snappy.decode(body, len(want)) == want


@pytest.mark.parametrize("body,declared", [(b"\x08ab", 3), (b"\x00a\x05\x02", 6), (b"\x00a", 2), (b"\xf0", 61)])
def test_decoder_refuses_malformed(body, declared):
    assert snappy.decode(body, declared) is None


@pytest.mark.parametrize("kind", ["random", "zeros", "period", "records", "short"])
def test_encoder_round_trips_and_matches_the_format(kind):
    rng = np.random.default_rng(1)
    data = {
        "random": rng.integers(0, 256, 65536, dtype=np.uint8).tobytes(),
        "zeros": bytes(65536),
        "period": (b"0123456789abc" * 6000)[:65536],
        "records": b"".join(rng.integers(0, 256, 48, dtype=np.uint8).tobytes() + bytes(40) + b"\xff" * 33
                            for _ in range(500)),
        "short": b"abcdefghijklmnop",
    }[kind]
    enc = snappy.encode_block(data)
    assert snappy.decode(enc, len(data)) == data
    assert len(enc) <= 32 + len(data) + len(data) // 6
    if kind == "zeros":  # a literal of one byte, then copies of 64 bytes at offset 1
        assert enc[:5] == b"\x00\x00" + bytes([(63 << 2) | 2, 1, 0])


def test_decoder_and_encoder_agree_with_the_host_c_runtime():
    from snappy_tpu_torch.ops import host_codec

    rng = np.random.default_rng(2)
    for n in (17, 1000, 65536):
        data = bytes(rng.integers(0, 3, n, dtype=np.uint8)) + bytes(rng.integers(0, 256, 100, dtype=np.uint8))
        data = data[:65536]
        raw = host_codec.raw_compress(data, 1)
        _, hdr = len(data), len(raw) - len(snappy.encode_block(data))
        assert raw[hdr:] == snappy.encode_block(data)
        assert snappy.decode(raw[hdr:], len(data)) == data


def _batch(datas):
    width = 65536 + 65536 // 6 + 64
    enc = torch.zeros((len(datas), width), dtype=torch.uint8)
    rows = torch.zeros((len(datas), 65536), dtype=torch.uint8)
    totals = []
    for i, d in enumerate(datas):
        e = snappy.encode_block(d)
        enc[i, : len(e)] = torch.tensor(list(e), dtype=torch.uint8)
        rows[i, : len(d)] = torch.tensor(list(d), dtype=torch.uint8)
        totals.append(len(e))
    return enc, torch.tensor(totals), rows, [len(d) for d in datas]


def test_bad_streams_agrees_with_the_decoder():
    """Every byte changed in turn, in small pieces: the batched check flags
    the row where the plain decoder does, and no other."""
    rng = np.random.default_rng(3)
    datas = [rng.integers(0, 256, 300, dtype=np.uint8).tobytes(), bytes(700), b"",
             (b"abcdefgh" * 40 + rng.integers(0, 256, 50, dtype=np.uint8).tobytes()) * 3,
             rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()]
    enc, totals, rows, lens = _batch(datas)
    assert not snappy.bad_streams(enc, totals, rows, lens).any()
    assert not snappy.bad_streams(enc, totals, rows, lens, flush_every=2, piece_bytes=64).any()
    for i in (0, 1, 3):
        for j in range(0, int(totals[i]), 7):
            e = enc.clone()
            e[i, j] ^= 0x21
            want = snappy.decode(e[i, : totals[i]].numpy().tobytes(), lens[i]) != datas[i]
            got = snappy.bad_streams(e, totals, rows, lens, flush_every=3, piece_bytes=100)
            assert got.tolist() == [k == i and want for k in range(len(datas))], (i, j)


@pytest.mark.parametrize("fault", ["short_total", "long_total", "over_width", "long_frame", "short_frame"])
def test_bad_streams_refuses_wrong_lengths(fault):
    rng = np.random.default_rng(4)
    enc, totals, rows, lens = _batch([rng.integers(0, 4, 5000, dtype=np.uint8).tobytes(), bytes(99)])
    totals, lens = totals.clone(), list(lens)
    if fault == "short_total":
        totals[0] -= 1
    elif fault == "long_total":
        totals[0] += 1
    elif fault == "over_width":
        totals[0] = enc.shape[1] + 1
    elif fault == "long_frame":
        lens[0] += 1
    else:
        lens[0] -= 1
    assert snappy.bad_streams(enc, totals, rows, lens).tolist() == [True, False]
