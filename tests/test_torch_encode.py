"""The port's block encoder (kernel K3) at levels 1 and 2 against the JAX
package (exact bytes).

The plain version is held against the TPU kernel itself, run through the
Pallas interpreter (encode_scalar.encode_blocks_words with interpret=True,
ways=1 and ways=2) on small blocks, and against the host C encoder
(snappy_tpu.engine.raw_compress(backend="host") at the same level) on
64 KiB blocks.  The CUDA kernel's source compiled by g++ (the twin) is held
against the plain version on the same inputs.
"""

import random
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snappy_tpu import engine  # noqa: E402
from snappy_tpu.formats import varint  # noqa: E402
from snappy_tpu.ops import encode_scalar  # noqa: E402

from snappy_tpu_torch.formats import constants as C  # noqa: E402
from snappy_tpu_torch.ops import _build, encode_blocks  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

from test_scalar_kernels import PAYLOADS  # noqa: E402


def host_block(data: bytes, level: int = 1) -> bytes:
    """Host C encoding of one block, without the varint header."""
    enc = engine.raw_compress(data, backend="host", level=level)
    _, read = varint.decode_uint32(enc)
    return enc[read:]


def small_blocks():
    rng = random.Random(5)
    blocks = list(PAYLOADS)
    blocks += [bytes(rng.randrange(4) for _ in range(n)) for n in (15, 16, 17, 18, 300, 2048)]
    blocks += [b"abcdefgh" * 200 + bytes(rng.randrange(256) for _ in range(100))]
    return blocks


def big_blocks():
    blocks = [b for _, b in payloads.smoke_blocks()]
    mixed = payloads.mixed_payload(6 * 65536, seed=9)
    return blocks + [mixed[k : k + 65536] for k in range(0, len(mixed), 65536)]


def run_plain(blocks, level=1):
    rows = np.zeros((len(blocks), 65536), dtype=np.uint8)
    for k, b in enumerate(blocks):
        rows[k, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    lens = torch.tensor([len(b) for b in blocks], dtype=torch.int32)
    enc, enc_len = encode_blocks.encode_blocks(torch.from_numpy(rows), lens, level)
    return [enc[k, :n].numpy().tobytes() for k, n in enumerate(enc_len.tolist())]


def test_plain_matches_tpu_kernel_interpreted():
    blocks = small_blocks()
    meta, in_words = encode_scalar.pack_blocks(blocks)
    enc_w, elen = encode_scalar.encode_blocks_words(meta, in_words, len(blocks), interpret=True, level=1)
    want = encode_scalar.unpack_enc(np.asarray(enc_w), np.asarray(elen)[:, 0, 0])

    rows, lens = encode_blocks.from_jax_packed(meta, in_words)
    enc, enc_len = encode_blocks.encode_blocks(rows, lens)
    got = [enc[k, :n].numpy().tobytes() for k, n in enumerate(enc_len.tolist())]
    assert got == want


def test_plain_matches_host_c_on_64k_blocks():
    blocks = big_blocks()
    got = run_plain(blocks)
    for k, b in enumerate(blocks):
        assert got[k] == host_block(b), k
        assert len(got[k]) <= C.max_compressed_len(len(b))


def test_small_blocks_match_host_c():
    blocks = small_blocks()
    assert run_plain(blocks) == [host_block(b) for b in blocks]


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(TypeError):
        encode_blocks.encode_blocks(torch.zeros((1, 64), dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        encode_blocks.encode_blocks(torch.zeros((1, 64), dtype=torch.uint8), torch.tensor([65], dtype=torch.int32))


def l2_blocks():
    """Blocks of 2 KiB or less where level 2 finds other matches than
    level 1 (recurring words, runs), and the size edges."""
    rng = random.Random(17)
    words = [bytes(rng.randrange(97, 123) for _ in range(rng.randrange(2, 7))) for _ in range(40)]
    text = b" ".join(rng.choice(words) for _ in range(600))[:2048]
    return small_blocks()[:8] + [text, text[:700], b"q" * 2000, bytes(rng.randrange(3) for _ in range(1500))]


def test_level2_plain_matches_tpu_kernel_interpreted():
    blocks = l2_blocks()
    meta, in_words = encode_scalar.pack_blocks(blocks)
    enc_w, elen = encode_scalar.encode_blocks_words(meta, in_words, len(blocks), interpret=True, level=2)
    want = encode_scalar.unpack_enc(np.asarray(enc_w), np.asarray(elen)[:, 0, 0])
    assert run_plain(blocks, level=2) == want
    # level 2 makes other choices than level 1 on these blocks
    assert want != run_plain(blocks, level=1)


def test_level2_plain_matches_host_c_on_64k_blocks():
    blocks = big_blocks()
    got = run_plain(blocks, level=2)
    for k, b in enumerate(blocks):
        assert got[k] == host_block(b, level=2), k
    assert sum(map(len, got)) < sum(map(len, run_plain(blocks, level=1)))


def test_level_maps_to_ways():
    """level >= 2 selects ways=2, as engine.py:222 does."""
    blocks = l2_blocks()[8:9]
    assert run_plain(blocks, level=3) == run_plain(blocks, level=2) != run_plain(blocks, level=1)
    assert run_plain(blocks, level=0) == run_plain(blocks, level=1)


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the CPU twin")
    return _build.twin_lib()


def run_twin(twin, blocks, ways):
    rows = np.zeros((len(blocks), 65536), dtype=np.uint8)
    for k, b in enumerate(blocks):
        rows[k, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    lens = np.array([len(b) for b in blocks], dtype=np.int32)
    enc = np.zeros((len(blocks), encode_blocks.ENC_CAP), dtype=np.uint8)
    enc_len = np.zeros(len(blocks), dtype=np.int32)
    rc = twin.stpu_twin_encode_blocks(
        rows.ctypes.data, 65536, lens.ctypes.data, len(blocks),
        enc.ctypes.data, encode_blocks.ENC_CAP, enc_len.ctypes.data, ways,
    )
    assert rc == 0
    return [enc[k, :n].tobytes() for k, n in enumerate(enc_len)]


@pytest.mark.parametrize("which", ["small", "big"])
def test_twin_matches_plain(twin, which):
    blocks = small_blocks() if which == "small" else big_blocks()
    assert run_twin(twin, blocks, 1) == run_plain(blocks)


@pytest.mark.parametrize("which", ["small", "big"])
def test_level2_twin_matches_plain(twin, which):
    blocks = l2_blocks() if which == "small" else big_blocks()
    assert run_twin(twin, blocks, 2) == run_plain(blocks, level=2)
