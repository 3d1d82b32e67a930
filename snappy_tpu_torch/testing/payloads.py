"""Seeded payloads for the framed main path, and pinned vectors.

JAX counterpart: none.  ``chip_smoke.py`` and the tests share these:

* ``mixed_payload`` — the main path's input: 48 MiB and a ragged tail (768
  full 64 KiB frames plus one short frame), made from a seed with numpy
  alone.  It mixes the kinds of data the upstream users frame: SSZ-like
  fixed-width records (Ethereum beacon blocks and states, which Nimbus
  stores framed), text, runs, a short period and incompressible bytes, in
  segments that do not line up with the frames.
* ``GOLDEN_SHA256`` — SHA-256 of the JAX package's level-1 framed encoding
  of ``mixed_payload()`` (``snappy_tpu.engine.framed_compress(payload,
  backend="host", level=1)``; the host C bytes equal the TPU kernel's).  A
  test recomputes it from the JAX package, so it cannot go stale; on the
  card it ties the port to the JAX package without importing jax.
* ``smoke_blocks`` — 8 blocks, one of each kind and size the kernels must
  handle, for comparing each kernel with its plain version.
* ``MALFORMED_RAW`` — a copy of ``tests/test_oracle.MALFORMED_RAW`` (a test
  pins the copy equal to the original), and ``malformed_chunks`` made from
  it for the chunk decoder.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..formats import varint

FRAME = 65536
MAIN_PATH_FRAMES = 768
MAIN_PATH_BYTES = MAIN_PATH_FRAMES * FRAME + 23_456  # + one ragged tail frame
# Seed of the main path's payload: its frames 0 and 1 are stored verbatim
# and frames 5 and 9 compressed, which the error-order checks rely on.
MAIN_PATH_SEED = 1

GOLDEN_SHA256 = "3290f41a2f89899d8bf89109c543ab047772d7d9ed745d80e56f7a3bbf7d4d09"

# Hand-written malformed raw-format vectors, one per validation rule of the
# sequential decoder.  Copied verbatim from tests/test_oracle.py.
MALFORMED_RAW = [
    b"",  # empty input: no varint
    b"\x80",  # truncated varint
    b"\xff\xff\xff\xff\xff\xff\xff\xff\xff\x7f",  # varint overflows u64
    b"\xff\xff\xff\xff\x1f\x00",  # declared len > 2^32-1 (u64 fits, too large)
    b"\x03\x00",  # declared 3, literal of 1 -> written != header
    b"\x01",  # declared 1, no tags
    b"\x01\xf0",  # literal tag len-extension truncated (lc=60 needs 1 byte)
    b"\x05\xfc\xff\xff\xff\xff",  # lc=63, 4-byte len = 0xffffffff wraps on +1
    b"\x02\x00\xff",  # literal of 1+0? lc=0 len1 ok; extra byte -> no, 2 tags: second truncated copy
    b"\x01\x04",  # literal len 2 but only 0 data bytes remain
    b"\x04\x0cab",  # declared 4: literal 'ab' short, then EOF mid-stream
    b"\x02\x01",  # copy1 missing offset byte
    b"\x02\x0a",  # copy2 missing offset bytes
    b"\x02\x03\x01",  # copy4 missing offset bytes
    b"\x04\x00a\x01\x00",  # copy1 offset 0 (lit 'a' then copy offset 0)
    b"\x04\x00a\x01\x02",  # copy1 offset 2 > written 1
    b"\x06\x00a\x0a\x05\x00",  # copy2 len 3.. wait len=1+(0x0a>>2)=3, off 5 > written 1
    b"\x08\x00a\x0e\x01\x00\x00\x00",  # copy4 off 1, len 4 -> writes 4, header says 8 -> mismatch? actually valid copy, written=5 != 8
    b"\x02\x00ab",  # trailing garbage after complete decode (written==header but input remains)
    b"\x00\x00",  # declared 0 but a literal tag follows writing 1 byte
]


class Rand:
    """Counter-based splitmix64 over numpy uint64 arithmetic: the same
    numbers from a seed on every numpy version (numpy's own generators may
    change their streams between releases, which would move the digest)."""

    def __init__(self, seed: int):
        self.seed = np.uint64(seed)
        self.ctr = 0

    def u64(self, n: int) -> np.ndarray:
        i = np.arange(self.ctr + 1, self.ctr + n + 1, dtype=np.uint64)
        self.ctr += n
        z = self.seed + i * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))

    def ints(self, lo: int, hi: int, n: int) -> np.ndarray:
        """n integers in [lo, hi) as int64."""
        return (self.u64(n) % np.uint64(hi - lo)).astype(np.int64) + lo

    def bytes(self, n: int) -> np.ndarray:
        return self.u64(n // 8 + 1).view(np.uint8)[:n].copy()


def _text(rng: Rand, n: int) -> np.ndarray:
    """Words of 1-9 letters and a space, drawn from a vocabulary with the
    low ids most frequent."""
    vocab = 512
    wlen = rng.ints(2, 11, vocab)
    words = (rng.ints(0, 26, vocab * 10) + ord("a")).astype(np.uint8).reshape(vocab, 10)
    words[np.arange(vocab), wlen - 1] = ord(" ")
    k = n // 3 + 16
    ids = np.minimum(np.minimum(rng.ints(0, vocab, k), rng.ints(0, vocab, k)), rng.ints(0, vocab, k))
    flat = words[ids][np.arange(10)[None, :] < wlen[ids][:, None]]
    while len(flat) < n:
        flat = np.concatenate([flat, flat])
    return flat[:n]


def _ssz(rng: Rand, n: int) -> np.ndarray:
    """128-byte SSZ-like records: LE uint64 slot (counting up) and proposer
    index, a parent root from a small pool, a fresh state root, zero
    padding and a signature fragment."""
    r = n // 128 + 1
    rec = np.zeros((r, 128), dtype=np.uint8)
    slot = np.uint64(rng.ints(0, 1 << 24, 1)[0]) + np.arange(r, dtype=np.uint64)
    rec[:, 0:8] = slot.view(np.uint8).reshape(r, 8)
    index = rng.ints(0, 500_000, r).astype(np.uint64)
    rec[:, 8:16] = index.view(np.uint8).reshape(r, 8)
    roots = rng.bytes(16 * 32).reshape(16, 32)
    rec[:, 16:48] = roots[rng.ints(0, 16, r)]
    rec[:, 48:80] = rng.bytes(r * 32).reshape(r, 32)
    rec[:, 112:128] = rng.bytes(r * 16).reshape(r, 16)
    return rec.reshape(-1)[:n]


def _runs(rng: Rand, n: int) -> np.ndarray:
    k = n // 40 + 1
    flat = np.repeat(rng.bytes(k), rng.ints(1, 160, k))
    while len(flat) < n:
        flat = np.concatenate([flat, flat])
    return flat[:n]


def _period8(rng: Rand, n: int) -> np.ndarray:
    flat = np.tile(rng.bytes(8), n // 8 + 1)[:n]
    noise = rng.ints(0, n, n // 4096 + 1)
    flat[noise] = rng.bytes(len(noise))
    return flat


def _random(rng: Rand, n: int) -> np.ndarray:
    return rng.bytes(n)


KINDS = {
    "text": _text,
    "ssz": _ssz,
    "runs": _runs,
    "period8": _period8,
    "random": _random,
}
# Segment kinds drawn uniformly from this list: 30% text, 40% SSZ-like,
# 10% each of runs, period 8 and random.
_DRAW = ["text"] * 3 + ["ssz"] * 4 + ["runs", "period8", "random"]


def mixed_payload(size: int = MAIN_PATH_BYTES, seed: int = MAIN_PATH_SEED) -> bytes:
    """``size`` bytes of segments of 16-256 KiB, each of one kind."""
    rng = Rand(seed)
    parts, have = [], 0
    while have < size:
        n = min(int(rng.ints(16 << 10, 256 << 10, 1)[0]), size - have)
        parts.append(KINDS[_DRAW[int(rng.ints(0, len(_DRAW), 1)[0])]](rng, n))
        have += n
    return np.concatenate(parts).tobytes() if parts else b""


def smoke_blocks(seed: int = 2) -> List[Tuple[str, bytes]]:
    """8 named blocks: one of each kind, a full 64 KiB block of the mixed
    payload, a 17-byte block (the shortest that is not one literal) and an
    empty block."""
    rng = Rand(seed)
    sizes = {"text": 48_000, "ssz": 64_000, "runs": 30_000, "period8": 20_000, "random": 10_000}
    blocks = [(k, KINDS[k](rng, n).tobytes()) for k, n in sizes.items()]
    blocks.append(("mixed_65536", mixed_payload(FRAME, seed)))
    blocks.append(("bytes_17", _text(rng, 17).tobytes()))
    blocks.append(("empty", b""))
    return blocks


def malformed_chunks() -> List[Tuple[bytes, int]]:
    """(tag stream, declared length) pairs for the chunk decoder from
    ``MALFORMED_RAW``: the vector's own varint where it has one that fits a
    chunk, else the whole vector with a declared length of 16."""
    out = []
    for vec in MALFORMED_RAW:
        declared, read = varint.decode_uint32(vec)
        if declared is None or declared > FRAME:
            out.append((vec, 16))
        else:
            out.append((vec[read:], declared))
    return out
