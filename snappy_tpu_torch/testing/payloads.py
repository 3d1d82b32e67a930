"""Seeded payloads for the main paths, and pinned vectors.

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
  ``RAW_L1_SHA256``, ``RAW_L2_SHA256`` and ``FRAMED_L2_SHA256`` pin the
  same payload's raw stream at levels 1 and 2
  (``snappy_tpu.engine.raw_compress(payload, backend="host", level=L)``)
  and its framed stream at level 2, the same way.
* ``serving_batch`` — the raw batch decoder's input: one-block streams,
  unsplittable streams of 70-128 KiB, one large stream and malformed ones.
* ``big_window_cases`` and ``stream_cases`` — tag streams for the chunk
  decoder's big-window shape and for the streaming decoders, the ROADMAP's
  watch list included (segments across window edges, far copies);
  ``scan_edge_cases`` adds the history limit of the scan-mode decoder,
  ``window_cases`` the window route of the grid-mode decoder (copies that
  reach an earlier window, chains of them, mutants that keep the index).
* ``smoke_blocks`` — 8 blocks, one of each kind and size the kernels must
  handle, for comparing each kernel with its plain version.
* ``encoder_cases`` and ``encoder_blocks`` — blocks for the block
  encoder: named cases of its warp's batch logic and its edges, then
  seeded blocks of every kind and of adversarial kinds (runs broken by
  one byte, short and 2047/2048-byte periods, planted words that share
  hash buckets) at random lengths, for the differential against the host
  C encoder.
* ``framed_vectors`` — framed streams for ``uncompress_framed_into`` with
  a budget and the pinned result: the resume point, the walk's error
  order and the CRC checked before the fit.
* ``decoder_cases`` and ``mutation_streams`` — named cases of the chunk
  decoder's batch logic, and seeded streams and mutants for the decoder
  differential against the host C decoder.
* ``MALFORMED_RAW`` — a copy of ``tests/test_oracle.MALFORMED_RAW`` (a test
  pins the copy equal to the original), and ``malformed_chunks`` made from
  it for the chunk decoder.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from ..engine import masked_crc32c
from ..formats import constants as C
from ..formats import varint
from ..ops.decode_stream import _tag
from ..ops.encode_blocks import encode_block, hash_word, table_bits

FRAME = 65536
MAIN_PATH_FRAMES = 768
MAIN_PATH_BYTES = MAIN_PATH_FRAMES * FRAME + 23_456  # + one ragged tail frame
# Seed of the main path's payload: its frames 0 and 1 are stored verbatim
# and frames 5 and 9 compressed, which the error-order checks rely on.
MAIN_PATH_SEED = 1

GOLDEN_SHA256 = "3290f41a2f89899d8bf89109c543ab047772d7d9ed745d80e56f7a3bbf7d4d09"
RAW_L1_SHA256 = "6c6af1e5ce4b8a5b191cb9189a1e80305316c68dcd461ee554fb76e7baeb4029"
RAW_L2_SHA256 = "f12efea7b7276fedde406cafda243e7caf6e7c7ce361cb5544c3c4be669b7011"
FRAMED_L2_SHA256 = "49b5f8fe31e2b3268316b15fdd629d68da91d6a9a0e0aaaa24d0a8cb65c4d5b9"

SERVING_SEED = 3
SERVING_SMALL = 256  # one-block streams of 40-60 KB
SERVING_STRADDLE = 8  # unsplittable streams of 70-128 KiB

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


def _colliding(rng: Rand, word: int, bits: int) -> int:
    """Another 4-byte word with ``word``'s hash at ``bits`` bits."""
    want = hash_word(word, bits)
    while True:
        cand = rng.u64(1 << 16) & np.uint64(0xFFFFFFFF)
        for k in np.nonzero(hash_word(cand, bits) == want)[0]:
            if int(cand[k]) != word:
                return int(cand[k])


def _place(block: np.ndarray, pos: int, word: int) -> None:
    block[pos : pos + 4] = np.frombuffer(word.to_bytes(4, "little"), dtype=np.uint8)


def _match_block(rng: Rand, offset: int, length: int, tail: int = 64) -> bytes:
    """A block whose first match is ``length`` bytes at ``offset`` (at most
    32, inside the first batch of probes): ``offset`` random bytes, their
    periodic extension for ``length`` bytes, a byte that ends the match and
    ``tail`` random bytes."""
    head = np.resize(rng.bytes(offset), offset + length)
    stop = np.array([head[length] ^ 0xFF], dtype=np.uint8)
    return np.concatenate([head, stop, rng.bytes(tail)]).tobytes()


def _broken_runs(rng: Rand, n: int) -> np.ndarray:
    """One byte value, broken by a single other byte every ~50 bytes."""
    c = int(rng.ints(0, 256, 1)[0])
    flat = np.full(n, c, dtype=np.uint8)
    if n:
        flat[rng.ints(0, n, n // 50 + 1)] = c ^ 1
    return flat


def _short_period(rng: Rand, n: int) -> np.ndarray:
    """A period of 1-8 bytes (offsets 1-8, self-overlapping copies)."""
    return np.resize(rng.bytes(int(rng.ints(1, 9, 1)[0])), n)


def _long_period(rng: Rand, n: int) -> np.ndarray:
    """Random bytes repeated with a period of 2047 or 2048 (the copy-1 and
    copy-2 offset edge)."""
    return np.resize(rng.bytes(int(rng.ints(2047, 2049, 1)[0])), n)


def _shared_buckets(rng: Rand, n: int) -> np.ndarray:
    """Random bytes with 8 words planted at n / 16 random places: probes of
    one batch share buckets and hit earlier lanes."""
    flat = rng.bytes(n)
    if n >= 4:
        words = rng.ints(0, 1 << 32, 8)
        for pos, w in zip(rng.ints(0, n - 3, n // 16), rng.ints(0, 8, n // 16)):
            _place(flat, int(pos), int(words[w]))
    return flat


def encoder_cases(seed: int = 61) -> List[Tuple[str, bytes]]:
    """Named blocks for the block encoder's batch logic and its edges:
    probes that share a bucket within one batch of 32 (2, 3 and 32 of
    them), the first hit at lane 0, lane 31 or in no lane of a batch, skip
    steps of 2 and more across batches, ip_limit inside a batch, a
    candidate at position 0, matches that run to the end, match lengths and
    offsets at the tag edges, and block lengths at the size edges (the hash
    table scales with the block)."""
    rng = Rand(seed)
    cases = []
    b = rng.bytes(128)  # lane 19 hits the position lane 2 stored in its batch
    w = int(rng.ints(0, 1 << 32, 1)[0])
    _place(b, 3, w)
    _place(b, 20, w)
    cases.append(("bucket_2", b.tobytes()))
    # X at 3, Y with X's hash at 10, X at 20: level 1 misses at 20 (its
    # candidate is 10), level 2 hits its second candidate, 3
    b = rng.bytes(128)
    x = int(rng.ints(0, 1 << 32, 1)[0])
    _place(b, 3, x)
    _place(b, 10, _colliding(rng, x, table_bits(128)))
    _place(b, 20, x)
    cases.append(("bucket_3", b.tobytes()))
    cases.append(("bucket_32_run", b"\x07" * 300))
    cases.append(("runs_broken", (b"a" * 37 + b"b") * 20 + b"a" * 300 + b"c" + b"a" * 5))
    cases += [(f"period_{p}", np.resize(rng.bytes(p), 1000 + p).tobytes()) for p in range(1, 9)]
    cases.append(("hit_lane_0", _match_block(rng, 1, 30)))
    cases.append(("hit_lane_31_at_0", _match_block(rng, 32, 40)))
    cases.append(("no_hit_4096", rng.bytes(4096).tobytes()))
    cases.append(("skip_steps_20000", rng.bytes(20000).tobytes()))
    cases += [(f"limit_in_batch_{n}", rng.bytes(n).tobytes()) for n in (20, 40, 47, 60)]
    cases.append(("limit_after_match", _match_block(rng, 5, 20, tail=0)))
    cases.append(("match_to_end", np.resize(rng.bytes(7), 500).tobytes()))
    head = rng.bytes(20).tobytes()
    cases.append(("match_to_end_40", head + head))
    cases += [(f"length_{k}", _match_block(rng, 9, k)) for k in (4, 11, 12, 60, 64, 67, 68, 69, 200, 1000)]
    cases += [(f"offset_{o}", _match_block(rng, o, 100)) for o in (1, 2, 3)]
    cases += [(f"offset_{o}", np.resize(rng.bytes(o), 16 * o).tobytes()) for o in (2047, 2048)]
    sizes = (0, 16, 17, 18, 33, 255, 256, 257, 4096, 16384, 16385, 65535, 65536)
    cases += [(f"size_{n}", mixed_payload(n, seed=seed + n)) for n in sizes]
    return cases


ENCODER_KINDS = {
    **KINDS,
    "broken_runs": _broken_runs,
    "short_period": _short_period,
    "long_period": _long_period,
    "shared_buckets": _shared_buckets,
}


def encoder_blocks(count: int, seed: int = 67) -> List[bytes]:
    """``encoder_cases`` and then seeded blocks up to ``count`` in all: each
    of a kind of ENCODER_KINDS or a slice of the mixed payload, in turn, at
    a random length of 1 to 65,536 bytes."""
    rng = Rand(seed)
    blocks = [b for _, b in encoder_cases()]
    kinds = list(ENCODER_KINDS.values())
    while len(blocks) < count:
        n = int(rng.ints(1, FRAME + 1, 1)[0])
        k = len(blocks) % (len(kinds) + 1)
        if k == len(kinds):
            blocks.append(mixed_payload(n, seed=int(rng.ints(0, 1 << 30, 1)[0])))
        else:
            blocks.append(kinds[k](rng, n).tobytes())
    return blocks


def literal(data: bytes) -> bytes:
    """A literal tag of any length (1 to 2^32 bytes) and its bytes."""
    n = len(data) - 1
    if n < 60:
        return bytes([n << 2]) + data
    extra = (n.bit_length() + 7) // 8
    return bytes([(59 + extra) << 2]) + n.to_bytes(extra, "little") + data


def copy2(offset: int, length: int) -> bytes:
    """A copy tag with a 2-byte offset (length 1-64)."""
    return bytes([2 | ((length - 1) << 2)]) + offset.to_bytes(2, "little")


def body_of(stream: bytes) -> bytes:
    """The tag stream of a raw stream (its varint header dropped)."""
    _, read = varint.decode_uint32(stream)
    return stream[read:]


def serving_batch(
    encode_batch: Callable[[List[bytes]], List[bytes]],
    n_small: int = SERVING_SMALL,
    big: int = MAIN_PATH_BYTES,
    seed: int = SERVING_SEED,
) -> Tuple[List[bytes], List[Optional[bytes]]]:
    """A seeded batch of raw streams for the batch decoder, and the payload
    each must decode to (None for a malformed stream):

    * ``n_small`` one-block streams of 40-60 KB of one kind each;
    * ``SERVING_STRADDLE`` unsplittable streams of 70-128 KiB: a block's
      encoding, then one op whose output straddles the 64 KiB boundary (a
      literal of up to 10 KB, or a copy of up to 64 bytes, alternately),
      then the rest's encoding.  The block scan refuses them;
    * ``mixed_payload(big)``'s stream (the scan splits it into its blocks);
    * 4 malformed streams: a truncated one-block stream; a 3-block stream
      whose second block holds a copy at offset 0 (the scan splits it, its
      segment fails and the whole-stream decoder rejects it); a valid
      one-block body under a declared length one too large; a varint that
      overflows.

    ``encode_batch`` maps payloads to raw streams (any encoder of the
    format: the streams' bodies are spliced by block)."""
    rng = Rand(seed)
    small = []
    for _ in range(n_small):
        kind = _DRAW[int(rng.ints(0, len(_DRAW), 1)[0])]
        small.append(KINDS[kind](rng, int(rng.ints(40_000, 60_001, 1)[0])).tobytes())
    straddle, pieces = [], []
    for k in range(SERVING_STRADDLE):
        n = int(rng.ints(70 << 10, (128 << 10) + 1, 1)[0])
        p = mixed_payload(n, seed + 100 + k)
        if k % 2 == 0:  # one literal over the boundary
            a = FRAME - int(rng.ints(1, 5000, 1)[0])
            b = FRAME + int(rng.ints(1, 5000, 1)[0])
            op = literal(p[a:b])
        else:  # one copy over the boundary: make its source bytes repeat
            length = int(rng.ints(5, 65, 1)[0])
            a = FRAME - int(rng.ints(1, length, 1)[0])
            b = a + length
            off = int(rng.ints(length, 2000, 1)[0])
            arr = bytearray(p)
            arr[a:b] = arr[a - off : b - off]
            p = bytes(arr)
            op = copy2(off, length)
        straddle.append((p, op))
        pieces += [p[:a], p[b:]]
    blocks3 = mixed_payload(3 * FRAME - 777, seed + 200)
    big_payload = mixed_payload(big, seed=MAIN_PATH_SEED)
    enc = encode_batch(small + pieces + [blocks3[:FRAME], blocks3[2 * FRAME :], big_payload])

    streams = list(enc[:n_small])
    expect: List[Optional[bytes]] = list(small)
    for k, (p, op) in enumerate(straddle):
        body = body_of(enc[n_small + 2 * k]) + op + body_of(enc[n_small + 2 * k + 1])
        streams.append(varint.encode_uint32(len(p)) + body)
        expect.append(p)
    streams.append(enc[-1])
    expect.append(big_payload)

    head, mid, tail = enc[-3], blocks3[FRAME : 2 * FRAME], enc[-2]
    bad_mid = literal(mid[:100]) + copy2(0, 4) + literal(mid[104:])
    streams += [
        enc[0][:-3],
        varint.encode_uint32(len(blocks3)) + body_of(head) + bad_mid + body_of(tail),
        varint.encode_uint32(len(small[1]) + 1) + body_of(enc[1]),
        b"\xff" * 6,
    ]
    expect += [None] * 4
    return streams, expect


def copy4(offset: int, length: int) -> bytes:
    """A copy tag with a 4-byte offset (length 1-64)."""
    return bytes([3 | ((length - 1) << 2)]) + offset.to_bytes(4, "little")


def raw_body(data: bytes) -> bytes:
    """The level-1 raw tag stream of ``data`` (no varint header), from the
    port's plain block encoder: the JAX package's bytes."""
    return b"".join(encode_block(data[k : k + FRAME]) for k in range(0, len(data), FRAME))


def _mutants(body: bytes, rng: Rand, count: int) -> List[bytes]:
    out = []
    for _ in range(count):
        b = bytearray(body)
        for _ in range(int(rng.ints(1, 3, 1)[0])):
            b[int(rng.ints(0, len(b), 1)[0])] ^= 1 << int(rng.ints(0, 8, 1)[0])
        out.append(bytes(b))
    return out


def big_window_cases(seed: int = 19) -> List[Tuple[bytes, int]]:
    """(tag stream, declared) pairs for the chunk decoder at 128 KiB: a
    100 KB one-literal stream, 128 KiB of RLE, mixed data over the 64 KiB
    boundary, a 64 KiB stream declaring 131 KiB, then a half, a one byte
    short and a mutated copy of each of the first three."""
    rng = Rand(seed)
    mixed = mixed_payload(120_000, seed)
    valid = [
        (literal(rng.bytes(100_000).tobytes()), 100_000),
        (raw_body(b"r" * 131_072), 131_072),
        (raw_body(mixed), len(mixed)),
    ]
    cases = valid + [(raw_body(mixed[:FRAME]), 131_072)]
    for body, n in valid:
        cases += [(body[: len(body) // 2], n), (body[:-1], n)]
        cases += [(m, n) for m in _mutants(body, rng, 1)]
    return cases


def stream_cases(seed: int = 41) -> List[Tuple[bytes, int, Optional[bytes]]]:
    """(tag stream, declared, payload or None) triples for the streaming
    decoder: multi-window RLE and text; 65535, 65536, 65537 and 131072
    bytes; one literal over 400 KB; copy-4 tags reaching more than 64 KiB
    back, one of them over a window edge, and one reaching a byte too far;
    literals and near and far copies cut by a window edge; six mutants of
    the text stream; truncated input, a short and a long declared length,
    trailing input and a copy past the declared length."""
    rng = Rand(seed)
    text = (b"the quick brown fox jumps over the lazy dog. " * 4000)[:140_000]
    out: List[Tuple[bytes, int, Optional[bytes]]] = []
    for p in (b"a" * 140_000, text, b"q" * 65535, b"q" * 65536, b"q" * 65537, b"q" * 131_072):
        out.append((raw_body(p), len(p), p))
    lit = rng.bytes(400_000).tobytes()
    out.append((literal(lit), len(lit), lit))
    head = rng.bytes(131_072).tobytes()
    body = literal(head[:70_000]) + copy4(70_000, 64) + literal(head[70_064:131_062]) + copy4(100_000, 40)
    p = head[:70_000] + head[:64] + head[70_064:131_062]  # 131,062 bytes
    p += p[len(p) - 100_000 : len(p) - 100_000 + 40]
    out.append((body, len(p), p))
    out.append((literal(head[:70_000]) + copy4(70_001, 8), 70_008, None))
    for cut in (1, 2, 17, 32):
        # a literal over the 64 KiB edge and a near (offset 3) copy over the
        # 128 KiB edge; a copy over the 128 KiB edge whose rest lies more
        # than 64 KiB behind the new window
        a = FRAME - cut
        p = head[: a + 2 * cut] + head[: 131_072 - cut - (a + 2 * cut)]
        body = literal(head[:a]) + literal(head[a : a + 2 * cut]) + literal(p[a + 2 * cut :])
        for k in range(2 * cut):
            p += p[-3:-2]
        out.append((body + copy2(3, 2 * cut), len(p), p))
        p = head[: 131_072 - cut]
        for k in range(2 * cut):
            p += p[len(p) - 65_541 - cut : len(p) - 65_540 - cut]
        out.append((literal(head[: 131_072 - cut]) + copy4(65_541 + cut, 2 * cut), len(p), p))
    base = raw_body(text)
    out += [(m, len(text), None) for m in _mutants(base, rng, 6)]
    out.append((base[:-3], len(text), None))
    out.append((base, len(text) - 1, None))
    out.append((base, len(text) + 1, None))
    out.append((base + b"\x00", len(text), None))
    out.append((base + copy2(1, 4), len(text), None))
    return out


def scan_edge_cases(seed: int = 43) -> List[Tuple[bytes, int, bytes]]:
    """(tag stream, declared, payload) triples at the scan-mode decoder's
    history limit: copies reaching exactly 64 KiB behind their window's
    start (served) and one byte further (``unsupported`` in scan mode), at
    a window start, inside a window and split by a window's end.  Every
    stream is valid."""
    head = Rand(seed).bytes(140_000).tobytes()
    out = []
    # (output before the copy, the farthest offset in reach): at the start
    # of window 2, 100 bytes into it, and 4 bytes before its end, where the
    # copy splits and its rest resumes at the next window's start
    for lead, reach in ((131_072, FRAME), (131_172, FRAME + 100), (131_068, FRAME)):
        for off in (reach, reach + 1):
            p = bytearray(head[:lead])
            for _ in range(8):
                p.append(p[-off])
            out.append((literal(head[:lead]) + copy4(off, 8), len(p), bytes(p)))
    return out


def ops_stream(ops) -> Tuple[bytes, bytes]:
    """(tag stream, payload) of a list of ops: ``bytes`` for a literal,
    ``(offset, length)`` for a copy-4 (length 1-64)."""
    body, p = bytearray(), bytearray()
    for op in ops:
        if isinstance(op, bytes):
            body += literal(op)
            p += op
        else:
            off, length = op
            body += copy4(off, length)
            for _ in range(length):
                p.append(p[-off])
    return bytes(body), bytes(p)


def _copy_tags(body: bytes) -> List[Tuple[int, int, int]]:
    """(input offset, tag kind, output offset) of every copy tag of a valid
    tag stream."""
    return [t for t in _tag_starts(body) if t[1]]


def _set_offset(b: bytearray, q: int, kind: int, off: int) -> None:
    """Rewrite the offset of the copy tag at b[q] (its kind can hold it)."""
    if kind == 1:
        b[q] = (b[q] & 0x1F) | ((off >> 8) << 5)
        b[q + 1] = off & 0xFF
    else:
        b[q + 1 : q + (3 if kind == 2 else 5)] = off.to_bytes(2 if kind == 2 else 4, "little")


def window_cases(seed: int = 53) -> List[Tuple[bytes, int, Optional[bytes]]]:
    """(tag stream, declared, payload or None) triples for the window route
    of the streaming decoder (decode_stream with in_offs):

    * block-encoded streams of about 300 KB of runs, text and the mixed
      payload: no copy reaches an earlier window;
    * a copy-4 at the start of window 2 reaching into window 0, a copy from
      20 bytes before window 2 into it, then a short fourth window: one
      deferred window;
    * a chain: windows 2, 3 and 4 each copy from the window before, which
      is itself deferred, and window 3 holds a repeating copy (offset 20,
      length 40) whose period starts 10 bytes before it;
    * ten mutants of the mixed stream that keep every tag's length, so the
      index still builds: a copy offset set to 0 in a window after the
      first, after a copy made to reach the window before in the same
      window, in an earlier one, or alone;
    * a literal across a 64 KiB boundary: no index (the whole-stream walk).

    Every tag of the first three kinds falls on the window boundaries."""
    rng = Rand(seed)
    out: List[Tuple[bytes, int, Optional[bytes]]] = []
    mixed = mixed_payload(300_000, seed)
    for p in (_runs(rng, 300_000).tobytes(), _text(rng, 300_000).tobytes(), mixed):
        out.append((raw_body(p), len(p), p))

    w = [rng.bytes(FRAME).tobytes() for _ in range(3)]
    body, p = ops_stream([w[0], w[1], (100_000, 64), w[2][:36], (120, 50),
                          w[2][: FRAME - 150], w[2][:1000]])
    out.append((body, len(p), p))
    body, p = ops_stream([
        w[0], w[1],
        (70_000, 64), w[2][: FRAME - 64],
        w[2][:10], (20, 40), (FRAME + 50, 64), w[1][: FRAME - 114],
        (FRAME, 64), w[0][:5000],
    ])
    out.append((body, len(p), p))

    base = raw_body(mixed)
    copies = [c for c in _copy_tags(base) if c[2] >= FRAME]
    for t in range(10):
        b = bytearray(base)
        q, kind, o = copies[int(rng.ints(len(copies) // 3, len(copies), 1)[0])]
        _set_offset(b, q, kind, 0)
        k = o // FRAME
        # a copy-2 made to reach the window before: in this window, ahead
        # of the bad tag, or in an earlier window after the first
        lo = k * FRAME if t % 3 == 0 else FRAME
        hi = o if t % 3 == 0 else k * FRAME
        reach = [c for c in copies if c[1] == 2 and lo <= c[2] < hi and c[2] % FRAME < 65_000]
        if t % 3 != 2 and reach:
            rq, _, ro = reach[int(rng.ints(0, len(reach), 1)[0])]
            _set_offset(b, rq, 2, ro % FRAME + 1 + int(rng.ints(0, 500, 1)[0]))
        out.append((bytes(b), len(mixed), None))

    x = mixed_payload(200_000, seed + 1)
    out.append((raw_body(x[:60_000]) + literal(x[60_000:70_000]) + raw_body(x[70_000:]), len(x), x))
    return out


def scan_differential_cases() -> List[Tuple[bytes, int, bytes]]:
    """(tag stream, declared, payload) triples: the JAX package's grid-
    versus-scan payloads (tests/test_scalar_kernels.py:503-516: text of one
    window and one byte more, pending segments over windows,
    incompressible, RLE) and its split copy beyond the scan's history
    (:136-176), made with the port's level-1 encoder."""
    text = b"grid versus scan differential payload text " * 4000
    out = [(raw_body(p), len(p), p) for p in (
        text[:65536], text[:65537], text[:140_000], Rand(21).bytes(90_000).tobytes(), b"z" * 200_000,
    )]
    rng = Rand(13)
    body, p = bytearray(), bytearray()
    for n in (65000, 60000, 6040):
        chunk = rng.bytes(n).tobytes()
        body += literal(chunk)
        p += chunk
    body += copy4(70000, 64)
    for _ in range(64):
        p.append(p[-70000])
    tail = rng.bytes(3).tobytes()
    out.append((bytes(body + literal(tail)), len(p) + 3, bytes(p + tail)))
    return out


def scan_window_cases(seed: int = 79) -> List[Tuple[bytes, int, Optional[bytes]]]:
    """(tag stream, declared, payload or None) triples for the window route
    of the scan-mode decoder (decode_stream_scan with in_offs), in order:

    * ragged: 70,000 one-byte literals, then 70,000 length-1 copy-4 tags:
      every comp window drains before 64 KiB of output, so the steps are
      walked and their lengths leave the 64 KiB grid;
    * resync: a block-encoded window, a window that opens with a copy into
      the window before (legal in the scan, refused by K2), then two
      block-encoded windows;
    * the history limit inside a window: two literal windows, then a copy
      100 bytes into window 2 that reaches exactly 64 KiB behind the
      window's start (served), then a block-encoded window; and the same
      copy one byte further (``unsupported``);
    * a bad tag (a copy at offset 0) in window 2, after window 1 opened
      with a copy into window 0;
    * a chain: windows 1, 2 and 3 each open with a copy into the window
      before, and window 4 is block-encoded;
    * the comp window's MARGIN: a literal window, then two windows of
      short literals ending in four one-byte literals, whose input ends
      exactly MARGIN (8) bytes before the end of the scan's comp window of
      76,800 bytes (clean) and 4 bytes before it (the scan stops before
      the last tag and the steps leave the grid), then a block-encoded
      window;
    * three block-encoded windows declaring 5,000 bytes more than they
      hold: the scan sets done at the stream's end (the host index does
      not build for it; scan_forced_index_cases gives it one);
    * a declared length of 0.

    Every tag falls on the 64 KiB output boundaries, so the host index
    builds for all but the last two."""
    rng = Rand(seed)
    x = mixed_payload(4 * FRAME, seed)
    w = [x[k * FRAME : (k + 1) * FRAME] for k in range(4)]
    out: List[Tuple[bytes, int, Optional[bytes]]] = []

    ones = rng.bytes(70_000).tobytes()
    offs = rng.ints(1, 4000, 70_000).tolist()
    body, p = bytearray(b"".join(literal(ones[k : k + 1]) for k in range(70_000))), bytearray(ones)
    for off in offs:
        body += copy4(off, 1)
        p.append(p[-off])
    out.append((bytes(body), len(p), bytes(p)))

    p = w[0] + w[0][-300:-236] + w[1][64:] + w[2] + w[3]
    body = encode_block(w[0]) + copy4(300, 64) + encode_block(w[1][64:]) + encode_block(w[2])
    out.append((body + encode_block(w[3]), len(p), p))

    for off in (FRAME + 100, FRAME + 101):
        head = literal(w[0]) + literal(w[1]) + literal(w[2][:100])
        p = bytearray(w[0] + w[1] + w[2][:100])
        for _ in range(8):
            p.append(p[-off])
        p += w[2][108:] + w[3]
        tail = literal(w[2][108:]) + encode_block(w[3])
        out.append((head + copy4(off, 8) + tail, len(p), bytes(p)))

    body = encode_block(w[0]) + copy4(300, 64) + encode_block(w[1][64:])
    body += literal(w[2][:1000]) + copy2(0, 10) + literal(w[2][1010:])
    out.append((body, 3 * FRAME, None))

    body, p = bytearray(encode_block(w[0])), bytearray(w[0])
    for k in (1, 2, 3):
        body += copy4(FRAME - 7 * k, 40) + encode_block(w[k][40:])
        p += p[len(p) - (FRAME - 7 * k) :][:40] + w[k][40:]
    body += encode_block(x[:5000])
    p += x[:5000]
    out.append((bytes(body), len(p), bytes(p)))

    body, p = bytearray(literal(w[0])), bytearray(w[0])
    for end in (76_792, 76_796):  # input end - word-aligned window start
        span = end - (len(body) & 3) - 8
        count = span - (FRAME - 4)  # literals of 5 and 6 bytes: one header byte each
        sixes = FRAME - 4 - 5 * count
        data = rng.bytes(FRAME).tobytes()
        q = 0
        for k in range(count + 4):
            n = 6 if k < sixes else 5 if k < count else 1
            body += literal(data[q : q + n])
            q += n
        p += data
    body += encode_block(w[3])
    p += w[3]
    out.append((bytes(body), len(p), bytes(p)))

    p = w[0] + w[1] + w[2]
    out.append((raw_body(p), len(p) + 5000, None))
    out.append((raw_body(w[0][:40]), 0, None))
    return out


def scan_forced_index_cases(seed: int = 83) -> List[Tuple[bytes, int, np.ndarray]]:
    """(tag stream, declared, in_offs) triples: window indices that the
    host's block scan does not give, for the scan-mode decoder's window
    route, whose result must not depend on the index:

    * three block-encoded windows declaring 5,000 bytes more than they
      hold, on their true windows plus an empty fourth: window 2's step
      sets done, with the output short of the declared length;
    * a copy over the first 64 KiB boundary (6 bytes before it, 4 after),
      then a 64 KiB literal window and a short one, on an index whose
      second window starts after the copy tag: the scan reaches it on the
      grid and at its offset, but with the copy's 4 bytes pending;
    * a 2-byte literal, a 64 KiB literal and a short one, on an index whose
      first window starts at the 64 KiB literal: K2 decodes that window,
      but the scan never reaches it there."""
    x = mixed_payload(3 * FRAME, seed)
    body = raw_body(x)
    offs = [FRAME * k for k in range(3)]
    in_offs = [int(q) for q, _, o in _tag_starts(body) if o in offs] + [len(body), len(body)]
    out = [(body, len(x) + 5000, np.asarray(in_offs, dtype=np.int64))]
    lead = literal(x[: FRAME - 6]) + copy2(100, 10)
    body = lead + literal(x[FRAME : 2 * FRAME]) + literal(x[:1000])
    in_offs = [0, len(lead), len(lead) + FRAME + 3, len(body)]
    out.append((body, 2 * FRAME + 4 + 1000, np.asarray(in_offs, dtype=np.int64)))
    body = literal(x[:2]) + literal(x[FRAME : 2 * FRAME]) + literal(x[:1000])
    in_offs = [3, 3 + FRAME + 3, len(body)]
    out.append((body, FRAME + 1002, np.asarray(in_offs, dtype=np.int64)))
    return out


def _tag_starts(body: bytes) -> List[Tuple[int, int, int]]:
    """(input offset, tag kind, output offset) of every tag of a valid tag
    stream."""
    out, q, o = [], 0, 0
    while q < len(body):
        kind, hdr, length, _ = _tag(body, q)
        out.append((q, kind, o))
        q += hdr + (length if kind == 0 else 0)
        o += length
    return out


class _Ops:
    """A tag stream and its payload, op by op: literals with a chosen
    number of length bytes, copies of a chosen tag kind, raw bytes."""

    def __init__(self, rng: Rand):
        self.rng = rng
        self.body = bytearray()
        self.out = bytearray()

    def lit(self, n: int, extra: Optional[int] = None) -> "_Ops":
        """A literal of n random bytes; its length in ``extra`` bytes (1-4),
        or the shortest header."""
        data = self.rng.bytes(n).tobytes()
        if extra is None:
            self.body += literal(data)
        else:
            self.body += bytes([(59 + extra) << 2]) + (n - 1).to_bytes(extra, "little") + data
        self.out += data
        return self

    def copy(self, offset: int, length: int, kind: int = 2) -> "_Ops":
        """A copy tag of kind 1 (length 4-11, offset < 2048), 2 or 3."""
        if kind == 1:
            self.body += bytes([1 | ((offset >> 8) << 5) | ((length - 4) << 2), offset & 0xFF])
        else:
            self.body += copy2(offset, length) if kind == 2 else copy4(offset, length)
        for _ in range(length):
            self.out.append(self.out[len(self.out) - offset] if 0 < offset <= len(self.out) else 0)
        return self

    def lead(self, p: int) -> "_Ops":
        """Tags of exactly p input bytes (p >= 2) from an empty stream: a
        literal, then 2-byte copies at offset 1."""
        x = p - 1 if p <= 61 else 60 - (p - 61) % 2
        self.lit(x)
        for _ in range((p - 1 - x) // 2):
            self.copy(1, 4, kind=1)
        assert len(self.body) == p
        return self

    def case(self, name: str, declared: Optional[int] = None):
        return name, bytes(self.body), len(self.out) if declared is None else declared


def decoder_cases(lookahead: int, ring: int, seed: int = 71) -> List[Tuple[str, bytes, int]]:
    """Named (name, tag stream, declared) cases for the chunk decoder's
    batch logic (K2: tags that start in the first ``lookahead`` bytes from
    the cursor, parsed from an input ring of ``ring`` bytes, the constants
    that ``testing.decode_layouts.kernel_params`` reads from a build of
    ``decode_chunks.cu``): a tag header cut by
    the lookahead's end; literals with 1-4 length bytes whose header ends
    past it; literals longer than the ring; copies of the tag just before
    them and one whose source ends where the batch's output starts;
    self-overlapping copies at offsets 1-3 and 4-7 in one batch; the
    first bad tag at a batch's first lane, a middle lane, its last tag and
    lane 31; a copy's offset at the output so far, then one past it; the
    declared length exceeded mid-batch; a literal of 2^32 bytes; tags
    truncated at the
    end of the input; empty bodies; a body longer than
    max_compressed_len(65536); a stream declaring more than 64 KiB (for
    the big window only)."""
    rng = Rand(seed)

    def ops():
        return _Ops(rng)

    cases = []
    for kind, hdr in ((1, 2), (2, 3), (3, 5)):
        for p in range(lookahead - hdr + 1, lookahead):
            cases.append(ops().lead(p).copy(3, 9, kind).lit(8).copy(20, 30).case(f"hdr_split_copy{kind}_at_{p}"))
    for extra in (1, 2, 3, 4):
        for p in sorted({lookahead - extra, lookahead - 1}):
            cases.append(ops().lead(p).lit(70, extra).copy(64, 40).lit(5).case(f"lit_len{extra}_at_{p}"))
    # a copy-4 header over byte `ring`, in the batch at ring - 66: the ring
    # holds bytes [0, ring) until then where the chunk starts 16-byte aligned
    o = ops().lit(ring - 69).lit(8)
    for _ in range(27):
        o.copy(1, 4, 1)
    cases.append(o.copy(9, 20, 3).lit(5).case("hdr_cut_by_staged_end"))
    for n in (ring + 1000, 5 * ring):
        cases.append(ops().lit(30).lit(n).copy(ring - 5, 64).lit(100).case(f"literal_{n}"))
    # the second batch: a literal and a copy of it, a copy whose source
    # ends where the batch's output starts, then copies of the tag just
    # before each
    cases.append(ops().lead(lookahead).lit(3).copy(3, 4, 1).copy(15, 8, 1).copy(8, 8, 1).copy(16, 16)
                 .copy(5, 40).lit(3).case("copy_of_previous_tag"))
    cases.append(ops().lit(5).copy(5, 4, 1).copy(10, 4, 1).lit(3).case("offset_at_and_past_output"))
    # the second batch opens with a self-overlapping copy of the bytes
    # before it, and the rest overlap in the batch's own output
    o = ops().lead(lookahead)
    for off in (1, 2, 3):
        o.copy(off, 20)
    cases.append(o.lit(4).case("overlap_1_3"))
    o = ops().lead(lookahead)
    for off in (4, 5, 6, 7):
        o.copy(off, 30).copy(off, 11, 1)
    cases.append(o.lit(4).case("overlap_4_7"))
    cases.append(ops().lead(lookahead).copy(0, 10).lit(9).case("bad_at_first_lane"))
    o = ops().lit(1)
    for _ in range(9):
        o.copy(1, 4, 1)
    cases.append(o.copy(200, 9, 1).copy(1, 4, 1).lit(20).case("bad_at_lane_10"))
    cases.append(ops().lead(lookahead - 2).copy(0, 8, 1).lit(9).case("bad_at_last_tag"))
    o = ops().lit(1)
    for _ in range(30):
        o.copy(1, 4, 1)
    cases.append(o.copy(0, 4, 1).lit(9).case("bad_at_lane_31"))
    o = ops().lit(10)
    for _ in range(5):
        o.copy(10, 10)
    cases.append(o.lit(5).case("declared_exceeded_mid_batch", 45))
    cases.append((lambda c: (c[0], c[1][:-2], c[2]))(ops().lit(10).copy(9, 20, 3).case("truncated_copy4")))
    o = ops().lit(10)
    cases.append(("truncated_literal_length", bytes(o.body) + bytes([61 << 2, 30]), 10 + 31))
    cases.append(("truncated_literal_data", bytes(o.body) + bytes([19 << 2]) + b"12345", 30))
    # a 4-byte literal length of 2^32 - 1: 2^32 bytes, more than any W
    cases.append(("len_2_32_literal", bytes(ops().lit(5).body) + bytes([63 << 2]) + b"\xff" * 4
                  + literal(b"abc"), 8))
    cases.append(("empty_declared_0", b"", 0))
    cases.append(("empty_declared_7", b"", 7))
    body = literal(b"q") + copy4(1, 1) * 65535
    cases.append(("longer_than_max_compressed_len", body, 65536))
    cases.append(ops().lit(60_000).copy(60_000, 64).lit(40_000, 3).copy(1, 64).case("declared_over_64k"))
    return cases


def mutation_streams(count: int, seed: int = 73) -> List[Tuple[bytes, str]]:
    """Seeded raw streams for the decoder differential (shaped like
    experiments/e40_hw_mutation_differential.py): payloads of 30 B to
    200 KB, half a repeated 2-16 byte word then random bytes (every third
    a slice of the mixed payload instead), each encoded by the host C
    block encoder; 60% of them mutated by a bit flip, a truncation, an
    insertion of 1-3 bytes or a duplication of up to 7 bytes.  Returns
    (stream, kind): kind "valid" or the mutation's name."""
    from ..ops import host_codec

    rng = Rand(seed)
    out = []
    for k in range(count):
        n = int(rng.ints(30, 200_000, 1)[0])
        if k % 3 == 2:
            p = mixed_payload(n, seed=int(rng.ints(0, 1 << 30, 1)[0]))
        else:
            word = rng.bytes(int(rng.ints(2, 17, 1)[0])).tobytes()
            p = (word * (n // len(word) + 1))[: n // 2] + rng.bytes(n - n // 2).tobytes()
        s = bytearray(varint.encode_uint32(len(p)) + b"".join(
            host_codec.encode_block(p[q : q + FRAME]) for q in range(0, len(p), FRAME)))
        kind = "valid"
        if int(rng.ints(0, 10, 1)[0]) < 6:
            kind = ("bitflip", "truncate", "insert", "duplicate")[int(rng.ints(0, 4, 1)[0])]
            if kind == "bitflip":
                s[int(rng.ints(0, len(s), 1)[0])] ^= 1 << int(rng.ints(0, 8, 1)[0])
            elif kind == "truncate":
                del s[int(rng.ints(1, len(s), 1)[0]) :]
            elif kind == "insert":
                q = int(rng.ints(0, len(s) + 1, 1)[0])
                s[q:q] = rng.bytes(int(rng.ints(1, 4, 1)[0])).tobytes()
            else:
                lo = int(rng.ints(0, len(s) - 2, 1)[0])
                hi = min(len(s), lo + int(rng.ints(1, 8, 1)[0]))
                s[hi:hi] = s[lo:hi]
        out.append((bytes(s), kind))
    return out


def host_raw_decode(stream: bytes) -> Optional[bytes]:
    """The oracle of the decoder differential: the payload of a raw stream
    by the host C decoder (``host_codec.decode_tags``), or None where the
    stream is malformed or decodes to another length than it declares.  A
    tag yields at most 64 bytes from 3, so a body of n bytes never decodes
    to more than 22 n, and the output buffer is cut there."""
    from ..ops import host_codec

    declared, read = varint.decode_uint32(stream)
    if declared is None:
        return None
    body = stream[read:]
    got, written = host_codec.decode_tags(body, min(declared, 22 * len(body)))
    return got if got is not None and written == declared else None


def frame(cid: int, payload: bytes) -> bytes:
    """One chunk: id, 3-byte length, payload."""
    return bytes([cid]) + len(payload).to_bytes(3, "little") + payload


def data_chunk(data: bytes, compressed: bool, bad_crc: bool = False) -> bytes:
    """A compressed (level-1 block encoding) or uncompressed chunk of
    ``data`` with its masked CRC, or a wrong one."""
    crc = masked_crc32c(data, device="cpu") ^ (0xFF if bad_crc else 0)
    if compressed:
        body = varint.encode_uint32(len(data)) + encode_block(data)
        return frame(C.CHUNK_COMPRESSED, crc.to_bytes(4, "little") + body)
    return frame(C.CHUNK_UNCOMPRESSED, crc.to_bytes(4, "little") + data)


def framed_vectors(seed: int = 47):
    """(name, stream, budget, check_integrity, expected) for
    ``uncompress_framed_into(stream, bytearray(budget), True,
    check_integrity)``: expected is ("ok", read, written) or ("err",
    FrameError name).  The cases of tests/test_framed.py's resume and
    error-order classes, rebuilt from the port's own encoder and CRC."""
    rng = Rand(seed)
    H = C.FRAMING_HEADER
    rnd = rng.bytes(140_000).tobytes()
    three = [data_chunk(rnd[k : k + FRAME], False) for k in range(0, len(rnd), FRAME)]
    s3 = H + b"".join(three)
    c0, c1 = len(H), len(H) + len(three[0])  # header offsets of chunks 0 and 1
    c2 = c1 + len(three[1])
    bad_id = bytearray(s3)
    bad_id[c2] = 0x40
    bad_first = bytearray(s3)
    bad_first[c0] = 0x40
    text = mixed_payload(150_000, seed)
    mixed = H + data_chunk(text[:FRAME], True) + frame(0x80, b"skip me") + data_chunk(
        text[FRAME : 2 * FRAME], False) + frame(0xFE, b"\0" * 9) + data_chunk(text[2 * FRAME :], True)
    small = rng.bytes(1000).tobytes()
    bad_small = H + data_chunk(small, False, bad_crc=True)
    bad_body = frame(C.CHUNK_COMPRESSED, b"\0\0\0\0" + b"\x05\xff\xff")  # truncated literal
    bad_crc0 = data_chunk(b"first chunk payload", False, bad_crc=True)
    overlong = frame(C.CHUNK_COMPRESSED, b"\0" * 4 + b"\xe4\x80\x80\x80\x80\x00" + b"\0" * 4)
    torn_varint = H + frame(C.CHUNK_COMPRESSED, b"\0" * 4 + b"\x80") + data_chunk(b"next chunk", False)
    big = rng.bytes(FRAME + 1).tobytes()
    return [
        ("three_frames_resume", s3, FRAME, True, ("ok", c1, FRAME)),
        ("three_frames_all", s3, 3 * FRAME, True, ("ok", len(s3), len(rnd))),
        ("truncated_tail_past_resume", s3[: c2 + 6], FRAME, True, ("ok", c1, FRAME)),
        ("unknown_id_past_resume", bytes(bad_id), FRAME, True, ("ok", c1, FRAME)),
        ("truncated_at_resume", s3[: c1 + 6], FRAME, True, ("err", "invalid_input")),
        ("unknown_id_within_budget", bytes(bad_first), FRAME, True, ("err", "unknown_chunk")),
        ("nonfitting_bad_crc", bad_small, 10, True, ("err", "crc_mismatch")),
        ("nonfitting_bad_crc_unchecked", bad_small, 10, False, ("ok", len(H), 0)),
        ("bad_body_beats_later_bad_crc", H + bad_body + data_chunk(b"tail data", False, True),
         FRAME, True, ("err", "invalid_input")),
        ("bad_crc_beats_later_unknown", H + bad_crc0 + frame(0x40, b""), FRAME, True,
         ("err", "crc_mismatch")),
        ("unknown_after_unchecked_crc", H + bad_crc0 + frame(0x40, b""), FRAME, False,
         ("err", "unknown_chunk")),
        ("bad_crc_beats_later_torn_header", H + bad_crc0 + b"\x00\x08", FRAME, True,
         ("err", "crc_mismatch")),
        ("overlong_varint_on_resume_path", H + overlong, 10, True, ("err", "invalid_input")),
        ("torn_varint_small_budget", torn_varint, 16, True, ("err", "invalid_input")),
        ("torn_varint_large_budget", torn_varint, FRAME, True, ("err", "invalid_input")),
        ("skippable_and_padding", mixed, len(text), True, ("ok", len(mixed), len(text))),
        ("skippable_and_padding_resume", mixed, FRAME + 100, True,
         ("ok", len(H) + len(data_chunk(text[:FRAME], True)) + 11, FRAME)),
        ("oversized_uncompressed", H + data_chunk(big, False), 2 * FRAME, True,
         ("err", "invalid_input")),
        ("compressed_too_short", H + frame(C.CHUNK_COMPRESSED, b"\0\0\0"), FRAME, True,
         ("err", "invalid_input")),
        ("bad_magic", b"sNaPpY!!!!" + s3[len(H) :], FRAME, True, ("err", "invalid_input")),
        ("empty", b"", FRAME, True, ("err", "invalid_input")),
        ("header_only", H, FRAME, True, ("ok", len(H), 0)),
    ]
