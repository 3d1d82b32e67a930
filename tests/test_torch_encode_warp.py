"""The warp block encoder (kernel K3) against the host C encoder, exact bytes.

The CUDA kernel walks a block with one warp: 32 probes a batch, one per
lane, candidates from earlier lanes of the same bucket, the first lane that
hits wins.  Its source compiled by g++ (the CPU twin) runs the same 32-lane
logic with each lane's values in arrays, so these tests hold that logic
against the host C encoder (snappy_tpu.engine.raw_compress(backend="host")
at levels 1 and 2, whose bytes equal the TPU kernel's) on blocks built to
reach its cases: probes that share a bucket within a batch, the winner's
lane, the limit inside a batch, match lengths and offsets at the tag edges,
block sizes at the table-size edges, and hypothesis-drawn blocks.  The
port's binding of the host C block encoder (host_codec.encode_block), which
chip_smoke.py uses for its differential on the card, is held against the
same.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from snappy_tpu_torch.ops import _build, encode_blocks, host_codec  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

from test_torch_encode import host_block  # noqa: E402

CASES = dict(payloads.encoder_cases())
LEVELS = [1, 2]


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the CPU twin")
    return _build.twin_lib()


def run_twin(twin, blocks, level):
    rows = np.zeros((len(blocks), 65536), dtype=np.uint8)
    for k, b in enumerate(blocks):
        rows[k, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    lens = np.array([len(b) for b in blocks], dtype=np.int32)
    enc = np.zeros((len(blocks), encode_blocks.ENC_CAP), dtype=np.uint8)
    enc_len = np.zeros(len(blocks), dtype=np.int32)
    rc = twin.stpu_twin_encode_blocks(
        rows.ctypes.data, 65536, lens.ctypes.data, len(blocks),
        enc.ctypes.data, encode_blocks.ENC_CAP, enc_len.ctypes.data, level,
    )
    assert rc == 0
    return [enc[k, :n].tobytes() for k, n in enumerate(enc_len)]


def first_batch(data: bytes, level: int):
    """The first 32 probes of the serial probe loop (positions 1-32, step
    1) as the warp's lanes take them.  Returns (lanes whose limit check
    passes, the first lane that hits or None, its candidate, whether an
    earlier lane of the batch stored that candidate)."""
    n = len(data)
    bits = encode_blocks.table_bits(n)
    table = {}  # bucket -> [(position, stored in this batch)], newest first
    for lane in range(32):
        p = 1 + lane
        if p + 1 > n - 15:
            return lane, None, None, None
        cur = data[p : p + 4]
        h = encode_blocks.hash_word(int.from_bytes(cur, "little"), bits)
        bucket = table.get(h, [(0, False), (0, False)])
        table[h] = [(p, True), bucket[0]]
        for c, in_batch in bucket[:level]:
            if data[c : c + 4] == cur:
                return 32, lane, c, in_batch
    return 32, None, None, None


def tags(body: bytes):
    """(offset, length) of each tag of a tag stream, offset None for a
    literal."""
    i = 0
    while i < len(body):
        b, kind = body[i], body[i] & 3
        if kind == 0:
            lc = b >> 2
            extra = lc - 59 if lc >= 60 else 0
            length = int.from_bytes(body[i + 1 : i + 1 + extra], "little") + 1 if extra else lc + 1
            i += 1 + extra + length
            yield None, length
        elif kind == 1:
            yield ((b & 0xE0) << 3) | body[i + 1], 4 + ((b >> 2) & 7)
            i += 2
        else:
            w = 2 if kind == 2 else 4
            yield int.from_bytes(body[i + 1 : i + 1 + w], "little"), 1 + (b >> 2)
            i += 1 + w


def copies(body: bytes):
    """(offset, length) of the copies of a tag stream, the tags of one copy
    (emit_copy splits long ones) merged: two copies in a row never share an
    offset, since the first ends where the bytes at that offset differ."""
    out, joined = [], False
    for off, length in tags(body):
        if off is None:
            joined = False
        elif joined and out[-1][0] == off:
            out[-1] = (off, out[-1][1] + length)
        else:
            out.append((off, length))
            joined = True
    return out


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_host_c(twin, name, level):
    block = CASES[name]
    want = host_block(block, level)
    assert run_twin(twin, [block], level) == [want]
    assert host_codec.encode_block(block, level) == want


def test_cases_reach_the_batch_logic():
    """The named blocks reach what their names say, in the host C's own
    output (and so in the twin's, which equals it above)."""
    # a winner whose candidate an earlier lane of its batch stored
    assert first_batch(CASES["bucket_2"], 1) == (32, 19, 3, True)
    # three probes in one bucket: level 1 misses at lane 19, level 2 takes
    # its second candidate, the lane before the latest
    assert first_batch(CASES["bucket_3"], 1)[1] != 19
    assert first_batch(CASES["bucket_3"], 2) == (32, 19, 3, True)
    assert first_batch(CASES["bucket_32_run"], 1) == (32, 0, 0, False)
    assert first_batch(CASES["hit_lane_0"], 1) == (32, 0, 0, False)
    assert first_batch(CASES["hit_lane_31_at_0"], 1) == (32, 31, 0, False)
    assert first_batch(CASES["no_hit_4096"], 1)[1] is None
    assert first_batch(CASES["limit_in_batch_40"], 1)[:2] == (24, None)
    for level in LEVELS:
        def first(name):
            return copies(host_block(CASES[name], level))[0]

        assert first("hit_lane_0") == (1, 30)
        assert first("hit_lane_31_at_0") == (32, 40)
        for k in (4, 11, 12, 60, 64, 67, 68, 69, 200, 1000):
            assert first(f"length_{k}") == (9, k)
        for o in (1, 2, 3):
            assert first(f"offset_{o}") == (o, 100)
        for o in (2047, 2048):
            assert o in [off for off, _ in copies(host_block(CASES[f"offset_{o}"], level))]
        assert copies(host_block(CASES["match_to_end_40"], level)) == [(20, 20)]
        # a literal of 20 bytes and the copy, which ends the block
        assert len(host_block(CASES["match_to_end_40"], level)) == 1 + 20 + 3


@pytest.mark.parametrize("level", LEVELS)
def test_twin_matches_host_c_on_seeded_blocks(twin, level):
    """The first 150 blocks of chip_smoke.py's differential on the card."""
    blocks = payloads.encoder_blocks(150)
    assert run_twin(twin, blocks, level) == [host_codec.encode_block(b, level) for b in blocks]


_segment = st.one_of(
    st.binary(min_size=1, max_size=200),
    st.tuples(st.integers(1, 3000), st.integers(1, 400)),  # (distance back, length)
    st.tuples(st.sampled_from([0, 1, 0x61]), st.integers(1, 300)).map(lambda t: bytes([t[0]]) * t[1]),
)


def _build_block(segments) -> bytes:
    out = bytearray()
    for seg in segments:
        if isinstance(seg, bytes):
            out += seg
        elif out:
            dist, length = seg
            start = len(out) - min(dist, len(out))
            for k in range(length):
                out.append(out[start + k])
    return bytes(out[:65536])


@pytest.mark.parametrize("level", LEVELS)
@settings(max_examples=60, deadline=None)
@given(segments=st.lists(_segment, max_size=24))
def test_twin_matches_host_c_property(twin, level, segments):
    block = _build_block(segments)
    assert run_twin(twin, [block], level) == [host_block(block, level)]


# The CPU twin's encoder with its timing hooks (STPU_PROF) counting the
# calls of each phase, as testing/encode_layouts.py counts their cycles on
# the card.
_PROFILED_TWIN = r"""
static unsigned long long g_calls[8];
#define STPU_PROF(k, ...) __VA_ARGS__; ++g_calls[k]
#include "encode_blocks.cu"
STPU_EXPORT void stpu_twin_phase_calls(unsigned long long* out) {
  for (int k = 0; k < 8; ++k) out[k] = g_calls[k], g_calls[k] = 0;
}
"""


@pytest.fixture(scope="module")
def profiled_twin(twin, tmp_path_factory):
    import ctypes

    src = tmp_path_factory.mktemp("profiled_twin") / "profiled_twin.cc"
    src.write_text(_PROFILED_TWIN)
    so = _build._build(
        "twin_profiled", ["g++", "-std=c++17", "-O2", "-fPIC", f"-I{_build.CSRC}"], ["g++", "-shared"],
        [src], [_build.CSRC / "encode_blocks.cu", _build.CSRC / "snappy_common.cuh"],
    )
    lib = ctypes.CDLL(str(so))
    lib.stpu_twin_encode_blocks.argtypes = _build._ENTRY_POINTS["encode_blocks"][:-1]
    lib.stpu_twin_phase_calls.argtypes = [ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", ["size_16", "bucket_2", "length_200", "period_3", "size_65536"])
def test_profile_hooks_count_each_phase(profiled_twin, name, level):
    """The hooks that split the walk's cycles by phase on the card sit
    around the statements their phases name: with each hook counting its
    calls, the twin still gives the host C's bytes, one literal copy per
    literal tag, one copy-tag emit per copy, and an extension for each
    copy that a probe batch found."""
    block = CASES[name]
    want = host_block(block, level)
    assert run_twin(profiled_twin, [block], level) == [want]
    calls = np.zeros(8, dtype=np.uint64)
    profiled_twin.stpu_twin_phase_calls(calls.ctypes.data)
    batches, extensions, literals, emits, after = (int(c) for c in calls[:5])
    assert literals == sum(off is None for off, _ in tags(want))
    assert emits == len(copies(want))
    assert extensions <= emits <= extensions + after
    assert batches >= extensions and (batches > 0) == (len(block) >= 17)
