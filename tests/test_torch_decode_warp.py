"""The warp chunk decoder (kernel K2) through its CPU twin, exact.

The CUDA kernel decodes a chunk with one warp: its lanes parse the tags
that would start at each of the next 64 bytes (the lookahead) from an
input ring in shared memory, follow the real tags through them, give each
its output position by a prefix sum, check them all at once, and emit the
batch in one lane-strided pass plus an ordered pass for the copies that
read the batch's own output.  Its source compiled by g++ (the twin) runs
the same 32-lane logic with each lane's values in arrays, so these tests
hold that logic against the plain version (``decode_chunks.decode_tags``,
the sequential walk, itself held against the TPU kernel in
tests/test_torch_decode.py) at both widths: verdict, written count and
every byte of the row, zeros included.  The inputs are the named cases of
``payloads.decoder_cases`` (tag headers and literal lengths cut by the
lookahead's end, literals longer than the ring, copies of the tag before,
self-overlapping copies, the first bad tag at chosen lanes, the declared
length exceeded mid-batch, truncations, empty and over-long bodies),
hypothesis-drawn streams and their mutants, and the start of chip_smoke.py's
decoder differential.  A twin build that records every batch checks that
the named cases reach what they name.  The port's binding of the host C
decoder (``host_codec.decode_tags``), the differential's oracle on the
card, is held against the JAX package's.
"""

import ctypes
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from snappy_tpu.ops import host_codec as jax_host_codec  # noqa: E402

from snappy_tpu_torch import engine  # noqa: E402
from snappy_tpu_torch.formats import constants as C  # noqa: E402
from snappy_tpu_torch.ops import _build, decode_chunks, host_codec  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

from test_torch_decode import big_cases, ragged  # noqa: E402

if shutil.which("g++") is None:
    pytest.skip("g++ is not available to build the CPU twin", allow_module_level=True)
# the walk's constants, as the twin's build of decode_chunks.cu defines them
PARAMS = decode_chunks.kernel_params(_build.twin_lib(), decode_chunks.MAX_OUT)
LOOKAHEAD, RING = PARAMS["lookahead"], PARAMS["ring"]
CASES = {name: (body, declared) for name, body, declared in payloads.decoder_cases(LOOKAHEAD, RING)}
WIDTHS = [decode_chunks.CHUNK, decode_chunks.MAX_OUT]
HDR = {1: 2, 2: 3, 3: 5}  # a copy tag's bytes by kind


def cases_at(width):
    return [name for name, (_, declared) in CASES.items() if declared <= width]


@pytest.fixture(scope="module", params=["lanes_up", "lanes_down"])
def twin(request):
    """The twin, its lanes run 0 .. 31 (the package's build) or 31 .. 0:
    equal results in both orders show that no lane reads, in one step, what
    another lane writes in it, which the card does not order."""
    if request.param == "lanes_up":
        return _build.twin_lib()
    return _build.twin_lib(lanes_down=True)


def run_twin(fn, cases, width):
    comp, offsets = ragged([b for b, _ in cases])
    comp, offsets = comp.numpy(), offsets.numpy()
    declared = np.array([n for _, n in cases], dtype=np.int32)
    out = np.full((len(cases), width), 0xAA, dtype=np.uint8)
    ok = np.zeros(len(cases), dtype=np.uint8)
    written = np.zeros(len(cases), dtype=np.int32)
    rc = fn(comp.ctypes.data, offsets.ctypes.data, declared.ctypes.data, len(cases),
            out.ctypes.data, width, ok.ctypes.data, written.ctypes.data)
    assert rc == 0
    return ok.astype(bool), written, out


def run_plain(cases, width):
    comp, offsets = ragged([b for b, _ in cases])
    declared = torch.tensor([n for _, n in cases], dtype=torch.int32)
    out = torch.empty((len(cases), width), dtype=torch.uint8)
    ok, written = decode_chunks.decode_chunks(comp, offsets, declared, out)
    return ok.numpy(), written.numpy(), out.numpy()


def assert_twin_equals_plain(twin, cases, width):
    got = run_twin(twin.stpu_twin_decode_chunks, cases, width)
    want = run_plain(cases, width)
    assert np.array_equal(got[0], want[0]), "ok"
    assert np.array_equal(got[1], want[1]), "written"
    assert np.array_equal(got[2], want[2]), "rows"


@pytest.mark.parametrize(
    "width,name", [(w, n) for w in WIDTHS for n in cases_at(w)])
def test_twin_matches_plain_on_named_cases(twin, width, name):
    assert_twin_equals_plain(twin, [CASES[name]], width)


def test_twin_matches_plain_on_all_named_cases_in_one_call(twin):
    """The cases as rows of one call: the ring and the scratch carry
    nothing from one row to the next."""
    assert_twin_equals_plain(twin, [CASES[n] for n in cases_at(decode_chunks.MAX_OUT)],
                             decode_chunks.MAX_OUT)


# ---- streams drawn by hypothesis, and their mutants ---------------------

_op = st.one_of(
    st.tuples(st.just("lit"), st.integers(1, 300), st.sampled_from([None, 1, 2, 3, 4])),
    st.tuples(st.just("copy"), st.integers(1, 3000), st.integers(1, 64), st.sampled_from([1, 2, 3])),
)
_mutation = st.one_of(
    st.none(),
    st.tuples(st.sampled_from(["bitflip", "truncate", "insert", "duplicate"]),
              st.integers(0, 1 << 20), st.integers(0, 255)),
)


def drawn_stream(seed, ops):
    """A valid tag stream of the drawn ops: literals of random bytes with
    the drawn number of length bytes (at least what the length needs),
    copies of the drawn kind with the offset cut to the output so far."""
    o = payloads._Ops(payloads.Rand(seed))
    for op in ops:
        if op[0] == "lit":
            _, n, extra = op
            o.lit(n, None if extra is None else max(extra, ((n - 1).bit_length() + 7) // 8))
        elif o.out:
            _, off, length, kind = op
            if kind == 1:
                off, length = min(off, 2047), 4 + length % 8
            o.copy(min(off, len(o.out)), length, kind)
    return bytes(o.body), len(o.out)


def mutate(body, mutation):
    if mutation is None or not body:
        return body
    kind, at, v = mutation
    s = bytearray(body)
    q = at % len(s)
    if kind == "bitflip":
        s[q] ^= 1 << (v % 8)
    elif kind == "truncate":
        del s[q:]
    elif kind == "insert":
        s[q:q] = bytes([v])
    else:
        s[q:q] = s[q : q + 1 + v % 7]
    return bytes(s)


@pytest.mark.parametrize("width", WIDTHS)
@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 1 << 30), ops=st.lists(_op, max_size=60), mutation=_mutation,
       shift=st.sampled_from([0, 0, 0, -1, 1]))
def test_twin_matches_plain_property(twin, width, seed, ops, mutation, shift):
    body, n = drawn_stream(seed, ops)
    declared = max(0, min(width, n + shift))
    assert_twin_equals_plain(twin, [(mutate(body, mutation), declared)], width)


def test_twin_matches_plain_on_mutation_streams(twin):
    """The first streams of chip_smoke.py's decoder differential that fit
    the big window, whole and as the raw decoders cut them."""
    cases = []
    for stream, _ in payloads.mutation_streams(24):
        declared, read = payloads.varint.decode_uint32(stream)
        if declared is not None and declared <= decode_chunks.MAX_OUT:
            cases.append((stream[read:], declared))
    assert len(cases) >= 8
    assert_twin_equals_plain(twin, cases, decode_chunks.MAX_OUT)


# ---- the batches that the named cases reach ------------------------------

# The twin with its timing hooks (STPU_PROF) counting the calls of each
# phase, and its batch hook (STPU_DEC_BATCH) recording each batch: its
# input and output positions, tags, end, first bad tag, dependent copies,
# output length, items, the stagings of the ring so far, and per lane the
# tag's position, kind | hdr << 2, length and offset.
_RECORDING_TWIN = r"""
#include <cstdint>
constexpr int64_t kRecs = 8192, kRecWords = 9 + 4 * 32;
static int64_t g_recs[kRecs][kRecWords];
static int64_t g_nrecs;
static unsigned long long g_calls[8];
template <class Batch, class Plan>
static void record_batch(int64_t i, uint32_t o, const Batch& bt, const Plan& pl) {
  if (g_nrecs < kRecs) {
    int64_t* r = g_recs[g_nrecs];
    r[0] = i, r[1] = o, r[2] = bt.tags, r[3] = bt.end;
    r[4] = pl.good, r[5] = pl.dep, r[6] = pl.out_len, r[7] = pl.items, r[8] = g_calls[0];
    for (uint32_t l = 0; l < 32; ++l)
      r[9 + l] = bt.pos[l], r[41 + l] = bt.meta[l], r[73 + l] = bt.len[l], r[105 + l] = bt.off[l];
  }
  ++g_nrecs;
}
#define STPU_DEC_BATCH(i, o, bt, pl) record_batch(i, o, bt, pl)
#define STPU_PROF(k, ...) __VA_ARGS__; ++g_calls[k]
#include "decode_chunks.cu"
// The batches recorded since the last call (at most max into out) and the
// calls of each phase; returns the number of batches.
STPU_EXPORT int64_t stpu_twin_batches(int64_t* out, int64_t max, unsigned long long* calls) {
  const int64_t n = g_nrecs < max ? g_nrecs : max, all = g_nrecs;
  memcpy(out, g_recs, (size_t)(n < kRecs ? n : kRecs) * sizeof(g_recs[0]));
  for (int k = 0; k < 8; ++k) calls[k] = g_calls[k], g_calls[k] = 0;
  g_nrecs = 0;
  return all;
}
"""


@pytest.fixture(scope="module")
def recording_twin(tmp_path_factory):
    src = tmp_path_factory.mktemp("recording_twin") / "recording_twin.cc"
    src.write_text(_RECORDING_TWIN)
    so = _build._build(
        "twin_recording", *_build.twin_cmds(f"-I{_build.CSRC}"),
        [src], [_build.CSRC / "decode_chunks.cu", _build.CSRC / "snappy_common.cuh"],
    )
    lib = ctypes.CDLL(str(so))
    lib.stpu_twin_decode_chunks.argtypes = _build._ENTRY_POINTS["decode_chunks"][:-1]
    lib.stpu_twin_batches.restype = ctypes.c_int64
    lib.stpu_twin_batches.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    return lib


class Batch:
    """One recorded batch; tag t's fields by lane."""

    def __init__(self, r):
        (self.i, self.o, self.tags, self.end, self.good, self.dep, self.out_len, self.items,
         self.stages) = (int(v) for v in r[:9])
        n = self.tags
        self.pos = [int(v) for v in r[9 : 9 + n]]
        self.kind = [int(v) & 3 for v in r[41 : 41 + n]]
        self.hdr = [int(v) >> 2 for v in r[41 : 41 + n]]
        self.len = [int(v) for v in r[73 : 73 + n]]
        self.off = [int(v) for v in r[105 : 105 + n]]

    def deps(self):
        return [t for t in range(self.tags) if self.dep >> t & 1]


def batches(lib, body, declared, width):
    ok, written, _ = run_twin(lib.stpu_twin_decode_chunks, [(body, declared)], width)
    recs = np.zeros((8192, 137), dtype=np.int64)
    calls = np.zeros(8, dtype=np.uint64)
    n = lib.stpu_twin_batches(recs.ctypes.data, 8192, calls.ctypes.data)
    assert n <= 8192
    return bool(ok[0]), int(written[0]), [Batch(r) for r in recs[:n]], [int(c) for c in calls]


def _reaches(name, body, declared, ok, written, bs):
    """Whether the batches of case ``name`` show what its name says."""
    first, last = (bs[0], bs[-1]) if bs else (None, None)
    if name.startswith("hdr_split_copy"):
        kind, p = (int(x) for x in name[len("hdr_split_copy"):].split("_at_"))
        t = first.tags - 1  # the copy whose header the lookahead's end cuts
        return (first.pos[t] == p and first.kind[t] == kind and first.hdr[t] == HDR[kind]
                and first.end == p + HDR[kind] > LOOKAHEAD and bs[1].i == first.end and ok)
    if name.startswith("lit_len"):
        extra, p = (int(x) for x in name[len("lit_len"):].split("_at_"))
        t = first.tags - 1
        return (first.pos[t] == p and first.kind[t] == 0 and first.hdr[t] == 1 + extra
                and p + 1 + extra > LOOKAHEAD and first.end == p + 1 + extra + 70 and ok)
    if name == "hdr_cut_by_staged_end":
        # the ring holds bytes [0, RING) until the batch at RING - 66, whose
        # last tag's header runs over byte RING: staged again before it
        b = next(b for b in bs if b.i == RING - 66)
        t = b.tags - 1
        return (b.pos[t] == 63 and b.kind[t] == 3 and b.stages == 2
                and all(a.stages == 1 for a in bs if a.i < b.i) and ok)
    if name.startswith("literal_"):
        n = int(name[len("literal_"):])
        return n > RING and ok and any(
            b.kind[t] == 0 and b.len[t] == n for b in bs for t in range(b.tags))
    if name == "copy_of_previous_tag":
        # a literal and a copy of it; a copy whose source ends where the
        # batch's output starts (the last that needs no order); three
        # copies of the tag before each
        b = bs[1]
        return (b.i == LOOKAHEAD and b.kind == [0, 1, 1, 1, 2, 2, 0] and b.deps() == [1, 3, 4, 5]
                and b.off[1:6] == [3, 15, 8, 16, 5] and b.len[2] == 8 and ok)
    if name == "offset_at_and_past_output":
        return len(bs) == 1 and first.off[1:3] == [5, 10] and first.good == 2 and not ok
    if name.startswith("overlap_"):
        b = bs[1]
        lo, hi = (1, 3) if name == "overlap_1_3" else (4, 7)
        copies = [t for t in range(b.tags) if b.kind[t]]
        return (b.i == LOOKAHEAD and copies[0] == 0 and b.deps() == copies[1:]
                and sorted({b.off[t] for t in copies}) == list(range(lo, hi + 1))
                and all(b.off[t] < b.len[t] for t in copies) and ok)
    if name == "bad_at_first_lane":
        return len(bs) == 2 and last.i == LOOKAHEAD and last.good == 0 and not ok
    if name == "bad_at_lane_10":
        return len(bs) == 1 and first.good == 10 and first.tags > 11 and not ok
    if name == "bad_at_last_tag":
        return len(bs) == 1 and 0 < first.good == first.tags - 1 < 31 and not ok
    if name == "bad_at_lane_31":
        return len(bs) == 1 and first.tags == 32 and first.good == 31 and not ok
    if name == "declared_exceeded_mid_batch":
        t = first.good
        return (len(bs) == 1 and 0 < t < first.tags - 1 and first.kind[t] != 0
                and written == first.out_len < declared < written + first.len[t] and not ok)
    if name == "len_2_32_literal":
        return (len(bs) == 1 and first.good == 1 and first.kind[1] == 0 and first.hdr[1] == 5
                and written == 5 and not ok)
    if name.startswith("truncated_"):
        t = last.good
        cut = {"truncated_copy4": last.i + last.pos[t] + 5 > len(body) and last.kind[t] == 3,
               "truncated_literal_length": last.i + last.pos[t] + last.hdr[t] > len(body)
               and last.kind[t] == 0,
               "truncated_literal_data": last.i + last.pos[t] + last.hdr[t] < len(body)
               < last.i + last.pos[t] + last.hdr[t] + last.len[t] and last.kind[t] == 0}[name]
        return t == last.tags - 1 and cut and not ok
    if name.startswith("empty_"):
        return not bs and written == 0 and ok == (declared == 0)
    if name == "longer_than_max_compressed_len":
        return (len(body) > C.max_compressed_len(declared) and sum(b.tags for b in bs) == 65536
                and ok)
    if name == "declared_over_64k":
        return declared > decode_chunks.CHUNK and ok
    raise AssertionError(f"no check for {name}")


@pytest.mark.parametrize("name", list(CASES))
def test_cases_reach_the_batch_logic(recording_twin, name):
    """Each named case reaches what its name says, in the batches the warp
    takes; the recording build still gives the plain version's result, and
    its phase hooks run once a batch (the ordered copies once a batch that
    has them)."""
    body, declared = CASES[name]
    width = decode_chunks.MAX_OUT
    ok, written, bs, calls = batches(recording_twin, body, declared, width)
    want = run_plain([(body, declared)], width)
    assert (ok, written) == (bool(want[0][0]), int(want[1][0]))
    assert _reaches(name, body, declared, ok, written, bs)
    assert calls[1:5] == [len(bs)] * 4
    assert calls[5] == sum(b.dep != 0 for b in bs)
    assert (calls[0] > 0) == (len(body) > 0)
    if name.startswith("literal_"):
        assert calls[0] > 1, "the ring was staged again past the literal"
    for b, nxt in zip(bs, bs[1:]):  # each batch starts where the one before ended
        assert (nxt.i, nxt.o) == (b.i + b.end, b.o + b.out_len) and b.good == b.tags


# ---- the host C decoder's binding, the oracle on the card ----------------


def test_host_decode_tags_matches_jax_binding():
    for body, n in big_cases():
        assert host_codec.decode_tags(body, n) == jax_host_codec.decode_tags(body, n)


def test_host_raw_decode_is_the_raw_decoders_verdict():
    """The differential's oracle against ``engine.raw_uncompress_batch`` on
    the CPU (the plain versions), on the first streams of the differential
    and on the varint's edges."""
    streams = [s for s, _ in payloads.mutation_streams(16)]
    streams += [b"", b"\x80", b"\x00", b"\x00\x00", b"\x01", b"\xff\xff\xff\xff\x1f\x00",
                b"\xff\xff\xff\xff\xff\x01\x00"]
    got = engine.raw_uncompress_batch(streams, device="cpu")
    assert [g for g, _ in got] == [payloads.host_raw_decode(s) for s in streams]
    assert sum(g is not None for g, _ in got) >= 4
