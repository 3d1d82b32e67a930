// Snappy chunk decoder: the kernel behind
// snappy_tpu_torch.ops.decode_chunks.decode_chunks.
//
// Replaces the TPU kernel snappy_tpu/ops/decode_scalar.py (_make_kernel /
// _kernel, launched by _call) at both of its shapes: the chunk shape
// (decode_chunks_words, <= 64 KiB out) and the big-window shape of the raw
// format (decode_raw_words and decode_raw_batch_words, <= 128 KiB out),
// with the emit helpers of scalar_emit.py and emit_long.py folded into the
// emission below.  The verdicts follow the host C decoder stpu_decode_tags
// (snappy_codec.c:297-480) and the kernel's condition
// ok = no error && pos == comp_len && written == declared
// (decode_scalar.py:327); `written` is the output produced before the first
// bad tag, as the TPU kernel reports it.  Input is ragged (one buffer plus
// int64 offsets), so a body of any length decodes.
//
// Bound on the H100: latency.  A tag's position is known only once the tag
// before it is parsed, and the bytes moved (22 + 50 MB at 768 chunks) take
// 0.02 ms; a header read straight from global memory is a dependent load
// of ~360 cycles.
//
// Design: one warp decodes one chunk, and all 32 lanes take part in every
// step of a batch:
// - staging: the warp copies its compressed bytes into an input ring of
//   kRing bytes in shared memory with aligned 16-byte loads, and refills it
//   as the cursor advances; headers, length bytes and offsets are then
//   shared loads (~34 cycles);
// - speculative parse: lane l parses the tag that would start at cursor +
//   l + 32 j (j < kDecPos: a lookahead of kLookahead bytes) from the ring;
// - chain: the real tags of the batch are found by following the next-tag
//   positions, stored in shared memory with the positions two tags on, two
//   tags a step, from the cursor to the first tag that starts past the
//   lookahead (or at the end of the input); lane t takes the t-th tag;
// - positions and checks: warp prefix sums of the output lengths give each
//   tag its output position; each tag applies the sequential walk's checks
//   at its own (input, output) position, and a ballot finds the first bad
//   one, whose output position is `written`.  Each check depends only on
//   that position pair, so the verdict equals the sequential walk's;
// - emission: one lane-strided pass over the batch's output, kPiece bytes a
//   lane, writes every literal and every copy whose source ends before the
//   batch's first output byte; then the copies that read the batch's own
//   output are written in order, byte k of a copy from o - offset +
//   k % offset (the forward-copy rule), with __syncwarp between them.
// Layout, from the A/B on the card (PERF.md §6): at the chunk shape the
// warp writes its row in place in `out` (global memory; copies read it back
// through L1 and L2) and only the ring sits in shared memory, so all 768
// chunks of the main path are in flight at once; at the big-window shape
// the row sits in shared memory beside the ring (one CTA per SM) and is
// written out at the end.  testing/decode_layouts.py builds the other
// layout of each shape around the same walk.
//
// One source, two builds: the walk is written against Lanes<T> and the
// collectives of snappy_common.cuh, so the CPU twin runs the same 32-lane
// batch logic (tests/test_torch_decode_warp.py).
#include "snappy_common.cuh"

namespace stpu {

constexpr uint32_t kDecPos = 2;                // positions a lane parses a batch
constexpr uint32_t kLookahead = 32 * kDecPos;  // bytes a batch's tags start in
constexpr uint32_t kRing = 4096;               // the input ring, bytes
constexpr uint32_t kPiece = 8;  // output bytes a lane moves per item of the lane-strided pass
// Literal lengths are kept below this; a longer one fails its W check at
// any W, and the clamp keeps 32 lanes' sums inside 32 bits.
constexpr uint32_t kLenClamp = 1u << 20;

// Timing hooks around the phases of a batch (k: 0 staging, 1 speculative
// parse, 2 chain, 3 positions and checks, 4 the lane-strided pass, 5 the
// ordered copies; 7 the whole walk); they only run the statement unless a
// build defines STPU_PROF, as testing/decode_layouts.py does to count cycles.
#ifndef STPU_PROF
#define STPU_PROF(k, ...) __VA_ARGS__
#endif
// Called once per batch with what it found; empty unless a build defines
// it (the tests' recording twin, the cycle counters' tag counts).
#ifndef STPU_DEC_BATCH
#define STPU_DEC_BATCH(...)
#endif

// The warp's chunk comp[0, n) in global memory (any alignment) and its
// ring: byte r of the chunk sits in ring slot (base + r) % kRing, base
// being the low bits of the chunk's address, so an aligned 16-byte block of
// the buffer fills an aligned 16-byte slot.  Bytes [lo, we) are staged.
// slots: kSlots words of shared scratch, where a batch's parsed positions
// wait for the chain.
struct DecInput {
  const uint8_t* comp;
  int64_t n;
  uint8_t* ring;
  uint32_t* slots;
  uint32_t base;
  int64_t lo, we;
};

constexpr uint32_t kSlots = 5 * kLookahead;

STPU_HD uint32_t ring_slot(const DecInput& in, int64_t r) {
  return (in.base + (uint32_t)r) & (kRing - 1);
}

STPU_HD uint8_t comp_byte(const DecInput& in, int64_t r) {
#ifdef __CUDA_ARCH__
  return __ldg(in.comp + r);
#else
  return in.comp[r];
#endif
}

// Stage the bytes from the aligned block that holds byte i on, up to kRing
// of them or the end of the chunk; the staged bytes at and after i stay.
// Blocks inside the chunk move as 16-byte loads, the edge blocks by bytes.
STPU_HD void dec_stage(DecInput& in, int64_t i) {
  const int64_t lo = i - ((in.base + (uint32_t)i) & 15);
  const int64_t we = min_i64(in.n, lo + kRing);
  const int64_t from = max_i64(in.we, lo);
  const int64_t b0 = from - ((in.base + (uint32_t)from) & 15);
  const uint32_t blocks = (uint32_t)((we - b0 + 15) / 16);
  STPU_LANES(l) {
    for (uint32_t k = l; k < blocks; k += 32) {
      const int64_t b = b0 + 16 * (int64_t)k;
      uint8_t* dst = in.ring + ring_slot(in, b);
#ifdef __CUDA_ARCH__
      if (b >= 0 && b + 16 <= in.n) {
        *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(in.comp + b));
        continue;
      }
#endif
      const int64_t e = min_i64(b + 16, we);
      for (int64_t r = max_i64(b, from); r < e; ++r) dst[r - b] = in.comp[r];
    }
  }
  warp_sync();
  in.lo = lo;
  in.we = we;
}

// The tags that would start at each lookahead position: meta = kind |
// hdr << 2, len (literals clamped), off, and next, the position after the
// tag (its header and literal bytes), relative to the batch's cursor.
struct DecSpec {
  Lanes<uint32_t> meta[kDecPos], len[kDecPos], off[kDecPos], next[kDecPos];
};

// The batch: its tags (tags <= 32) in lanes 0 .. tags - 1, by position
// relative to the cursor, and `end`, the position after the last one.
struct DecBatch {
  Lanes<uint32_t> pos, meta, len, off;
  uint32_t tags, end;
};

// The aligned ring word that holds byte r of the chunk (r 4-aligned in the
// buffer's address space).
STPU_HD uint32_t ring_word(const DecInput& in, int64_t r) {
  return load_aligned32(in.ring + ring_slot(in, r));
}

// Lane l parses the tags at i + l + 32 j from the staged bytes (zero past
// n), as parse_tag does: the caller checks hdr against the bytes left.
// A tag's 5 bytes come from the two aligned ring words that hold them.
STPU_HD void dec_parse(const DecInput& in, int64_t i, DecSpec& sp) {
  const uint32_t lead = (in.base + (uint32_t)i) & 3;  // i's byte in its word
  STPU_LANES(l) {
#pragma unroll
    for (uint32_t j = 0; j < kDecPos; ++j) {
      const uint32_t p = l + 32 * j;
      const int64_t r = i - lead + ((lead + p) & ~3u);
      uint64_t x = ((uint64_t)ring_word(in, r + 4) << 32 | ring_word(in, r)) >>
                   (8 * ((lead + p) & 3));
      const int64_t left = in.n - (i + p);
      if (left < 5) x = left > 0 ? x & ((1ull << (8 * left)) - 1) : 0;
      const uint32_t b = (uint32_t)x & 0xFF;
      const uint32_t w = (uint32_t)(x >> 8);
      // every kind's fields, then a select: no branch on the lane's kind
      const uint32_t kind = b & 3, lc = b >> 2;
      const uint32_t extra = lc >= 60 ? lc - 59 : 0;  // a literal's 1..4 length bytes
      const uint32_t v = extra == 4 ? w : w & ((1u << (8 * extra)) - 1);
      const uint32_t lit_len = extra ? (v >= kLenClamp ? kLenClamp : v + 1) : lc + 1;
      const uint32_t hdr = kind == 0 ? 1 + extra : (0x05030200u >> (8 * kind)) & 0xFF;
      const uint32_t len = kind == 0 ? lit_len : kind == 1 ? 4 + (lc & 7) : 1 + lc;
      const uint32_t off = kind == 1   ? ((b & 0xE0) << 3) | (w & 0xFF)
                           : kind == 2 ? w & 0xFFFF
                                       : w;
      sp.meta[j][l] = kind | hdr << 2;
      sp.len[j][l] = len;
      sp.off[j][l] = off;
      sp.next[j][l] = p + hdr + (kind == 0 ? len : 0);
    }
  }
}

// The batch's tags: from the cursor, the tags that start inside the
// lookahead and before the end of the input (avail bytes), at most 32.
// Each lane stores its positions' fields and next-tag positions in shared
// memory, and then the position two tags on (next of next); a warp-uniform
// loop follows the tags two at a time, each step two shared loads issued
// together (~34 cycles), and lane t records the t-th tag's position.  Lane
// t then loads that tag's fields.
STPU_HD void dec_chain(const DecSpec& sp, uint32_t avail, uint32_t* slots, DecBatch& bt) {
  uint32_t* next = slots;
  uint32_t* next2 = slots + kLookahead;
  uint32_t* meta = slots + 2 * kLookahead;
  uint32_t* len = slots + 3 * kLookahead;
  uint32_t* off = slots + 4 * kLookahead;
  STPU_LANES(l) {
#pragma unroll
    for (uint32_t j = 0; j < kDecPos; ++j) {
      const uint32_t p = l + 32 * j;
      next[p] = sp.next[j][l];
      meta[p] = sp.meta[j][l];
      len[p] = sp.len[j][l];
      off[p] = sp.off[j][l];
    }
  }
  warp_sync();
  STPU_LANES(l) {
#pragma unroll
    for (uint32_t j = 0; j < kDecPos; ++j) {
      const uint32_t q = sp.next[j][l];
      next2[l + 32 * j] = q < avail ? next[q] : q;
    }
  }
  warp_sync();
  uint32_t t = 0, cur = 0;
  STPU_LANES(l) { bt.pos[l] = 0; }
  for (;;) {  // cur < avail
    const uint32_t c1 = next[cur], c2 = next2[cur];
    STPU_LANES(l) {
      if (l == t) bt.pos[l] = cur;
      if (l == t + 1) bt.pos[l] = c1;
    }
    if (c1 >= avail || t + 1 == 32) {
      bt.end = c1;
      t += 1;
      break;
    }
    t += 2;
    if (c2 >= avail || t == 32) {
      bt.end = c2;
      break;
    }
    cur = c2;
  }
  bt.tags = t;
  STPU_LANES(l) {
    const uint32_t p = l < t ? bt.pos[l] : 0;  // lane t may hold the end
    bt.meta[l] = meta[p];
    bt.len[l] = len[p];
    bt.off[l] = off[p];
  }
  warp_sync();
}

// The batch's output positions and verdict.  ostart: each tag's output
// position; items, istart: its kPiece-byte pieces and the first one's
// index in the batch; src: a literal's input position (bit 31 set) or a
// copy's offset.  Returns the first bad tag (tags if none); *dep holds the
// copies, before it, whose source reaches the batch's own output.
struct DecPlan {
  Lanes<uint32_t> ostart, len, istart, src;
  uint32_t good, dep, items, out_len;
};

STPU_HD void dec_check(const DecBatch& bt, int64_t i, int64_t n, uint32_t o, uint32_t m,
                       DecPlan& pl) {
  // one prefix sum of (items << 32 | len)
  Lanes<uint32_t> len, items, out_end, item_end;
  Lanes<uint64_t> both;
  STPU_LANES(l) {
    len[l] = l < bt.tags ? bt.len[l] : 0;
    items[l] = (len[l] + kPiece - 1) / kPiece;
    both[l] = (uint64_t)items[l] << 32 | len[l];
  }
  const Lanes<uint64_t> ends = warp_scan_add(both);
  STPU_LANES(l) {
    out_end[l] = (uint32_t)ends[l];
    item_end[l] = (uint32_t)(ends[l] >> 32);
  }
  Lanes<bool> bad;
  STPU_LANES(l) {
    const uint32_t ot = o + out_end[l] - len[l];
    const uint32_t kind = bt.meta[l] & 3, hdr = bt.meta[l] >> 2;
    const int64_t left = n - (i + bt.pos[l]);
    const bool b = kind == 0
                       ? hdr > left || len[l] > left - hdr || len[l] > m - ot
                       : hdr > left || bt.off[l] == 0 || bt.off[l] > ot || len[l] > m - ot;
    bad[l] = l < bt.tags && b;
    pl.ostart[l] = ot;
    pl.len[l] = len[l];
    pl.istart[l] = item_end[l] - items[l];
    pl.src[l] = kind == 0 ? 0x80000000u | (bt.pos[l] + hdr) : bt.off[l];
  }
  const uint32_t bad_lanes = warp_ballot(bad);
  pl.good = bad_lanes ? low_lane(bad_lanes) : bt.tags;
  Lanes<bool> dep;
  STPU_LANES(l) {
    const uint32_t off = pl.src[l];
    dep[l] = l < pl.good && !(off >> 31) &&
             pl.ostart[l] - off + (off < len[l] ? off : len[l]) > o;
  }
  pl.dep = warp_ballot(dep);
  pl.items = pl.good ? warp_bcast(item_end, pl.good - 1) : 0;
  pl.out_len = pl.good ? warp_bcast(out_end, pl.good - 1) : 0;
}

// The lane-strided pass: item j is piece j - istart of the tag whose
// pieces hold it; each lane moves one piece, from the ring (or the chunk in
// global memory past the staged bytes) for a literal, from the output
// before the batch for a copy.  The dependent copies are skipped.
STPU_HD void dec_emit_pieces(const DecInput& in, int64_t i, const DecPlan& pl, uint8_t* out) {
  uint32_t before = 0;  // tags whose first piece lies in an earlier step
  for (uint32_t s0 = 0; s0 < pl.items; s0 += 32) {
    Lanes<uint32_t> bit, owner;
    STPU_LANES(l) {
      const uint32_t st = pl.istart[l];
      bit[l] = l < pl.good && st >= s0 && st < s0 + 32 ? 1u << (st - s0) : 0;
    }
    const uint32_t starts = warp_or(bit);
    STPU_LANES(l) { owner[l] = before + popc(starts & lanes_upto(l)) - 1; }
    before += popc(starts);
    const Lanes<uint32_t> ot = warp_shfl(pl.ostart, owner), st = warp_shfl(pl.istart, owner);
    const Lanes<uint32_t> len = warp_shfl(pl.len, owner), src = warp_shfl(pl.src, owner);
    STPU_LANES(l) {
      const uint32_t j = s0 + l;
      if (j < pl.items && !((pl.dep >> (owner[l] & 31)) & 1)) {
        const uint32_t k0 = (j - st[l]) * kPiece;
        const uint32_t k1 = len[l] < k0 + kPiece ? len[l] : k0 + kPiece;
        uint8_t* dst = out + ot[l];
        uint8_t v[kPiece];
        if (src[l] >> 31) {
          const int64_t r = i + (src[l] & 0x7FFFFFFFu);
          if (r + k1 <= in.we) {
#pragma unroll
            for (uint32_t k = 0; k < kPiece; ++k)
              if (k0 + k < k1) v[k] = in.ring[ring_slot(in, r + k0 + k)];
          } else {
#pragma unroll
            for (uint32_t k = 0; k < kPiece; ++k)
              if (k0 + k < k1) v[k] = comp_byte(in, r + k0 + k);
          }
        } else {
          const uint32_t off = src[l];
          const uint8_t* from = out + (ot[l] - off);
          if (off >= len[l]) {
#pragma unroll
            for (uint32_t k = 0; k < kPiece; ++k)
              if (k0 + k < k1) v[k] = from[k0 + k];
          } else {  // self-overlapping: the first `off` bytes repeat
            uint32_t q = k0 % off;
#pragma unroll
            for (uint32_t k = 0; k < kPiece; ++k) {
              if (k0 + k < k1) v[k] = from[q];
              q = q + 1 == off ? 0 : q + 1;
            }
          }
        }
#pragma unroll
        for (uint32_t k = 0; k < kPiece; ++k)
          if (k0 + k < k1) dst[k0 + k] = v[k];
      }
    }
  }
  warp_sync();
}

// The copies that read the batch's own output, in order: byte k of the
// copy at o comes from o - off + k % off, all of it written before.
STPU_HD void dec_emit_dependent(const DecPlan& pl, uint8_t* out) {
  for (uint32_t d = pl.dep; d; d &= d - 1) {
    const uint32_t t = low_lane(d);
    const uint32_t ot = warp_bcast(pl.ostart, t), off = warp_bcast(pl.src, t);
    const uint32_t len = warp_bcast(pl.len, t);
    STPU_LANES(l) {
      for (uint32_t k = l; k < len; k += 32) out[ot + k] = out[ot - off + k % off];
    }
    warp_sync();
  }
}

// Decode the warp's chunk into out[0, m).  Returns 1 when the stream is
// valid, consumed exactly and produced exactly m bytes; *written is the
// output produced before the first bad tag (or in all).
STPU_HD int decode_chunk_warp(DecInput& in, uint8_t* out, uint32_t m, uint32_t* written) {
  const int64_t n = in.n;
  int64_t i = 0;
  uint32_t o = 0;
  bool bad = false;
  while (i < n) {
    if (in.we < min_i64(n, i + kLookahead + 4)) {
      STPU_PROF(0, dec_stage(in, i));
    }
    DecSpec sp;
    DecBatch bt;
    DecPlan pl;
    STPU_PROF(1, dec_parse(in, i, sp));
    STPU_PROF(2, dec_chain(sp, (uint32_t)min_i64(n - i, kLookahead), in.slots, bt));
    STPU_PROF(3, dec_check(bt, i, n, o, m, pl));
    STPU_DEC_BATCH(i, o, bt, pl);
    STPU_PROF(4, dec_emit_pieces(in, i, pl, out));
    if (pl.dep) {
      STPU_PROF(5, dec_emit_dependent(pl, out));
    }
    o += pl.out_len;
    if (pl.good < bt.tags) {
      bad = true;
      break;
    }
    i += bt.end;
  }
  *written = o;
  return !bad && i == n && o == m;
}

// The layout of each shape, from the A/B on the card (PERF.md §6): above
// 64 KiB the row sits in shared memory beside the ring (layout a), else the
// warp writes it in place in `out` (layout b).
STPU_HD bool dec_row_in_smem(int64_t out_cols) { return out_cols > kMaxBlock; }

}  // namespace stpu

// The walk's constants and the layout at out_cols, in both builds, for the
// tests and the measurement scripts: params = {kLookahead, kRing, kPiece,
// 1 where the row sits in shared memory}.
STPU_EXPORT void stpu_decode_chunks_params(int64_t out_cols, int64_t* params) {
  params[0] = stpu::kLookahead;
  params[1] = stpu::kRing;
  params[2] = stpu::kPiece;
  params[3] = stpu::dec_row_in_smem(out_cols);
}

#ifdef __CUDACC__

namespace {

// Shared memory of a CTA: the ring, the slots, then the row where it sits
// there.
constexpr size_t kRowAt = stpu::kRing + 4 * stpu::kSlots;

template <bool kRowInSmem>
size_t dec_smem(int64_t out_cols) {
  return kRowAt + (kRowInSmem ? (size_t)out_cols : 0);
}

// One warp per chunk.  kRowInSmem: the row is built in shared memory and
// written out at the end (layout a), else in place in `out` (layout b).
template <bool kRowInSmem>
__global__ void __launch_bounds__(32)
    decode_chunks_kernel(const uint8_t* __restrict__ comp,
                         const int64_t* __restrict__ offsets,
                         const int32_t* __restrict__ declared,
                         uint8_t* out, int64_t out_cols,
                         uint8_t* __restrict__ ok,
                         int32_t* __restrict__ written) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t lane = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int64_t lo = offsets[row];
  stpu::DecInput in = {comp + lo, offsets[row + 1] - lo, smem,
                       reinterpret_cast<uint32_t*>(smem + stpu::kRing),
                       (uint32_t)reinterpret_cast<uintptr_t>(comp + lo) & (stpu::kRing - 1),
                       0, 0};
  uint8_t* grow = out + row * out_cols;
  uint8_t* row_out = kRowInSmem ? smem + kRowAt : grow;
  uint32_t w = 0;
  STPU_PROF(7, const int good = stpu::decode_chunk_warp(in, row_out, (uint32_t)declared[row], &w));
  if (lane == 0) {
    ok[row] = (uint8_t)good;
    written[row] = (int32_t)w;
  }
  // zeros from w to the next 16-byte edge, then whole 16-byte words
  const uint32_t w16 = (w + 15) & ~15u;
  if (lane < w16 - w) row_out[w + lane] = 0;
  __syncwarp();
  uint4* dst = reinterpret_cast<uint4*>(grow);
  const uint4* src = reinterpret_cast<const uint4*>(row_out);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (uint32_t k = (kRowInSmem ? 0 : w16 / 16) + lane; k < out_cols / 16; k += 32)
    dst[k] = 16 * k < w16 ? src[k] : zero;
}

template <bool kRowInSmem>
int launch_decode(const uint8_t* comp, const int64_t* offsets, const int32_t* declared, int n,
                  uint8_t* out, int64_t out_cols, uint8_t* ok, int32_t* written,
                  cudaStream_t stream) {
  const size_t smem = dec_smem<kRowInSmem>(out_cols);
  cudaError_t err = cudaFuncSetAttribute(decode_chunks_kernel<kRowInSmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_chunks_kernel<kRowInSmem><<<n, 32, smem, stream>>>(comp, offsets, declared, out,
                                                            out_cols, ok, written);
  return (int)cudaGetLastError();
}

}  // namespace

// comp: uint8 ragged tag streams, chunk r = comp[offsets[r], offsets[r+1]);
// declared: int32 [n], each <= out_cols; out: uint8 [n, out_cols], 16-byte
// aligned rows, out_cols a multiple of 16 and <= 131072; ok: uint8 [n];
// written: int32 [n].  Launches on `stream`; returns cudaGetLastError().
STPU_EXPORT int stpu_decode_chunks(const uint8_t* comp, const int64_t* offsets,
                                   const int32_t* declared, int n, uint8_t* out,
                                   int64_t out_cols, uint8_t* ok,
                                   int32_t* written, void* stream) {
  if (stpu::dec_row_in_smem(out_cols))
    return launch_decode<true>(comp, offsets, declared, n, out, out_cols, ok, written,
                               (cudaStream_t)stream);
  return launch_decode<false>(comp, offsets, declared, n, out, out_cols, ok, written,
                              (cudaStream_t)stream);
}

#else  // CPU twin: the same warp code, its 32 lanes as arrays

STPU_EXPORT int stpu_twin_decode_chunks(const uint8_t* comp,
                                        const int64_t* offsets,
                                        const int32_t* declared, int n,
                                        uint8_t* out, int64_t out_cols,
                                        uint8_t* ok, int32_t* written) {
  alignas(16) static thread_local uint8_t ring[stpu::kRing];
  static thread_local uint32_t slots[stpu::kSlots];
  for (int64_t row = 0; row < n; ++row) {
    const uint8_t* src = comp + offsets[row];
    stpu::DecInput in = {src, offsets[row + 1] - offsets[row], ring, slots,
                         (uint32_t)reinterpret_cast<uintptr_t>(src) & (stpu::kRing - 1), 0, 0};
    uint8_t* dst = out + row * out_cols;
    uint32_t w = 0;
    ok[row] = (uint8_t)stpu::decode_chunk_warp(in, dst, (uint32_t)declared[row], &w);
    written[row] = (int32_t)w;
    memset(dst + w, 0, (size_t)(out_cols - w));
  }
  return 0;
}

#endif
