// Snappy block encoder, levels 1 and 2: the kernel behind
// snappy_tpu_torch.ops.encode_blocks.encode_blocks.
//
// Replaces the TPU kernel snappy_tpu/ops/encode_scalar.py (_kernel with
// ways=1 and ways=2, launched by _call and encode_blocks_words).  The bytes
// equal the host C encoder encode_block_impl (snappy_codec.c:127-222) at
// the same `ways`, which equals the TPU kernel's (encode_scalar.py:12-16;
// test_scalar_kernels.py:960-980 for ways=2).  The three parity rules of
// encode_scalar.py:18-28 hold here as they do in the host C: the hash
// table is zeroed per block, so position 0 is a candidate; the hash takes
// the top log2(table size) bits of u * 0x1e35a7bd with the table size
// scaled to the block; the probe checks ip + step against the limit before
// it probes.  Blocks shorter than 17 bytes are one literal.  At ways=2
// each hash bucket is a two-entry FIFO (slot 0 newest): a probe shifts
// slot 0 into slot 1 and stores the position in slot 0, then tests the
// old slot 0 (c1) before the old slot 1 (c2); the match-extension loop
// inserts ip - 1 the same way before it probes ip
// (snappy_codec.c:171-178, 209-219).
//
// Bound on the H100: latency, and so the walks in flight.  A greedy walk
// is a chain of dependent loads (probe, table, candidate, compare) over
// ~5,200 tags per 64 KiB block of the mixed payload, about 1,400 cycles a
// tag; the bytes moved (50 + 22 MB at 768 blocks) take 0.02 ms.  So one
// walk's speed is set by latency, and the card's rate by the number of
// walks in flight.  The earlier design walked each block with one thread
// of a 128-thread CTA, one byte per step.
//
// Design: one warp walks one block, and all 32 lanes take part in every
// step while the decisions stay in the host C's order:
// - probe batches: the positions a probe loop visits do not depend on the
//   table until a probe hits, so lane k takes probe k of the next 32 (its
//   position from the skip recurrence, its limit check, hash, table read
//   and the words at the bucket's old entries).  A lane's candidate is the
//   latest earlier lane of its bucket, else the entry read before the
//   batch; at ways=2 c2 is the second-latest such lane, else the old slot
//   0, else the old slot 1.  The lanes of a bucket come from 14 ballots,
//   one per hash bit (__match_any_sync gives the same masks but
//   serialises over distinct values, and 32 probes' buckets are mostly
//   distinct).  The first lane that hits wins (a ballot); only lanes up to
//   it update the table, the latest lane of each bucket alone (at ways=2
//   slot 0 = that lane, slot 1 = its c1);
// - match extension: each lane compares 4 bytes, 128 bytes a step, and
//   ballots find the first mismatch, with the block's end masked;
// - literals: the lanes copy the bytes together, coalesced;
// - the step after a match (insert ip - 1, probe ip) and the copy tags are
//   warp-uniform: every lane computes them and stores the same bytes.  The
//   probe's compare is the head of its match extension.
//
// Launch: a persistent grid of walkers, each a warp with its own hash
// table (32 KiB at ways=1, 64 KiB at ways=2) in its CTA's shared memory,
// reading its block from global memory through the read-only path.
// - Shared memory, not registers (38-40 a thread) or warp slots, caps the
//   walks in flight: one table per one-warp CTA plus the SM's 1 KB
//   reservation a CTA let only 6 (3) CTAs share an SM.  One CTA an SM of
//   as many walkers as the card's opt-in shared memory per block holds
//   pays that reservation once: 7 walkers at ways=1 (229,376 of 232,448
//   bytes on the H100), 3 at ways=2.  ops/encode_blocks.launch_shape sets
//   the walkers and CTAs; a batch of fewer blocks gets no more walkers than
//   blocks, spread over as many SMs as it has blocks.
// - Walks differ up to 3x in tags (a beacon state's balances against its
//   validator records), so no walker is dealt a fixed share of the rows:
//   lane 0 of a walker that is free takes the next entry from a counter on
//   the card (zeroed on the stream before each launch) and the warp walks
//   its row, until none is left.  Rows keep their places in the output.
// - Where rows outnumber walkers, the walks that start last set the end:
//   on a beacon state the 244 balance and participation frames, 2.1x a
//   validator frame's walk, come last in index order and leave most
//   walkers idle behind them (PERF.md §6).  So the queue takes the rows
//   costliest first: a first launch times walks at ways=1 of four 256-byte
//   pieces of each row (the same walk on a sample of the row), and
//   ops/encode_blocks orders the queue by those times before the walk.
// - Staging the block beside the table (layout a, which
//   testing/encode_layouts.py builds around the same walk, PERF.md §6)
//   makes each load cheaper but leaves 2 (1) walks an SM, and measured
//   slower at both ways.
//
// One source, two builds: the warp code is written against Lanes<T> and
// the collectives of snappy_common.cuh, which are registers and
// intrinsics on the card and 32-entry arrays and loops in the CPU twin, so
// the twin runs the same 32-lane batch logic.
#include "snappy_common.cuh"

namespace stpu {

// Per lane, the mask of the lanes whose x agrees with its own in bits 0 ..
// kBits - 1: kBits ballots, all issued before the first result is used.
// (__match_any_sync takes the same mask but serialises over the distinct
// values, which is the common case of 32 probes' buckets: PERF.md §6.)
template <uint32_t kBits>
STPU_HD Lanes<uint32_t> warp_match_bits(const Lanes<uint32_t>& x) {
  uint32_t votes[kBits];
#pragma unroll
  for (uint32_t b = 0; b < kBits; ++b) {
    Lanes<bool> bit;
    STPU_LANES(l) { bit[l] = (x[l] >> b) & 1; }
    votes[b] = warp_ballot(bit);
  }
  Lanes<uint32_t> m;
  STPU_LANES(l) {
    m[l] = 0xFFFFFFFFu;
#pragma unroll
    for (uint32_t b = 0; b < kBits; ++b) m[l] &= (x[l] >> b) & 1 ? votes[b] : ~votes[b];
  }
  return m;
}

// The warp's block in[0, n): its row in global memory, read through the
// read-only path.  The walk below takes its block type as a parameter
// (S, with .n, block_word and block_byte), so that
// testing/encode_layouts.py can time the same walk on a block staged in
// shared memory.
struct Block {
  const uint8_t* in;
  uint32_t n;
};

// Bytes p .. p + 3 of the block (p < n) as a little-endian word; the bytes
// at n and past it are unspecified.  On the card: from the aligned words
// that hold them, never one wholly past in + n.
STPU_HD uint32_t block_word(const Block& b, uint32_t p) {
#ifdef __CUDA_ARCH__
  const uintptr_t q = reinterpret_cast<uintptr_t>(b.in + p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(q & ~(uintptr_t)3);
  const uint32_t sh = (uint32_t)(q & 3) * 8;
  const uint32_t lo = __ldg(w);
  const uint32_t hi =
      sh && reinterpret_cast<const uint8_t*>(w + 1) < b.in + b.n ? __ldg(w + 1) : 0;
  return __funnelshift_r(lo, hi, sh);
#else
  uint32_t v = 0;
  for (uint32_t k = 0; k < 4; ++k)
    if (p + k < b.n) v |= (uint32_t)b.in[p + k] << (8 * k);
  return v;
#endif
}

STPU_HD uint8_t block_byte(const Block& b, uint32_t p) {
#ifdef __CUDA_ARCH__
  return __ldg(b.in + p);
#else
  return b.in[p];
#endif
}

// Timing hooks around the phases of the walk (k: the phase, 0-4, and 7 for
// the whole walk); they only run the statement unless a build defines
// STPU_PROF, as testing/encode_layouts.py does to count cycles per phase.
#ifndef STPU_PROF
#define STPU_PROF(k, ...) __VA_ARGS__
#endif

// Hash-table entries per way for a block of n bytes (snappy_codec.c:138).
STPU_HD uint32_t table_entries(uint32_t n) {
  uint32_t size = 256;
  while (size < kTableSize && size < n) size <<= 1;
  return size;
}

// The literal in[start, start + len) at op: its tag, then the bytes, copied
// by the lanes together.  Returns the new output position.
template <class S>
STPU_HD uint32_t warp_literal(uint8_t* out, uint32_t op, const S& src,
                              uint32_t start, uint32_t len) {
  op = literal_tag(out, op, len);
  STPU_LANES(l) {
#pragma unroll 4
    for (uint32_t k = l; k < len; k += 32) out[op + k] = block_byte(src, start + k);
  }
  return op + len;
}

// Length of the common prefix of in[s1 ..] and in[s2 .. n), s1 < s2: each
// lane compares one 4-byte word, 128 bytes a step.  Three ballots, issued
// together, give the first short lane and its equal bytes (0-3).
template <class S>
STPU_HD uint32_t warp_match_length(const S& src, uint32_t s1, uint32_t s2) {
  const uint32_t n = src.n;
  for (uint32_t len = 0;; len += 128) {
    Lanes<bool> whole, bit0, bit1;
    STPU_LANES(l) {
      const uint32_t b = s2 + len + 4 * l;
      uint32_t e = 0;  // equal bytes at the head of this lane's word
      if (b < n) {
        const uint32_t x = block_word(src, s1 + len + 4 * l) ^ block_word(src, b);
        e = x ? low_lane(x) >> 3 : 4;
        if (e > n - b) e = n - b;
      }
      whole[l] = e == 4;
      bit0[l] = e & 1;
      bit1[l] = (e >> 1) & 1;
    }
    const uint32_t short_lanes = ~warp_ballot(whole);
    const uint32_t b0 = warp_ballot(bit0), b1 = warp_ballot(bit1);
    if (short_lanes) {
      const uint32_t f = low_lane(short_lanes);
      return len + 4 * f + ((b0 >> f) & 1) + 2 * ((b1 >> f) & 1);
    }
  }
}

enum : uint32_t { kMore = 0, kHit = 1, kEnd = 2 };

// The next 32 probes of the probe loop from (ip, skip), one per lane.
// kHit: the first lane that hit set ip and candidate, the table holds the
// probes up to it.  kMore: no probe hit; ip and skip move past the 32 and
// the table holds them all.  kEnd: a probe's next ip passed ip_limit
// before any hit, and the block ends with its trailing literal.
//
// Each lane loads the words at its bucket's old entries at once; the lanes
// of its bucket come from one ballot per hash bit, and a candidate that an
// earlier lane stored is tested against that lane's word (a shuffle), so
// no load waits on the lane masks.
template <int Ways, class S>
STPU_HD uint32_t probe_batch(const S& src, uint16_t* table, uint32_t shift, uint32_t ip_limit,
                             uint32_t& ip, uint32_t& skip, uint32_t& candidate) {
  Lanes<uint32_t> pos, skp, cur, h, old0, old1, w0, w1;
  Lanes<bool> ok;
  const uint32_t s0 = skip >> 5;
  // all 32 probes take the same step (always so from skip = 32)
  const bool flat = skip + 31 * s0 < 32 * (s0 + 1);
  STPU_LANES(l) {
    uint32_t p = ip, sk = skip;
    if (flat) {
      p += l * s0;
      sk += l * s0;
    } else {
      for (uint32_t k = 0; k < l; ++k) {
        const uint32_t st = sk >> 5;
        p += st;
        sk += st;
      }
    }
    pos[l] = p;
    skp[l] = sk;
    ok[l] = p + (sk >> 5) <= ip_limit;  // a prefix of the lanes
    cur[l] = ok[l] ? block_word(src, p) : 0;
    // a lane past the limit gets a value past the table; its low 14 bits
    // may equal a real bucket's, and `same &= okmask` below is what keeps
    // it out of every bucket's lanes
    h[l] = ok[l] ? hash32(cur[l], shift) : 0x10000u + l;
    old0[l] = ok[l] ? table[Ways * h[l]] : 0;
    old1[l] = Ways == 2 && ok[l] ? table[2 * h[l] + 1] : 0;
    w0[l] = ok[l] ? block_word(src, old0[l]) : 0;
    w1[l] = Ways == 2 && ok[l] ? block_word(src, old1[l]) : 0;
  }
  const uint32_t okmask = warp_ballot(ok);
  Lanes<uint32_t> same = warp_match_bits<kTableBits>(h);  // h < 2^14 on ok lanes
  Lanes<uint32_t> src1, src2;
  STPU_LANES(l) {
    same[l] &= okmask;
    const uint32_t below = same[l] & ((1u << l) - 1);
    src1[l] = below ? high_lane(below) : l;
    const uint32_t rest = below & ~(1u << src1[l]);
    src2[l] = rest ? high_lane(rest) : l;
  }
  const Lanes<uint32_t> p1 = warp_shfl(pos, src1), cur1 = warp_shfl(cur, src1);
  const Lanes<uint32_t> p2 = warp_shfl(pos, src2), cur2 = warp_shfl(cur, src2);
  Lanes<uint32_t> c1, win;
  Lanes<bool> hit;
  STPU_LANES(l) {
    const uint32_t below = same[l] & ((1u << l) - 1);
    // c1: the latest earlier lane of the bucket, else the old slot 0
    c1[l] = below ? p1[l] : old0[l];
    const bool hit1 = cur[l] == (below ? cur1[l] : w0[l]);
    // c2: the second-latest earlier lane, else the old slot 0 (behind
    // one earlier lane), else the old slot 1
    const uint32_t c2 = popc(below) >= 2 ? p2[l] : below ? old0[l] : old1[l];
    const bool hit2 = cur[l] == (popc(below) >= 2 ? cur2[l] : below ? w0[l] : w1[l]);
    hit[l] = ok[l] && (hit1 || (Ways == 2 && hit2));
    win[l] = hit1 ? c1[l] : c2;
  }
  const uint32_t hits = warp_ballot(hit);
  if (!hits && okmask != 0xFFFFFFFFu) return kEnd;
  const uint32_t last = hits ? low_lane(hits) : 31;
  const uint32_t p_last = warp_bcast(pos, last), c_last = warp_bcast(win, last);
  const uint32_t s_last = warp_bcast(skp, last);
  warp_sync();  // every lane has read the table
  STPU_LANES(l) {
    const uint32_t later = same[l] & ~lanes_upto(l) & lanes_upto(last);
    if (l <= last && !later) {
      table[Ways * h[l]] = (uint16_t)pos[l];
      if (Ways == 2) table[2 * h[l] + 1] = (uint16_t)c1[l];
    }
  }
  warp_sync();
  if (hits) {
    ip = p_last;
    candidate = c_last;
    return kHit;
  }
  ip = p_last + (s_last >> 5);
  skip = s_last + (s_last >> 5);
  return kMore;
}

// The step after a match ends at ip (<= ip_limit), warp-uniform: insert
// ip - 1, then probe ip.  The probe's compare is the head of its match
// extension (the word at ip is the first of the extension's), so a hit
// returns its match length (>= 4) at once, with its candidate; a miss
// returns 0.
template <int Ways, class S>
STPU_HD uint32_t after_match(const S& src, uint16_t* table, uint32_t shift, uint32_t ip,
                             uint32_t& candidate) {
  const uint32_t hp = hash32(block_word(src, ip - 1), shift);
  const uint32_t h = hash32(block_word(src, ip), shift);
  uint32_t c1, c2 = 0;
  if (Ways == 1) {
    c1 = h == hp ? ip - 1 : table[h];
    warp_sync();
    table[hp] = (uint16_t)(ip - 1);
    table[h] = (uint16_t)ip;
  } else {
    const uint32_t a0 = table[2 * hp];
    c1 = h == hp ? ip - 1 : table[2 * h];
    c2 = h == hp ? a0 : table[2 * h + 1];
    warp_sync();
    if (h != hp) {
      table[2 * hp] = (uint16_t)(ip - 1);
      table[2 * hp + 1] = (uint16_t)a0;
    }
    table[2 * h] = (uint16_t)ip;
    table[2 * h + 1] = (uint16_t)c1;
  }
  warp_sync();
  uint32_t len = warp_match_length(src, c1, ip);
  if (len >= 4) {
    candidate = c1;
    return len;
  }
  if (Ways == 2) {
    len = warp_match_length(src, c2, ip);
    if (len >= 4) {
      candidate = c2;
      return len;
    }
  }
  return 0;
}

// Encode the block of src (n <= 65536 bytes) into out with one warp;
// returns the encoded length, at most max_compressed_len(n).  `table`
// holds Ways * table_entries(n) zeroed entries.
template <int Ways, class S>
STPU_HD uint32_t encode_block_warp(const S& src, uint8_t* out, uint16_t* table) {
  const uint32_t n = src.n;
  uint32_t op = 0;
  if (n < kMinNonLiteral) {
    if (n) {
      STPU_PROF(2, op = warp_literal(out, op, src, 0, n));
    }
    return op;
  }
  uint32_t shift = 32;
  for (uint32_t s = table_entries(n); s > 1; s >>= 1) --shift;
  const uint32_t ip_limit = n - kInputMargin;
  uint32_t ip = 1, next_emit = 0, candidate = 0;
  for (;;) {
    uint32_t skip = 32, found;
    do {
      STPU_PROF(0, found = probe_batch<Ways>(src, table, shift, ip_limit, ip, skip, candidate));
    } while (found == kMore);
    if (found == kEnd) break;
    if (next_emit < ip) {
      STPU_PROF(2, op = warp_literal(out, op, src, next_emit, ip - next_emit));
    }
    STPU_PROF(1, uint32_t len = 4 + warp_match_length(src, candidate + 4, ip + 4));
    for (;;) {  // a match of len bytes at ip, candidate bytes back
      const uint32_t offset = ip - candidate;
      ip += len;
      next_emit = ip;
      uint32_t next_len = 0;
      if (ip <= ip_limit) {
        STPU_PROF(4, next_len = after_match<Ways>(src, table, shift, ip, candidate));
      }
      STPU_PROF(3, op = emit_copy(out, op, offset, len));
      if (!next_len) break;
      len = next_len;
    }
    if (ip > ip_limit) break;
    ++ip;
  }
  if (next_emit < n) {
    STPU_PROF(2, op = warp_literal(out, op, src, next_emit, n - next_emit));
  }
  return op;
}

}  // namespace stpu

#ifdef __CUDACC__

namespace {

template <int Ways>
__host__ __device__ constexpr size_t table_bytes() {
  return Ways * stpu::kTableSize * sizeof(uint16_t);
}

// Bytes of a row, in kPieces pieces at the starts of its quarters, whose
// walks estimate the cost of its whole walk, for the order of the queue.
constexpr uint32_t kSample = 1024;
constexpr uint32_t kPieces = 4;

// The kernel's passes: the walk of the rows in index order or in a given
// order, at either `ways`, and the estimate of their costs, at ways=1 for
// both levels (the pieces' walks at ways=1 rank the rows as well, and
// ptxas fails (C7600) to allocate the estimate at ways=2).
enum Pass : int { kIndexOrder, kOrdered, kEstimate };

// `walkers` warps over gridDim.x CTAs: warp w of CTA c is walker w *
// gridDim.x + c, and the warps past the last walker return at once.  Each
// walker owns its slice of the CTA's shared memory as its hash table and,
// once free, takes the next entry of `queue` until none is left.  In the
// walk passes entry k is row order[k] (kOrdered) or row k, walked into
// out[row] and out_len[row].  kEstimate has kPieces entries a row: entry
// k walks piece k % kPieces of row k / kPieces, sample / kPieces bytes at
// the start of that quarter of the row (so that a row whose fields change
// inside it is seen whole), and adds its cycles, scaled to the row's
// length over `sample`, to cost[row], zeroed before the launch; a row of
// `sample` bytes or fewer keeps 0.  The pieces' bytes land in the row's
// output, for the walk to overwrite.  (`sample` is kSample, passed at run
// time so that the estimate's walk is not compiled for one block size;
// the pieces are entries of their own because ptxas fails (C7600) to
// allocate a loop of walks inside the loop of entries.)
template <int Ways, int P>
__global__ void encode_blocks_kernel(const uint8_t* __restrict__ blocks, int64_t in_stride,
                                     const int32_t* __restrict__ lens, int n,
                                     uint8_t* __restrict__ out, int64_t out_stride,
                                     int32_t* __restrict__ out_len, int walkers,
                                     uint32_t* __restrict__ queue, int32_t* __restrict__ cost,
                                     const int32_t* __restrict__ order, uint32_t sample) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp * gridDim.x + blockIdx.x >= (uint32_t)walkers) return;
  uint16_t* table = reinterpret_cast<uint16_t*>(smem + warp * table_bytes<Ways>());
  uint4* tab16 = reinterpret_cast<uint4*>(table);
  const int64_t entries = P == kEstimate ? (int64_t)n * kPieces : n;
  for (;;) {
    uint32_t next = 0;
    if (lane == 0) next = atomicAdd(queue, 1u);
    const int64_t k = __shfl_sync(0xFFFFFFFFu, next, 0);
    if (k >= entries) return;
    const int64_t row = P == kOrdered ? order[k] : P == kEstimate ? k / kPieces : k;
    const uint32_t len_in = (uint32_t)lens[row];
    if (P == kEstimate && len_in <= sample) continue;
    const uint32_t size = P == kEstimate ? sample / kPieces : len_in;
    const uint8_t* src = blocks + row * in_stride;
    if (P == kEstimate) src += (k % kPieces) * (len_in / kPieces);
    const uint32_t tab_chunks = Ways * stpu::table_entries(size) * sizeof(uint16_t) / 16;
    for (uint32_t c = lane; c < tab_chunks; c += 32) tab16[c] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    const stpu::Block block = {src, size};
    uint8_t* dst = out + row * out_stride;
    if constexpr (P == kEstimate) {
      const long long start = clock64();
      STPU_PROF(7, stpu::encode_block_warp<Ways>(block, dst, table));
      if (lane == 0) {
        const long long spent = (clock64() - start) * len_in / sample;
        atomicAdd(cost + row, (int32_t)(spent < 0x1FFFFFFF ? spent : 0x1FFFFFFF));
      }
    } else {
      STPU_PROF(7, const uint32_t len = stpu::encode_block_warp<Ways>(block, dst, table));
      if (lane == 0) out_len[row] = (int32_t)len;
    }
    __syncwarp();  // the walk is done with the table before the next row zeroes it
  }
}

template <int Ways, int P>
int launch_pass(const uint8_t* blocks, int64_t in_stride, const int32_t* lens, int n,
                uint8_t* out, int64_t out_stride, int32_t* out_len, int walkers, int ctas,
                uint32_t* queue, int32_t* cost, const int32_t* order, cudaStream_t stream) {
  if (walkers < 1 || ctas < 1 || ctas > walkers) return (int)cudaErrorInvalidValue;
  const int warps = (walkers + ctas - 1) / ctas;
  const size_t smem = warps * table_bytes<Ways>();
  // the kernel's dynamic shared memory may reach the card's opt-in limit:
  // the same value for every launch, so that launches of other sizes on
  // other threads never lower it under this one
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(encode_blocks_kernel<Ways, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) err = cudaMemsetAsync(queue, 0, sizeof(uint32_t), stream);
  if (err != cudaSuccess) return (int)err;
  encode_blocks_kernel<Ways, P><<<ctas, 32 * warps, smem, stream>>>(
      blocks, in_stride, lens, n, out, out_stride, out_len, walkers, queue, cost, order, kSample);
  return (int)cudaGetLastError();
}

template <int Ways>
int launch_encode(const uint8_t* blocks, int64_t in_stride, const int32_t* lens, int n,
                  uint8_t* out, int64_t out_stride, int32_t* out_len, int walkers, int ctas,
                  uint32_t* queue, int32_t* cost, const int32_t* order, cudaStream_t stream) {
  if (cost && Ways != 1) return (int)cudaErrorInvalidValue;
  if (cost) {
    const cudaError_t err = cudaMemsetAsync(cost, 0, (size_t)n * sizeof(int32_t), stream);
    if (err != cudaSuccess) return (int)err;
    return launch_pass<1, kEstimate>(blocks, in_stride, lens, n, out, out_stride, out_len,
                                     walkers, ctas, queue, cost, order, stream);
  }
  if (order)
    return launch_pass<Ways, kOrdered>(blocks, in_stride, lens, n, out, out_stride, out_len,
                                       walkers, ctas, queue, cost, order, stream);
  return launch_pass<Ways, kIndexOrder>(blocks, in_stride, lens, n, out, out_stride, out_len,
                                        walkers, ctas, queue, cost, order, stream);
}

}  // namespace

// blocks: uint8 [n, in_stride], lens: int32 [n] (each <= 65536);
// out: uint8 [n, out_stride], out_stride >= max_compressed_len(65536);
// out_len: int32 [n]; ways: 1 (level 1) or 2 (level 2); walkers and ctas:
// ops/encode_blocks.launch_shape's; queue: 4 bytes of scratch on the card;
// cost: int32 [n] for the estimate pass (ways 1; zeroed here), else null;
// order: int32 [n], a permutation of the rows to walk in, or null for 0 ..
// n - 1.  Launches on `stream`; returns the first CUDA error (or
// cudaErrorInvalidValue for another `ways` or shape).
STPU_EXPORT int stpu_encode_blocks(const uint8_t* blocks, int64_t in_stride,
                                   const int32_t* lens, int n, uint8_t* out,
                                   int64_t out_stride, int32_t* out_len, int ways,
                                   int walkers, int ctas, uint32_t* queue, int32_t* cost,
                                   const int32_t* order, void* stream) {
  if (ways == 1)
    return launch_encode<1>(blocks, in_stride, lens, n, out, out_stride, out_len, walkers,
                            ctas, queue, cost, order, (cudaStream_t)stream);
  if (ways == 2)
    return launch_encode<2>(blocks, in_stride, lens, n, out, out_stride, out_len, walkers,
                            ctas, queue, cost, order, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// limits: int64 [2], set to CUDA device `dev`'s opt-in shared memory per
// block in bytes and its SMs; returns the first CUDA error.
STPU_EXPORT int stpu_encode_blocks_limits(int dev, int64_t* limits) {
  int smem = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  limits[0] = smem;
  limits[1] = sms;
  return (int)err;
}

#else  // CPU twin: the same warp code, its 32 lanes as arrays

#include <algorithm>
#include <vector>

// The rows in order; the launch shape and the queue's order (walkers,
// ctas, queue, cost, order) are the card's.
STPU_EXPORT int stpu_twin_encode_blocks(const uint8_t* blocks,
                                        int64_t in_stride, const int32_t* lens,
                                        int n, uint8_t* out,
                                        int64_t out_stride, int32_t* out_len,
                                        int ways, int, int, uint32_t*, int32_t*,
                                        const int32_t*) {
  if (ways != 1 && ways != 2) return 1;
  std::vector<uint16_t> table(2 * stpu::kTableSize);
  for (int64_t row = 0; row < n; ++row) {
    std::fill(table.begin(), table.end(), 0);
    const stpu::Block src = {blocks + row * in_stride, (uint32_t)lens[row]};
    uint8_t* dst = out + row * out_stride;
    out_len[row] = (int32_t)(ways == 1 ? stpu::encode_block_warp<1>(src, dst, table.data())
                                       : stpu::encode_block_warp<2>(src, dst, table.data()));
  }
  return 0;
}

#endif
