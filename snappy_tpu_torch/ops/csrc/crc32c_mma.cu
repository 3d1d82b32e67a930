// Masked CRC32C as GF(2) products on the int8 tensor cores (K6): the
// kernel behind snappy_tpu_torch.ops.crc32c_mma.masked_crc32c_chunks_fused.
//
// Replaces the TPU kernel snappy_tpu/ops/crc32c_mxu.py (_fused_kernel,
// launched by _fused_registers and reached through
// masked_crc32c_chunks_fused).  CRC is linear over GF(2): the zero-init
// register of a 32-byte block is A32 . bits(block) mod 2, A32 a fixed 0/1
// [256, 32] matrix (row 8 b + j: the register contribution of bit j of
// byte b; the last 256 rows of the TPU kernel's A), and the register of a
// longer run advances a block at a time, r <- M32 . r xor A32 . bits, M32
// the advance over 32 zero bytes.  As on the TPU, the products run on the
// matrix unit (mma.sync m16n8k32 u8.u8.s32), reduced mod 2.  The TPU
// kernel's 512-byte super-lanes and 32 bit-plane matmuls suit Mosaic and a
// 128 x 128 MXU; nothing on the H100 binds them.
//
// Design:
// - the matrices in registers: each of a warp's 16 mma rows walks one
//   512-byte stripe 32 bytes a step; k-step kk (0 .. 7) takes bit kk of
//   each of the step's 32 bytes, and a 9th k-step takes the stripe's
//   register so far against M32's rows (the Horner step inside the
//   product), so B is 9 k-steps x 4 n-tiles x 2 = 72 registers a thread,
//   loaded once per launch: the loop reads no constants;
// - one instruction per operand register: lane (g, t) takes bytes 8t ..
//   8t + 7 of its two rows' block; k-step kk's operand is
//   w & (0x01010101 << kk), values {0, 2^kk}, against weights scaled by
//   2^(7 - kk), so every product is 128 . bit . a and bit 7 of a sum (at
//   most 288 terms) is its parity; the state operand is byte 0 of each
//   accumulator (its low 7 bits are 0), gathered by byte permutes, with
//   the slots of that k-step permuted to follow the C fragment, so the
//   feedback stays inside the thread;
// - a persistent grid: CTAs of 8 warps, 2 per SM, each owning whole 64 KiB
//   chunks in turn; warp w takes the chunk's w-th 8 KiB (16 stripes), its
//   next 3 steps staged in its shared memory by cp.async (16 bytes a lane,
//   every 32-byte sector read once, in full), across into its next chunk;
// - a parallel epilogue: a stripe's register by OR-shuffles over the quad,
//   the 16 stripes and then the 8 warps folded by "advance by 2^j bytes"
//   byte tables (as K1), the zero tail of a ragged chunk cancelled one
//   inverse matrix at a time across the warp (a column a lane, an XOR
//   reduction), by one warp in turn while the others go on to the next
//   chunk.  The constants come through the read-only cache.
//
// Bound on the H100: the 50.3 MB read of 768 chunks (15.0 us at 3.35
// TB/s); the products, 3.54 M m16n8k32 (14.5 G MAC), 14.7 us at the
// 1,979 TOP/s int8 peak.  What holds the kernel is the products' dispatch:
// mma.sync takes about 6.6 cycles a product on each tensor core, and the
// SM dispatches nothing else meanwhile (testing/mma_layouts.py measures both),
// so the design spends about 1.5 other instructions a product: an AND an
// operand register, three byte permutes a state register, the loads.
//
// One source, two builds: the warp code is written against Lanes<T> of
// snappy_common.cuh, and in the CPU twin warp_mma computes mma.sync's
// product from its documented fragment layouts, so the twin runs the same
// operands, state feedback, walk, folds and finish.  The variants measured
// against this design (0/1 operands, byte-table advances, other rings, one
// CTA an SM) are built only by testing/mma_layouts.py.
#include "snappy_common.cuh"

#ifdef __CUDA_ARCH__
#define STPU_UNROLL _Pragma("unroll")
#else
#define STPU_UNROLL
#endif

namespace stpu {

constexpr uint32_t kMmaChunk = 65536;
constexpr uint32_t kMmaWarps = 8;                      // warps of a CTA: the units of a chunk
constexpr uint32_t kMmaUnit = kMmaChunk / kMmaWarps;   // 8 KiB, a warp's
constexpr uint32_t kMmaStripe = kMmaUnit / 16;         // 512 bytes, an mma row's
constexpr uint32_t kMmaStep = 32;                      // bytes of a stripe a step
constexpr uint32_t kMmaSteps = kMmaStripe / kMmaStep;  // 16
constexpr uint32_t kMmaKSteps = 9;                     // bit planes 0 .. 7, then the state
constexpr uint32_t kMmaSlot = 16 * kMmaStep;           // a step of a warp's 16 stripes
constexpr int kMmaTwinGrid = 3;                        // the twin's CTAs
// The constants (crc32c_mma.consts()), in words: the B fragments
// [k-step][lane][n-tile][2], the advance tables of levels 5 and 9 .. 15
// [8][4][256], the 17 inverse shift matrices [17][32] and the init term.
// The card reads them through the read-only cache.
constexpr uint32_t kFragWords = kMmaKSteps * 32 * 8;
constexpr uint32_t kAdvOff = kFragWords;
constexpr uint32_t kInvOff = kAdvOff + 8 * 1024;
constexpr uint32_t kInitOff = kInvOff + 17 * 32;
constexpr uint32_t kMmaConstWords = kInitOff + 1;

// The advance table of level j (2^j bytes): 5, or 9 .. 15.
STPU_HD const uint32_t* adv_level(const uint32_t* adv, uint32_t j) {
  return adv + 1024u * (j == 5 ? 0 : j - 8);
}

// v advanced across 2^j zero bytes by that level's 4 x 256 table a.
STPU_HD uint32_t adv_bytes(const uint32_t* a, uint32_t v) {
  return a[v & 0xFFu] ^ a[256u + ((v >> 8) & 0xFFu)] ^ a[512u + ((v >> 16) & 0xFFu)] ^
         a[768u + (v >> 24)];
}

// Byte i of the result is byte (s >> 4i) & 7 of y:x (__byte_perm).
STPU_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const uint64_t v = x | (uint64_t)y << 32;
  uint32_t r = 0;
  for (uint32_t i = 0; i < 4; ++i) r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
#endif
}

// A thread's fragments.  MmaData: a step's 16 bytes or an A operand, in the
// order of mma.sync's a0 .. a3 (words 0 / 2: bytes 8t .. 8t + 3 / 8t + 4 ..
// 8t + 7 of row g's block; 1 / 3: the same of row g + 8).  MmaB: the
// weights [k-step][n-tile][b0, b1].  MmaAcc: the accumulators
// [n-tile][c0 .. c3].
struct MmaData {
  uint32_t w[4];
};
struct MmaB {
  uint32_t b[kMmaKSteps][4][2];
};
struct MmaAcc {
  int32_t c[4][4];
};

// cp.async of the 16 bytes at src (global, 16-byte aligned) to dst
// (shared); the twin copies at once.
STPU_HD void copy16_async(uint8_t* dst, const uint8_t* src) {
#ifdef __CUDA_ARCH__
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

STPU_HD void stage_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most kPending of this thread's groups are in flight, then
// for the warp's lanes.
template <int kPending>
STPU_HD void stage_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
  __syncwarp();
#endif
}

// Step s of the unit into a slot of shared memory: lane l copies 16 bytes
// of stripe l / 2 (half l % 2 of its block) to the slot's row l / 2.
STPU_HD void stage_step(const uint8_t* unit, uint32_t s, uint8_t* slot) {
  STPU_LANES(l) {
    const uint32_t row = l >> 1, half = 16 * (l & 1);
    copy16_async(slot + kMmaStep * row + half, unit + kMmaStripe * row + kMmaStep * s + half);
  }
}

// Lane (g, t)'s words of a staged step: bytes 8t .. 8t + 7 of rows g and
// g + 8.
STPU_HD void read_step(const uint8_t* slot, Lanes<MmaData>& d) {
  STPU_LANES(l) {
    const uint8_t* p = slot + kMmaStep * (l >> 2) + 8 * (l & 3);
    STPU_UNROLL
    for (uint32_t h = 0; h < 2; ++h) {
#ifdef __CUDA_ARCH__
      const uint2 q = *reinterpret_cast<const uint2*>(p + 8 * kMmaStep * h);
      d[l].w[h] = q.x, d[l].w[2 + h] = q.y;
#else
      memcpy(&d[l].w[h], p + 8 * kMmaStep * h, 4);
      memcpy(&d[l].w[2 + h], p + 8 * kMmaStep * h + 4, 4);
#endif
    }
  }
}

// Where a warp's next kMmaAhead steps wait: kMmaSlots slots of the warp's
// shared memory (`stage`), filled by cp.async, so that no register waits on
// a load in flight; the last steps of a unit take the first of the warp's
// next unit.  kMmaCtas: the CTAs an SM of the kernel's launch bounds.
constexpr uint32_t kMmaAhead = 3;
constexpr uint32_t kMmaSlots = kMmaAhead + 1;
constexpr uint32_t kMmaStageBytes = kMmaSlots * kMmaSlot;
constexpr int kMmaCtas = 2;
static_assert(kMmaSteps % kMmaSlots == 0, "a unit's steps fill whole rings");

// Start the loads of a unit's first kMmaAhead steps, one group a step.
STPU_HD void ring_prime(const uint8_t* unit, uint8_t* stage) {
  STPU_UNROLL
  for (uint32_t s = 0; s < kMmaAhead; ++s) {
    stage_step(unit, s, stage + kMmaSlot * s);
    stage_commit();
  }
}

// Step s's words, once its group is complete (at most kMmaAhead - 1 newer);
// its slot's refill with step s + kMmaAhead (of `next` past this unit;
// nothing where next is null) goes out first.  The wait's warp barrier also
// ends every lane's read of the slot of step s - 1, which the refill takes.
STPU_HD Lanes<MmaData> ring_take(uint32_t s, const uint8_t* unit, const uint8_t* next,
                                 uint8_t* stage) {
  stage_wait<kMmaAhead - 1>();
  uint8_t* spare = stage + kMmaSlot * ((s + kMmaAhead) % kMmaSlots);
  if (s + kMmaAhead < kMmaSteps)
    stage_step(unit, s + kMmaAhead, spare);
  else if (next)
    stage_step(next, s + kMmaAhead - kMmaSteps, spare);
  stage_commit();
  Lanes<MmaData> d;
  read_step(stage + kMmaSlot * (s % kMmaSlots), d);
  return d;
}

#ifdef __CUDACC__
__device__ __forceinline__ void mma_u8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1, int32_t c0, int32_t c1, int32_t c2,
                                       int32_t c3) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3));
}
#endif

#ifdef __CUDA_ARCH__
__device__ __forceinline__ uint32_t warp_xor(const Lanes<uint32_t>& x) {
  return __reduce_xor_sync(kAll, x.v);
}
#else
inline uint32_t warp_xor(const Lanes<uint32_t>& x) {
  uint32_t r = 0;
  for (uint32_t l = 0; l < 32; ++l) r ^= x[l];
  return r;
}
#endif

// acc[nt] <- a . B(k-step kk, n-tile nt) + (zero ? 0 : acc[nt]) over the
// warp: mma.sync m16n8k32 .row.col u8.u8.s32, in which thread (g, t) =
// (lane / 4, lane % 4) holds A[g][4t + i] (byte i of a0), A[g + 8][4t + i]
// (a1), A[g][16 + 4t + i] (a2), A[g + 8][16 + 4t + i] (a3), B[4t + i][g]
// (b0), B[16 + 4t + i][g] (b1), and D[g][2t + j] (c0, c1), D[g + 8][2t +
// j] (c2, c3).  The twin computes the same product from those layouts.
STPU_HD void warp_mma(Lanes<MmaAcc>& acc, uint32_t nt, const Lanes<MmaData>& a,
                      const Lanes<MmaB>& B, uint32_t kk, bool zero) {
#ifdef __CUDA_ARCH__
  int32_t(&c)[4] = acc.v.c[nt];
  if (zero)
    mma_u8(c, a.v.w, B.v.b[kk][nt][0], B.v.b[kk][nt][1], 0, 0, 0, 0);
  else
    mma_u8(c, a.v.w, B.v.b[kk][nt][0], B.v.b[kk][nt][1], c[0], c[1], c[2], c[3]);
#else
  int32_t A[16][32], Bm[32][8];
  for (uint32_t l = 0; l < 32; ++l) {
    const uint32_t g = l >> 2, t = l & 3;
    for (uint32_t i = 0; i < 4; ++i) {
      A[g][4 * t + i] = (a[l].w[0] >> (8 * i)) & 0xFF;
      A[g + 8][4 * t + i] = (a[l].w[1] >> (8 * i)) & 0xFF;
      A[g][16 + 4 * t + i] = (a[l].w[2] >> (8 * i)) & 0xFF;
      A[g + 8][16 + 4 * t + i] = (a[l].w[3] >> (8 * i)) & 0xFF;
      Bm[4 * t + i][g] = (B[l].b[kk][nt][0] >> (8 * i)) & 0xFF;
      Bm[16 + 4 * t + i][g] = (B[l].b[kk][nt][1] >> (8 * i)) & 0xFF;
    }
  }
  for (uint32_t l = 0; l < 32; ++l) {
    const uint32_t g = l >> 2, t = l & 3;
    for (uint32_t h = 0; h < 2; ++h)
      for (uint32_t j = 0; j < 2; ++j) {
        int32_t s = zero ? 0 : acc[l].c[nt][2 * h + j];
        for (uint32_t k = 0; k < 32; ++k) s += A[g + 8 * h][k] * Bm[k][2 * t + j];
        acc[l].c[nt][2 * h + j] = s;
      }
  }
#endif
}

// k-step kk's operand of a step's words: bit kk of each byte, as 2^kk.
STPU_HD MmaData bit_plane(const MmaData& d, uint32_t kk) {
  MmaData a;
  STPU_UNROLL
  for (uint32_t r = 0; r < 4; ++r) a.w[r] = d.w[r] & (0x01010101u << kk);
  return a;
}

// The 9th k-step's operand from the accumulators of the step before: byte
// 0 of each (128 . parity, whose low 7 bits are 0).  Slot 4t + i of a0 /
// a1 is column 8 (i / 2) + 2t + i % 2 of row g / g + 8 (c0, c1 of n-tiles 0
// and 1), slot 16 + 4t + i of a2 / a3 column 16 + the same (n-tiles 2 and
// 3).
STPU_HD MmaData state_operand(const MmaAcc& c) {
  MmaData s;
  STPU_UNROLL
  for (uint32_t h = 0; h < 2; ++h)
    STPU_UNROLL
    for (uint32_t r = 0; r < 2; ++r) {
      const uint32_t x =
          byte_perm((uint32_t)c.c[2 * h][2 * r], (uint32_t)c.c[2 * h][2 * r + 1], 0x0040u);
      const uint32_t y =
          byte_perm((uint32_t)c.c[2 * h + 1][2 * r], (uint32_t)c.c[2 * h + 1][2 * r + 1], 0x0040u);
      s.w[2 * h + r] = byte_perm(x, y, 0x5410u);
    }
  return s;
}

// One step of the warp's 16 stripes: the 8 bit planes of its 32 bytes,
// the first from a zero C, then (after the first step) the stripes'
// registers so far against M32.
STPU_HD void mma_step(Lanes<MmaAcc>& acc, const Lanes<MmaData>& d, const Lanes<MmaB>& B,
                      bool first) {
  Lanes<MmaData> s;
  if (!first) {
    STPU_LANES(l) { s[l] = state_operand(acc[l]); }
  }
  STPU_UNROLL
  for (uint32_t kk = 0; kk < 8; ++kk) {
    Lanes<MmaData> a;
    STPU_LANES(l) { a[l] = bit_plane(d[l], kk); }
    STPU_UNROLL
    for (uint32_t nt = 0; nt < 4; ++nt) warp_mma(acc, nt, a, B, kk, kk == 0);
  }
  if (!first) {
    STPU_UNROLL
    for (uint32_t nt = 0; nt < 4; ++nt) warp_mma(acc, nt, s, B, 8, false);
  }
}

// The registers of stripes g and g + 8 (lo, hi) in every lane of quad g:
// lane (g, t)'s accumulators hold columns 8 nt + 2t + {0, 1} of both, each
// bit the parity in bit 7; two OR-shuffles.
STPU_HD void stripe_registers(const Lanes<MmaAcc>& acc, Lanes<uint32_t>& lo,
                              Lanes<uint32_t>& hi) {
  STPU_LANES(l) {
    uint32_t rl = 0, rh = 0;
    STPU_UNROLL
    for (uint32_t nt = 0; nt < 4; ++nt) {
      const uint32_t col = 8 * nt + 2 * (l & 3);
      const int32_t* c = acc[l].c[nt];
      rl |= (((uint32_t)c[0] >> 7) & 1) << col | (((uint32_t)c[1] >> 7) & 1) << (col + 1);
      rh |= (((uint32_t)c[2] >> 7) & 1) << col | (((uint32_t)c[3] >> 7) & 1) << (col + 1);
    }
    lo[l] = rl;
    hi[l] = rh;
  }
  for (uint32_t m = 1; m < 4; m <<= 1) {
    Lanes<uint32_t> src;
    STPU_LANES(l) { src[l] = l ^ m; }
    const Lanes<uint32_t> ol = warp_shfl(lo, src), oh = warp_shfl(hi, src);
    STPU_LANES(l) {
      lo[l] |= ol[l];
      hi[l] |= oh[l];
    }
  }
}

// The register of the warp's 8 KiB from its stripes' registers: stripes g
// and g + 8 (4 KiB apart) in quad g, then the 8 quads in a tree of 512 B,
// 1 KiB and 2 KiB.
STPU_HD uint32_t fold_unit(const Lanes<uint32_t>& lo, const Lanes<uint32_t>& hi,
                           const uint32_t* adv) {
  Lanes<uint32_t> v;
  STPU_LANES(l) { v[l] = adv_bytes(adv_level(adv, 12), lo[l]) ^ hi[l]; }
  for (uint32_t q = 0; q < 3; ++q) {
    Lanes<uint32_t> src;
    STPU_LANES(l) { src[l] = l + (4u << q); }
    const Lanes<uint32_t> right = warp_shfl(v, src);
    STPU_LANES(l) {
      if (((l >> 2) & ((2u << q) - 1)) == 0) v[l] = adv_bytes(adv_level(adv, 9 + q), v[l]) ^ right[l];
    }
  }
  return warp_bcast(v, 0);
}

// The register of the warp's unit (8 KiB at `unit`), 16 steps, their
// words taken from the warp's ring (ring_take).
STPU_HD uint32_t walk_unit(uint8_t* stage, const uint8_t* unit, const uint8_t* next,
                           const Lanes<MmaB>& B, const uint32_t* adv) {
  Lanes<MmaAcc> acc;
  STPU_UNROLL
  for (uint32_t s = 0; s < kMmaSteps; ++s) mma_step(acc, ring_take(s, unit, next, stage), B, s == 0);
  Lanes<uint32_t> lo, hi;
  stripe_registers(acc, lo, hi);
  return fold_unit(lo, hi, adv);
}

// A thread's B fragments, read once: words 8 (32 kk + l) .. + 7 of the
// constants are lane l's [n-tile][b0, b1] of k-step kk.
STPU_HD void load_weights(Lanes<MmaB>& B, const uint32_t* consts) {
  STPU_LANES(l) {
    STPU_UNROLL
    for (uint32_t kk = 0; kk < kMmaKSteps; ++kk) {
#ifdef __CUDA_ARCH__
      const uint4* f = reinterpret_cast<const uint4*>(consts) + 2 * (kk * 32 + l);
      const uint4 q0 = __ldg(f), q1 = __ldg(f + 1);
      const uint32_t words[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#else
      const uint32_t* words = consts + 8 * (kk * 32 + l);
#endif
      STPU_UNROLL
      for (uint32_t i = 0; i < 8; ++i) B[l].b[kk][i / 2][i % 2] = words[i];
    }
  }
}

// The masked CRC of a chunk of `length` bytes from its warps' registers
// (earliest first): a tree of 8, 16 and 32 KiB, the init term, the zero
// tail cancelled one inverse matrix at a time (lane i takes column i, then
// an XOR over the warp), the final xor and snappy's mask.
STPU_HD uint32_t chunk_crc(const uint32_t* unit_regs, uint32_t length, const uint32_t* adv,
                           const uint32_t* inv, uint32_t init) {
  Lanes<uint32_t> v;
  STPU_LANES(l) { v[l] = l < kMmaWarps ? unit_regs[l] : 0; }
  for (uint32_t q = 0; q < 3; ++q) {
    Lanes<uint32_t> src;
    STPU_LANES(l) { src[l] = l + (1u << q); }
    const Lanes<uint32_t> right = warp_shfl(v, src);
    STPU_LANES(l) {
      if ((l & ((2u << q) - 1)) == 0) v[l] = adv_bytes(adv_level(adv, 13 + q), v[l]) ^ right[l];
    }
  }
  uint32_t reg = warp_bcast(v, 0) ^ init;
  const uint32_t pad = kMmaChunk - length;
  for (uint32_t j = 0; j < 17; ++j) {
    if (((pad >> j) & 1) == 0) continue;
    Lanes<uint32_t> term;
    STPU_LANES(l) { term[l] = ((reg >> l) & 1) ? inv[32 * j + l] : 0; }
    reg = warp_xor(term);
  }
  reg ^= 0xFFFFFFFFu;
  return ((reg >> 15) | (reg << 17)) + 0xA282EAD8u;
}

}  // namespace stpu

// Shared bytes of a CTA: the warps' registers by turns, then the warps'
// slots.
constexpr size_t kMmaSmemBytes = 4 * 2 * stpu::kMmaWarps + (size_t)stpu::kMmaWarps * stpu::kMmaStageBytes;

// Constants of the design, in both builds, for the tests and the
// measurement scripts: params = {chunk bytes, warps of a CTA, stripe bytes,
// steps loaded ahead, shared bytes of a CTA, CTAs per SM (the card's
// build; 0 in the twin's), words of the constants}.
STPU_EXPORT void stpu_crc32c_mma_params(int64_t* params);

#ifdef __CUDACC__

namespace {

constexpr uint32_t kMmaThreads = 32 * stpu::kMmaWarps;

// One CTA of 8 warps walks chunks blockIdx.x, + gridDim.x, ...; warp w
// takes each one's w-th 8 KiB, and after the barrier one warp in turn folds
// the chunk's 8 registers and writes its CRC.  The first chunk's first
// steps are requested before the weights are loaded.
__global__ void __launch_bounds__(kMmaThreads, stpu::kMmaCtas)
    crc32c_mma_kernel(const uint8_t* __restrict__ chunks, const int32_t* __restrict__ lengths,
                      int n, const uint32_t* __restrict__ consts, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* unit_regs = smem;  // [2][warps], by turns from chunk to chunk
  const uint32_t tid = threadIdx.x, w = tid / 32;
  uint8_t* stage = reinterpret_cast<uint8_t*>(smem + 2 * stpu::kMmaWarps) + stpu::kMmaStageBytes * w;
  const uint8_t* base = chunks + (size_t)stpu::kMmaUnit * w;
  stpu::ring_prime(base + (size_t)blockIdx.x * stpu::kMmaChunk, stage);
  stpu::Lanes<stpu::MmaB> B;
  stpu::load_weights(B, consts);
  const uint32_t* adv = consts + stpu::kAdvOff;
  const uint32_t* inv = consts + stpu::kInvOff;
  const uint32_t init = __ldg(consts + stpu::kInitOff);
  uint32_t turn = 0, folder = 0;
  for (int64_t c = blockIdx.x; c < n; c += gridDim.x) {
    const int64_t nc = c + gridDim.x;
    const uint8_t* next = nc < n ? base + nc * stpu::kMmaChunk : nullptr;
    const uint32_t reg = stpu::walk_unit(stage, base + c * stpu::kMmaChunk, next, B, adv);
    uint32_t* regs = unit_regs + stpu::kMmaWarps * turn;
    if (tid % 32 == 0) regs[w] = reg;
    __syncthreads();
    if (w == folder) {
      const uint32_t crc = stpu::chunk_crc(regs, (uint32_t)__ldg(lengths + c), adv, inv, init);
      if (tid % 32 == 0) out[c] = crc;
    }
    turn ^= 1;
    folder = (folder + 1) % stpu::kMmaWarps;
  }
}

// The kernel's shared-memory limit, set once; then its CTAs per SM.
int mma_ctas_per_sm() {
  static int blocks = -1;
  if (blocks >= 0) return blocks;
  cudaError_t err = cudaFuncSetAttribute(crc32c_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMmaSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, crc32c_mma_kernel, kMmaThreads,
                                                        kMmaSmemBytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

STPU_EXPORT void stpu_crc32c_mma_params(int64_t* params) {
  params[0] = stpu::kMmaChunk;
  params[1] = stpu::kMmaWarps;
  params[2] = stpu::kMmaStripe;
  params[3] = stpu::kMmaAhead;
  params[4] = (int64_t)kMmaSmemBytes;
  params[5] = mma_ctas_per_sm();
  params[6] = stpu::kMmaConstWords;
}

// chunks: uint8 [n, 65536], 16-byte aligned, zero past each length;
// lengths: int32 [n] in [0, 65536]; consts: uint32 [kMmaConstWords]
// (crc32c_mma.consts()); out: uint32 [n] masked CRCs.  Launches on
// `stream` on CTAs per SM x SMs CTAs, at most one a chunk; returns
// cudaGetLastError().
STPU_EXPORT int stpu_crc32c_mma(const uint8_t* chunks, const int32_t* lengths, int n,
                                const uint32_t* consts, uint32_t* out, void* stream) {
  constexpr int kDevices = 64;
  static int sms_of[kDevices];
  if (n <= 0) return 0;
  const int per_sm = mma_ctas_per_sm();
  if (per_sm < 0) return -per_sm;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int& sms = sms_of[dev % kDevices];
  if (sms == 0 && (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)err;
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (grid > n) grid = n;
  crc32c_mma_kernel<<<(unsigned)grid, kMmaThreads, kMmaSmemBytes, (cudaStream_t)stream>>>(
      chunks, lengths, n, consts, out);
  return (int)cudaGetLastError();
}

#else  // CPU twin: the CTAs in turn, each one's warps in turn on every chunk

#include <vector>

STPU_EXPORT void stpu_crc32c_mma_params(int64_t* params) {
  params[0] = stpu::kMmaChunk;
  params[1] = stpu::kMmaWarps;
  params[2] = stpu::kMmaStripe;
  params[3] = stpu::kMmaAhead;
  params[4] = (int64_t)kMmaSmemBytes;
  params[5] = 0;
  params[6] = stpu::kMmaConstWords;
}

// On kMmaTwinGrid CTAs (at most one a chunk), each owning chunks b, b +
// grid, ...: a warp's loads of its next chunk go out from the end of the
// one before.
STPU_EXPORT int stpu_twin_crc32c_mma(const uint8_t* chunks, const int32_t* lengths, int n,
                                     const uint32_t* consts, uint32_t* out) {
  if (n <= 0) return 0;
  const int grid = n < stpu::kMmaTwinGrid ? n : stpu::kMmaTwinGrid;
  std::vector<stpu::Lanes<stpu::MmaB>> B(1);
  stpu::load_weights(B[0], consts);
  const uint32_t* adv = consts + stpu::kAdvOff;
  const uint32_t* inv = consts + stpu::kInvOff;
  std::vector<uint8_t> stages(stpu::kMmaWarps * stpu::kMmaStageBytes);
  for (int b = 0; b < grid; ++b) {
    for (uint32_t w = 0; w < stpu::kMmaWarps; ++w)
      stpu::ring_prime(chunks + (size_t)b * stpu::kMmaChunk + stpu::kMmaUnit * w,
                       stages.data() + stpu::kMmaStageBytes * w);
    for (int64_t c = b; c < n; c += grid) {
      uint32_t unit_regs[stpu::kMmaWarps];
      const int64_t nc = c + grid;
      for (uint32_t w = 0; w < stpu::kMmaWarps; ++w) {
        const uint8_t* unit = chunks + c * stpu::kMmaChunk + stpu::kMmaUnit * w;
        const uint8_t* next = nc < n ? chunks + nc * stpu::kMmaChunk + stpu::kMmaUnit * w : nullptr;
        unit_regs[w] = stpu::walk_unit(stages.data() + stpu::kMmaStageBytes * w, unit, next, B[0], adv);
      }
      out[c] = stpu::chunk_crc(unit_regs, (uint32_t)lengths[c], adv, inv, consts[stpu::kInitOff]);
    }
  }
  return 0;
}

#endif
