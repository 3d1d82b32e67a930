"""Measure the GF(2) tensor-core CRC kernel (K6) on one CUDA card: the
package's kernel and its variants at the main-path shape, with registers,
shared memory and CTAs per SM, and the rate and latency of mma.sync on the
card.

    python -m snappy_tpu_torch.testing.mma_layouts [--reps N]
    python snappy_tpu_torch/testing/mma_layouts.py --tree DIR [--reps N]

The variants (``MMA_VARIANTS`` in ``_VARIANTS`` below; id 0 is the
package's kernel, ``ops/csrc/crc32c_mma.cu``): ``scaled`` (u8 bit-plane
operands, one instruction a register, against weights scaled by
2^(7 - kk)) or ``bits`` (0/1 operands, two instructions, 0/1 weights);
``horner`` (the register so far as a 9th k-step) or ``tables`` (8
k-steps, then each stripe's register advanced across 32 bytes by byte
tables); ``smem``N (the next N steps in the warp's shared memory by
``cp.async``) or ``reg``N (in registers); and the CTAs an SM of the launch
bounds (2: at most 128 registers a thread).  The package's kernel is also
timed at 1, 2 and 3 chunks a CTA (its fixed cost and its cost a round of
chunks).  This script builds one scratch source under
``build/snappy_tpu_torch/`` that includes ``ops/csrc/crc32c_mma.cu``
unchanged, builds the variants from its parts with their template
arguments opened up, and adds the probe kernels: a loop of independent
``mma.sync`` u8 m16n8k32 products on registers (8 chains a warp, at 16 and
at 32 warps an SM; the weights shared, one B a chain, or one A and one B a
chain), the same loop with k = 0, 2, 4 or 8 XORs on chains of their own
after each product (whether the SM dispatches other instructions while the
tensor core works), one dependent chain of products on one warp timed by
``clock64`` (cycles an mma), the same rate and chain for the binary
``m16n8k256 .and.popc`` product, and the rate of ``u4 m16n8k64`` (built
apart, as the toolkit may refuse it).  While the package's kernel runs for
about a second, ``nvidia-smi`` samples the SM clock and the power draw.

Inputs: the main path's 768 full 64 KiB blocks of the seeded 48 MiB
payload.  Every variant must give the host C CRCs
(``host_codec.masked_crc32c``); then its kernel time by CUDA events (the
mean of ``reps`` calls after a warm-up, in the order of the variants and
back), launched from Python (``ms``) and from one host loop in C
(``device_ms``), its registers (``-Xptxas -v``), shared bytes and CTAs per
SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and where the
toolkit has ``cuobjdump``, the count of each SASS opcode of the kernel.
Every line names the card, its power limit and its SM clock.  ``--tree
DIR`` instead times the K6 of the checkout DIR through its wrapper
(parent against change).  Needs CUDA; exits nonzero without it.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys

# The variants' walk, from the parts of ops/csrc/crc32c_mma.cu (host and
# device code: it builds in the CPU twin as well).
_VARIANTS = r"""
#include "crc32c_mma.cu"

namespace stpu {

// The 8 bytes at p (8-byte aligned) as 2 little-endian words.
STPU_HD void load8(const uint8_t* p, uint32_t& lo, uint32_t& hi) {
#ifdef __CUDA_ARCH__
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  lo = q.x, hi = q.y;
#else
  memcpy(&lo, p, 4);
  memcpy(&hi, p + 4, 4);
#endif
}

// Step s of the unit at `unit`: lane (g, t) takes bytes 8t .. 8t + 7 of
// the step's block of stripes g and g + 8.
STPU_HD void load_step(const uint8_t* unit, uint32_t s, Lanes<MmaData>& d) {
  STPU_LANES(l) {
    const uint8_t* p = unit + kMmaStripe * (l >> 2) + kMmaStep * s + 8 * (l & 3);
    load8(p, d[l].w[0], d[l].w[2]);
    load8(p + 8 * kMmaStripe, d[l].w[1], d[l].w[3]);
  }
}

#ifdef __CUDACC__
#define STPU_HD_MEMBER static __host__ __device__ __forceinline__
#else
#define STPU_HD_MEMBER static inline
#endif

// Where a warp's next kDepth steps wait (ring_prime / ring_take of
// crc32c_mma.cu): RegRing in registers, loaded straight from global memory;
// SmemRing in kSlots = kDepth + 1 slots of shared memory by cp.async
// (SmemRing<kMmaSlots> is the package's ring).
template <uint32_t kR>
struct RegRing {
  static_assert(kMmaSteps % kR == 0, "a unit's steps fill whole rings");
  static constexpr uint32_t kDepth = kR, kStageBytes = 0;
  struct State {
    Lanes<MmaData> d[kR];
  };
  STPU_HD_MEMBER void prime(State& st, const uint8_t* unit, uint8_t*) {
    STPU_UNROLL
    for (uint32_t s = 0; s < kR; ++s) load_step(unit, s, st.d[s]);
  }
  STPU_HD_MEMBER Lanes<MmaData> take(State& st, uint32_t s, const uint8_t* unit,
                                     const uint8_t* next, uint8_t*) {
    const Lanes<MmaData> d = st.d[s % kR];
    if (s + kR < kMmaSteps)
      load_step(unit, s + kR, st.d[s % kR]);
    else if (next)
      load_step(next, s + kR - kMmaSteps, st.d[s % kR]);
    return d;
  }
};

template <uint32_t kSlots>
struct SmemRing {
  static_assert(kMmaSteps % kSlots == 0, "a unit's steps fill whole rings");
  static constexpr uint32_t kDepth = kSlots - 1, kStageBytes = kSlots * kMmaSlot;
  struct State {};
  STPU_HD_MEMBER void prime(State&, const uint8_t* unit, uint8_t* stage) {
    STPU_UNROLL
    for (uint32_t s = 0; s < kDepth; ++s) {
      stage_step(unit, s, stage + kMmaSlot * s);
      stage_commit();
    }
  }
  STPU_HD_MEMBER Lanes<MmaData> take(State&, uint32_t s, const uint8_t* unit,
                                     const uint8_t* next, uint8_t* stage) {
    stage_wait<kDepth - 1>();
    uint8_t* spare = stage + kMmaSlot * ((s + kDepth) % kSlots);
    if (s + kDepth < kMmaSteps)
      stage_step(unit, s + kDepth, spare);
    else if (next)
      stage_step(next, s + kDepth - kMmaSteps, spare);
    stage_commit();
    Lanes<MmaData> d;
    read_step(stage + kMmaSlot * (s % kSlots), d);
    return d;
  }
};

// k-step kk's operand: bit kk of each byte as 2^kk (kScaled: bit_plane) or
// as 1, against 0/1 weights.
template <bool kScaled>
STPU_HD MmaData plane_of(const MmaData& d, uint32_t kk) {
  if (kScaled) return bit_plane(d, kk);
  MmaData a;
  STPU_UNROLL
  for (uint32_t r = 0; r < 4; ++r) a.w[r] = (d.w[r] >> kk) & 0x01010101u;
  return a;
}

// The 9th k-step's operand; with 0/1 weights the sums' low bytes, masked
// to their parity.
template <bool kScaled>
STPU_HD MmaData state_of(const MmaAcc& c) {
  MmaData s = state_operand(c);
  if (!kScaled) {
    STPU_UNROLL
    for (uint32_t r = 0; r < 4; ++r) s.w[r] &= 0x01010101u;
  }
  return s;
}

// mma_step, and with kHorner = false the 8 bit planes alone.
template <bool kScaled, bool kHorner>
STPU_HD void variant_step(Lanes<MmaAcc>& acc, const Lanes<MmaData>& d, const Lanes<MmaB>& B,
                          bool first) {
  const bool state = kHorner && !first;
  Lanes<MmaData> s;
  if (state) {
    STPU_LANES(l) { s[l] = state_of<kScaled>(acc[l]); }
  }
  STPU_UNROLL
  for (uint32_t kk = 0; kk < 8; ++kk) {
    Lanes<MmaData> a;
    STPU_LANES(l) { a[l] = plane_of<kScaled>(d[l], kk); }
    STPU_UNROLL
    for (uint32_t nt = 0; nt < 4; ++nt) warp_mma(acc, nt, a, B, kk, kk == 0);
  }
  if (state) {
    STPU_UNROLL
    for (uint32_t nt = 0; nt < 4; ++nt) warp_mma(acc, nt, s, B, 8, false);
  }
}

// walk_unit with the ring, the operands and the state opened up; with
// kHorner = false each stripe's register advances across 32 bytes by the
// level-5 byte table after every step.
template <bool kScaled, bool kHorner, class Ring>
STPU_HD uint32_t variant_walk(typename Ring::State& ring, uint8_t* stage, const uint8_t* unit,
                              const uint8_t* next, const Lanes<MmaB>& B, const uint32_t* adv) {
  static_assert(kScaled || kHorner, "the byte-table advances read the parity in bit 7");
  Lanes<MmaAcc> acc;
  Lanes<uint32_t> lo, hi;
  STPU_UNROLL
  for (uint32_t s = 0; s < kMmaSteps; ++s) {
    variant_step<kScaled, kHorner>(acc, Ring::take(ring, s, unit, next, stage), B, s == 0);
    if constexpr (!kHorner) {
      Lanes<uint32_t> plo, phi;
      stripe_registers(acc, plo, phi);
      const uint32_t* a32 = adv_level(adv, 5);
      STPU_LANES(l) {
        lo[l] = s == 0 ? plo[l] : adv_bytes(a32, lo[l]) ^ plo[l];
        hi[l] = s == 0 ? phi[l] : adv_bytes(a32, hi[l]) ^ phi[l];
      }
    }
  }
  if constexpr (kHorner) {
    if constexpr (!kScaled) {  // the parity from bit 0 to bit 7
      STPU_LANES(l) {
        for (uint32_t nt = 0; nt < 4; ++nt)
          for (uint32_t j = 0; j < 4; ++j) acc[l].c[nt][j] <<= 7;
      }
    }
    stripe_registers(acc, lo, hi);
  }
  return fold_unit(lo, hi, adv);
}

}  // namespace stpu

// The variants (id, kScaled, kHorner, ring, CTAs an SM) after id 0, the
// package's kernel (scaled, Horner, SmemRing<kMmaSlots>, kMmaCtas).
#define MMA_VARIANTS(X)                                             \
  X(1, true, true, stpu::RegRing<2>, 2)                             \
  X(2, true, true, stpu::SmemRing<8>, 1)                            \
  X(3, false, true, stpu::SmemRing<stpu::kMmaSlots>, stpu::kMmaCtas) \
  X(4, true, false, stpu::SmemRing<stpu::kMmaSlots>, stpu::kMmaCtas)

// Variant `id` as {scaled, horner, ring in shared memory, its depth, CTAs
// an SM}; returns -1 past the last.
STPU_EXPORT int stpu_mma_variant(int id, int64_t* info) {
  if (id == 0) {
    info[0] = 1, info[1] = 1, info[2] = 1, info[3] = stpu::kMmaAhead, info[4] = stpu::kMmaCtas;
    return 0;
  }
#define MMA_INFO(i, S, H, R, C)                                                   \
  if (id == i) {                                                                  \
    info[0] = S, info[1] = H, info[2] = R::kStageBytes > 0, info[3] = R::kDepth; \
    info[4] = C;                                                                  \
    return 0;                                                                     \
  }
  MMA_VARIANTS(MMA_INFO)
#undef MMA_INFO
  return -1;
}

// Shared bytes of a CTA with ring R: the warps' registers by turns, then
// the warps' slots.
template <class Ring>
constexpr size_t variant_smem_bytes() {
  return 4 * 2 * stpu::kMmaWarps + (size_t)stpu::kMmaWarps * Ring::kStageBytes;
}
"""

_SOURCE = _VARIANTS + r"""
namespace {

// crc32c_mma_kernel with the variant's walk and launch bounds.
template <bool kScaled, bool kHorner, class Ring, int kCtas>
__global__ void __launch_bounds__(kMmaThreads, kCtas)
    mma_variant_kernel(const uint8_t* __restrict__ chunks, const int32_t* __restrict__ lengths,
                       int n, const uint32_t* __restrict__ consts, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* unit_regs = smem;
  const uint32_t tid = threadIdx.x, w = tid / 32;
  uint8_t* stage = reinterpret_cast<uint8_t*>(smem + 2 * stpu::kMmaWarps) + Ring::kStageBytes * w;
  const uint8_t* base = chunks + (size_t)stpu::kMmaUnit * w;
  typename Ring::State ring;
  Ring::prime(ring, base + (size_t)blockIdx.x * stpu::kMmaChunk, stage);
  stpu::Lanes<stpu::MmaB> B;
  stpu::load_weights(B, consts);
  const uint32_t* adv = consts + stpu::kAdvOff;
  const uint32_t* inv = consts + stpu::kInvOff;
  const uint32_t init = __ldg(consts + stpu::kInitOff);
  uint32_t turn = 0, folder = 0;
  for (int64_t c = blockIdx.x; c < n; c += gridDim.x) {
    const int64_t nc = c + gridDim.x;
    const uint8_t* next = nc < n ? base + nc * stpu::kMmaChunk : nullptr;
    const uint32_t reg = stpu::variant_walk<kScaled, kHorner, Ring>(
        ring, stage, base + c * stpu::kMmaChunk, next, B, adv);
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

// The variant's shared-memory limit, set once; then its CTAs per SM.
template <bool kScaled, bool kHorner, class Ring, int kCtas>
int variant_ctas_per_sm() {
  static int blocks = -1;
  if (blocks >= 0) return blocks;
  const auto kernel = mma_variant_kernel<kScaled, kHorner, Ring, kCtas>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)variant_smem_bytes<Ring>());
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kMmaThreads,
                                                        variant_smem_bytes<Ring>());
  return err == cudaSuccess ? blocks : -(int)err;
}

// One launch on CTAs per SM x SMs CTAs, at most one a chunk.
template <bool kScaled, bool kHorner, class Ring, int kCtas>
int launch_variant(const uint8_t* chunks, const int32_t* lengths, int n, const uint32_t* consts,
                   uint32_t* out, cudaStream_t stream) {
  static int sms = 0;
  if (n <= 0) return 0;
  const int per_sm = variant_ctas_per_sm<kScaled, kHorner, Ring, kCtas>();
  if (per_sm < 0) return -per_sm;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && sms == 0)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (grid > n) grid = n;
  mma_variant_kernel<kScaled, kHorner, Ring, kCtas>
      <<<(unsigned)grid, kMmaThreads, variant_smem_bytes<Ring>(), stream>>>(chunks, lengths, n,
                                                                            consts, out);
  return (int)cudaGetLastError();
}


__device__ __forceinline__ void mma_b1(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kKind 0: u8 m16n8k32; 1: b1 m16n8k256 .and.popc; 2: u8 with a B of
// its own for each chain (as the kernel's weights); 3: u8 with an A and a B
// of its own for each chain.
template <int kKind>
__device__ __forceinline__ void probe_mma(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  if (kKind == 1)
    mma_b1(c, a, b0, b1);
  else
    stpu::mma_u8(c, a, b0, b1, c[0], c[1], c[2], c[3]);
}

// 8 independent chains a warp.
template <int kKind>
__global__ void mma_rate_kernel(int iters, int* sink) {
  const uint32_t x = threadIdx.x * 0x01010101u;
  uint32_t a[8][4], b[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j][0] = (x & 0x7F7F7F7Fu) ^ j, a[j][1] = x ^ 0x01020304u, a[j][2] = x | (1u + j);
    a[j][3] = x + 7u + j, b[j][0] = 0x01010101u ^ x ^ j, b[j][1] = 0x02020202u + x + j;
  }
  int32_t acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ja = kKind == 3 ? j : 0, jb = kKind >= 2 ? j : 0;
      probe_mma<kKind>(acc[j], a[ja], b[jb][0], b[jb][1]);
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] ^ acc[j][1] ^ acc[j][2] ^ acc[j][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// One warp, one chain: each product waits for the one before.
template <int kKind>
__global__ void mma_latency_kernel(int iters, long long* cycles, int* sink) {
  const uint32_t x = threadIdx.x * 0x01010101u;
  const uint32_t a[4] = {x & 0x7F7F7F7Fu, x ^ 0x01020304u, x | 1u, x + 7u};
  const uint32_t b0 = 0x01010101u ^ x, b1 = 0x02020202u + x;
  int32_t acc[4] = {};
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < iters; ++i) probe_mma<kKind>(acc, a, b0, b1);
  const long long t1 = clock64();
  sink[threadIdx.x] = acc[0] ^ acc[1] ^ acc[2] ^ acc[3];
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

// 8 independent u8 chains a warp, and after each product kAlu XORs on
// chains of their own: whether the SM dispatches them while the tensor core
// works on the products.
template <int kAlu>
__global__ void mma_alu_kernel(int iters, int* sink) {
  const uint32_t x = threadIdx.x * 0x01010101u;
  const uint32_t a[4] = {x & 0x7F7F7F7Fu, x ^ 0x01020304u, x | 1u, x + 7u};
  uint32_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = x ^ (0x9E3779B9u * (j + 1));
  int32_t acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      stpu::mma_u8(acc[j], a, 0x01010101u ^ x ^ j, 0x02020202u + x + j, acc[j][0], acc[j][1],
                   acc[j][2], acc[j][3]);
#pragma unroll
      for (int q = 0; q < kAlu; ++q)
        asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(v[(j + q) & 7])
                     : "r"(v[(j + q + 1) & 7]), "r"(x));
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] ^ acc[j][1] ^ acc[j][2] ^ acc[j][3] ^ v[j];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

STPU_EXPORT int stpu_mma_alu_rate(int alu, int blocks, int threads, int iters, int* sink,
                                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (alu) {
    case 0: mma_alu_kernel<0><<<blocks, threads, 0, st>>>(iters, sink); break;
    case 2: mma_alu_kernel<2><<<blocks, threads, 0, st>>>(iters, sink); break;
    case 4: mma_alu_kernel<4><<<blocks, threads, 0, st>>>(iters, sink); break;
    default: mma_alu_kernel<8><<<blocks, threads, 0, st>>>(iters, sink); break;
  }
  return (int)cudaGetLastError();
}

// reps launches of variant `id` (0: the package's entry point).
STPU_EXPORT int stpu_crc32c_mma_layout(const uint8_t* chunks, const int32_t* lengths, int n,
                                       const uint32_t* consts, uint32_t* out, int id, int reps,
                                       void* stream) {
  for (int k = 0; k < reps; ++k) {
    int rc = -1;
    if (id == 0) rc = stpu_crc32c_mma(chunks, lengths, n, consts, out, stream);
#define MMA_LAUNCH(i, S, H, R, C) \
    if (id == i) rc = launch_variant<S, H, R, C>(chunks, lengths, n, consts, out, (cudaStream_t)stream);
    MMA_VARIANTS(MMA_LAUNCH)
#undef MMA_LAUNCH
    if (rc) return rc;
  }
  return 0;
}

// {shared bytes of a CTA, CTAs per SM} of variant `id`.
STPU_EXPORT int stpu_crc32c_mma_layout_occupancy(int id, int64_t* res) {
  if (id == 0) {
    res[0] = (int64_t)kMmaSmemBytes;
    res[1] = mma_ctas_per_sm();
    return 0;
  }
#define MMA_OCC(i, S, H, R, C)                               \
  if (id == i) {                                             \
    res[0] = (int64_t)variant_smem_bytes<R>();               \
    res[1] = variant_ctas_per_sm<S, H, R, C>();              \
    return 0;                                                \
  }
  MMA_VARIANTS(MMA_OCC)
#undef MMA_OCC
  return -1;
}

STPU_EXPORT int stpu_mma_rate(int kind, int blocks, int threads, int iters, int* sink,
                              void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0: mma_rate_kernel<0><<<blocks, threads, 0, st>>>(iters, sink); break;
    case 1: mma_rate_kernel<1><<<blocks, threads, 0, st>>>(iters, sink); break;
    case 2: mma_rate_kernel<2><<<blocks, threads, 0, st>>>(iters, sink); break;
    default: mma_rate_kernel<3><<<blocks, threads, 0, st>>>(iters, sink); break;
  }
  return (int)cudaGetLastError();
}

STPU_EXPORT int stpu_mma_latency(int kind, int iters, long long* cycles, int* sink,
                                 void* stream) {
  if (kind == 0)
    mma_latency_kernel<0><<<1, 32, 0, (cudaStream_t)stream>>>(iters, cycles, sink);
  else
    mma_latency_kernel<1><<<1, 32, 0, (cudaStream_t)stream>>>(iters, cycles, sink);
  return (int)cudaGetLastError();
}
"""

# The u4 product, built apart: the toolkit may refuse it for sm_90a.
_U4_SOURCE = r"""
#include <stdint.h>
#include <cuda_runtime.h>

__global__ void mma_u4_rate_kernel(int iters, int* sink) {
  const uint32_t x = threadIdx.x * 0x01010101u;
  uint32_t b[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j][0] = 0x11111111u ^ x ^ j, b[j][1] = 0x22222222u + x + j;
  const uint32_t a[4] = {x & 0x77777777u, x ^ 0x01020304u, x | 1u, x + 7u};
  int32_t acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm("mma.sync.aligned.m16n8k64.row.col.s32.u4.u4.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[j][0]), "r"(b[j][1]));
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] ^ acc[j][1] ^ acc[j][2] ^ acc[j][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" __attribute__((visibility("default"))) int stpu_mma_u4_rate(
    int blocks, int threads, int iters, int* sink, void* stream) {
  mma_u4_rate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(iters, sink);
  return (int)cudaGetLastError();
}
"""

PEAK_INT8 = 1.979e15  # H100 SXM, dense int8 tensor-core peak (OP/s)


def variant_name(scaled, horner, smem, depth, ctas) -> str:
    return (f"{'scaled' if scaled else 'bits'}-{'horner' if horner else 'tables'}-"
            f"{'smem' if smem else 'reg'}{depth}-{ctas}cta")


def variants(lib) -> list:
    """The variants of a build of ``_SOURCE`` (or of ``_VARIANTS`` in the
    CPU twin), in their order, the package's first: per variant its id,
    flags and name."""
    import numpy as np

    fn = lib.stpu_mma_variant
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    found, info = [], np.zeros(5, dtype=np.int64)
    while fn(len(found), info.ctypes.data) == 0:
        flags = dict(zip(("scaled", "horner", "smem", "depth", "ctas"), (int(v) for v in info)))
        found.append({"id": len(found), **flags, "name": variant_name(**flags)})
    return found


PACKAGE = "package"  # the key of the package's kernel in registers() and sass_opcodes()
_VARIANT = re.compile(r"mma_variant_kernelILb([01])ELb([01])EN4stpu\d+(RegRing|SmemRing)ILj(\d+)EEELi(\d+)E")


def _kernel_variant(line: str):
    """``PACKAGE`` for the package's kernel, a variant's name for its
    kernel's mangled name (SmemRing's argument counts its slots: the steps
    ahead and the one being read), or None."""
    if "crc32c_mma_kernelE" in line:
        return PACKAGE
    m = _VARIANT.search(line)
    if not m:
        return None
    smem = m.group(3) == "SmemRing"
    return variant_name(m.group(1) == "1", m.group(2) == "1", smem, int(m.group(4)) - smem,
                        int(m.group(5)))


def registers(log: str) -> dict:
    """Registers per thread (and spill bytes) of the package's kernel
    (``PACKAGE``) and of each variant's in a build's ``-Xptxas -v`` lines,
    by name."""
    found, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            key = _kernel_variant(line)
        elif key and "bytes spill stores" in line:
            found.setdefault(key, {})["spill_bytes"] = int(line.split("bytes spill stores")[0].split()[-1])
        elif key and "Used" in line and "registers" in line:
            found.setdefault(key, {})["registers"] = int(line.split("Used", 1)[1].split("registers")[0])
            key = None
    return found


def bit_consts():
    """``crc32c_mma.consts()`` with 0/1 weights in k-steps 0 .. 7, for the
    0/1-operand variant: each weight byte 2^(7 - kk) . a shifted down to a."""
    from snappy_tpu_torch.ops import crc32c_mma

    out = crc32c_mma.consts().copy()
    frag = out[: crc32c_mma.MMA_K_STEPS * 32 * 8].reshape(crc32c_mma.MMA_K_STEPS, -1)
    for kk in range(8):
        frag[kk] >>= 7 - kk
    return out


def sass_opcodes(so, keep=None) -> dict:
    """Per variant, the count of each SASS opcode of its kernel, where the
    toolkit has cuobjdump (else empty); the listing is written to `keep`."""
    from snappy_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or str(_build.Path(_build._nvcc()).parent / "cuobjdump")
    try:
        text = subprocess.run([tool, "-sass", str(so)], check=True, capture_output=True,
                              text=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    if keep is not None:
        keep.write_text(text)
    found, key = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            key = _kernel_variant(line)
            if key:
                found[key] = collections.Counter()
        elif key:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[.\s;]", line)
            if m:
                found[key][m.group(1)] += 1
    return {k: dict(v) for k, v in found.items()}


def card_label() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def kernel_params(lib) -> dict:
    """The kernel's constants, as ``ops/csrc/crc32c_mma.cu`` defines them,
    read from a build of it (``_build.cuda_lib()``, ``_build.twin_lib()`` or
    a scratch build): the chunk's bytes, the warps of a CTA, a stripe's
    bytes, the steps loaded ahead, the shared bytes of a CTA, its CTAs per
    SM (0 in the twin) and the words of the constants."""
    import numpy as np

    fn = lib.stpu_crc32c_mma_params
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p]
    p = np.zeros(7, dtype=np.int64)
    fn(p.ctypes.data)
    keys = ("chunk", "warps", "stripe", "ring", "smem_bytes", "ctas_per_sm", "const_words")
    return dict(zip(keys, (int(v) for v in p)))


def _main_path_blocks(dev):
    import numpy as np
    import torch

    from snappy_tpu_torch.ops import host_codec
    from snappy_tpu_torch.testing import payloads

    nf = payloads.MAIN_PATH_FRAMES
    host = np.frombuffer(payloads.mixed_payload(), dtype=np.uint8)[: nf * 65536].reshape(nf, 65536)
    rows = torch.from_numpy(host.copy()).to(dev)
    lengths = torch.full((nf,), 65536, dtype=torch.int32, device=dev)
    want = torch.tensor([host_codec.masked_crc32c(r) for r in host], dtype=torch.int64)
    return rows, lengths, want.to(torch.int32)


def _event_ms(fn, reps: int) -> float:
    import torch

    fn(1)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(reps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(reps: int = 20) -> dict:
    """Build, check and time the variants, and probe mma.sync, printing each
    line.  Returns per variant its registers, spills, shared bytes, CTAs per
    SM, SASS opcode counts and times, and the probe's rates."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mma_layouts: torch.cuda is not available")
    from snappy_tpu_torch.ops import _build, crc32c_mma

    tag = f"[{card_label()}]"
    root = _build.BUILD_DIR / "mma_layouts"
    root.mkdir(parents=True, exist_ok=True)
    src = root / "mma_layouts.cu"
    src.write_text(_SOURCE)
    deps = [_build.CSRC / "crc32c_mma.cu", _build.CSRC / "snappy_common.cuh"]
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    cmd = [_build._nvcc(), *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           f"-I{_build.CSRC}"]
    so = _build._build("mma_layouts", cmd, [_build._nvcc(), *arch, "-shared"], [src], deps)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.stpu_crc32c_mma_layout.argtypes = [P, P, I, P, P, I, I, P]
    lib.stpu_crc32c_mma_layout_occupancy.argtypes = [I, P]
    lib.stpu_mma_rate.argtypes = [I, I, I, I, P, P]
    lib.stpu_mma_latency.argtypes = [I, I, P, P, P]
    regs = registers(so.with_suffix(".log").read_text())
    ops = sass_opcodes(so, root / "mma_layouts.sass")
    params = kernel_params(lib)
    found = variants(lib)
    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, lengths, want = _main_path_blocks(dev)
    n = rows.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    consts = {1: torch.from_numpy(crc32c_mma.consts()).to(dev),
              0: torch.from_numpy(bit_consts()).to(dev)}
    result = {"variants": {}, "params": params}

    def launcher(v):
        def run(k):
            rc = lib.stpu_crc32c_mma_layout(rows.data_ptr(), lengths.data_ptr(), n,
                                            consts[v["scaled"]].data_ptr(), out.data_ptr(),
                                            v["id"], k, stream)
            assert rc == 0, (v["name"], rc)
        return run

    def from_python(v):
        one = launcher(v)

        def run(k):
            for _ in range(k):
                one(1)
        return run

    got = crc32c_mma.masked_crc32c_chunks_fused(rows, lengths).cpu().view(torch.int32)
    assert torch.equal(got, want), "the package kernel against the host C CRC"
    occ = np.zeros(2, dtype=np.int64)
    for v in found:
        out.fill_(0)
        launcher(v)(1)
        assert torch.equal(out.cpu(), want), (v["name"], "against the host C CRC")
        assert lib.stpu_crc32c_mma_layout_occupancy(v["id"], occ.ctypes.data) == 0
        key = PACKAGE if v["id"] == 0 else v["name"]
        info = dict(regs.get(key, {}))
        info.update({"smem_bytes": int(occ[0]), "ctas_per_sm": int(occ[1]),
                     "sass": ops.get(key, {}), "ms": [], "device_ms": []})
        result["variants"][v["name"]] = info
        mix = {k: info["sass"].get(k, 0) for k in ("IMMA", "PRMT", "LOP3", "LDG", "LDGSTS", "LDS",
                                                    "SHFL", "BAR", "STL", "LDL")}
        print(f"variant {v['name']}: {info.get('registers')} registers, {info.get('spill_bytes')} "
              f"bytes spilled, {info['smem_bytes']} bytes of shared memory a CTA of "
              f"{32 * params['warps']} threads, {info['ctas_per_sm']} CTAs per SM; SASS {mix} {tag}")
    print(f"the package kernel and the variants give the host C CRCs on {n} x 64 KiB blocks {tag}")
    order = found + found[::-1]
    for v in order:
        result["variants"][v["name"]]["ms"].append(_event_ms(from_python(v), reps))
        result["variants"][v["name"]]["device_ms"].append(_event_ms(launcher(v), reps))
    for v in found:
        info = result["variants"][v["name"]]
        print(f"variant {v['name']}: {info['ms'][0]:.4f} / {info['ms'][1]:.4f} ms from Python, "
              f"{info['device_ms'][0]:.4f} / {info['device_ms'][1]:.4f} ms from C ({n} x 64 KiB, "
              f"mean of {reps}, the variants in order and back) {tag}")
    # the package's kernel on 1, 2 and 3 chunks a CTA (full chunks of the
    # payload, repeated): the fixed cost and the cost of a round of chunks
    per = params["ctas_per_sm"] * sms
    many = torch.cat([rows] * (1 + 3 * per // n))[: 3 * per].contiguous()
    many_len = torch.full((3 * per,), 65536, dtype=torch.int32, device=dev)
    many_out = torch.empty(3 * per, dtype=torch.int32, device=dev)
    by_rounds = {}
    for r in (1, 2, 3, 3, 2, 1):
        def run_rounds(k, r=r):
            assert lib.stpu_crc32c_mma_layout(many.data_ptr(), many_len.data_ptr(), r * per,
                                              consts[1].data_ptr(), many_out.data_ptr(), 0, k,
                                              stream) == 0
        by_rounds.setdefault(r, []).append(_event_ms(run_rounds, reps))
    mean = {r: sum(t) / len(t) for r, t in by_rounds.items()}
    slope = (mean[3] - mean[1]) / 2
    result["rounds_device_ms"] = by_rounds
    result["round_ms"], result["fixed_ms"] = slope, mean[1] - slope
    print(f"the package's kernel on {per} CTAs, 1 / 2 / 3 chunks each (from C): "
          + "; ".join(f"{r * per} chunks {t[0]:.4f} / {t[1]:.4f} ms" for r, t in by_rounds.items())
          + f"; a round {slope:.4f} ms, fixed {mean[1] - slope:.4f} ms {tag}")

    # mma.sync on the card
    sink = torch.empty(4 * sms * 256, dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    probe = {}
    iters = 8192
    for kind, what, ops_per in ((0, "u8 m16n8k32", 2 * 16 * 8 * 32),
                                (2, "u8 m16n8k32, a B of its own a chain", 2 * 16 * 8 * 32),
                                (3, "u8 m16n8k32, an A and a B of its own a chain", 2 * 16 * 8 * 32),
                                (1, "b1 m16n8k256 .and.popc", 2 * 16 * 8 * 256)):
        rates = {}
        for per_sm in (2, 4):  # CTAs of 8 warps an SM
            def run(k, kind=kind, per_sm=per_sm):
                for _ in range(k):
                    assert lib.stpu_mma_rate(kind, per_sm * sms, 256, iters, sink.data_ptr(),
                                             stream) == 0
            ms = _event_ms(run, 3)
            mmas = per_sm * sms * 8 * 8 * iters
            rates[8 * per_sm] = mmas * ops_per / (ms * 1e-3)
        entry = {"ops_per_s": rates, "ns_per_mma_smsp": 4 * sms * ops_per / rates[16] * 1e9}
        line = ""
        if kind in (0, 1):
            assert lib.stpu_mma_latency(kind, iters, cycles.data_ptr(), sink.data_ptr(), stream) == 0
            torch.cuda.synchronize()
            entry["latency_cycles"] = int(cycles.item()) / iters
            line = f"; one dependent chain: {entry['latency_cycles']:.1f} cycles an mma"
        probe[what] = entry
        share = "" if kind == 1 else f" ({rates[16] / PEAK_INT8:.1%} / {rates[32] / PEAK_INT8:.1%} of the 1,979 TOP/s int8 peak)"
        print(f"mma.sync {what}: {rates[16] / 1e12:.1f} T op/s at 16 warps an SM, "
              f"{rates[32] / 1e12:.1f} at 32{share}, 8 independent chains a warp, "
              f"{entry['ns_per_mma_smsp']:.3f} ns an mma on each of the 4 tensor cores of an "
              f"SM{line} {tag}")
    lib.stpu_mma_alu_rate.argtypes = [I, I, I, I, P, P]
    alu_ns = {}
    for alu in (0, 2, 4, 8):
        def run_alu(k, alu=alu):
            for _ in range(k):
                assert lib.stpu_mma_alu_rate(alu, 2 * sms, 256, iters, sink.data_ptr(), stream) == 0
        ms = _event_ms(run_alu, 3)
        alu_ns[alu] = ms * 1e6 / (2 * sms * 8 * 8 * iters / (4 * sms))
    probe["u8 m16n8k32 with XORs between"] = {"ns_per_mma_smsp": alu_ns}
    print("mma.sync u8 m16n8k32 with k XORs on chains of their own after each product, 16 warps "
          "an SM: " + ", ".join(f"k = {k}: {t:.3f} ns an mma" for k, t in alu_ns.items())
          + f" on each of the 4 tensor cores of an SM {tag}")
    # u4 m16n8k64 (a B of its own a chain), where the toolkit builds it
    src4 = root / "mma_u4.cu"
    src4.write_text(_U4_SOURCE)
    try:
        so4 = _build._build("mma_u4", cmd, [_build._nvcc(), *arch, "-shared"], [src4])
    except RuntimeError as e:
        probe["u4 m16n8k64"] = {"error": str(e)[-400:]}
        print(f"mma.sync u4 m16n8k64: did not build: {str(e)[-400:]!r} {tag}")
    else:
        lib4 = ctypes.CDLL(str(so4))
        lib4.stpu_mma_u4_rate.argtypes = [I, I, I, P, P]

        def run4(k):
            for _ in range(k):
                assert lib4.stpu_mma_u4_rate(2 * sms, 256, iters, sink.data_ptr(), stream) == 0
        ms = _event_ms(run4, 3)
        rate = 2 * sms * 8 * 8 * iters * (2 * 16 * 8 * 64) / (ms * 1e-3)
        probe["u4 m16n8k64"] = {"ops_per_s": {16: rate},
                                "ns_per_mma_smsp": 4 * sms * 2 * 16 * 8 * 64 / rate * 1e9}
        print(f"mma.sync u4 m16n8k64, a B of its own a chain: {rate / 1e12:.1f} T op/s at 16 warps "
              f"an SM, {probe['u4 m16n8k64']['ns_per_mma_smsp']:.3f} ns an mma on each of the 4 "
              f"tensor cores of an SM {tag}")
    # the SM clock and power, sampled every 50 ms while the package's
    # kernel runs for about a second (launches from one C loop)
    launcher(found[0])(1)
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader",
                            "--loop-ms=50"], stdout=subprocess.PIPE, text=True)
    launcher(found[0])(30000)
    torch.cuda.synchronize()
    smi.terminate()
    samples = [line.strip() for line in smi.communicate()[0].splitlines() if line.strip()]
    result["busy_samples"] = samples
    print(f"clocks.sm, power.draw every 50 ms while the package's kernel runs: {samples} {tag}")
    result["mma_probe"] = probe
    return result


def time_tree(reps: int = 20) -> dict:
    """The K6 of the checkout first on sys.path (``--tree``), through its
    wrapper's ``_launch``, on the main path's 768 x 64 KiB blocks: checked
    against the host C CRC, then the mean of ``reps`` calls after a
    warm-up, twice.  Parent against change: run it once with each tree."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mma_layouts: torch.cuda is not available")
    from snappy_tpu_torch.ops import crc32c_mma

    dev = torch.device("cuda:0")
    rows, lengths, want = _main_path_blocks(dev)
    out = torch.empty(rows.shape[0], dtype=torch.uint32, device=dev)
    crc32c_mma._launch(rows, lengths, out)
    assert torch.equal(out.cpu().view(torch.int32), want), "K6 against the host C CRC"

    def run(k):
        for _ in range(k):
            crc32c_mma._launch(rows, lengths, out)

    times = [_event_ms(run, reps) for _ in range(2)]
    print(f"K6 of {crc32c_mma.__file__}: {times[0]:.4f} / {times[1]:.4f} ms ({rows.shape[0]} x "
          f"64 KiB, mean of {reps}) [{card_label()}]")
    return {"ms": times}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--tree", default=None, help="time the K6 of the package in this checkout instead")
    args = p.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
        print(json.dumps({"mma_tree": time_tree(args.reps)}))
        return
    print(json.dumps({"mma_layouts": measure(args.reps)}))


if __name__ == "__main__":
    main()
