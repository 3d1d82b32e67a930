// Masked CRC32C as GF(2) products on the int8 tensor cores (K6): the
// kernel behind snappy_tpu_torch.ops.crc32c_mma.masked_crc32c_chunks_fused.
//
// Replaces the TPU kernel snappy_tpu/ops/crc32c_mxu.py (_fused_kernel,
// launched by _fused_registers and reached through
// masked_crc32c_chunks_fused).  CRC is linear over GF(2): the zero-init
// register of a 512-byte super-lane is A . bits(super-lane) mod 2, with
// A a fixed int8 [4096, 32] matrix (row k: the register contribution of
// message bit k, bits in stream order, LSB first in each byte).  As on
// the TPU, stage 1 is that product on the matrix unit: the bits of each
// super-lane are unpacked to 0/1 int8 in registers (never to memory) and
// contracted with A by mma.sync m16n8k32 s8.s8.s32, then reduced mod 2.
// The epilogue folds the 128 super-lane registers of a chunk with the
// GF(2) combine tree (crc32c_mxu.py:214-225: level j advances the left
// half by 512 * 2^j bytes) and cancels the zero tail of a ragged chunk
// with the inverse shift matrices (crc32c_mxu.py:248-255).
//
// Design: one CTA of 8 warps per 64 KiB chunk; warp w takes the m-tile of
// super-lanes 16w .. 16w + 15, walks the 128 k-steps of 32 bits (one
// 32-bit word of each super-lane: word kk holds message bits 32kk ..
// 32kk + 31, its bit c being bit c mod 8 of byte c / 8) and keeps the
// four n-tiles of the 32 register columns in 16 int32 accumulators
// (sums <= 4096, exact).  A's B-operand fragments are packed on the host
// in the lane order of mma.sync (constants below) and read through L1 and
// L2 as two 16-byte loads per lane per k-step: 128 KiB for the whole card.
//
// Bound on the H100: the 50.3 MB read of 768 chunks (15.0 us at 3.35
// TB/s) against 25.8 G int8 MACs (13.0 us at 1,979 TOP/s); mma.sync
// reaches only part of the int8 peak (wgmma is the way to all of it), and
// the unpack costs ALU work per k-step, so the products may bound this
// kernel before the bytes do.  Nothing in the CPU twin runs the tensor-core
// body: its stage 1 is the same product as a bit loop over A's rows, and
// it shares the fold and the pad cancellation with the card.
#include "snappy_common.cuh"

namespace stpu {

constexpr int kMmaChunk = 65536;
constexpr int kMmaNSuper = 128;                  // super-lanes per chunk
constexpr int kMmaKSteps = 128;                  // 32-bit k-steps per super-lane
constexpr int kFragWords = kMmaKSteps * 32 * 8;  // A fragments: [kk][lane][nt][2]
constexpr int kRowsOff = kFragWords;             // A rows: 4096 x 32 bits
constexpr int kFoldOff = kRowsOff + 4096;        // fold matrices: 7 x 32 columns
constexpr int kInvOff = kFoldOff + 7 * 32;       // inverse shift matrices: 17 x 32
constexpr int kInitOff = kInvOff + 17 * 32;      // the init term of 64 KiB
constexpr int kMmaConstWords = kInitOff + 1;

// GF(2) matrix (32 columns, column i the image of bit i) times v.
STPU_HD uint32_t gf2_apply(const uint32_t* cols, uint32_t v) {
  uint32_t acc = 0;
  for (int i = 0; i < 32; ++i)
    if ((v >> i) & 1) acc ^= cols[i];
  return acc;
}

// One node of the combine tree at `level`: the register of the left span
// advanced over the right span's 512 * 2^level bytes, xor the right one.
STPU_HD uint32_t fold_pair(const uint32_t* consts, int level, uint32_t left, uint32_t right) {
  return gf2_apply(consts + kFoldOff + 32 * level, left) ^ right;
}

// Zero-init register of the padded 64 KiB chunk -> masked CRC32C of its
// first `length` bytes: the init term, the zero tail cancelled, the final
// xor and snappy's mask.
STPU_HD uint32_t crc_finish(uint32_t reg, uint32_t length, const uint32_t* consts) {
  reg ^= consts[kInitOff];
  const uint32_t pad = (uint32_t)kMmaChunk - length;
  for (int j = 0; j < 17; ++j)
    if ((pad >> j) & 1) reg = gf2_apply(consts + kInvOff + 32 * j, reg);
  reg ^= 0xFFFFFFFFu;
  return ((reg >> 15) | (reg << 17)) + 0xA282EAD8u;
}

// Bits 0..3 of y, one to a byte: the 0/1 int8 operand of four k values.
STPU_HD uint32_t spread4(uint32_t y) { return ((y & 0xF) * 0x00204081u) & 0x01010101u; }

}  // namespace stpu

#ifdef __CUDACC__

namespace {

constexpr int kMmaThreads = 256;  // 8 warps: the 8 m-tiles of one chunk

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMmaThreads)
    crc32c_mma_kernel(const uint8_t* __restrict__ chunks, const int32_t* __restrict__ lengths,
                      const uint32_t* __restrict__ consts, uint32_t* __restrict__ out) {
  __shared__ uint32_t regs[stpu::kMmaNSuper];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma.sync's groupID, threadID_in_group
  // this thread's A-operand rows: super-lanes 16 warp + g and + 8
  const uint4* row_lo = reinterpret_cast<const uint4*>(
      chunks + (size_t)blockIdx.x * stpu::kMmaChunk + (size_t)(16 * warp + g) * 512);
  const uint4* row_hi = row_lo + 8 * 512 / 16;
  const uint4* frag = reinterpret_cast<const uint4*>(consts) + 2 * lane;
  int acc[4][4] = {};
  for (int q = 0; q < stpu::kMmaKSteps / 4; ++q) {
    const uint4 wl = __ldg(row_lo + q);  // words 4q .. 4q + 3 of each row
    const uint4 wh = __ldg(row_hi + q);
    const uint32_t lo[4] = {wl.x, wl.y, wl.z, wl.w};
    const uint32_t hi[4] = {wh.x, wh.y, wh.z, wh.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = 4 * q + u;
      // A fragment: rows g / g + 8, k columns 4t .. 4t + 3 and 16 + 4t ..
      const uint32_t a0 = stpu::spread4(lo[u] >> (4 * t));
      const uint32_t a1 = stpu::spread4(hi[u] >> (4 * t));
      const uint32_t a2 = stpu::spread4(lo[u] >> (16 + 4 * t));
      const uint32_t a3 = stpu::spread4(hi[u] >> (16 + 4 * t));
      const uint4 b01 = __ldg(frag + 64 * kk);      // n-tiles 0 and 1
      const uint4 b23 = __ldg(frag + 64 * kk + 1);  // n-tiles 2 and 3
      mma_s8(acc[0], a0, a1, a2, a3, b01.x, b01.y);
      mma_s8(acc[1], a0, a1, a2, a3, b01.z, b01.w);
      mma_s8(acc[2], a0, a1, a2, a3, b23.x, b23.y);
      mma_s8(acc[3], a0, a1, a2, a3, b23.z, b23.w);
    }
  }
  // C fragment: rows g (c0, c1) and g + 8 (c2, c3), columns 8 nt + 2t + {0, 1}
  uint32_t rlo = 0, rhi = 0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = 8 * nt + 2 * t;
    rlo |= ((uint32_t)acc[nt][0] & 1) << col | ((uint32_t)acc[nt][1] & 1) << (col + 1);
    rhi |= ((uint32_t)acc[nt][2] & 1) << col | ((uint32_t)acc[nt][3] & 1) << (col + 1);
  }
  rlo |= __shfl_xor_sync(0xFFFFFFFFu, rlo, 1);
  rlo |= __shfl_xor_sync(0xFFFFFFFFu, rlo, 2);
  rhi |= __shfl_xor_sync(0xFFFFFFFFu, rhi, 1);
  rhi |= __shfl_xor_sync(0xFFFFFFFFu, rhi, 2);
  if (t == 0) {
    regs[16 * warp + g] = rlo;
    regs[16 * warp + g + 8] = rhi;
  }
  __syncthreads();
  for (int level = 0; level < 7; ++level) {
    const int half = stpu::kMmaNSuper >> (level + 1);
    uint32_t v = 0;
    if (tid < half) v = stpu::fold_pair(consts, level, regs[2 * tid], regs[2 * tid + 1]);
    __syncthreads();
    if (tid < half) regs[tid] = v;
    __syncthreads();
  }
  if (tid == 0) out[blockIdx.x] = stpu::crc_finish(regs[0], (uint32_t)lengths[blockIdx.x], consts);
}

}  // namespace

// chunks: uint8 [n, 65536], 16-byte aligned, zero past each length;
// lengths: int32 [n] in [0, 65536]; consts: uint32 [kMmaConstWords]
// (crc32c_mma.consts()); out: uint32 [n] masked CRCs.  One CTA per chunk;
// launches on `stream`; returns cudaGetLastError().
STPU_EXPORT int stpu_crc32c_mma(const uint8_t* chunks, const int32_t* lengths, int n,
                                const uint32_t* consts, uint32_t* out, void* stream) {
  crc32c_mma_kernel<<<n, kMmaThreads, 0, (cudaStream_t)stream>>>(chunks, lengths, consts, out);
  return (int)cudaGetLastError();
}

#else  // CPU twin: stage 1 as a bit loop over A's rows, the same epilogue

STPU_EXPORT int stpu_twin_crc32c_mma(const uint8_t* chunks, const int32_t* lengths, int n,
                                     const uint32_t* consts, uint32_t* out) {
  const uint32_t* rows = consts + stpu::kRowsOff;
  uint32_t regs[stpu::kMmaNSuper];
  for (int c = 0; c < n; ++c) {
    const uint8_t* chunk = chunks + (size_t)c * stpu::kMmaChunk;
    for (int s = 0; s < stpu::kMmaNSuper; ++s) {
      uint32_t r = 0;
      for (int k = 0; k < 4096; ++k)
        if ((chunk[512 * s + k / 8] >> (k % 8)) & 1) r ^= rows[k];
      regs[s] = r;
    }
    for (int level = 0; level < 7; ++level)
      for (int p = 0; p < (stpu::kMmaNSuper >> (level + 1)); ++p)
        regs[p] = stpu::fold_pair(consts, level, regs[2 * p], regs[2 * p + 1]);
    out[c] = stpu::crc_finish(regs[0], (uint32_t)lengths[c], consts);
  }
  return 0;
}

#endif
