// Masked CRC32C of a batch of chunks: the kernel behind
// snappy_tpu_torch.ops.crc32c.masked_crc32c_chunks.
//
// Replaces the TPU kernel snappy_tpu/ops/crc32c_pallas.py
// (_kernel_factory, launched by _lane_fold_pallas) and its XLA twin
// snappy_tpu/ops/crc32c_jax.py (masked_crc32c_chunks), which the JAX main
// path calls.
//
// Design: one CTA per chunk, kCrcThreads threads.  The chunk of L bytes is
// placed at the END of a window of W = kCrcThreads * S bytes, S the
// smallest power of two with W >= L; thread t owns window bytes
// [t*S, (t+1)*S).  Each thread runs a slicing-by-4 table CRC over the data
// bytes of its segment (tables in shared memory).  A zero-init register is
// unchanged by leading zero bytes, so the front padding costs nothing and
// needs no cancelling; the thread that owns data byte 0 starts from the
// standard init 0xFFFFFFFF instead of 0, which folds the init term in.
// The segment registers are then combined in a tree in shared memory:
// reg(A || B) = shift(reg(A), |B|) ^ reg(B), where |B| = S * 2^level is
// always a power of two, so each level applies one "advance by 2^j bytes"
// GF(2) matrix (the zlib crc32_combine construction, as
// crc32c_jax._shift_matrices builds them).  Masking (rotr 15 + 0xa282ead8)
// follows.  The kernel reads only the first L bytes of each row.
//
// Bound on the H100: the bytes read (one pass over the chunk).  This first
// version is bound instead by the table lookups of the per-thread CRC and
// the strided, per-thread word loads; making it fast is later work.
#include "snappy_common.cuh"

namespace stpu {

constexpr int kCrcThreads = 256;
constexpr int kCrcThreadsLog2 = 8;
constexpr uint32_t kMaskDelta = 0xA282EAD8u;

// Table CRC update of reg over p[0, n): bytes up to a 4-byte boundary, then
// slicing-by-4 over aligned little-endian words, then the tail bytes.
// tab holds the four 256-entry slicing tables back to back.
STPU_HD uint32_t crc32c_update(const uint32_t* tab, uint32_t reg,
                               const uint8_t* p, int64_t n) {
  while (n > 0 && ((uintptr_t)p & 3)) {
    reg = tab[(reg ^ *p++) & 0xFF] ^ (reg >> 8);
    --n;
  }
  while (n >= 4) {
    reg ^= load_aligned32(p);
    reg = tab[768 + (reg & 0xFF)] ^ tab[512 + ((reg >> 8) & 0xFF)] ^
          tab[256 + ((reg >> 16) & 0xFF)] ^ tab[reg >> 24];
    p += 4;
    n -= 4;
  }
  while (n > 0) {
    reg = tab[(reg ^ *p++) & 0xFF] ^ (reg >> 8);
    --n;
  }
  return reg;
}

// Apply a GF(2) 32x32 matrix, given as its 32 columns, to v.
STPU_HD uint32_t gf2_apply(const uint32_t* cols, uint32_t v) {
  uint32_t acc = 0;
  for (int i = 0; i < 32; ++i) {
    if ((v >> i) & 1u) acc ^= cols[i];
  }
  return acc;
}

// log2 of the per-thread segment S for a chunk of len bytes.
STPU_HD int crc_seg_log2(int64_t len) {
  int s = 0;
  while (((int64_t)kCrcThreads << s) < len) ++s;
  return s;
}

// The register of thread t's segment (0 for a segment wholly in the front
// padding).
STPU_HD uint32_t crc_segment_register(const uint32_t* tab, const uint8_t* row,
                                      int64_t len, int seg_log2, int t) {
  const int64_t pad = ((int64_t)kCrcThreads << seg_log2) - len;
  int64_t a = ((int64_t)t << seg_log2) - pad;
  const int64_t b = a + ((int64_t)1 << seg_log2);
  if (b <= 0) return 0;
  uint32_t reg = 0;
  if (a <= 0) {  // this segment holds data byte 0: the standard init
    a = 0;
    reg = 0xFFFFFFFFu;
  }
  return crc32c_update(tab, reg, row + a, b - a);
}

// Combine the segment registers of a tree level: left (earlier bytes) is
// advanced across the 2^shift_log2 bytes of right.
STPU_HD uint32_t crc_fold(const uint32_t* mats, int shift_log2, uint32_t left,
                          uint32_t right) {
  return gf2_apply(mats + 32 * shift_log2, left) ^ right;
}

// Final step from the folded register: invert, then the snappy mask
// (framing_format.txt:39-58).  An empty chunk has CRC 0.
STPU_HD uint32_t crc_finish(int64_t len, uint32_t reg) {
  const uint32_t crc = len == 0 ? 0u : reg ^ 0xFFFFFFFFu;
  return ((crc >> 15) | (crc << 17)) + kMaskDelta;
}

}  // namespace stpu

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(stpu::kCrcThreads)
    crc32c_chunks_kernel(const uint8_t* __restrict__ chunks, int64_t stride,
                         const int32_t* __restrict__ lengths,
                         const uint32_t* __restrict__ tables,
                         const uint32_t* __restrict__ mats,
                         uint32_t* __restrict__ out) {
  __shared__ uint32_t s_tab[4 * 256];
  __shared__ uint32_t s_mat[32 * 32];
  __shared__ uint32_t s_reg[stpu::kCrcThreads];
  const int t = threadIdx.x;
  for (int i = t; i < 4 * 256; i += stpu::kCrcThreads) s_tab[i] = tables[i];
  for (int i = t; i < 32 * 32; i += stpu::kCrcThreads) s_mat[i] = mats[i];
  __syncthreads();

  const int64_t row = blockIdx.x;
  const int64_t len = lengths[row];
  const int seg_log2 = stpu::crc_seg_log2(len);
  s_reg[t] = stpu::crc_segment_register(s_tab, chunks + row * stride, len,
                                        seg_log2, t);
  __syncthreads();
  for (int level = 0; level < stpu::kCrcThreadsLog2; ++level) {
    const int step = 1 << level;
    if ((t & (2 * step - 1)) == 0) {
      s_reg[t] = stpu::crc_fold(s_mat, seg_log2 + level, s_reg[t],
                                s_reg[t + step]);
    }
    __syncthreads();
  }
  if (t == 0) out[row] = stpu::crc_finish(len, s_reg[0]);
}

}  // namespace

// chunks: uint8 [n, >= stride], row r at chunks + r * stride, 4-byte
// aligned; lengths: int32 [n]; tables: uint32 [4, 256] slicing tables;
// mats: uint32 [32, 32], row j = the columns of "advance by 2^j bytes";
// out: uint32 [n].  Launches on `stream`; returns cudaGetLastError().
STPU_EXPORT int stpu_crc32c_chunks(const uint8_t* chunks, int64_t stride,
                                   const int32_t* lengths, int n,
                                   const uint32_t* tables,
                                   const uint32_t* mats, uint32_t* out,
                                   void* stream) {
  crc32c_chunks_kernel<<<n, stpu::kCrcThreads, 0, (cudaStream_t)stream>>>(
      chunks, stride, lengths, tables, mats, out);
  return (int)cudaGetLastError();
}

#else  // CPU twin: the same per-thread bodies, threads run in turn.

#include <vector>

STPU_EXPORT int stpu_twin_crc32c_chunks(const uint8_t* chunks, int64_t stride,
                                        const int32_t* lengths, int n,
                                        const uint32_t* tables,
                                        const uint32_t* mats, uint32_t* out) {
  std::vector<uint32_t> reg(stpu::kCrcThreads);
  for (int64_t row = 0; row < n; ++row) {
    const int64_t len = lengths[row];
    const int seg_log2 = stpu::crc_seg_log2(len);
    for (int t = 0; t < stpu::kCrcThreads; ++t) {
      reg[t] = stpu::crc_segment_register(tables, chunks + row * stride, len,
                                          seg_log2, t);
    }
    for (int level = 0; level < stpu::kCrcThreadsLog2; ++level) {
      const int step = 1 << level;
      for (int t = 0; t < stpu::kCrcThreads; t += 2 * step) {
        reg[t] = stpu::crc_fold(mats, seg_log2 + level, reg[t], reg[t + step]);
      }
    }
    out[row] = stpu::crc_finish(len, reg[0]);
  }
  return 0;
}

#endif
