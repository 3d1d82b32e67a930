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
// Design: one CTA per block.  The block (64 KiB) and the hash table live
// in dynamic shared memory: 16 K uint16 entries (32 KiB, 96 KiB in all) at
// ways=1, 2 x 16 K (64 KiB, 128 KiB in all, one CTA per SM) at ways=2,
// above the 48 KiB default, hence cudaFuncSetAttribute per instantiation.
// The CTA loads the block and zeroes the whole table cooperatively, then
// thread 0 walks the block greedily and writes the tag stream straight to
// global memory.
//
// Bound on the H100: a single thread's dependent probe/match loop
// (latency), not bytes moved; at ways=2 also the occupancy of one CTA per
// SM.  Parallel match search is later work.
#include "snappy_common.cuh"

namespace stpu {

// Length of the common prefix of s1 and s2, with s2 limited to limit.
STPU_HD uint32_t match_length(const uint8_t* in, uint32_t s1, uint32_t s2,
                              uint32_t limit) {
  const uint32_t start = s2;
  while (s2 < limit && in[s1] == in[s2]) {
    ++s1;
    ++s2;
  }
  return s2 - start;
}

// Encode in[0, n) (n <= 65536) into out; returns the encoded length, at
// most max_compressed_len(n).  `table` holds Ways * kTableSize zeroed
// entries.
template <int Ways>
STPU_HD uint32_t encode_block_body(const uint8_t* in, uint32_t n, uint8_t* out,
                                   uint16_t* table) {
  uint32_t op = 0;
  if (n < kMinNonLiteral) {
    if (n) op = emit_literal(out, op, in, n);
    return op;
  }
  uint32_t table_size = 256;
  while (table_size < kTableSize && table_size < n) table_size <<= 1;
  uint32_t shift = 32;
  for (uint32_t s = table_size; s > 1; s >>= 1) --shift;

  uint32_t ip = 1;
  const uint32_t ip_limit = n - kInputMargin;
  uint32_t next_emit = 0;

  for (;;) {
    uint32_t skip = 32;
    uint32_t next_ip = ip;
    uint32_t candidate;
    for (;;) {  // probe loop with the 1/32 skip heuristic
      ip = next_ip;
      const uint32_t step = skip >> 5;
      skip += step;
      next_ip = ip + step;
      if (next_ip > ip_limit) {
        if (next_emit < n) op = emit_literal(out, op, in + next_emit, n - next_emit);
        return op;
      }
      const uint32_t cur = load_le32(in + ip);
      const uint32_t h = hash32(cur, shift);
      if (Ways == 1) {
        candidate = table[h];
        table[h] = (uint16_t)ip;
        if (cur == load_le32(in + candidate)) break;
      } else {
        const uint32_t c1 = table[2 * h];
        const uint32_t c2 = table[2 * h + 1];
        table[2 * h + 1] = table[2 * h];
        table[2 * h] = (uint16_t)ip;
        if (cur == load_le32(in + c1)) { candidate = c1; break; }
        if (cur == load_le32(in + c2)) { candidate = c2; break; }
      }
    }
    if (next_emit < ip) op = emit_literal(out, op, in + next_emit, ip - next_emit);

    for (;;) {  // match extension loop
      const uint32_t match_base = ip;
      const uint32_t matched = 4 + match_length(in, candidate + 4, ip + 4, n);
      ip += matched;
      op = emit_copy(out, op, match_base - candidate, matched);
      next_emit = ip;
      if (ip > ip_limit) {
        if (next_emit < n) op = emit_literal(out, op, in + next_emit, n - next_emit);
        return op;
      }
      const uint32_t hp = hash32(load_le32(in + ip - 1), shift);
      const uint32_t cur = load_le32(in + ip);
      const uint32_t h = hash32(cur, shift);
      if (Ways == 1) {
        table[hp] = (uint16_t)(ip - 1);
        candidate = table[h];
        table[h] = (uint16_t)ip;
        if (cur != load_le32(in + candidate)) {
          ++ip;
          break;
        }
      } else {
        table[2 * hp + 1] = table[2 * hp];
        table[2 * hp] = (uint16_t)(ip - 1);
        const uint32_t c1 = table[2 * h];
        const uint32_t c2 = table[2 * h + 1];
        table[2 * h + 1] = table[2 * h];
        table[2 * h] = (uint16_t)ip;
        if (cur == load_le32(in + c1)) {
          candidate = c1;
        } else if (cur == load_le32(in + c2)) {
          candidate = c2;
        } else {
          ++ip;
          break;
        }
      }
    }
  }
}

}  // namespace stpu

#ifdef __CUDACC__

namespace {

constexpr int kEncThreads = 128;

template <int Ways>
constexpr size_t enc_smem() {
  return stpu::kMaxBlock + Ways * stpu::kTableSize * sizeof(uint16_t);
}

template <int Ways>
__global__ void __launch_bounds__(kEncThreads)
    encode_blocks_kernel(const uint8_t* __restrict__ blocks, int64_t in_stride,
                         const int32_t* __restrict__ lens,
                         uint8_t* __restrict__ out, int64_t out_stride,
                         int32_t* __restrict__ out_len) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_in = smem;
  uint16_t* s_tab = reinterpret_cast<uint16_t*>(smem + stpu::kMaxBlock);
  const int64_t row = blockIdx.x;
  const uint32_t n = (uint32_t)lens[row];
  const uint8_t* src = blocks + row * in_stride;
  for (uint32_t k = threadIdx.x; k < n; k += kEncThreads) s_in[k] = src[k];
  uint32_t* tab_words = reinterpret_cast<uint32_t*>(s_tab);
  for (uint32_t k = threadIdx.x; k < Ways * stpu::kTableSize / 2; k += kEncThreads)
    tab_words[k] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    out_len[row] = (int32_t)stpu::encode_block_body<Ways>(
        s_in, n, out + row * out_stride, s_tab);
  }
}

template <int Ways>
int launch_encode(const uint8_t* blocks, int64_t in_stride, const int32_t* lens,
                  int n, uint8_t* out, int64_t out_stride, int32_t* out_len,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      encode_blocks_kernel<Ways>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)enc_smem<Ways>());
  if (err != cudaSuccess) return (int)err;
  encode_blocks_kernel<Ways><<<n, kEncThreads, enc_smem<Ways>(), stream>>>(
      blocks, in_stride, lens, out, out_stride, out_len);
  return (int)cudaGetLastError();
}

}  // namespace

// blocks: uint8 [n, in_stride], lens: int32 [n] (each <= 65536);
// out: uint8 [n, out_stride], out_stride >= max_compressed_len(65536);
// out_len: int32 [n]; ways: 1 (level 1) or 2 (level 2).  Launches on
// `stream`; returns cudaGetLastError() (or cudaErrorInvalidValue for
// another `ways`).
STPU_EXPORT int stpu_encode_blocks(const uint8_t* blocks, int64_t in_stride,
                                   const int32_t* lens, int n, uint8_t* out,
                                   int64_t out_stride, int32_t* out_len,
                                   int ways, void* stream) {
  if (ways == 1)
    return launch_encode<1>(blocks, in_stride, lens, n, out, out_stride,
                            out_len, (cudaStream_t)stream);
  if (ways == 2)
    return launch_encode<2>(blocks, in_stride, lens, n, out, out_stride,
                            out_len, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

#else  // CPU twin

#include <algorithm>
#include <vector>

STPU_EXPORT int stpu_twin_encode_blocks(const uint8_t* blocks,
                                        int64_t in_stride, const int32_t* lens,
                                        int n, uint8_t* out,
                                        int64_t out_stride, int32_t* out_len,
                                        int ways) {
  if (ways != 1 && ways != 2) return 1;
  std::vector<uint16_t> table(2 * stpu::kTableSize);
  for (int64_t row = 0; row < n; ++row) {
    std::fill(table.begin(), table.end(), 0);
    const uint8_t* in = blocks + row * in_stride;
    uint8_t* dst = out + row * out_stride;
    const uint32_t len = (uint32_t)lens[row];
    out_len[row] = (int32_t)(ways == 1
        ? stpu::encode_block_body<1>(in, len, dst, table.data())
        : stpu::encode_block_body<2>(in, len, dst, table.data()));
  }
  return 0;
}

#endif
