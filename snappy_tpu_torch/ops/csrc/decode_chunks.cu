// Snappy chunk decoder: the kernel behind
// snappy_tpu_torch.ops.decode_chunks.decode_chunks.
//
// Replaces the TPU kernel snappy_tpu/ops/decode_scalar.py (_make_kernel /
// _kernel, launched by _call) at both of its shapes: the chunk shape
// (decode_chunks_words, <= 64 KiB out) and the big-window shape of the raw
// format (decode_raw_words and decode_raw_batch_words, <= 128 KiB out),
// with the emit helpers of scalar_emit.py and emit_long.py folded into the
// byte loop below.  The verdicts follow the host C decoder stpu_decode_tags
// (snappy_codec.c:297-480) and the kernel's condition
// ok = no error && pos == comp_len && written == declared
// (decode_scalar.py:327); `written` is the output produced before the first
// bad tag, as the TPU kernel reports it.
//
// Design: one CTA per chunk.  Thread 0 walks the tag stream; the chunk's
// output row (up to 128 KiB: out_cols bytes of dynamic shared memory, so
// 3 CTAs per SM at 64 KiB and one at 128 KiB) is built there, so copies read
// back what was just written at shared-memory latency.  The compressed
// bytes are read from global memory, where they arrive ragged (one buffer
// plus int64 offsets), so a chunk body of any length is accepted — there
// is no per-chunk capacity as in the TPU layout.  The CTA then writes the
// row out with 16-byte stores, zero past `written`.
//
// Bound on the H100: a single thread's dependent byte loop (latency), not
// bytes moved.  Warp-cooperative copies are the next step (later work).
#include "snappy_common.cuh"

namespace stpu {

// Decode the tag stream in[0, n) into out[0, m).  Returns 1 when the
// stream is valid, consumed exactly and produced exactly m bytes; *written
// is the output produced before the first bad tag (or in all).
STPU_HD int decode_tags_body(const uint8_t* in, int64_t n, uint8_t* out,
                             uint32_t m, uint32_t* written) {
  int64_t i = 0;
  uint32_t o = 0;
  int bad = 0;
  while (i < n) {
    const uint32_t b = in[i];
    const uint32_t tag = b & 3;
    if (tag == 0) {  // literal
      const uint32_t lc = b >> 2;
      int64_t hdr = 1;
      uint64_t len = lc + 1;
      if (lc >= 60) {
        const uint32_t extra = lc - 59;  // 1..4 length bytes
        if (extra > n - i - 1) { bad = 1; break; }
        uint32_t v = 0;
        for (uint32_t k = 0; k < extra; ++k) v |= (uint32_t)in[i + 1 + k] << (8 * k);
        hdr = 1 + extra;
        len = (uint64_t)v + 1;
      }
      if (len > (uint64_t)(n - i - hdr) || len > (uint64_t)(m - o)) { bad = 1; break; }
      const uint8_t* src = in + i + hdr;
      for (uint32_t k = 0; k < (uint32_t)len; ++k) out[o + k] = src[k];
      o += (uint32_t)len;
      i += hdr + (int64_t)len;
      continue;
    }
    uint32_t len, offset;
    int64_t hdr;
    if (tag == 1) {
      hdr = 2;
      if (hdr > n - i) { bad = 1; break; }
      len = 4 + ((b >> 2) & 7);
      offset = ((b & 0xE0) << 3) | in[i + 1];
    } else if (tag == 2) {
      hdr = 3;
      if (hdr > n - i) { bad = 1; break; }
      len = 1 + (b >> 2);
      offset = (uint32_t)in[i + 1] | ((uint32_t)in[i + 2] << 8);
    } else {
      hdr = 5;
      if (hdr > n - i) { bad = 1; break; }
      len = 1 + (b >> 2);
      offset = load_le32(in + i + 1);
    }
    if (offset == 0 || offset > o || len > m - o) { bad = 1; break; }
    // forward byte copy: right for self-overlapping copies too
    for (uint32_t k = 0; k < len; ++k) out[o + k] = out[o - offset + k];
    o += len;
    i += hdr;
  }
  *written = o;
  return !bad && i == n && o == m;
}

}  // namespace stpu

#ifdef __CUDACC__

namespace {

constexpr int kDecThreads = 128;

__global__ void __launch_bounds__(kDecThreads)
    decode_chunks_kernel(const uint8_t* __restrict__ comp,
                         const int64_t* __restrict__ offsets,
                         const int32_t* __restrict__ declared,
                         uint8_t* __restrict__ out, int64_t out_cols,
                         uint8_t* __restrict__ ok,
                         int32_t* __restrict__ written) {
  extern __shared__ __align__(16) uint8_t s_out[];
  __shared__ uint32_t s_written;
  const int64_t row = blockIdx.x;
  if (threadIdx.x == 0) {
    const int64_t lo = offsets[row];
    uint32_t w = 0;
    const int good = stpu::decode_tags_body(comp + lo, offsets[row + 1] - lo,
                                            s_out, (uint32_t)declared[row], &w);
    ok[row] = (uint8_t)good;
    written[row] = (int32_t)w;
    s_written = w;
  }
  __syncthreads();
  const uint32_t w = s_written;
  for (int64_t k = w + threadIdx.x; k < out_cols; k += kDecThreads) s_out[k] = 0;
  __syncthreads();
  const uint4* src = reinterpret_cast<const uint4*>(s_out);
  uint4* dst = reinterpret_cast<uint4*>(out + row * out_cols);
  for (int64_t k = threadIdx.x; k < out_cols / 16; k += kDecThreads) dst[k] = src[k];
}

}  // namespace

// comp: uint8 ragged tag streams, chunk r = comp[offsets[r], offsets[r+1]);
// declared: int32 [n], each <= out_cols; out: uint8 [n, out_cols], 16-byte
// aligned rows, out_cols a multiple of 16 and <= 131072 (the launch refuses
// more than the 232,448 bytes of shared memory a block may have); ok: uint8
// [n]; written: int32 [n].  Launches on `stream`; returns
// cudaGetLastError().
STPU_EXPORT int stpu_decode_chunks(const uint8_t* comp, const int64_t* offsets,
                                   const int32_t* declared, int n, uint8_t* out,
                                   int64_t out_cols, uint8_t* ok,
                                   int32_t* written, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)out_cols);
  if (err != cudaSuccess) return (int)err;
  decode_chunks_kernel<<<n, kDecThreads, (size_t)out_cols,
                         (cudaStream_t)stream>>>(comp, offsets, declared, out,
                                                 out_cols, ok, written);
  return (int)cudaGetLastError();
}

#else  // CPU twin

STPU_EXPORT int stpu_twin_decode_chunks(const uint8_t* comp,
                                        const int64_t* offsets,
                                        const int32_t* declared, int n,
                                        uint8_t* out, int64_t out_cols,
                                        uint8_t* ok, int32_t* written) {
  for (int64_t row = 0; row < n; ++row) {
    uint8_t* dst = out + row * out_cols;
    uint32_t w = 0;
    ok[row] = (uint8_t)stpu::decode_tags_body(
        comp + offsets[row], offsets[row + 1] - offsets[row], dst,
        (uint32_t)declared[row], &w);
    written[row] = (int32_t)w;
    memset(dst + w, 0, (size_t)(out_cols - w));
  }
  return 0;
}

#endif
