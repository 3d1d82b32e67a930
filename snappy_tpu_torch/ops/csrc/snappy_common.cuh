// Shared helpers of the codec kernels: byte-wise loads, the match hash, the
// tag emitters, the tag parser, the lane-strided segment emitters of the
// streaming decoders, all __host__ __device__, and the warp of the
// one-warp kernels (Lanes<T> and its collectives, below).
//
// The per-chunk bodies in crc32c.cu, decode_chunks.cu, decode_stream.cu,
// decode_stream_scan.cu and encode_blocks.cu
// are written against these helpers so that one source compiles twice:
// with nvcc for sm_90a (the kernels the port launches) and with g++ into the
// CPU twin the tests load (no __CUDACC__: the shim below turns the CUDA
// qualifiers into plain inline functions).  The twin is never on the
// port's path.
//
// Every multi-byte load is assembled from byte loads or made at an aligned
// address: a cast load at an arbitrary address faults on the card
// ("misaligned address"), where the host C codec (snappy_codec.c) loads
// 4 and 8 bytes anywhere.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define STPU_HD __host__ __device__ __forceinline__
#else
#define STPU_HD static inline
#endif

#define STPU_EXPORT extern "C" __attribute__((visibility("default")))

#ifdef __CUDA_ARCH__
#define STPU_SYNCWARP() __syncwarp()
#else
#define STPU_SYNCWARP()
#endif

namespace stpu {

constexpr uint32_t kMaxBlock = 65536;      // MAX_BLOCK_LEN
constexpr uint32_t kInputMargin = 15;      // INPUT_MARGIN
constexpr uint32_t kMinNonLiteral = 17;    // MIN_NON_LITERAL_BLOCK_SIZE
constexpr uint32_t kTableBits = 14;        // encoder hash table: 16 K entries
constexpr uint32_t kTableSize = 1u << kTableBits;
constexpr uint32_t kHashMul = 0x1E35A7BDu;

STPU_HD int64_t min_i64(int64_t a, int64_t b) { return a < b ? a : b; }
STPU_HD int64_t max_i64(int64_t a, int64_t b) { return a > b ? a : b; }

// Little-endian 32-bit load from any address, one byte at a time.
STPU_HD uint32_t load_le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// Little-endian 32-bit load from a 4-byte aligned address.
STPU_HD uint32_t load_aligned32(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint32_t*>(p);
#else
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
#endif
}

// The encoder's hash: the top bits of u * 0x1e35a7bd (shift = 32 - log2 of
// the table size), encode_scalar.py:25-28 and snappy_codec.c:41-43.
STPU_HD uint32_t hash32(uint32_t u, uint32_t shift) {
  return (u * kHashMul) >> shift;
}

// The tag of a literal of len bytes (snappy_codec.c:47-75); returns the
// output position of its first byte.
STPU_HD uint32_t literal_tag(uint8_t* out, uint32_t op, uint32_t len) {
  const uint32_t n = len - 1;
  if (n < 60) {
    out[op++] = (uint8_t)(n << 2);
  } else if (n < 256) {
    out[op++] = (uint8_t)(60 << 2);
    out[op++] = (uint8_t)n;
  } else {
    out[op++] = (uint8_t)(61 << 2);
    out[op++] = (uint8_t)(n & 0xFF);
    out[op++] = (uint8_t)(n >> 8);
  }
  return op;
}

STPU_HD uint32_t emit_copy2(uint8_t* out, uint32_t op, uint32_t offset,
                            uint32_t len) {
  out[op] = (uint8_t)(((len - 1) << 2) | 2);
  out[op + 1] = (uint8_t)(offset & 0xFF);
  out[op + 2] = (uint8_t)(offset >> 8);
  return op + 3;
}

// Copy tags with the 68/64/60 long-copy split and copy-1 for short near
// copies (snappy_codec.c:84-102).
STPU_HD uint32_t emit_copy(uint8_t* out, uint32_t op, uint32_t offset,
                           uint32_t len) {
  while (len >= 68) {
    op = emit_copy2(out, op, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    op = emit_copy2(out, op, offset, 60);
    len -= 60;
  }
  if (len >= 12 || offset >= 2048) return emit_copy2(out, op, offset, len);
  out[op] = (uint8_t)(((offset >> 8) << 5) | (((len - 4) & 7) << 2) | 1);
  out[op + 1] = (uint8_t)(offset & 0xFF);
  return op + 2;
}

// One parsed tag (decoder.nim:48-113): kind 0 is a literal, 1-3 a copy
// with a 1-, 2- or 4-byte offset; hdr is the tag's own length, len the
// bytes it emits.
struct Tag {
  uint32_t kind;
  uint32_t hdr;
  uint64_t len;
  uint64_t offset;
};

// Byte k of p, of which `avail` bytes exist; zero past them.
STPU_HD uint32_t byte_or_zero(const uint8_t* p, int64_t avail, int64_t k) {
  return k < avail ? p[k] : 0;
}

// Parse the tag at p, of which `avail` bytes exist; bytes past them read as
// zero, so the caller checks hdr <= avail before trusting len or offset.
STPU_HD Tag parse_tag(const uint8_t* p, int64_t avail) {
  const uint32_t b = p[0];
  Tag t;
  t.kind = b & 3;
  t.offset = 0;
  if (t.kind == 0) {
    const uint32_t lc = b >> 2;
    t.hdr = 1;
    t.len = lc + 1;
    if (lc >= 60) {
      const uint32_t extra = lc - 59;  // 1..4 length bytes
      uint64_t v = 0;
      for (uint32_t k = 0; k < extra; ++k) v |= (uint64_t)byte_or_zero(p, avail, 1 + k) << (8 * k);
      t.hdr = 1 + extra;
      t.len = v + 1;
    }
  } else if (t.kind == 1) {
    t.hdr = 2;
    t.len = 4 + ((b >> 2) & 7);
    t.offset = ((b & 0xE0) << 3) | byte_or_zero(p, avail, 1);
  } else {
    t.hdr = t.kind == 2 ? 3 : 5;
    t.len = 1 + (b >> 2);
    for (uint32_t k = 1; k < t.hdr; ++k) t.offset |= (uint64_t)byte_or_zero(p, avail, k) << (8 * (k - 1));
  }
  return t;
}

// The lane-strided segment emitters of the streaming decoders.  Output
// position x lives at buf[x & mask] (a ring of windows, or mask = ~0 for
// a flat output); `lanes` threads run them together, this one being
// `lane`, and write bytes k = lane, lane + lanes, ... of the segment.  A
// copy's byte k is output byte o - off + (k mod off), written before the
// copy began, so no lane waits on another; the __syncwarp at the end makes
// the segment visible to every lane.
STPU_HD void lanes_literal(uint8_t* buf, uint64_t mask, uint64_t o, const uint8_t* src,
                           uint64_t take, uint32_t lane, uint32_t lanes) {
  for (uint64_t k = lane; k < take; k += lanes) buf[(o + k) & mask] = src[k];
  STPU_SYNCWARP();
}

STPU_HD void lanes_copy(uint8_t* buf, uint64_t mask, uint64_t o, uint64_t off,
                        uint64_t take, uint32_t lane, uint32_t lanes) {
  const uint64_t s = o - off;
  if (off >= take) {
    for (uint64_t k = lane; k < take; k += lanes) buf[(o + k) & mask] = buf[(s + k) & mask];
  } else {  // self-overlapping: the first `off` bytes repeat
    const uint32_t period = (uint32_t)off;
    for (uint32_t k = lane; k < take; k += lanes) buf[(o + k) & mask] = buf[(s + k % period) & mask];
  }
  STPU_SYNCWARP();
}

// ---- the warp, for the card and for the twin ----------------------------
// The one-warp kernels (decode_chunks.cu, encode_blocks.cu) are written
// against these.  A Lanes<T> holds one value per lane; STPU_LANES(l) runs
// its body for lane l: once in each thread on the card, for l = 0 .. 31 in
// turn in the twin.  Plain scalars are warp-uniform.  Two rules keep the
// builds equal: a STPU_LANES body calls no collective, and no lane reads in
// a body what another lane writes in it (reads and writes of shared state
// sit in separate bodies with warp_sync() between them).
#ifdef __CUDA_ARCH__
template <class T>
struct Lanes {
  T v;
  __device__ __forceinline__ T& operator[](uint32_t) { return v; }
  __device__ __forceinline__ const T& operator[](uint32_t) const { return v; }
};
#define STPU_LANES(l) \
  for (uint32_t l = threadIdx.x & 31u, l##_once = 0; l##_once < 1; ++l##_once)
constexpr uint32_t kAll = 0xFFFFFFFFu;
__device__ __forceinline__ uint32_t warp_ballot(const Lanes<bool>& b) {
  return __ballot_sync(kAll, b.v);
}
// Per lane l, x of lane src[l].
__device__ __forceinline__ Lanes<uint32_t> warp_shfl(const Lanes<uint32_t>& x,
                                                     const Lanes<uint32_t>& src) {
  return {__shfl_sync(kAll, x.v, src.v)};
}
__device__ __forceinline__ uint32_t warp_bcast(const Lanes<uint32_t>& x, uint32_t src) {
  return __shfl_sync(kAll, x.v, src);
}
// The OR of x over the lanes.
__device__ __forceinline__ uint32_t warp_or(const Lanes<uint32_t>& x) {
  return __reduce_or_sync(kAll, x.v);
}
// Per lane l, the sum of x over lanes 0 .. l (five shuffles up); T is a
// 32- or 64-bit unsigned integer.
template <class T>
__device__ __forceinline__ Lanes<T> warp_scan_add(const Lanes<T>& x) {
  T s = x.v;
  const uint32_t lane = threadIdx.x & 31u;
#pragma unroll
  for (uint32_t d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kAll, s, d);
    if (lane >= d) s += y;
  }
  return {s};
}
__device__ __forceinline__ void warp_sync() { __syncwarp(); }
__device__ __forceinline__ uint32_t high_lane(uint32_t m) { return 31 - __clz(m); }
__device__ __forceinline__ uint32_t low_lane(uint32_t m) { return __ffs(m) - 1; }
__device__ __forceinline__ uint32_t popc(uint32_t m) { return __popc(m); }
#else
template <class T>
struct Lanes {
  T v[32];
  T& operator[](uint32_t l) { return v[l]; }
  const T& operator[](uint32_t l) const { return v[l]; }
};
// Lanes 0 .. 31 in turn, or 31 .. 0 in a build that defines
// STPU_TWIN_REVERSE_LANES: the tests run both orders, so a lane that read
// in a body what another lane writes in it would show.
#ifdef STPU_TWIN_REVERSE_LANES
#define STPU_LANES(l) \
  for (uint32_t l##_k = 0, l = 31; l##_k < 32; ++l##_k, l = 31 - l##_k)
#else
#define STPU_LANES(l) for (uint32_t l = 0; l < 32; ++l)
#endif
inline uint32_t warp_ballot(const Lanes<bool>& b) {
  uint32_t m = 0;
  for (uint32_t l = 0; l < 32; ++l) m |= (uint32_t)b[l] << l;
  return m;
}
inline Lanes<uint32_t> warp_shfl(const Lanes<uint32_t>& x, const Lanes<uint32_t>& src) {
  Lanes<uint32_t> r;
  for (uint32_t l = 0; l < 32; ++l) r[l] = x[src[l] & 31];
  return r;
}
inline uint32_t warp_bcast(const Lanes<uint32_t>& x, uint32_t src) { return x[src & 31]; }
inline uint32_t warp_or(const Lanes<uint32_t>& x) {
  uint32_t m = 0;
  for (uint32_t l = 0; l < 32; ++l) m |= x[l];
  return m;
}
template <class T>
inline Lanes<T> warp_scan_add(const Lanes<T>& x) {
  Lanes<T> r;
  T s = 0;
  for (uint32_t l = 0; l < 32; ++l) r[l] = s += x[l];
  return r;
}
inline void warp_sync() {}
inline uint32_t high_lane(uint32_t m) { return 31 - __builtin_clz(m); }
inline uint32_t low_lane(uint32_t m) { return __builtin_ctz(m); }
inline uint32_t popc(uint32_t m) { return __builtin_popcount(m); }
#endif

// Lanes 0 .. l.
STPU_HD uint32_t lanes_upto(uint32_t l) { return l >= 31 ? 0xFFFFFFFFu : (2u << l) - 1; }

}  // namespace stpu
