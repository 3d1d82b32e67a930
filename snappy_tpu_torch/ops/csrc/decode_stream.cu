// Streaming raw-format decoder: the kernel behind
// snappy_tpu_torch.ops.decode_stream.decode_stream.
//
// Replaces the TPU kernel snappy_tpu/ops/decode_stream.py (_kernel_grid,
// launched by decode_raw_stream_grid and decode_raw_stream_bytes in grid
// mode): one raw tag stream of any size in one launch, in 64 KiB output
// windows.  It computes what grid mode computes: ok = no malformed tag,
// consumed == comp_len and written == declared, with `written` the output
// produced before the first bad tag and `consumed` the input position of
// that tag (or of the stream's end).  The verdicts follow the sequential
// decoder (decoder.nim:20-155, snappy.nim:107-108), as the chunk decoder's
// do: the whole compressed stream lies in global memory, so every tag is
// validated against the stream's true input and output bounds before any
// of it is emitted.  Every legal copy offset is served, so the TPU's
// `unsupported` verdict never arises here.
//
// What the TPU design needed and this one does not: 1024-word aligned comp
// slices with prefetch semaphores, a minimum-slice step budget and idle
// grid steps (a sequential grid stood in for a loop).  Here one CTA loops
// over the windows itself, with 64-bit input and output cursors.
//
// Design: one CTA per stream.  The current 64 KiB output window and the
// previous one sit in dynamic shared memory as a 128 KiB ring; warp 0
// walks the tags, every lane parsing the same tag from the compressed
// bytes in global memory (one broadcast load per byte), and stops when the
// window is full.  Each literal or copy is emitted by the 32 lanes
// together (lanes_literal and lanes_copy of snappy_common.cuh, which K5
// shares).  A literal or copy that crosses
// the window's end is kept as a pending segment (its remaining length and
// its source) and resumed in the next window.  Then the whole CTA flushes
// the window to global memory with 16-byte stores.  A copy whose source
// lies before the ring (more than 64 KiB behind the window start) reads
// the output already flushed to global memory; such a source lies wholly
// in flushed windows (an offset beyond the ring exceeds 64 KiB, a copy tag
// emits at most 64 bytes).  The window and pending-segment logic is
// stream_window below, __host__ __device__, so the g++ twin runs it too
// (as one lane).
//
// Bound on the H100: the walk's dependent parse of one tag after another
// (latency), with no other CTA to hide it: one stream uses one SM.  The
// lanes cut the per-byte part of each segment, not the per-tag part.
#include "snappy_common.cuh"

namespace stpu {

constexpr uint64_t kWin = 65536;           // output window
constexpr uint64_t kRingMask = 2 * kWin - 1;  // ring of two windows

// Walk state carried from one window to the next.
struct StreamState {
  int64_t i;           // input cursor: bytes consumed
  uint64_t o;          // output cursor: bytes produced
  uint64_t win_start;  // output offset of the current window
  uint64_t plen;       // pending segment: bytes still to emit (0: none)
  uint64_t psrc;       // pending literal: input offset; pending copy: offset
  int plit;            // pending segment is a literal
  int bad;             // a malformed tag stopped the walk
};

STPU_HD uint64_t min_u64(uint64_t a, uint64_t b) { return a < b ? a : b; }

// Decode in[0, n) (declared length m) into the ring until the window that
// starts at shared->win_start is full or the walk ends.  Output position p
// lives at ring[p & kRingMask]; positions before the window start are also
// in `flushed` (global memory).  `lanes` threads run it together, this one
// being `lane`: all of them walk the same tags, each writes the bytes
// k = lane, lane + lanes, ... of every segment, and lane 0 stores the
// state back.  Returns 1 when the window is full and more output follows
// (flush it, advance win_start by kWin, call again), 0 when the walk has
// ended (input exhausted or a malformed tag).
STPU_HD int stream_window(const uint8_t* in, int64_t n, uint64_t m,
                          uint8_t* ring, const uint8_t* flushed,
                          StreamState* shared, uint32_t lane, uint32_t lanes) {
  StreamState state = *shared;
  StreamState* st = &state;
  STPU_SYNCWARP();  // every lane has read the state before lane 0 stores it
  const uint64_t win_end = min_u64(st->win_start + kWin, m);
  const uint64_t ring_lo = st->win_start >= kWin ? st->win_start - kWin : 0;
  int64_t i = st->i;
  uint64_t o = st->o;
  int more = 0;
  for (;;) {
    if (st->plen) {  // emit (the rest of) the pending segment
      const uint64_t take = min_u64(st->plen, win_end - o);
      if (st->plit) {
        lanes_literal(ring, kRingMask, o, in + st->psrc, take, lane, lanes);
        st->psrc += take;
      } else if (st->psrc <= o - ring_lo) {  // source in the ring
        lanes_copy(ring, kRingMask, o, st->psrc, take, lane, lanes);
      } else {
        // source before the ring: flushed output (never self-overlapping)
        lanes_literal(ring, kRingMask, o, flushed + (o - st->psrc), take, lane, lanes);
      }
      o += take;
      st->plen -= take;
    }
    if (o == win_end && win_end < m) {
      more = 1;  // window full: flush before going on
      break;
    }
    if (i >= n) break;
    // parse and validate one tag (decode_tags_body's rules, 64-bit cursors)
    const Tag t = parse_tag(in + i, n - i);
    if (t.hdr > n - i) { st->bad = 1; break; }
    if (t.kind == 0) {
      if (t.len > (uint64_t)(n - i - t.hdr) || t.len > m - o) { st->bad = 1; break; }
      st->psrc = (uint64_t)(i + t.hdr);
    } else {
      if (t.offset == 0 || t.offset > o || t.len > m - o) { st->bad = 1; break; }
      st->psrc = t.offset;
    }
    st->plit = t.kind == 0;
    st->plen = t.len;
    i += t.hdr + (t.kind == 0 ? (int64_t)t.len : 0);
  }
  st->i = i;
  st->o = o;
  if (lane == 0) *shared = state;
  return more;
}

STPU_HD void stream_init(StreamState* st) {
  st->i = 0;
  st->o = 0;
  st->win_start = 0;
  st->plen = 0;
  st->psrc = 0;
  st->plit = 0;
  st->bad = 0;
}

}  // namespace stpu

#ifdef __CUDACC__

namespace {

constexpr int kStreamThreads = 256;
constexpr int kRingBytes = (int)(2 * stpu::kWin);

__global__ void __launch_bounds__(kStreamThreads)
    decode_stream_kernel(const uint8_t* __restrict__ in, int64_t n, uint64_t m,
                         uint8_t* out, int64_t* __restrict__ status) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ stpu::StreamState st;
  __shared__ int s_more;
  if (threadIdx.x == 0) stpu::stream_init(&st);
  __syncthreads();
  for (;;) {
    if (threadIdx.x < 32) {  // warp 0 walks
      const int more = stpu::stream_window(in, n, m, ring, out, &st, threadIdx.x, 32);
      if (threadIdx.x == 0) s_more = more;
    }
    __syncthreads();
    // Read what the walk left before the barrier below: thread 0 changes
    // it again only after that barrier.
    const int more = s_more;
    const uint64_t ws = st.win_start;
    const uint64_t len = st.o - ws;
    const uint8_t* src = ring + (ws & stpu::kRingMask);
    uint8_t* dst = out + ws;  // ws is a multiple of 64 KiB: 16-byte aligned
    const uint64_t vec = len / 16;
    for (uint64_t k = threadIdx.x; k < vec; k += kStreamThreads)
      reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(src)[k];
    for (uint64_t k = vec * 16 + threadIdx.x; k < len; k += kStreamThreads)
      dst[k] = src[k];
    __syncthreads();  // the flushed window is visible to the walkers
    if (!more) break;
    if (threadIdx.x == 0) st.win_start += stpu::kWin;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    status[0] = !st.bad && st.i == n && st.o == m;
    status[1] = (int64_t)st.o;
    status[2] = st.i;
  }
}

}  // namespace

// in: uint8 [n] one raw tag stream (no varint header), m: its declared
// length; out: uint8 with room for m bytes, 16-byte aligned; status: int64
// [3] = (ok, written, consumed).  Bytes of `out` past `written` are left
// as they were.  One CTA; launches on `stream`; returns cudaGetLastError().
STPU_EXPORT int stpu_decode_stream(const uint8_t* in, int64_t n, int64_t m,
                                   uint8_t* out, int64_t* status,
                                   void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRingBytes);
  if (err != cudaSuccess) return (int)err;
  decode_stream_kernel<<<1, kStreamThreads, kRingBytes, (cudaStream_t)stream>>>(
      in, n, (uint64_t)m, out, status);
  return (int)cudaGetLastError();
}

#else  // CPU twin

#include <vector>

STPU_EXPORT int stpu_twin_decode_stream(const uint8_t* in, int64_t n,
                                        int64_t m, uint8_t* out,
                                        int64_t* status) {
  std::vector<uint8_t> ring(2 * stpu::kWin);
  stpu::StreamState st;
  stpu::stream_init(&st);
  for (;;) {
    const int more = stpu::stream_window(in, n, (uint64_t)m, ring.data(), out, &st, 0, 1);
    memcpy(out + st.win_start, ring.data() + (st.win_start & stpu::kRingMask),
           (size_t)(st.o - st.win_start));
    if (!more) break;
    st.win_start += stpu::kWin;
  }
  status[0] = !st.bad && st.i == n && st.o == (uint64_t)m;
  status[1] = (int64_t)st.o;
  status[2] = st.i;
  return 0;
}

#endif
