// Streaming raw-format decoder: the kernels behind
// snappy_tpu_torch.ops.decode_stream.decode_stream.
//
// Replaces the TPU kernel snappy_tpu/ops/decode_stream.py (_kernel_grid,
// launched by decode_raw_stream_grid and decode_raw_stream_bytes in grid
// mode): one raw tag stream of any size, in 64 KiB output windows.  It
// computes what grid mode computes: ok = no malformed tag, consumed ==
// comp_len and written == declared, with `written` the output produced
// before the first bad tag and `consumed` the input position of that tag
// (or of the stream's end).  The verdicts follow the sequential decoder
// (decoder.nim:20-155, snappy.nim:107-108), as the chunk decoder's do: the
// whole compressed stream lies in global memory, so every tag is validated
// against the stream's true input and output bounds before any of it is
// emitted.  Every legal copy offset is served, so the TPU's `unsupported`
// verdict never arises here.  Bytes of `out` past `written` are not kept:
// on the window route, windows after a failing one may have been written.
//
// What the TPU design needed and this one does not: 1024-word aligned comp
// slices with prefetch semaphores, a minimum-slice step budget and idle
// grid steps (a sequential grid stood in for a loop).
//
// Two routes, chosen on the host from the data before any launch:
//
// * The window route, when the host's block scan (host_codec.scan_raw_blocks)
//   gives the input offset of every 64 KiB output boundary: the stream's
//   tags fall on those boundaries, as in every stream of a block encoder.
//   Pass 1 launches one CTA per window.  It stages its window in 64 KiB of
//   dynamic shared memory (three CTAs fit on an SM); warp 0 walks the
//   window's tags from in_offs[k] with stream_window, the lanes emitting
//   each segment together (lanes_literal and lanes_copy of
//   snappy_common.cuh), and the whole CTA writes the window to its final
//   offset with 16-byte stores.  A legal copy that reaches before the
//   window's start stops the window as deferred: its source is another
//   window's output.  Pass 2, one CTA launched right after on the same
//   stream, finds in order the first window that failed or was deferred (a
//   parallel scan of the window records), decodes a deferred window again
//   with its earlier output read from `out`, where every earlier window is
//   final by then, and repeats until a window fails or none is left; then
//   it writes the status.  Because the tags fall on the offsets, each
//   window's checks are the sequential walk's checks at the same tags.
//   Bound on the H100: the per-tag latency of each window's dependent
//   parse, hidden by running the windows side by side (769 windows of the
//   48 MiB stream, three per SM), not removed; pass 2 is bound by its
//   one-warp walk, over the deferred windows only.
//
// * The whole-stream walk, when there is no index (a literal or copy
//   straddles a boundary, or the stream is malformed): one CTA keeps the
//   current window and the previous one in shared memory as a 128 KiB ring
//   and loops over the windows itself.  A literal or copy that crosses the
//   window's end is kept as a pending segment (its remaining length and its
//   source) and resumed in the next window.  Bound on the H100: the walk's
//   dependent parse of one tag after another, with no other CTA to hide it.
//
// The window and pending-segment logic is stream_window below,
// __host__ __device__, so the g++ twin runs it too (as one lane).
#include "snappy_common.cuh"

namespace stpu {

constexpr uint64_t kWin = 65536;           // output window
constexpr uint64_t kRingMask = 2 * kWin - 1;  // the walk's ring of two windows
constexpr uint64_t kWinMask = kWin - 1;       // a window route CTA's one window

// The window route's record of window k: rec[kRecWords * k + ...].
constexpr int kRecWords = 3;
enum { kRecConsumed = 0, kRecWritten = 1, kRecFlag = 2 };
enum { kWinDone = 0, kWinBad = 1, kWinDeferred = 2 };

// Walk state carried from one window to the next.
struct StreamState {
  int64_t i;           // input cursor: bytes consumed
  uint64_t o;          // output cursor: bytes produced
  uint64_t win_start;  // output offset of the current window
  uint64_t plen;       // pending segment: bytes still to emit (0: none)
  uint64_t psrc;       // pending literal: input offset; pending copy: offset
  int plit;            // pending segment is a literal
  int bad;             // a malformed tag stopped the walk
  int deferred;        // a copy reaching before the window stopped it
};

STPU_HD uint64_t min_u64(uint64_t a, uint64_t b) { return a < b ? a : b; }

// A copy of `take` bytes at offset `off` to output position o whose source
// starts before ring_lo: output positions before ring_lo are read from
// `flushed`, later ones from the ring.  Byte k is output byte
// o - off + (k mod off) when the copy repeats itself (off < take), else
// o - off + k: written before the copy began, so no lane waits on another.
STPU_HD void lanes_copy_flushed(uint8_t* ring, uint64_t mask, uint64_t o, uint64_t off,
                                uint64_t take, const uint8_t* flushed, uint64_t ring_lo,
                                uint32_t lane, uint32_t lanes) {
  const uint64_t s = o - off;
  for (uint64_t k = lane; k < take; k += lanes) {
    const uint64_t p = s + (off >= take ? k : k % off);
    ring[(o + k) & mask] = p < ring_lo ? flushed[p] : ring[p & mask];
  }
  STPU_SYNCWARP();
}

// Decode in[0, n) (declared length m) into the ring until the window that
// starts at shared->win_start is full or the walk ends.  Output position p
// lives at ring[p & mask] for p >= win_start - hist (the ring's history:
// kWin for the walk, 0 for a window of the window route); every position
// before the window start is also in `flushed` (global memory).  With
// `defer`, a legal copy reaching before the window start stops the walk at
// its tag and sets `deferred`.  `lanes` threads run it together, this one
// being `lane`: all of them walk the same tags, each writes the bytes
// k = lane, lane + lanes, ... of every segment, and lane 0 stores the
// state back.  Returns 1 when the window is full and more output follows
// (flush it, advance win_start by kWin, call again), 0 when the walk has
// ended (input exhausted, a malformed tag or a deferred copy).
STPU_HD int stream_window(const uint8_t* in, int64_t n, uint64_t m,
                          uint8_t* ring, uint64_t mask, uint64_t hist,
                          const uint8_t* flushed, int defer,
                          StreamState* shared, uint32_t lane, uint32_t lanes) {
  StreamState state = *shared;
  StreamState* st = &state;
  STPU_SYNCWARP();  // every lane has read the state before lane 0 stores it
  const uint64_t win_end = min_u64(st->win_start + kWin, m);
  const uint64_t ring_lo = st->win_start >= hist ? st->win_start - hist : 0;
  int64_t i = st->i;
  uint64_t o = st->o;
  int more = 0;
  for (;;) {
    if (st->plen) {  // emit (the rest of) the pending segment
      const uint64_t take = min_u64(st->plen, win_end - o);
      if (st->plit) {
        lanes_literal(ring, mask, o, in + st->psrc, take, lane, lanes);
        st->psrc += take;
      } else if (st->psrc <= o - ring_lo) {  // source in the ring
        lanes_copy(ring, mask, o, st->psrc, take, lane, lanes);
      } else {  // source starts in flushed output
        lanes_copy_flushed(ring, mask, o, st->psrc, take, flushed, ring_lo, lane, lanes);
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
      if (defer && t.offset > o - st->win_start) { st->deferred = 1; break; }
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
  st->deferred = 0;
}

// The state at the start of window k of the window route.  An offset
// outside the body marks the window bad before any read.
STPU_HD void window_init(StreamState* st, const int64_t* in_offs, int64_t k, int64_t n) {
  stream_init(st);
  st->i = in_offs[k];
  st->win_start = (uint64_t)k * kWin;
  st->o = st->win_start;
  if (st->i < 0 || st->i > n) {
    st->i = 0;
    st->bad = 1;
  }
}

// Record window k's walk: done when it filled its window and stopped on
// the next window's first tag (the last window: used up the input), else
// bad or deferred.
STPU_HD void window_record(int64_t* rec, const StreamState* st, const int64_t* in_offs,
                           int64_t k, int64_t nwin, int64_t n, uint64_t m) {
  const uint64_t win_end = min_u64(st->win_start + kWin, m);
  const int64_t next = k + 1 < nwin ? in_offs[k + 1] : n;
  int flag = kWinDone;
  if (st->deferred)
    flag = kWinDeferred;
  else if (st->bad || st->plen || st->o != win_end || st->i != next)
    flag = kWinBad;
  rec[kRecWords * k + kRecConsumed] = st->i;
  rec[kRecWords * k + kRecWritten] = (int64_t)st->o;
  rec[kRecWords * k + kRecFlag] = flag;
}

// The status from the first window `first` that failed (first == nwin:
// none did, and the last window's record is the stream's end).
STPU_HD void window_status(const int64_t* rec, int64_t first, int64_t nwin, int64_t n,
                           uint64_t m, int64_t redecoded, int64_t* status) {
  const int64_t k = first < nwin ? first : nwin - 1;
  const int64_t i = rec[kRecWords * k + kRecConsumed];
  const int64_t o = rec[kRecWords * k + kRecWritten];
  status[0] = first == nwin && i == n && (uint64_t)o == m;
  status[1] = o;
  status[2] = i;
  status[3] = redecoded;
}

}  // namespace stpu

#ifdef __CUDACC__

namespace {

constexpr int kStreamThreads = 256;
constexpr int kRingBytes = (int)(2 * stpu::kWin);
constexpr int kWindowThreads = 128;
constexpr int kOrderedThreads = 256;
constexpr int kWinBytes = (int)stpu::kWin;

// out[ws, ws + len) = src[0, len), by `threads` threads; ws is a multiple
// of 64 KiB and out 16-byte aligned, so the stores are 16 bytes wide.
__device__ void flush_window(uint8_t* out, uint64_t ws, const uint8_t* src, uint64_t len,
                             int threads) {
  uint8_t* dst = out + ws;
  const uint64_t vec = len / 16;
  for (uint64_t k = threadIdx.x; k < vec; k += threads)
    reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(src)[k];
  for (uint64_t k = vec * 16 + threadIdx.x; k < len; k += threads) dst[k] = src[k];
}

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
      const int more = stpu::stream_window(in, n, m, ring, stpu::kRingMask, stpu::kWin, out, 0,
                                           &st, threadIdx.x, 32);
      if (threadIdx.x == 0) s_more = more;
    }
    __syncthreads();
    // Read what the walk left before the barrier below: thread 0 changes
    // it again only after that barrier.
    const int more = s_more;
    const uint64_t ws = st.win_start;
    flush_window(out, ws, ring + (ws & stpu::kRingMask), st.o - ws, kStreamThreads);
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

// Pass 1 of the window route: CTA k decodes window k into shared memory,
// stopping at a copy that reaches before the window, and writes what it
// decoded to out and its record to rec.
__global__ void __launch_bounds__(kWindowThreads)
    decode_windows_kernel(const uint8_t* __restrict__ in, int64_t n, uint64_t m,
                          const int64_t* __restrict__ in_offs, int64_t nwin, uint8_t* out,
                          int64_t* __restrict__ rec) {
  extern __shared__ __align__(16) uint8_t win[];
  __shared__ stpu::StreamState st;
  const int64_t k = blockIdx.x;
  if (threadIdx.x == 0) stpu::window_init(&st, in_offs, k, n);
  __syncthreads();
  if (threadIdx.x < 32 && !st.bad)
    stpu::stream_window(in, n, m, win, stpu::kWinMask, 0, out, 1, &st, threadIdx.x, 32);
  __syncthreads();
  flush_window(out, st.win_start, win, st.o - st.win_start, kWindowThreads);
  if (threadIdx.x == 0) stpu::window_record(rec, &st, in_offs, k, nwin, n, m);
}

// Pass 2 of the window route, one CTA: in window order, the first window
// whose record is not done; a deferred one is decoded again (its sources
// before the window read from out, final by now) and the search goes on
// from it; a bad one, or none, gives the status.
__global__ void __launch_bounds__(kOrderedThreads)
    ordered_pass_kernel(const uint8_t* __restrict__ in, int64_t n, uint64_t m,
                        const int64_t* __restrict__ in_offs, int64_t nwin, uint8_t* out,
                        int64_t* rec, int64_t* __restrict__ status) {
  extern __shared__ __align__(16) uint8_t win[];
  __shared__ stpu::StreamState st;
  __shared__ int s_first;
  int64_t cur = 0, redecoded = 0;
  int first;
  for (;;) {
    if (threadIdx.x == 0) s_first = (int)nwin;
    __syncthreads();
    for (int64_t k = cur + threadIdx.x; k < nwin; k += kOrderedThreads) {
      if (rec[stpu::kRecWords * k + stpu::kRecFlag] != stpu::kWinDone) {
        atomicMin(&s_first, (int)k);
        break;  // this thread's later windows come after it
      }
    }
    __syncthreads();
    first = s_first;
    if (first == nwin || rec[stpu::kRecWords * first + stpu::kRecFlag] == stpu::kWinBad) break;
    if (threadIdx.x == 0) stpu::window_init(&st, in_offs, first, n);
    __syncthreads();
    if (threadIdx.x < 32)
      stpu::stream_window(in, n, m, win, stpu::kWinMask, 0, out, 0, &st, threadIdx.x, 32);
    __syncthreads();
    flush_window(out, st.win_start, win, st.o - st.win_start, kOrderedThreads);
    if (threadIdx.x == 0) stpu::window_record(rec, &st, in_offs, first, nwin, n, m);
    ++redecoded;
    cur = first;  // done now, or bad: the next search says which
    __syncthreads();  // the window and its record are visible to every thread
  }
  if (threadIdx.x == 0) stpu::window_status(rec, first, nwin, n, m, redecoded, status);
}

cudaError_t allow_shared(const void* kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// The whole-stream walk.  in: uint8 [n] one raw tag stream (no varint
// header), m: its declared length; out: uint8 with room for m bytes,
// 16-byte aligned; status: int64 [3] = (ok, written, consumed).  One
// CTA; launches on `stream`; returns cudaGetLastError().
STPU_EXPORT int stpu_decode_stream(const uint8_t* in, int64_t n, int64_t m,
                                   uint8_t* out, int64_t* status,
                                   void* stream) {
  cudaError_t err = allow_shared((const void*)decode_stream_kernel, kRingBytes);
  if (err != cudaSuccess) return (int)err;
  decode_stream_kernel<<<1, kStreamThreads, kRingBytes, (cudaStream_t)stream>>>(
      in, n, (uint64_t)m, out, status);
  return (int)cudaGetLastError();
}

// The window route.  As stpu_decode_stream, with in_offs: int64 [nwin + 1]
// the input offset of every 64 KiB output boundary (nwin >= 1 windows,
// in_offs[nwin] = n) and rec: int64 [3 * nwin] the window records;
// status: int64 [4], status[3] the number of windows pass 2 decoded.
// `passes` is 3 on the decode path: pass 1 (bit 0, nwin CTAs) and pass 2
// (bit 1, one CTA) launch on `stream` one after the other, with no host
// sync between; one bit alone times one pass (pass 2 reads the records
// that an earlier pass 1 left in rec).
STPU_EXPORT int stpu_decode_stream_windows(const uint8_t* in, int64_t n, int64_t m,
                                           const int64_t* in_offs, int64_t nwin,
                                           uint8_t* out, int64_t* status, int64_t* rec,
                                           int passes, void* stream) {
  cudaError_t err = allow_shared((const void*)decode_windows_kernel, kWinBytes);
  if (err == cudaSuccess) err = allow_shared((const void*)ordered_pass_kernel, kWinBytes);
  if (err != cudaSuccess) return (int)err;
  if (passes & 1) {
    decode_windows_kernel<<<(unsigned)nwin, kWindowThreads, kWinBytes, (cudaStream_t)stream>>>(
        in, n, (uint64_t)m, in_offs, nwin, out, rec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2)
    ordered_pass_kernel<<<1, kOrderedThreads, kWinBytes, (cudaStream_t)stream>>>(
        in, n, (uint64_t)m, in_offs, nwin, out, rec, status);
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
    const int more = stpu::stream_window(in, n, (uint64_t)m, ring.data(), stpu::kRingMask,
                                         stpu::kWin, out, 0, &st, 0, 1);
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

namespace {

// One window of the window route (pass 1 with defer, pass 2 without),
// then its flush and record, as one CTA of the kernels does it.
void twin_window(const uint8_t* in, int64_t n, uint64_t m, const int64_t* in_offs,
                 int64_t k, int64_t nwin, uint8_t* out, int64_t* rec, uint8_t* win,
                 int defer) {
  stpu::StreamState st;
  stpu::window_init(&st, in_offs, k, n);
  if (!st.bad) stpu::stream_window(in, n, m, win, stpu::kWinMask, 0, out, defer, &st, 0, 1);
  memcpy(out + st.win_start, win, (size_t)(st.o - st.win_start));
  stpu::window_record(rec, &st, in_offs, k, nwin, n, m);
}

}  // namespace

STPU_EXPORT int stpu_twin_decode_stream_windows(const uint8_t* in, int64_t n, int64_t m,
                                                const int64_t* in_offs, int64_t nwin,
                                                uint8_t* out, int64_t* status,
                                                int64_t* rec, int passes) {
  std::vector<uint8_t> win(stpu::kWin);
  // pass 1: every window, the last first, so that a window that read
  // another's output (which the card's CTAs may not have written yet)
  // would read it unwritten
  for (int64_t k = nwin - 1; k >= 0 && (passes & 1); --k)
    twin_window(in, n, (uint64_t)m, in_offs, k, nwin, out, rec, win.data(), 1);
  if (!(passes & 2)) return 0;
  int64_t first = 0, redecoded = 0;  // pass 2
  for (; first < nwin; ++first) {
    int64_t flag = rec[stpu::kRecWords * first + stpu::kRecFlag];
    if (flag == stpu::kWinDeferred) {
      twin_window(in, n, (uint64_t)m, in_offs, first, nwin, out, rec, win.data(), 0);
      ++redecoded;
      flag = rec[stpu::kRecWords * first + stpu::kRecFlag];
    }
    if (flag == stpu::kWinBad) break;
  }
  stpu::window_status(rec, first, nwin, n, (uint64_t)m, redecoded, status);
  return 0;
}

#endif
