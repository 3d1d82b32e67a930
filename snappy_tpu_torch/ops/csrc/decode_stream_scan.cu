// Scan-mode streaming raw decoder (K5): the kernels behind
// snappy_tpu_torch.ops.decode_stream.decode_stream_scan.
//
// Replaces the TPU kernel snappy_tpu/ops/decode_stream.py (_kernel,
// launched by _call_kernel inside the lax.scan of decode_raw_stream, and
// reached through decode_raw_stream_bytes(mode="scan")).  A step of that
// scan fills at most one 64 KiB output window, from the comp window of
// 76,800 bytes at the word-aligned input cursor, with the 64 KiB of output
// before the window as its history.  K5 computes what the whole scan
// computes: the final state (16 int64 words), every step's window length
// and the output bytes, including its verdicts: a copy that reaches more
// than 64 KiB behind the window start (at a tag start, or the split part
// of a copy that crosses the window's end) sets `unsupported`, although
// the bytes it would read lie in the output here.
//
// What the TPU design needed and this one does not: the output window and
// its history as packed SMEM words, realigned by a funnel shift after a
// ragged window, a host-side compaction of the windows, and one kernel
// call per step.  Here every window is written straight to its final
// offset in one flat output, so the history is the output itself and a
// copy reads out[o - offset].
//
// The scan's step boundaries are a function of the stream: every step
// starts where the last one stopped.  For a stream whose tags fall on the
// 64 KiB output boundaries (every stream a block encoder writes), they
// are those boundaries, which the host's block scan locates
// (decode_stream.window_index).  Two launches on the caller's stream:
//
// * Pass 1, the bulk of K5's work, is K2's kernel (decode_chunks.cu, one
//   warp per chunk, reused as it is): window k of the index, input
//   in_offs[k] .. in_offs[k+1], decoded as one chunk of declared length
//   m_k = min(64 KiB, declared - 64 KiB * k) in place at out[64 KiB * k].
//   The wrapper launches it; there is no pass 1 without an index.
// * Pass 2, one CTA, decode_stream_scan_kernel below.  Window k is clean
//   when K2 decoded it ok (no malformed tag, input consumed exactly,
//   written == m_k, no copy before the window's start) and the scan's comp
//   window at in_offs[k] holds it without a MARGIN stop
//   (scan_window_clean).  A step that starts aligned on a clean window
//   (pos_total == in_offs[k], written_total == 64 KiB * k, nothing
//   pending, neither err nor done) parses the same tags and emits the
//   same bytes as K2, raises no far or bad copy (every offset is within
//   the window), and ends with w == m_k at in_offs[k+1]: its result is
//   written down without the walk (scan_apply_clean).  The CTA finds the
//   first window that breaks the clean prefix by a parallel search of the
//   flags (as K4's ordered pass finds its first failing window) and fills
//   the prefix's step lengths in parallel; from there warp 0 walks the
//   remaining steps in order (scan_walk): a step aligned on a clean
//   window takes its result, any other runs scan_step, its history read
//   from out, where every earlier window is final.  Without an index
//   every step is walked, in this one launch.
//
// scan_step, the clean-window rule and the walk are __host__ __device__,
// so the g++ twin runs them (as one lane).
//
// Bound on the H100: pass 1 is K2's, the dependent parse of each window's
// tags hidden by running the windows side by side; pass 2 is its launch
// and flag search where every window is clean, else the one-warp walk of
// the steps that are not, tag after tag from global memory.
#include "snappy_common.cuh"

namespace stpu {

constexpr int64_t kScanWin = 65536;   // output window (4 * OW_WORDS)
constexpr int64_t kScanComp = 76800;  // comp window (4 * SC_WORDS)
constexpr int64_t kScanMargin = 8;    // MARGIN
constexpr int64_t kInt32Max = 0x7FFFFFFF;

// The scan state, int64 [16] (the carry of decode_raw_stream).
enum : int {
  kSP = 0,      // pos_total: input bytes consumed
  kSW = 1,      // written_total: output bytes produced
  kSErr = 2,
  kSDone = 3,
  kSUnsup = 4,
  kSPk = 5,     // pending kind: 0 none / 1 literal / 2 copy
  kSPlen = 6,   // pending remaining length
  kSPoff = 7,   // pending copy offset
  kStateWords = 16,
};

// One scan step (decode_raw_stream's body and the kernel it calls) over
// the raw tag stream comp[0, n) with declared length `declared`, writing
// the window at out[written_total, ...) and the step's written length to
// *written_k.  `lanes` threads run it together, this one being `lane`;
// lane 0 stores the state back.
STPU_HD void scan_step(const uint8_t* comp, int64_t n, int64_t declared, uint8_t* out,
                       int64_t* state, int64_t* written_k, uint32_t lane, uint32_t lanes) {
  int64_t s[8];
  for (int k = 0; k < 8; ++k) s[k] = state[k];
  STPU_SYNCWARP();  // every lane has read the state before lane 0 stores it
  const int64_t m_raw = min_i64(kScanWin, declared - s[kSW]);
  if (s[kSDone] || s[kSErr] || (m_raw <= 0 && s[kSPk] <= 0)) {
    if (lane == 0) *written_k = 0;  // an idle step
    return;
  }
  // entry: the step's windows and budget
  const int64_t m = max_i64(m_raw, 0);
  const int64_t wb4 = s[kSP] & ~(int64_t)3;  // word-aligned comp window start
  const int64_t start = s[kSP] - wb4;
  const int64_t navail = min_i64(max_i64(n - wb4, 0), kScanComp);
  const bool more = wb4 + navail < n;
  const int64_t base_w = s[kSW];
  const uint8_t* win = comp + wb4;
  int64_t pk = s[kSPk], plen = s[kSPlen], poff = s[kSPoff];
  int64_t pos = start, w = 0;
  bool err = false, unsup = false;

  // the pending segment
  if (pk == 1) {
    const int64_t eff = max_i64(min_i64(plen, min_i64(m, navail - start)), 0);
    lanes_literal(out, ~0ull, base_w, win + start, eff, lane, lanes);
    pos = start + eff;
    w = eff;
    plen -= eff;
    pk = plen > 0 ? 1 : 0;
  } else if (pk == 2) {
    const int64_t eff = max_i64(min_i64(plen, m), 0);
    lanes_copy(out, ~0ull, base_w, poff, eff, lane, lanes);
    w = eff;
    plen -= eff;
    pk = plen > 0 ? 2 : 0;
  } else {
    pk = 0;
    plen = 0;
  }
  bool stop = pk > 0;

  // the tag loop
  while (pos < navail && !err && !stop && w < m && !(more && pos > navail - kScanMargin)) {
    const Tag t = parse_tag(win + pos, n - wb4 - pos);
    const bool lit = t.kind == 0;
    const int64_t len = (int64_t)t.len;
    const int64_t off = (int64_t)t.offset;
    // the TPU kernel's int32 limits: a literal length or an offset over
    // 2^31 - 1 is malformed
    bool bad = lit ? len > kInt32Max : off > kInt32Max;
    if (lit) {
      bad |= !more && pos + t.hdr + len > navail;  // truncated payload
    } else {
      bad |= pos + t.hdr > navail;
      bad |= off <= 0 || off > base_w + w;
    }
    const bool far = !lit && !bad && off > kScanWin + w;  // beyond the history
    bad |= far;
    unsup |= far;
    int64_t eff = min_i64(len, m - w);
    if (lit && more) eff = min_i64(eff, navail - (pos + t.hdr));
    eff = max_i64(eff, 0);
    const bool split = !bad && eff < len;
    if (!bad && eff > 0) {
      if (lit) {
        lanes_literal(out, ~0ull, base_w + w, win + pos + t.hdr, eff, lane, lanes);
      } else {
        lanes_copy(out, ~0ull, base_w + w, off, eff, lane, lanes);
      }
    }
    if (!bad) {
      pos += t.hdr + (lit ? eff : 0);
      w += eff;
    }
    pk = split ? (lit ? 1 : 2) : 0;
    plen = split ? len - eff : 0;
    if (split && !lit) poff = off;
    err |= bad;
    // the split part of a copy resumes at w = 0 of the next window, where
    // only 64 KiB of history is in reach
    unsup |= split && !lit && off > kScanWin;
    stop |= split;
  }

  // exit: the state for the next step
  if (lane == 0) {
    const bool done = !err && pos == navail && !more && pk == 0;
    state[kSP] = wb4 + pos;
    state[kSW] = base_w + w;
    state[kSErr] = err;
    state[kSDone] = done;
    state[kSUnsup] = s[kSUnsup] | (int64_t)unsup;
    state[kSPk] = pk;
    state[kSPlen] = plen;
    state[kSPoff] = poff;
    *written_k = w;
  }
}

// ---- the window route ----------------------------------------------------

// The window index and K2's verdict on each window (pass 1): window k is
// input in_offs[k] .. in_offs[k + 1]; nwin == 0 is no index.
struct ScanIndex {
  const int64_t* in_offs;
  int64_t nwin;
  const uint8_t* ok;
  const int32_t* written;
};

// State word kScanWalked of the kernel's state buffer (int64 [17]): the
// steps that pass 2 ran through scan_step.
constexpr int kScanWalked = kStateWords;

// Output window k's length, m_k.
STPU_HD int64_t scan_window_len(int64_t declared, int64_t k) {
  return min_i64(kScanWin, declared - kScanWin * k);
}

// Window k is clean: K2 decoded it ok to exactly m_k bytes, and the
// scan's comp window at in_offs[k] holds its input with no MARGIN stop and
// no split literal: all of it, or its end at least MARGIN bytes before
// the comp window's end.
STPU_HD bool scan_window_clean(const ScanIndex& ix, int64_t k, int64_t n, int64_t declared) {
  if (!ix.ok[k] || (int64_t)ix.written[k] != scan_window_len(declared, k)) return false;
  const int64_t wb4 = ix.in_offs[k] & ~(int64_t)3;
  const int64_t navail = min_i64(max_i64(n - wb4, 0), kScanComp);
  return !(wb4 + navail < n) || ix.in_offs[k + 1] - wb4 <= navail - kScanMargin;
}

// scan_step's `done` after the step of clean window k: the step used up
// the stream (its comp window then reaches the stream's end: `more` is
// false).  It is set even when the output falls short of `declared`, as
// the scan sets it.
STPU_HD bool scan_window_done(const ScanIndex& ix, int64_t k, int64_t n) {
  return ix.in_offs[k + 1] == n;
}

// Whether the clean prefix (steps 0, 1, ... taking windows 0, 1, ... from
// the zero state) ends at window k: window k is not clean, or window 0
// does not start at input 0.  A window after one whose step sets done has
// no input and is never clean.
STPU_HD bool scan_prefix_breaks(const ScanIndex& ix, int64_t k, int64_t n, int64_t declared) {
  return (k == 0 && ix.in_offs[0] != 0) || !scan_window_clean(ix, k, n, declared);
}

// The state after the clean prefix of windows 0 .. first - 1, from zero.
STPU_HD void scan_prefix_state(const ScanIndex& ix, int64_t first, int64_t n, int64_t declared,
                               int64_t* state) {
  for (int k = 0; k < kStateWords; ++k) state[k] = 0;
  if (first == 0) return;
  state[kSP] = ix.in_offs[first];
  state[kSW] = min_i64(kScanWin * first, declared);
  state[kSDone] = scan_window_done(ix, first - 1, n);
}

// The clean window that the state sits aligned on, or -1.  The caller has
// checked that neither err nor done is set.
STPU_HD int64_t scan_aligned_window(const ScanIndex& ix, const int64_t* s, int64_t n,
                                    int64_t declared) {
  if (ix.nwin == 0 || s[kSPk] != 0 || s[kSW] % kScanWin != 0) return -1;
  const int64_t k = s[kSW] / kScanWin;
  if (k >= ix.nwin || s[kSP] != ix.in_offs[k]) return -1;
  return scan_window_clean(ix, k, n, declared) ? k : -1;
}

// The result of the step aligned on clean window k: what scan_step
// computes (err, unsupported and the pending copy's offset stay), without
// the walk.
STPU_HD void scan_apply_clean(const ScanIndex& ix, int64_t k, int64_t n, int64_t declared,
                              int64_t* state, int64_t* written_k) {
  const int64_t m = scan_window_len(declared, k);
  state[kSP] = ix.in_offs[k + 1];
  state[kSW] += m;
  state[kSDone] = scan_window_done(ix, k, n);
  state[kSPk] = 0;
  state[kSPlen] = 0;
  *written_k = m;
}

// Whether every step from this state on is idle (scan_step's first test):
// done, err, or the declared output reached with nothing pending.
STPU_HD bool scan_stopped(const int64_t* s, int64_t declared) {
  return s[kSDone] || s[kSErr] || (declared - s[kSW] <= 0 && s[kSPk] <= 0);
}

// Steps s0 .. steps - 1 in order from `state`, as `lanes` threads (this
// one `lane`): a step aligned on a clean window takes its result, any
// other runs scan_step over `out`, where every output byte before the step
// is final.  Stops where every later step would be idle.  Returns the step
// it stopped at; *walked counts the steps run through scan_step.
STPU_HD int64_t scan_walk(const uint8_t* comp, int64_t n, int64_t declared, uint8_t* out,
                          int64_t* state, int64_t* writtens, int64_t s0, int64_t steps,
                          const ScanIndex& ix, int64_t* walked, uint32_t lane, uint32_t lanes) {
  int64_t s = s0;
  for (; s < steps && !scan_stopped(state, declared); ++s) {
    const int64_t k = scan_aligned_window(ix, state, n, declared);
    if (k >= 0) {
      STPU_SYNCWARP();  // every lane has read the state before lane 0 stores it
      if (lane == 0) scan_apply_clean(ix, k, n, declared, state, writtens + s);
    } else {
      scan_step(comp, n, declared, out, state, writtens + s, lane, lanes);
      ++*walked;
    }
    STPU_SYNCWARP();  // lane 0's state is visible to every lane
  }
  return s;
}

}  // namespace stpu

#ifdef __CUDACC__

namespace {

constexpr int kScanThreads = 256;

// Pass 2, one CTA: the clean prefix by a parallel search and fill, then
// warp 0 walks the rest; the state (16 words and the walked count) goes
// to state_out, and the steps after the walk's stop get length 0.
__global__ void __launch_bounds__(kScanThreads)
    decode_stream_scan_kernel(const uint8_t* __restrict__ comp, int64_t n, int64_t declared,
                              uint8_t* out, int64_t* __restrict__ state_out,
                              int64_t* __restrict__ writtens, int64_t steps, stpu::ScanIndex ix) {
  __shared__ int64_t st[stpu::kStateWords];
  __shared__ int s_first;
  __shared__ int64_t s_stop, s_walked;
  const int tid = threadIdx.x;
  if (tid == 0) s_first = (int)stpu::min_i64(ix.nwin, steps);
  __syncthreads();
  for (int64_t k = tid; k < ix.nwin; k += kScanThreads) {
    if (stpu::scan_prefix_breaks(ix, k, n, declared)) {
      atomicMin(&s_first, (int)k);
      break;  // this thread's later windows come after it
    }
  }
  __syncthreads();
  const int64_t first = s_first;
  for (int64_t k = tid; k < first; k += kScanThreads)
    writtens[k] = stpu::scan_window_len(declared, k);
  if (tid == 0) stpu::scan_prefix_state(ix, first, n, declared, st);
  __syncthreads();
  if (tid < 32) {
    int64_t walked = 0;
    const int64_t stop = stpu::scan_walk(comp, n, declared, out, st, writtens, first, steps, ix,
                                         &walked, tid, 32);
    if (tid == 0) {
      s_stop = stop;
      s_walked = walked;
    }
  }
  __syncthreads();
  for (int64_t s = s_stop + tid; s < steps; s += kScanThreads) writtens[s] = 0;
  if (tid < stpu::kStateWords) state_out[tid] = st[tid];
  if (tid == 0) state_out[stpu::kScanWalked] = s_walked;
}

}  // namespace

// comp: uint8 [n] one raw tag stream (no varint header); declared: its
// declared length; out: uint8 with room for max(declared, 64 KiB * nwin)
// bytes; state: int64 [17], the final scan state and the walked steps;
// writtens: int64 [steps], every step's window length.  in_offs: int64
// [nwin + 1] the window index, ok / written: uint8 / int32 [nwin] K2's
// verdicts from pass 1 (nwin == 0, null pointers: no index).  Pass 2 as
// one CTA; launches on `stream`; returns cudaGetLastError().
STPU_EXPORT int stpu_decode_stream_scan(const uint8_t* comp, int64_t n, int64_t declared,
                                        uint8_t* out, int64_t* state, int64_t* writtens,
                                        int64_t steps, const int64_t* in_offs, int64_t nwin,
                                        const uint8_t* ok, const int32_t* written,
                                        void* stream) {
  decode_stream_scan_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
      comp, n, declared, out, state, writtens, steps, stpu::ScanIndex{in_offs, nwin, ok, written});
  return (int)cudaGetLastError();
}

#else  // CPU twin: pass 2, its flag search in window order

STPU_EXPORT int stpu_twin_decode_stream_scan(const uint8_t* comp, int64_t n, int64_t declared,
                                             uint8_t* out, int64_t* state, int64_t* writtens,
                                             int64_t steps, const int64_t* in_offs, int64_t nwin,
                                             const uint8_t* ok, const int32_t* written) {
  const stpu::ScanIndex ix = {in_offs, nwin, ok, written};
  const int64_t search = stpu::min_i64(nwin, steps);
  int64_t first = 0;
  while (first < search && !stpu::scan_prefix_breaks(ix, first, n, declared)) ++first;
  for (int64_t k = 0; k < first; ++k) writtens[k] = stpu::scan_window_len(declared, k);
  int64_t st[stpu::kStateWords];
  stpu::scan_prefix_state(ix, first, n, declared, st);
  int64_t walked = 0;
  const int64_t stop =
      stpu::scan_walk(comp, n, declared, out, st, writtens, first, steps, ix, &walked, 0, 1);
  for (int64_t s = stop; s < steps; ++s) writtens[s] = 0;
  memcpy(state, st, sizeof st);
  state[stpu::kScanWalked] = walked;
  return 0;
}

#endif
