// Scan-mode streaming raw decoder (K5): the kernel behind
// snappy_tpu_torch.ops.decode_stream.decode_stream_scan.
//
// Replaces the TPU kernel snappy_tpu/ops/decode_stream.py (_kernel,
// launched by _call_kernel inside the lax.scan of decode_raw_stream, and
// reached through decode_raw_stream_bytes(mode="scan")).  Each launch
// computes one step of that scan: at most one 64 KiB output window, from
// the comp window of 76,800 bytes at the word-aligned input cursor, with
// the 64 KiB of output before the window as its history.  It computes
// what the TPU kernel computes, including its verdicts: a copy that
// reaches more than 64 KiB behind the window start (at a tag start, or
// the split part of a copy that crosses the window's end) sets
// `unsupported`, although the bytes it would read lie in the output here.
//
// What the TPU design needed and this one does not: the output window and
// its history as packed SMEM words, realigned by a funnel shift after a
// ragged window, and a host-side compaction of the windows.  Here every
// window is written straight to its final offset in one flat output, so
// the history is the output itself and a copy reads out[o - offset].
//
// Design: one warp per launch, launched once per scan step on the
// caller's stream with no synchronisation between steps.  The scan state
// (input and output cursors, err, done, unsupported, the pending segment)
// lives in a small int64 tensor on the card that each launch reads and
// writes; a step that is no longer active returns at once, so the host
// launches a fixed count of steps (_n_steps) and reads the state once at
// the end.  The 32 lanes walk the same tags (broadcast byte loads from
// global memory) and emit each segment together with lanes_literal and
// lanes_copy of snappy_common.cuh, shared with K4.  scan_step is
// __host__ __device__, so the g++ twin runs it (as one lane).
//
// Bound on the H100: the walk's dependent parse of one tag after another,
// as K4's, plus a few microseconds of launch per step.
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

}  // namespace stpu

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(32)
    decode_stream_scan_kernel(const uint8_t* __restrict__ comp, int64_t n, int64_t declared,
                              uint8_t* out, int64_t* state, int64_t* written_k) {
  stpu::scan_step(comp, n, declared, out, state, written_k, threadIdx.x, 32);
}

}  // namespace

// comp: uint8 [n] one raw tag stream (no varint header); declared: its
// declared length; out: uint8 with room for `declared` bytes; state: int64
// [16], zero before the first step; writtens: int64 [steps].  One step:
// one warp; launches on `stream`; returns cudaGetLastError().
STPU_EXPORT int stpu_decode_stream_scan(const uint8_t* comp, int64_t n, int64_t declared,
                                        uint8_t* out, int64_t* state, int64_t* writtens,
                                        int64_t step, void* stream) {
  decode_stream_scan_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      comp, n, declared, out, state, writtens + step);
  return (int)cudaGetLastError();
}

#else  // CPU twin

STPU_EXPORT int stpu_twin_decode_stream_scan(const uint8_t* comp, int64_t n, int64_t declared,
                                             uint8_t* out, int64_t* state, int64_t* writtens,
                                             int64_t step) {
  stpu::scan_step(comp, n, declared, out, state, writtens + step, 0, 1);
  return 0;
}

#endif
