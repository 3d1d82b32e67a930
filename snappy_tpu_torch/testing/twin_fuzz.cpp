// Coverage-guided fuzzer of the kernels' CPU twins against the host C codec.
//
// The port's counterpart of ops/native/fuzz_driver.c, aimed at the kernels:
// the six sources of ops/csrc compiled by g++ (the twin: the same
// __host__ __device__ bodies and 32-lane warp code that run on the card)
// with -fsanitize=address,undefined -fsanitize-coverage=trace-pc, this file
// and the host C (ops/native/*.c, the oracle) with the sanitizers and
// without trace-pc.  testing/sanitize.py builds it, lanes up and lanes down
// (-DSTPU_TWIN_REVERSE_LANES), and runs it:
//
//     twin_fuzz CONSTS [corpus files...]
//
// CONSTS holds K1's slicing and advance tables and K6's constants, uint32
// little-endian, as ops/crc32c.py and ops/crc32c_mma.py make them.  The
// loop is fuzz_driver.c's: an AFL-style edge map in
// __sanitizer_cov_trace_pc, and an input that lights a new edge joins the
// corpus.  FUZZ_ITERS is the budget, FUZZ_SEED the mutation seed,
// FUZZ_CRASH the file that receives the input at fault.  The seeds are the
// files, and the level-1 and level-2 raw encodings of each that is not a
// raw stream the host decoder accepts.
//
// Each input is a varint declared length and a raw tag stream, packed and
// passed as each wrapper's _launch does, in buffers of exactly the size it
// gives them (so that ASan sees a byte past their end):
//   - K2 at W = 64 KiB and 128 KiB (decode_chunks._launch), one row;
//   - K4's walk (decode_stream._launch) and, where the host block scan
//     gives the index, its window route (_launch_windows);
//   - K5 without the index and on its window route, K2 over the windows
//     then pass 2 (decode_stream._launch_scan);
//   - K3 at ways 1 and 2 on the last block of the decoded bytes (where the
//     host accepts the stream) and on the first of the input's own bytes;
//   - K1 on the input as one row and on its 64 KiB pieces and on those of
//     the decoded bytes, and K6 on the first of these (every 8th input).
// The comparisons, each kernel's contract as its plain version states it:
// K2's and K4's verdict is the host decoder's (ok, and written equal to
// the declared length) and their output its bytes where it accepts; K2
// and both K4 routes agree on written (and the K4 routes on consumed) and
// on the bytes up to it, and K2 zero-fills its row past it; both K5
// routes give the same 16 state words, step lengths and bytes up to
// written; K5's ok implies the host's and its bytes, its "invalid"
// (neither ok nor unsupported) the host's refusal but for a declared
// length of 0, which the scan never finishes, and "unsupported" a
// declared length past 64 KiB; K3 gives the host C encoder's bytes, K1 and
// K6 the host C CRC.  A divergence writes the input to FUZZ_CRASH and
// aborts; a sanitizer report does the same through the death callback.
#include <sanitizer/common_interface_defs.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <vector>

extern "C" {
// the twins (ops/csrc/*.cu): the kernels' entry points without the stream
int stpu_twin_decode_chunks(const uint8_t* comp, const int64_t* offsets, const int32_t* declared,
                            int n, uint8_t* out, int64_t out_cols, uint8_t* ok, int32_t* written);
int stpu_twin_decode_stream(const uint8_t* in, int64_t n, int64_t m, uint8_t* out,
                            int64_t* status);
int stpu_twin_decode_stream_windows(const uint8_t* in, int64_t n, int64_t m,
                                    const int64_t* in_offs, int64_t nwin, uint8_t* out,
                                    int64_t* status, int64_t* rec, int passes);
int stpu_twin_decode_stream_scan(const uint8_t* comp, int64_t n, int64_t declared, uint8_t* out,
                                 int64_t* state, int64_t* writtens, int64_t steps,
                                 const int64_t* in_offs, int64_t nwin, const uint8_t* ok,
                                 const int32_t* written);
int stpu_twin_encode_blocks(const uint8_t* blocks, int64_t in_stride, const int32_t* lens, int n,
                            uint8_t* out, int64_t out_stride, int32_t* out_len, int ways);
int stpu_twin_crc32c_chunks(const uint8_t* chunks, int64_t stride, const int32_t* lengths, int n,
                            int64_t nt_max, const uint32_t* tables, const uint32_t* adv,
                            uint32_t* tile_regs, uint32_t* out);
int stpu_twin_crc32c_mma(const uint8_t* chunks, const int32_t* lengths, int n,
                         const uint32_t* consts, uint32_t* out);
void stpu_crc32c_mma_params(int64_t* params);
// the host C (ops/native/*.c): the oracle
int stpu_decode_tags(const uint8_t* in, size_t n, uint8_t* out, size_t out_len, size_t* written);
uint32_t stpu_encode_block(const uint8_t* in, uint32_t n, uint8_t* out, uint16_t* table);
uint32_t stpu_encode_block_l2(const uint8_t* in, uint32_t n, uint8_t* out, uint16_t* table);
size_t stpu_encode_span_level(const uint8_t* in, size_t n, uint8_t* out, int level);
long stpu_raw_scan_blocks(const uint8_t* in, size_t n, size_t out_len, int64_t* in_offs, long cap);
uint32_t snappy_tpu_masked_crc32c(const uint8_t* buf, size_t len);
}

// The decoder that the kernels are held against; a build may name another
// (the tests plant a wrong one to show that the comparisons bite).
#ifndef STPU_FUZZ_ORACLE_DECODE
#define STPU_FUZZ_ORACLE_DECODE stpu_decode_tags
#else
extern "C" int STPU_FUZZ_ORACLE_DECODE(const uint8_t* in, size_t n, uint8_t* out, size_t out_len,
                                       size_t* written);
#endif

namespace {

constexpr int64_t kWin = 65536;          // K4's and K5's window, K2's chunk shape
constexpr int64_t kBig = 131072;         // K2's big-window shape
constexpr int64_t kScBytes = 76800;      // K5's comp window (decode_stream.SC_BYTES)
constexpr int64_t kEncCap = 76490 + 16;  // encode_blocks.ENC_CAP: max_compressed_len(65536) + 16
constexpr size_t kMaxInput = 256u << 10;
constexpr uint32_t kOutCap = 1u << 20;
constexpr int kMaxEntries = 4096;
enum { S_POS, S_WRITTEN, S_ERR, S_DONE, S_UNSUP };  // decode_stream.S_*
constexpr int kStateWords = 17;                     // decode_stream.STATE_WORDS + 1

// ---- edge map (fuzz_driver.c's AFL-style prev-pc xor hash) ----
constexpr uint32_t kMapSize = 1u << 16;
uint8_t cov_map[kMapSize];
uint64_t cov_count = 0, run_new = 0;
uintptr_t prev_pc = 0;

// ---- the input at work, for the crash file ----
const uint8_t* cur_data = nullptr;
size_t cur_len = 0;

void write_crash() {
  const char* path = getenv("FUZZ_CRASH");
  FILE* f = fopen(path && *path ? path : "twin_fuzz_crash.bin", "wb");
  if (!f) return;
  if (cur_len) fwrite(cur_data, 1, cur_len, f);
  fclose(f);
}

[[noreturn]] void diverge(const char* what) {
  fprintf(stderr, "twin fuzz: divergence: %s (input of %zu bytes)\n", what, cur_len);
  write_crash();
  abort();
}

#define EXPECT(cond, what) \
  do {                     \
    if (!(cond)) diverge(what); \
  } while (0)

// A buffer of exactly n bytes (ASan flags a byte past its end), freed on scope exit.
template <class T>
struct Exact {
  T* p;
  explicit Exact(size_t n) : p(static_cast<T*>(malloc(n * sizeof(T) ? n * sizeof(T) : 1))) {}
  ~Exact() { free(p); }
  Exact(const Exact&) = delete;
  Exact& operator=(const Exact&) = delete;
};

// ---- K1's tables and K6's constants ----
std::vector<uint32_t> crc_tables, crc_adv, mma_consts;

bool load_consts(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  std::vector<uint32_t> all;
  uint32_t w;
  while (fread(&w, 4, 1, f) == 1) all.push_back(w);
  fclose(f);
  int64_t params[8];
  stpu_crc32c_mma_params(params);
  const size_t nt = 4 * 256, na = 32 * 4 * 256;
  if (all.size() != nt + na + (size_t)params[6]) return false;
  crc_tables.assign(all.begin(), all.begin() + nt);
  crc_adv.assign(all.begin() + nt, all.begin() + nt + na);
  mma_consts.assign(all.begin() + nt + na, all.end());
  return true;
}

// K6's walk does the same work for any bytes of a chunk (only the length
// steers it), and is the slowest twin: it runs on every kMmaEvery-th input.
constexpr long kMmaEvery = 8;
long runs = 0;
bool mma_turn = false;

// ---- what the inputs reached ----
struct Reach {
  long inputs, accepted, k2, k2_big, walk, windows, deferred, scan_windows, unsupported, k3_blocks,
      k1_rows, k6_rows;
} reach;

int64_t n_steps(int64_t comp_len, int64_t declared) {  // decode_stream.n_steps
  const int64_t need = (declared + kWin - 1) / kWin + (comp_len + kScBytes - 257) / (kScBytes - 256) + 2;
  for (int64_t b : {4, 16, 64, 256})
    if (need <= b) return b;
  return (need + 255) / 256 * 256;
}

// K1 on the rows (stride, lengths) of one exact buffer against the host C
// CRC, and K6 where `mma` (rows of 65536 bytes, zero past each length).
void crcs(const uint8_t* rows, int64_t stride, const std::vector<int32_t>& lens, bool mma) {
  const int n = (int)lens.size();
  if (n == 0) return;
  int32_t max_len = 0;
  for (int32_t l : lens) max_len = l > max_len ? l : max_len;
  const int64_t nt = max_len > kWin ? (max_len + kWin - 1) / kWin : 1;
  Exact<int32_t> lengths(n);
  memcpy(lengths.p, lens.data(), 4 * n);
  Exact<uint32_t> out(n);
  Exact<uint32_t> tile_regs(nt > 1 ? n * nt : 0);  // crc32c._launch: out serves where nt is 1
  EXPECT(stpu_twin_crc32c_chunks(rows, stride, lengths.p, n, nt, crc_tables.data(), crc_adv.data(),
                                 nt > 1 ? tile_regs.p : out.p, out.p) == 0,
         "K1 refused");
  for (int r = 0; r < n; ++r)
    EXPECT(out.p[r] == snappy_tpu_masked_crc32c(rows + r * stride, lens[r]), "K1 CRC");
  reach.k1_rows += n;
  if (!mma) return;
  Exact<uint32_t> mout(n);
  EXPECT(stpu_twin_crc32c_mma(rows, lengths.p, n, mma_consts.data(), mout.p) == 0, "K6 refused");
  for (int r = 0; r < n; ++r) EXPECT(mout.p[r] == out.p[r], "K6 CRC");
  reach.k6_rows += n;
}

// K1 on the 64 KiB pieces of data as rows of 65536 bytes, zero past each
// length; then, where `mma`, K1 and K6 on the first piece alone.
void crc_pieces(const uint8_t* data, size_t n, bool mma) {
  const size_t rows = (n + kWin - 1) / kWin;
  Exact<uint8_t> buf(rows * kWin);
  memset(buf.p, 0, rows * kWin);
  std::vector<int32_t> lens;
  for (size_t r = 0; r < rows; ++r) {
    const size_t len = n - r * kWin < (size_t)kWin ? n - r * kWin : kWin;
    memcpy(buf.p + r * kWin, data + r * kWin, len);
    lens.push_back((int32_t)len);
  }
  crcs(buf.p, kWin, lens, false);
  if (mma && rows) crcs(buf.p, kWin, {lens[0]}, true);
}

// K3 at both levels on the block of at most 64 KiB at data + pos, in a
// buffer of the block's own size, against the host C encoder.
void encode_block(const uint8_t* data, size_t n, size_t pos) {
  std::vector<uint16_t> table(2 << 14);
  const int32_t len = (int32_t)(n - pos < (size_t)kWin ? n - pos : kWin);
  Exact<uint8_t> block(len);
  memcpy(block.p, data + pos, len);
  for (int ways = 1; ways <= 2; ++ways) {
    Exact<uint8_t> enc(kEncCap);
    Exact<int32_t> enc_len(1);
    EXPECT(stpu_twin_encode_blocks(block.p, len, &len, 1, enc.p, kEncCap, enc_len.p, ways) == 0,
           "K3 refused");
    Exact<uint8_t> want(kEncCap);
    const uint32_t wl = ways == 1 ? stpu_encode_block(block.p, len, want.p, table.data())
                                  : stpu_encode_block_l2(block.p, len, want.p, table.data());
    EXPECT((uint32_t)*enc_len.p == wl && memcmp(enc.p, want.p, wl) == 0,
           ways == 1 ? "K3 ways=1 bytes" : "K3 ways=2 bytes");
  }
  ++reach.k3_blocks;
}

int read_varint(const uint8_t* p, size_t n, uint32_t* val, size_t* used) {
  uint64_t v = 0;
  for (size_t i = 0; i < n && i < 5; i++) {
    v |= (uint64_t)(p[i] & 0x7f) << (7 * i);
    if (!(p[i] & 0x80)) {
      if (v >> 32) return -1;
      *val = (uint32_t)v;
      *used = i + 1;
      return 0;
    }
  }
  return -1;
}

void decodes(const uint8_t* data, size_t n) {
  uint32_t m32;
  size_t used;
  if (read_varint(data, n, &m32, &used) != 0 || m32 > kOutCap) return;
  const int64_t m = m32, bn = (int64_t)(n - used);
  ++reach.inputs;
  // the body at the end of a buffer that starts up to 15 bytes before it
  // (K2 and K4 read any alignment): a read past the body's end is past the buffer's
  const size_t pad = n % 16;
  Exact<uint8_t> cbuf(pad + bn);
  memcpy(cbuf.p + pad, data + used, bn);
  const uint8_t* comp = cbuf.p + pad;

  Exact<uint8_t> host(m);
  size_t hw = 0;
  const bool host_ok = STPU_FUZZ_ORACLE_DECODE(comp, bn, host.p, m, &hw) == 0 && (int64_t)hw == m;
  reach.accepted += host_ok;

  // K4's walk: the sequential verdict, written and consumed of the others
  Exact<uint8_t> wout(m ? m : 1);
  Exact<int64_t> wst(3);
  EXPECT(stpu_twin_decode_stream(comp, bn, m, wout.p, wst.p) == 0, "K4 walk refused");
  ++reach.walk;
  const bool ok = wst.p[0] != 0;
  const int64_t written = wst.p[1];
  EXPECT(ok == host_ok, "K4 walk verdict");
  EXPECT(!ok || memcmp(wout.p, host.p, m) == 0, "K4 walk bytes");
  EXPECT(written >= 0 && written <= m && wst.p[2] >= 0 && wst.p[2] <= bn, "K4 walk status range");

  // K2 at both shapes, one row: verdict, written, bytes, zeros past written
  for (int64_t width : {kWin, kBig}) {
    if (m > width) continue;
    const int64_t offs[2] = {0, bn};
    Exact<int64_t> offsets(2);
    memcpy(offsets.p, offs, sizeof offs);
    Exact<int32_t> decl(1);
    *decl.p = (int32_t)m;
    Exact<uint8_t> row(width), k_ok(1);
    Exact<int32_t> k_w(1);
    EXPECT(stpu_twin_decode_chunks(comp, offsets.p, decl.p, 1, row.p, width, k_ok.p, k_w.p) == 0,
           "K2 refused");
    const bool big = width == kBig;
    EXPECT((*k_ok.p != 0) == ok, big ? "K2 W=131072 verdict" : "K2 W=65536 verdict");
    EXPECT(*k_w.p == written, big ? "K2 W=131072 written" : "K2 W=65536 written");
    EXPECT(memcmp(row.p, wout.p, written) == 0, big ? "K2 W=131072 bytes" : "K2 W=65536 bytes");
    for (int64_t q = written; q < width; ++q)
      EXPECT(row.p[q] == 0, big ? "K2 W=131072 zeros" : "K2 W=65536 zeros");
    ++(big ? reach.k2_big : reach.k2);
  }

  // the window index, as decode_stream.window_index takes it
  const int64_t nwin = (m + kWin - 1) / kWin;
  std::vector<int64_t> index(nwin + 2);
  const long nseg = m > 0 ? stpu_raw_scan_blocks(comp, bn, m, index.data(), (long)(m / kWin + 2)) : -1;
  const bool routed = nseg >= 1 && nseg == nwin;
  Exact<int64_t> in_offs(routed ? nwin + 1 : 0);
  if (routed) {
    memcpy(in_offs.p, index.data(), 8 * (nwin + 1));
    Exact<uint8_t> out(m);
    Exact<int64_t> st(4), rec(3 * nwin);
    EXPECT(stpu_twin_decode_stream_windows(comp, bn, m, in_offs.p, nwin, out.p, st.p, rec.p, 3) == 0,
           "K4 windows refused");
    EXPECT(st.p[0] == wst.p[0] && st.p[1] == written && st.p[2] == wst.p[2],
           "K4 window route status");
    EXPECT(memcmp(out.p, wout.p, written) == 0, "K4 window route bytes");
    ++reach.windows;
    reach.deferred += st.p[3] > 0;
  }

  // K5 without the index, then on its window route: the same scan
  const int64_t steps = n_steps(bn, m);
  Exact<uint8_t> sout(m ? m : 1);
  Exact<int64_t> sst(kStateWords), swr(steps);
  EXPECT(stpu_twin_decode_stream_scan(comp, bn, m, sout.p, sst.p, swr.p, steps, nullptr, 0, nullptr,
                                      nullptr) == 0,
         "K5 refused");
  const int64_t* s = sst.p;
  const int64_t sw = s[S_WRITTEN];
  const bool s_ok = s[S_DONE] && !s[S_ERR] && !s[S_UNSUP] && sw == m && s[S_POS] == bn;
  EXPECT(sw >= 0 && sw <= m, "K5 written range");
  EXPECT(!s_ok || (host_ok && memcmp(sout.p, host.p, m) == 0), "K5 accepts what the host refuses");
  // a scan step runs only while output remains (or a copy is pending), so
  // the scan never finishes a stream that declares 0 bytes: K5 says
  // "invalid" for the empty stream the host accepts, as the TPU kernel and
  // snappy_tpu's decode_raw_stream_bytes do (no engine route sends it there)
  EXPECT(s_ok || s[S_UNSUP] || !host_ok || m == 0, "K5 refuses what the host accepts");
  EXPECT(!s_ok || m > 0, "K5 finishes a stream that declares 0 bytes");
  EXPECT(!s[S_UNSUP] || m > kWin, "K5 unsupported within the first window");
  reach.unsupported += s[S_UNSUP] != 0;
  if (routed) {
    const int64_t cap = m > nwin * kWin ? m : nwin * kWin;
    Exact<uint8_t> out(cap);
    Exact<int32_t> lens(nwin), k_w(nwin);
    Exact<uint8_t> k_ok(nwin);
    for (int64_t k = 0; k < nwin; ++k) lens.p[k] = (int32_t)(m - k * kWin < kWin ? m - k * kWin : kWin);
    EXPECT(stpu_twin_decode_chunks(comp, in_offs.p, lens.p, (int)nwin, out.p, kWin, k_ok.p, k_w.p) == 0,
           "K5 pass 1 refused");
    Exact<int64_t> st(kStateWords), wr(steps);
    EXPECT(stpu_twin_decode_stream_scan(comp, bn, m, out.p, st.p, wr.p, steps, in_offs.p, nwin,
                                        k_ok.p, k_w.p) == 0,
           "K5 pass 2 refused");
    EXPECT(memcmp(st.p, sst.p, 8 * (kStateWords - 1)) == 0, "K5 window route state");
    EXPECT(memcmp(wr.p, swr.p, 8 * steps) == 0, "K5 window route step lengths");
    EXPECT(memcmp(out.p, sout.p, sw) == 0, "K5 window route bytes");
    ++reach.scan_windows;
  }

  if (host_ok && m > 0) {
    encode_block(host.p, m, (m - 1) / kWin * kWin);  // the last block: its length varies
    crc_pieces(host.p, m, mma_turn);
  }
}

void run_one(const uint8_t* data, size_t n) {
  cur_data = data;
  cur_len = n;
  mma_turn = ++runs % kMmaEvery == 0;
  decodes(data, n);
  encode_block(data, n, 0);
  // K1 on the input as one row (several tiles past 64 KiB), at the end of its buffer
  const size_t pad = (n / 16) % 16;
  Exact<uint8_t> row(pad + n);
  memcpy(row.p + pad, data, n);
  crcs(row.p + pad, (int64_t)n, {(int32_t)n}, false);
  crc_pieces(data, n, false);
}

// ---- corpus and mutations (fuzz_driver.c's) ----
uint8_t* corpus_buf[kMaxEntries];
size_t corpus_len[kMaxEntries];
int corpus_n = 0;

void corpus_add(const uint8_t* d, size_t n) {
  if (corpus_n >= kMaxEntries || n == 0 || n > kMaxInput) return;
  uint8_t* copy = static_cast<uint8_t*>(malloc(n));
  memcpy(copy, d, n);
  corpus_buf[corpus_n] = copy;
  corpus_len[corpus_n++] = n;
}

uint64_t rng_state = 0x243f6a8885a308d3ull;
uint64_t xrand() {
  uint64_t x = rng_state;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  return rng_state = x;
}

// The varint header of buf rewritten to declare m bytes; the new length.
size_t redeclare(uint8_t* buf, size_t n, size_t cap, uint32_t m) {
  uint32_t old;
  size_t used;
  if (read_varint(buf, n, &old, &used) != 0) used = 0;
  uint8_t hdr[5];
  size_t hl = 0;
  for (uint32_t v = m;; v >>= 7) {
    hdr[hl++] = (uint8_t)(v >= 0x80 ? (v | 0x80) : v);
    if (v < 0x80) break;
  }
  if (n - used + hl > cap) return n;
  memmove(buf + hl, buf + used, n - used);
  memcpy(buf, hdr, hl);
  return n - used + hl;
}

size_t mutate(uint8_t* buf, size_t n, size_t cap) {
  const int rounds = 1 + (int)(xrand() % 4);
  for (int r = 0; r < rounds; r++) {
    switch (xrand() % 9) {
      case 7: {  // declare another length: a little more or less, or a window more or less
        uint32_t m;
        size_t used;
        if (read_varint(buf, n, &m, &used) == 0) {
          const int64_t d = xrand() & 1 ? (int64_t)(xrand() % 33) - 16
                                        : ((xrand() & 1) ? kWin : -kWin);
          const int64_t nm = (int64_t)m + d;
          if (nm >= 0 && nm <= kOutCap) n = redeclare(buf, n, cap, (uint32_t)nm);
        }
        break;
      }
      case 8:  // insert a copy tag: 2-byte offsets, or 4-byte ones past a window
        if (n > 1 && n + 5 <= cap) {
          const size_t p = 1 + xrand() % (n - 1);
          const uint32_t len = 1 + (uint32_t)(xrand() % 64);
          const bool far = xrand() & 1;
          const uint32_t off = far ? 1 + (uint32_t)(xrand() % (3 * kWin)) : 1 + (uint32_t)(xrand() % 0xFFFF);
          uint8_t tag[5] = {(uint8_t)((far ? 3 : 2) | ((len - 1) << 2)), (uint8_t)off,
                            (uint8_t)(off >> 8), (uint8_t)(off >> 16), (uint8_t)(off >> 24)};
          const size_t tl = far ? 5 : 3;
          memmove(buf + p + tl, buf + p, n - p);
          memcpy(buf + p, tag, tl);
          n += tl;
        }
        break;
      case 0:  // bit flip
        if (n) buf[xrand() % n] ^= (uint8_t)(1u << (xrand() & 7));
        break;
      case 1:  // byte set
        if (n) buf[xrand() % n] = (uint8_t)xrand();
        break;
      case 2:  // truncate
        if (n > 2) n = 1 + xrand() % (n - 1);
        break;
      case 3:  // interesting bytes (tag-shaped values)
        if (n) {
          static const uint8_t vals[] = {0x00, 0x01, 0x02, 0x03, 0xf0, 0xf4, 0xf8,
                                         0xfc, 0xff, 0x80, 0x3c, 0x1e, 0x6c};
          buf[xrand() % n] = vals[xrand() % sizeof(vals)];
        }
        break;
      case 4:  // duplicate a window (grow)
        if (n > 8 && n + 8 <= cap) {
          const size_t p = xrand() % (n - 8);
          memmove(buf + p + 8, buf + p, n - p);
          n += 8;
        }
        break;
      case 5:  // splice the tail of another corpus entry
        if (corpus_n && n > 1) {
          const int k = (int)(xrand() % (uint64_t)corpus_n);
          const size_t at = 1 + xrand() % (n - 1), from = xrand() % corpus_len[k];
          size_t take = corpus_len[k] - from;
          if (at + take > cap) take = cap - at;
          memcpy(buf + at, corpus_buf[k] + from, take);
          n = at + take;
        }
        break;
      default:  // clobber window
        if (n > 4) {
          const size_t p = xrand() % (n - 4);
          for (size_t j = 0; j < 2 + (xrand() & 2); j++) buf[p + j] = (uint8_t)xrand();
        }
    }
  }
  return n;
}

}  // namespace

extern "C" void __sanitizer_cov_trace_pc(void) {
  const uintptr_t pc = (uintptr_t)__builtin_return_address(0);
  const uint32_t idx = (uint32_t)(((pc >> 4) ^ (prev_pc << 5)) & (kMapSize - 1));
  prev_pc = pc >> 1;
  if (!cov_map[idx]) {
    cov_map[idx] = 1;
    cov_count++;
    run_new++;
  }
}

int main(int argc, char** argv) {
  if (argc < 2 || !load_consts(argv[1])) {
    fprintf(stderr, "usage: twin_fuzz CONSTS [corpus files...] (CONSTS: K1's tables and K6's constants)\n");
    return 2;
  }
  long iters = 2000;
  if (const char* env = getenv("FUZZ_ITERS")) iters = atol(env);
  if (const char* env = getenv("FUZZ_SEED")) rng_state ^= strtoull(env, nullptr, 0) * 0x9e3779b97f4a7c15ull;
  if (!rng_state) rng_state = 1;
  __sanitizer_set_death_callback(write_crash);

  // seeds: every file as it is, and its level-1 and level-2 raw encodings
  std::vector<uint8_t> enc(8 + kMaxInput + kMaxInput / 6 + 64 * 1024);
  for (int a = 2; a < argc; a++) {
    FILE* f = fopen(argv[a], "rb");
    if (!f) continue;
    std::vector<uint8_t> buf(kMaxInput + 1);
    const size_t fn = fread(buf.data(), 1, buf.size(), f);
    fclose(f);
    if (fn == 0 || fn > kMaxInput) continue;
    corpus_add(buf.data(), fn);
    uint32_t m;
    size_t used, w;
    std::vector<uint8_t> dec(kOutCap);
    if (read_varint(buf.data(), fn, &m, &used) == 0 && m <= kOutCap &&
        stpu_decode_tags(buf.data() + used, fn - used, dec.data(), m, &w) == 0 && w == m)
      continue;  // a raw stream already: no encodings of it
    for (int level = 1; level <= 2; ++level) {
      size_t hl = 0;
      for (uint32_t v = (uint32_t)fn;; v >>= 7) {
        enc[hl++] = (uint8_t)(v >= 0x80 ? (v | 0x80) : v);
        if (v < 0x80) break;
      }
      corpus_add(enc.data(), hl + stpu_encode_span_level(buf.data(), fn, enc.data() + hl, level));
    }
  }
  if (corpus_n == 0) {
    fprintf(stderr, "twin fuzz: no seeds\n");
    return 1;
  }
  const int seeds = corpus_n;
  for (int k = 0; k < seeds; k++) run_one(corpus_buf[k], corpus_len[k]);
  const uint64_t base_edges = cov_count;

  std::vector<uint8_t> work(kMaxInput);
  long kept = 0;
  for (long it = 0; it < iters; it++) {
    const int pick = (int)(xrand() % (uint64_t)corpus_n);
    size_t n = corpus_len[pick];
    memcpy(work.data(), corpus_buf[pick], n);
    n = mutate(work.data(), n, kMaxInput);
    run_new = 0;
    run_one(work.data(), n);
    if (run_new > 0) {
      corpus_add(work.data(), n);
      kept++;
    }
  }
  printf("twin fuzz OK: %ld iters, %d seeds, %d corpus entries (%ld grown), %llu edges "
         "(%llu from seeds); inputs decoded %ld (host accepts %ld): K2 %ld, K2 big %ld, K4 walk %ld, "
         "K4 window route %ld (deferred windows in %ld), K5 window route %ld, K5 unsupported %ld; "
         "K3 blocks %ld; K1 rows %ld, K6 rows %ld\n",
         iters, seeds, corpus_n, kept, (unsigned long long)cov_count,
         (unsigned long long)base_edges, reach.inputs, reach.accepted, reach.k2, reach.k2_big,
         reach.walk, reach.windows, reach.deferred, reach.scan_windows, reach.unsupported,
         reach.k3_blocks, reach.k1_rows, reach.k6_rows);
  return 0;
}
