/* Coverage-guided mutational fuzzer for the native codec.
 *
 * Parity target: the reference fuzzes with libFuzzer via nim-testutils
 * (/root/reference/tests/fuzzing/fuzz_block_format.nim:8-33,
 * run_fuzzing_test.nims:21) — i.e. COVERAGE-GUIDED, not blind mutation.
 * This toolchain has no clang/libFuzzer, so this driver implements the
 * same loop on gcc's -fsanitize-coverage=trace-pc instrumentation: the
 * codec objects are built with trace-pc (+ASan/UBSan), the driver
 * provides __sanitizer_cov_trace_pc recording AFL-style edge hashes in
 * a global map, and inputs that light up new edges join the corpus.
 *
 * Per input the harness exercises (mirroring the reference's two fuzz
 * targets plus our parallel-decode machinery):
 *   1. raw tag-stream decode (bounded output);
 *   2. decode-encode-decode idempotence when the input decodes
 *      (fuzz_framing_format.nim:4-14's invariant, applied to raw);
 *   3. the framed chunk walk + slab decode with CRC;
 *   4. boundary scan + parallel-segment decode vs sequential decode
 *      equivalence (accept/reject AND bytes).
 *
 * Build/run via tools/fuzz_coverage.sh.  Exit 0 = clean; sanitizer
 * reports or invariant violations abort.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

size_t stpu_encode_span_level(const uint8_t* in, size_t n, uint8_t* out,
                              int level);
int stpu_decode_tags(const uint8_t* in, size_t n, uint8_t* out, size_t out_len,
                     size_t* written);
size_t stpu_encode_framed_slab_level(const uint8_t* in, size_t lo, size_t hi,
                                     uint8_t* outbuf, int level);
int stpu_decode_framed_slab(const uint8_t* stream, const uint8_t* kinds,
                            const int64_t* src_off, const int64_t* src_len,
                            const int64_t* declared, const int64_t* out_off,
                            const uint32_t* stored_crc, int n, uint8_t* out,
                            int check_crc);
long stpu_raw_scan_blocks(const uint8_t* in, size_t n, size_t out_len,
                          int64_t* in_offs, long cap);
int stpu_decode_raw_segments(const uint8_t* in, const int64_t* in_offs,
                             long seg_lo, long seg_hi, uint8_t* out,
                             size_t out_len);
long stpu_framed_walk(const uint8_t* s, size_t n, size_t start,
                      uint64_t budget, int check_integrity, uint8_t* kinds,
                      int64_t* src_off, int64_t* src_len, int64_t* declared,
                      int64_t* out_off, uint32_t* stored_crc, long cap,
                      int* status, int64_t* read_end, int64_t* total_out);

/* ---- edge-coverage map (AFL-style prev-pc xor hash) ---- */
#define MAP_BITS 16
#define MAP_SIZE (1u << MAP_BITS)
static uint8_t cov_map[MAP_SIZE];     /* edges ever seen */
static uint64_t cov_count = 0;        /* set bits in cov_map */
static uint64_t run_new = 0;          /* new edges in the current run */
static uintptr_t prev_pc = 0;

void __sanitizer_cov_trace_pc(void) {
  uintptr_t pc = (uintptr_t)__builtin_return_address(0);
  uint32_t idx = (uint32_t)(((pc >> 4) ^ (prev_pc << 5)) & (MAP_SIZE - 1));
  prev_pc = pc >> 1;
  if (!cov_map[idx]) {
    cov_map[idx] = 1;
    cov_count++;
    run_new++;
  }
}

/* ---- corpus ---- */
#define MAX_ENTRIES 4096
#define MAX_INPUT (1u << 20) /* 1 MiB per entry */
static uint8_t* corpus_buf[MAX_ENTRIES];
static size_t corpus_len[MAX_ENTRIES];
static int corpus_n = 0;

static void corpus_add(const uint8_t* d, size_t n) {
  if (corpus_n >= MAX_ENTRIES || n == 0 || n > MAX_INPUT) return;
  uint8_t* copy = malloc(n);
  memcpy(copy, d, n);
  corpus_buf[corpus_n] = copy;
  corpus_len[corpus_n] = n;
  corpus_n++;
}

static uint64_t rng_state = 0x243f6a8885a308d3ull;
static uint64_t xrand(void) {
  uint64_t x = rng_state;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  rng_state = x;
  return x;
}

static size_t mutate(uint8_t* buf, size_t n, size_t cap) {
  int rounds = 1 + (int)(xrand() % 4);
  for (int r = 0; r < rounds; r++) {
    switch (xrand() % 6) {
      case 0: /* bit flip */
        if (n) buf[xrand() % n] ^= (uint8_t)(1u << (xrand() & 7));
        break;
      case 1: /* byte set */
        if (n) buf[xrand() % n] = (uint8_t)xrand();
        break;
      case 2: /* truncate */
        if (n > 2) n = 1 + xrand() % (n - 1);
        break;
      case 3: /* interesting bytes (tag-shaped values) */
        if (n) {
          static const uint8_t vals[] = {0x00, 0x01, 0x02, 0x03, 0xf0,
                                         0xf4, 0xf8, 0xfc, 0xff, 0x80,
                                         0x3c, 0x1e, 0x6c};
          buf[xrand() % n] = vals[xrand() % sizeof(vals)];
        }
        break;
      case 4: /* duplicate a window (grow) */
        if (n > 8 && n + 8 <= cap) {
          size_t p = xrand() % (n - 8);
          memmove(buf + p + 8, buf + p, n - p);
          n += 8;
        }
        break;
      default: /* clobber window */
        if (n > 4) {
          size_t p = xrand() % (n - 4);
          for (size_t j = 0; j < 2 + (xrand() & 2); j++)
            buf[p + j] = (uint8_t)xrand();
        }
    }
  }
  return n;
}

/* ---- shared run buffers ---- */
#define OUT_CAP (4u << 20)
static uint8_t *dec1, *dec2, *reenc;

/* Minimal LEB128 (uint32, 5-byte rule). */
static int read_varint(const uint8_t* p, size_t n, uint32_t* val,
                       size_t* used) {
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

static int64_t seg_offs[OUT_CAP / 65536 + 2];

/* Run all targets on one input.  Aborts on invariant violations. */
static void run_one(const uint8_t* data, size_t n) {
  /* 1+2: raw decode (treat input as varint + tag stream) + idempotence */
  uint32_t declared;
  size_t used;
  if (read_varint(data, n, &declared, &used) == 0 && declared <= OUT_CAP) {
    size_t written = 0;
    int rc = stpu_decode_tags(data + used, n - used, dec1, declared, &written);
    if (rc == 0 && written == declared) {
      /* decode-encode-decode idempotence */
      size_t en = stpu_encode_span_level(dec1, declared, reenc, 1);
      size_t w2 = 0;
      if (stpu_decode_tags(reenc, en, dec2, declared, &w2) != 0 ||
          w2 != declared || memcmp(dec1, dec2, declared) != 0) {
        fprintf(stderr, "FUZZ: raw idempotence violated (n=%zu)\n", n);
        abort();
      }
    }
    /* 4: boundary scan + parallel segments == sequential verdict/bytes */
    long nseg = stpu_raw_scan_blocks(data + used, n - used, declared, seg_offs,
                                     (long)(declared / 65536 + 2));
    if (nseg >= 1) {
      memset(dec2, 0, declared);
      int prc = stpu_decode_raw_segments(data + used, seg_offs, 0, nseg, dec2,
                                         declared);
      if (prc == 0) {
        if (rc != 0 || written != declared ||
            memcmp(dec1, dec2, declared) != 0) {
          fprintf(stderr, "FUZZ: parallel/sequential divergence (n=%zu)\n", n);
          abort();
        }
      }
      /* prc != 0 is fine: segment not self-contained; sequential is
       * authoritative. */
    }
  }

  /* 3: framed walk + slab decode (input as header-less framed stream),
   * through the PRODUCTION walk (stpu_framed_walk) so its validation and
   * resume-budget logic are under the coverage loop too. */
  {
    uint8_t kinds[64];
    int64_t so[64], sl[64], dc[64], oo[64];
    uint32_t cr[64];
    int status;
    int64_t read_end, total;
    long k = stpu_framed_walk(data, n, 0, (uint64_t)OUT_CAP, 1, kinds, so, sl,
                              dc, oo, cr, 64, &status, &read_end, &total);
    if (k > 0 && total <= (int64_t)OUT_CAP)
      (void)stpu_decode_framed_slab(data, kinds, so, sl, dc, oo, cr, (int)k,
                                    dec1, 1);
  }
}

int main(int argc, char** argv) {
  long iters = 200000;
  const char* env = getenv("FUZZ_ITERS");
  if (env) iters = atol(env);

  dec1 = malloc(OUT_CAP);
  dec2 = malloc(OUT_CAP);
  reenc = malloc(OUT_CAP + OUT_CAP / 6 + 4096);
  uint8_t* work = malloc(MAX_INPUT + 64);

  /* Seeds: every argv file raw, raw-encoded, and framed-encoded
   * (collect_corpus.nim:17-35 parity: compress each data file in both
   * formats). */
  for (int a = 1; a < argc; a++) {
    FILE* f = fopen(argv[a], "rb");
    if (!f) continue;
    fseek(f, 0, SEEK_END);
    long fn = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (fn <= 0 || (size_t)fn > MAX_INPUT) {
      fclose(f);
      continue;
    }
    uint8_t* buf = malloc((size_t)fn);
    if (fread(buf, 1, (size_t)fn, f) == (size_t)fn) {
      corpus_add(buf, (size_t)fn);
      /* varint-prefixed raw encoding as a decode seed */
      size_t blocks = ((size_t)fn + 65535) / 65536;
      uint8_t* enc = malloc(8 + blocks * (32 + 65536 + 65536 / 6));
      size_t hl = 0;
      uint32_t v = (uint32_t)fn;
      while (v >= 0x80) {
        enc[hl++] = (uint8_t)(v | 0x80);
        v >>= 7;
      }
      enc[hl++] = (uint8_t)v;
      size_t en = stpu_encode_span_level(buf, (size_t)fn, enc + hl, 1);
      corpus_add(enc, hl + en);
      size_t fl = stpu_encode_framed_slab_level(buf, 0, (size_t)fn, enc, 1);
      corpus_add(enc, fl);
      free(enc);
    }
    fclose(f);
    free(buf);
  }
  if (corpus_n == 0) {
    fprintf(stderr, "fuzz: no seeds\n");
    return 1;
  }

  /* Warm coverage with the seeds themselves. */
  for (int k = 0; k < corpus_n; k++) run_one(corpus_buf[k], corpus_len[k]);
  uint64_t base_edges = cov_count;

  long kept = 0;
  for (long it = 0; it < iters; it++) {
    int pick = (int)(xrand() % (uint64_t)corpus_n);
    size_t n = corpus_len[pick];
    memcpy(work, corpus_buf[pick], n);
    n = mutate(work, n, MAX_INPUT);
    run_new = 0;
    run_one(work, n);
    if (run_new > 0) {
      corpus_add(work, n); /* coverage grew: keep the input */
      kept++;
    }
  }
  printf(
      "coverage fuzz OK: %ld iters, %d corpus entries (%ld grown), "
      "%llu edges (%llu from seeds)\n",
      iters, corpus_n, kept, (unsigned long long)cov_count,
      (unsigned long long)base_edges);
  return 0;
}
