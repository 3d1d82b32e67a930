/* Standalone sanitizer test driver for the native codec.
 *
 * Compiled whole-binary with -fsanitize=address,undefined (see
 * tools/sanitize_tests.sh) — the analog of the reference building every
 * Linux test with UBSan (snappy.nimble:21-28).  Running the codec inside a
 * fully sanitized binary (instead of a ctypes .so under a Python process)
 * sidesteps ASan-vs-JAX interceptor conflicts and lets the mutation fuzz
 * run millions of iterations at native speed.
 *
 * Exercises, per input file given on argv:
 *   1. raw encode (levels 1 and 2) -> decode -> byte compare;
 *   2. framed slab encode -> chunk-walk -> framed slab decode (CRC on)
 *      -> byte compare;
 *   3. deterministic mutation fuzz of both streams: decode must never
 *      touch memory out of bounds (correctness of accept/reject decisions
 *      is covered by the Python differential suites; memory safety under
 *      arbitrary corruption is what this binary proves).
 *
 * Exit code 0 = all clean; any sanitizer report aborts the process.
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
void stpu_scan_span_index(const uint8_t* in, size_t n, int64_t s_lo,
                          int64_t s_hi, uint32_t* pos, uint32_t* cum, long cap,
                          long* n_rec, int64_t* exit_pos, int64_t* exit_cum,
                          int* err);
long stpu_raw_scan_stitch(const uint8_t* in, size_t n, size_t out_len,
                          long nspans, const int64_t* span_lo,
                          const uint32_t* pos, const uint32_t* cum,
                          const int64_t* rec_off, const int64_t* n_rec,
                          const int64_t* exit_pos, const int64_t* exit_cum,
                          const int* errs, int64_t* in_offs, long cap);
int stpu_decode_raw_segments(const uint8_t* in, const int64_t* in_offs,
                             long seg_lo, long seg_hi, uint8_t* out,
                             size_t out_len);
uint32_t snappy_tpu_masked_crc32c(const uint8_t* buf, size_t len);

#define MAX_BLOCK 65536u
#define FUZZ_ITERS 20000

static uint64_t rng_state = 0x9e3779b97f4a7c15ull;
static uint64_t xrand(void) {
  uint64_t x = rng_state;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  rng_state = x;
  return x;
}

static uint8_t* read_file(const char* path, size_t* out_n) {
  FILE* f = fopen(path, "rb");
  if (!f) return NULL;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  uint8_t* buf = malloc((size_t)n + 1);
  if (fread(buf, 1, (size_t)n, f) != (size_t)n) {
    fclose(f);
    free(buf);
    return NULL;
  }
  fclose(f);
  *out_n = (size_t)n;
  return buf;
}

/* Minimal LEB128 read (uint32, 5-byte limit = the decode-path rule). */
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

/* Walk a framed stream (no 10-byte header) into per-chunk job arrays.
 * Returns chunk count, or -1 on malformed structure. */
static int walk_frames(const uint8_t* s, size_t n, uint8_t* kinds,
                       int64_t* src_off, int64_t* src_len, int64_t* declared,
                       int64_t* out_off, uint32_t* crcs, int max_chunks,
                       size_t* total_out) {
  size_t read = 0, pos = 0;
  int k = 0;
  while (n - read > 0) {
    if (n - read < 4 || k >= max_chunks) return -1;
    uint8_t id = s[read];
    uint32_t dlen =
        (uint32_t)s[read + 1] | ((uint32_t)s[read + 2] << 8) |
        ((uint32_t)s[read + 3] << 16);
    if (n - read - 4 < dlen) return -1;
    size_t dpos = read + 4;
    if (id == 0x00) { /* compressed */
      if (dlen < 4) return -1;
      uint32_t inner;
      size_t used;
      size_t body = dlen - 4;
      if (read_varint(s + dpos + 4, body, &inner, &used) != 0) return -1;
      if (inner > MAX_BLOCK) return -1;
      kinds[k] = 0;
      src_off[k] = (int64_t)(dpos + 4 + used);
      src_len[k] = (int64_t)(body - used);
      declared[k] = inner;
      out_off[k] = (int64_t)pos;
      memcpy(&crcs[k], s + dpos, 4);
      pos += inner;
      k++;
    } else if (id == 0x01) { /* uncompressed */
      if (dlen < 4) return -1;
      uint32_t inner = dlen - 4;
      if (inner > MAX_BLOCK) return -1;
      kinds[k] = 1;
      src_off[k] = (int64_t)(dpos + 4);
      src_len[k] = inner;
      declared[k] = inner;
      out_off[k] = (int64_t)pos;
      memcpy(&crcs[k], s + dpos, 4);
      pos += inner;
      k++;
    } else if (id < 0x80) {
      return -1; /* reserved unskippable */
    } /* else skippable: ignore */
    read += 4 + dlen;
  }
  *total_out = pos;
  return k;
}

static void mutate(uint8_t* buf, size_t* n) {
  switch (xrand() & 3) {
    case 0:
      if (*n) buf[xrand() % *n] ^= (uint8_t)(1u << (xrand() & 7));
      break;
    case 1:
      if (*n > 2) *n = 1 + xrand() % (*n - 1); /* truncate */
      break;
    case 2:
      if (*n) buf[xrand() % *n] = (uint8_t)xrand();
      break;
    default: { /* clobber a 2-4 byte window */
      if (*n > 4) {
        size_t p = xrand() % (*n - 4);
        for (size_t j = 0; j < 2 + (xrand() & 2); j++)
          buf[p + j] = (uint8_t)xrand();
      }
    }
  }
}

int main(int argc, char** argv) {
  int files_done = 0;
  for (int a = 1; a < argc; a++) {
    size_t n;
    uint8_t* data = read_file(argv[a], &n);
    if (!data) {
      fprintf(stderr, "cannot read %s\n", argv[a]);
      return 1;
    }
    size_t blocks = (n + MAX_BLOCK - 1) / MAX_BLOCK;
    if (!blocks) blocks = 1;
    size_t enc_cap = blocks * (32 + MAX_BLOCK + MAX_BLOCK / 6);
    uint8_t* enc = malloc(enc_cap);
    uint8_t* dec = malloc(n ? n : 1);

    /* 1. raw round-trip, both levels */
    size_t enc_len_l1 = 0;
    for (int level = 1; level <= 2; level++) {
      size_t en = stpu_encode_span_level(data, n, enc, level);
      if (level == 1) enc_len_l1 = en;
      size_t written = 0;
      if (stpu_decode_tags(enc, en, dec, n, &written) != 0 || written != n ||
          (n && memcmp(dec, data, n) != 0)) {
        fprintf(stderr, "raw roundtrip FAILED %s level %d\n", argv[a], level);
        return 1;
      }
    }

    /* 2. framed round-trip (CRC verified) */
    size_t framed_cap = blocks * (8 + MAX_BLOCK) + 64;
    uint8_t* framed = malloc(framed_cap);
    size_t fn = stpu_encode_framed_slab_level(data, 0, n, framed, 1);
    int max_chunks = (int)blocks + 4;
    uint8_t* kinds = malloc((size_t)max_chunks);
    int64_t* so = malloc(sizeof(int64_t) * (size_t)max_chunks);
    int64_t* sl = malloc(sizeof(int64_t) * (size_t)max_chunks);
    int64_t* dc = malloc(sizeof(int64_t) * (size_t)max_chunks);
    int64_t* oo = malloc(sizeof(int64_t) * (size_t)max_chunks);
    uint32_t* cr = malloc(sizeof(uint32_t) * (size_t)max_chunks);
    size_t total_out = 0;
    int nk = walk_frames(framed, fn, kinds, so, sl, dc, oo, cr, max_chunks,
                         &total_out);
    if (nk < 0 || total_out != n) {
      fprintf(stderr, "framed walk FAILED %s\n", argv[a]);
      return 1;
    }
    if (nk > 0) {
      memset(dec, 0, n ? n : 1);
      if (stpu_decode_framed_slab(framed, kinds, so, sl, dc, oo, cr, nk, dec,
                                  1) != 0 ||
          (n && memcmp(dec, data, n) != 0)) {
        fprintf(stderr, "framed roundtrip FAILED %s\n", argv[a]);
        return 1;
      }
    }

    /* 2b. block-parallel raw decode machinery: the boundary scan, the
     * speculative span index + stitch (equivalence vs the sequential
     * scan), and the segment decoder, all on the clean stream. */
    long seg_cap = (long)(n / MAX_BLOCK) + 2;
    int64_t* offs_a = malloc(sizeof(int64_t) * (size_t)seg_cap);
    int64_t* offs_b = malloc(sizeof(int64_t) * (size_t)seg_cap);
    {
      long nseg = stpu_raw_scan_blocks(enc, enc_len_l1, n, offs_a, seg_cap);
      if (nseg >= 1) {
        memset(dec, 0, n ? n : 1);
        if (stpu_decode_raw_segments(enc, offs_a, 0, nseg, dec, n) != 0 ||
            (n && memcmp(dec, data, n) != 0)) {
          fprintf(stderr, "segment decode FAILED %s\n", argv[a]);
          return 1;
        }
      }
      /* speculative index over 3 uneven spans, stitched */
      long nspans = 3;
      int64_t span_lo[4] = {0, (int64_t)(enc_len_l1 / 3),
                            (int64_t)(2 * enc_len_l1 / 3 + 1),
                            (int64_t)enc_len_l1};
      if (span_lo[1] == 0 || span_lo[2] <= span_lo[1]) nspans = 1,
                                                       span_lo[1] = (int64_t)enc_len_l1;
      long rec_cap = (long)(enc_len_l1 / 16) + 8;
      uint32_t* pos = malloc(sizeof(uint32_t) * (size_t)rec_cap * 3);
      uint32_t* cum = malloc(sizeof(uint32_t) * (size_t)rec_cap * 3);
      int64_t rec_off[4] = {0, rec_cap, 2 * rec_cap, 3 * rec_cap};
      int64_t n_rec[3], exit_pos[3], exit_cum[3];
      int errs[3];
      for (long k = 0; k < nspans; k++) {
        long nr = 0;
        stpu_scan_span_index(enc, enc_len_l1, span_lo[k], span_lo[k + 1],
                             pos + rec_off[k], cum + rec_off[k], rec_cap, &nr,
                             &exit_pos[k], &exit_cum[k], &errs[k]);
        n_rec[k] = nr;
      }
      long nseg2 = stpu_raw_scan_stitch(enc, enc_len_l1, n, nspans, span_lo,
                                        pos, cum, rec_off, n_rec, exit_pos,
                                        exit_cum, errs, offs_b, seg_cap);
      if (nseg2 != nseg ||
          (nseg >= 0 &&
           memcmp(offs_a, offs_b, sizeof(int64_t) * (size_t)(nseg + 1)) != 0)) {
        fprintf(stderr, "stitched scan != sequential scan %s (%ld vs %ld)\n",
                argv[a], nseg2, nseg);
        return 1;
      }
      free(pos);
      free(cum);
    }

    /* 3. mutation fuzz: decode corrupted streams; ASan/UBSan watch for
     * out-of-bounds.  The output buffer is sized exactly `n` so any
     * overrun is caught. */
    uint8_t* mut = malloc(enc_cap);
    for (int it = 0; it < FUZZ_ITERS; it++) {
      /* raw */
      size_t mn = enc_len_l1;
      memcpy(mut, enc, mn);
      mutate(mut, &mn);
      size_t written = 0;
      (void)stpu_decode_tags(mut, mn, dec, n, &written);
      /* block-parallel path on the corrupted stream: scan + segments */
      long mseg = stpu_raw_scan_blocks(mut, mn, n, offs_a, seg_cap);
      if (mseg >= 1) (void)stpu_decode_raw_segments(mut, offs_a, 0, mseg, dec, n);
      /* framed: re-walk (headers may be corrupt) then slab-decode */
      size_t fmn = fn < enc_cap ? fn : enc_cap;
      memcpy(mut, framed, fmn);
      mutate(mut, &fmn);
      int mk = walk_frames(mut, fmn, kinds, so, sl, dc, oo, cr, max_chunks,
                           &total_out);
      if (mk > 0 && total_out <= n) {
        (void)stpu_decode_framed_slab(mut, kinds, so, sl, dc, oo, cr, mk, dec,
                                      1);
      }
    }
    free(mut);
    free(offs_a);
    free(offs_b);
    free(kinds);
    free(so);
    free(sl);
    free(dc);
    free(oo);
    free(cr);
    free(framed);
    free(enc);
    free(dec);
    free(data);
    files_done++;
  }
  printf("sanitize driver OK: %d files, %d fuzz iters each\n", files_done,
         FUZZ_ITERS);
  return 0;
}
