/* CRC-32C (Castagnoli, poly 0x1EDC6F41) — slicing-by-8, host-side.
 *
 * Role parity: the reference keeps its only native code here too
 * (/root/reference/snappy/crc32c.c, slicing-by-8 with eight 256-entry
 * tables).  This implementation is written from the algorithm description:
 * tables are generated at init from the reflected polynomial instead of
 * being hard-coded, and the 8-byte inner step folds the current register
 * into the first four table lookups.
 *
 * Masking parity: framing_format.txt:39-58 — masked = rotr(crc, 15) +
 * 0xa282ead8, applied to the standard (init ~0, final ~) CRC-32C.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define POLY_REFLECTED 0x82F63B78u
#define MASK_DELTA 0xA282EAD8u

static uint32_t table[8][256];
static int initialized = 0;

void snappy_tpu_crc32c_init(void) {
  if (initialized) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c >> 1) ^ (POLY_REFLECTED & (uint32_t)(-(int32_t)(c & 1)));
    table[0][i] = c;
  }
  for (int t = 1; t < 8; t++)
    for (uint32_t i = 0; i < 256; i++)
      table[t][i] = (table[t - 1][i] >> 8) ^ table[0][table[t - 1][i] & 0xFF];
  initialized = 1;
}

/* Raw register update: crc state in, state out (no pre/post inversion). */
static uint32_t crc32c_update(uint32_t crc, const uint8_t* buf, size_t len) {
  /* Align to 8 bytes with the bytewise loop. */
  while (len && ((uintptr_t)buf & 7)) {
    crc = (crc >> 8) ^ table[0][(crc ^ *buf++) & 0xFF];
    len--;
  }
  /* 8 bytes per iteration: two 32-bit words, eight table lookups. */
  while (len >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, buf, 4);
    memcpy(&hi, buf + 4, 4);
    lo ^= crc;
    crc = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^
          table[5][(lo >> 16) & 0xFF] ^ table[4][lo >> 24] ^
          table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
          table[1][(hi >> 16) & 0xFF] ^ table[0][hi >> 24];
    buf += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ table[0][(crc ^ *buf++) & 0xFF];
  return crc;
}

#if defined(__x86_64__) && defined(__SSE4_2__)
/* Hardware path: the SSE4.2 crc32 instruction implements exactly the
 * Castagnoli polynomial used by snappy framing.  ~10x the table path. */
#include <nmmintrin.h>
static uint32_t crc32c_update_hw(uint32_t crc, const uint8_t* buf, size_t len) {
  uint64_t c = crc;
  while (len && ((uintptr_t)buf & 7)) {
    c = _mm_crc32_u8((uint32_t)c, *buf++);
    len--;
  }
  while (len >= 32) {
    uint64_t a, b, d, e;
    memcpy(&a, buf, 8);
    memcpy(&b, buf + 8, 8);
    memcpy(&d, buf + 16, 8);
    memcpy(&e, buf + 24, 8);
    c = _mm_crc32_u64(c, a);
    c = _mm_crc32_u64(c, b);
    c = _mm_crc32_u64(c, d);
    c = _mm_crc32_u64(c, e);
    buf += 32;
    len -= 32;
  }
  while (len >= 8) {
    uint64_t a;
    memcpy(&a, buf, 8);
    c = _mm_crc32_u64(c, a);
    buf += 8;
    len -= 8;
  }
  while (len--) c = _mm_crc32_u8((uint32_t)c, *buf++);
  return (uint32_t)c;
}
#define HAVE_HW_CRC 1
#endif

uint32_t snappy_tpu_crc32c(const uint8_t* buf, size_t len) {
#ifdef HAVE_HW_CRC
  return ~crc32c_update_hw(0xFFFFFFFFu, buf, len);
#else
  snappy_tpu_crc32c_init();
  return ~crc32c_update(0xFFFFFFFFu, buf, len);
#endif
}

uint32_t snappy_tpu_masked_crc32c(const uint8_t* buf, size_t len) {
  uint32_t crc = snappy_tpu_crc32c(buf, len);
  return ((crc >> 15) | (crc << 17)) + MASK_DELTA;
}
