// Masked CRC32C of a batch of chunks: the kernel behind
// snappy_tpu_torch.ops.crc32c.masked_crc32c_chunks.
//
// Replaces the TPU kernel snappy_tpu/ops/crc32c_pallas.py
// (_kernel_factory, launched by _lane_fold_pallas) and its XLA twin
// snappy_tpu/ops/crc32c_jax.py (masked_crc32c_chunks), which the JAX main
// path calls.
//
// Bound on the H100: the bytes read, one pass over the rows (50.3 MB, 15 us,
// at the main path's 768 x 64 KiB).  A table CRC spends a shared-memory
// lookup on every byte, so the design keeps those lookups at the shared
// memory's full rate and the loads coalesced.
//
// Geometry of a row of L bytes at address A: the head [A, a0) up to the
// first 16-byte edge and the tail past the last one go byte by byte; the
// body between them, a whole number of 16-byte words, is cut into tiles of
// kTile bytes.  The body is placed at the END of a virtual window of nt
// tiles (nt = max(1, ceil(L / kTile))): a zero-init register is unchanged
// by leading zero bytes, so the front padding costs nothing and every
// combine below advances by a fixed power of two.  The head's register
// (from the standard init 0xFFFFFFFF) is XORed into the body's first 4
// bytes, which folds the init in where the data starts.
//
// Design:
// - tiles on a persistent grid: one CTA of kCrcWarps warps per SM walks the
//   tiles of the call, tile t being slot t % nt_max of row t / nt_max
//   (slots past a row's nt are skipped); a CTA builds its tables in shared
//   memory once; three tiles are in flight in a warp: the one it works on
//   (its words in registers), the next (its loads issued before the work
//   on this one starts) and the one after (its row's length read ahead);
// - coalesced loads: a warp takes its 4 KiB of a tile as 4 strides of 1 KiB,
//   lane l the 32 bytes at 32 l of each (two 16-byte loads), and keeps one
//   register over its pieces: r <- adv1024(r) ^ crc0(piece), crc0 by
//   slicing-by-4 eight times (32 lookups) and the advance by 4, 1.125
//   lookups a byte (layout (i); testing/crc_layouts.py builds layout (ii),
//   lanes over contiguous segments staged through shared memory, around the
//   same tiles and folds);
// - conflict-free lookups: the slicing tables have one copy per bank (lane
//   l always reads bank l; 128 KiB for the four tables), laid out so that
//   one byte permute gives an entry's offset from the byte and the lane;
// - folds with no serial loop: the lanes' registers combine in a tree of 5
//   shuffles, each level advancing the left register across the bytes of
//   the right one with 4 byte lookups into that level's "advance by 2^j
//   bytes" tables; the warps' registers in a tree of 4 more, by warp 0
//   while the others go on to the next tile; the tiles of a row longer
//   than one tile in a second launch, one CTA per row, a tree of 5 + 5
//   levels over each 1,024 tiles, its tables in shared memory.
//
// One source, two builds: the warp code is written against Lanes<T> and
// the collectives of snappy_common.cuh, so the CPU twin runs the same tiles,
// lanes and folds (tests/test_torch_crc32c_warp.py, lanes in both orders).
#include "snappy_common.cuh"

namespace stpu {

constexpr uint32_t kMaskDelta = 0xA282EAD8u;
constexpr int64_t kTile = 65536;           // bytes of a tile
constexpr uint32_t kCrcWarps = 16;         // warps of a CTA of the tile kernel
constexpr uint32_t kWarpBytes = kTile / kCrcWarps;  // 4 KiB a warp
constexpr uint32_t ilog2(uint32_t v) { return v > 1 ? 1 + ilog2(v / 2) : 0; }
constexpr uint32_t kPiece = 32;            // bytes a lane takes of a stride
constexpr uint32_t kStride = 32 * kPiece;  // bytes a warp loads at once
constexpr uint32_t kFoldWarps = 32;        // warps of a CTA of the fold kernel
constexpr uint32_t kFoldLo = 16;           // its levels: 64 KiB .. 64 MiB
constexpr uint32_t kFoldWords = 11 * 1024;
// Shared memory of the tile kernel, in words: the per-bank slicing tables,
// then the advance tables of levels kAdvLo .. kAdvHi (2^j bytes), then the
// warps' registers.
constexpr uint32_t kBankTabWords = 4 * 256 * 32;
constexpr uint32_t kAdvLo = 5, kAdvHi = 15;
constexpr uint32_t kAdvWords = (kAdvHi - kAdvLo + 1) * 1024;

// Timing hooks around the phases of the tile kernel (k: 0 the tables, 1 a
// tile's load issue, 2 a warp's CRC of its words, 3 the CTA's barrier, 4
// warp 0's fold of the warps, 5 the geometry of the tile after next, 7 the
// walk over the tiles); they only run the statement unless a build defines
// STPU_PROF, as testing/crc_layouts.py does to count cycles.
#ifndef STPU_PROF
#define STPU_PROF(k, ...) __VA_ARGS__
#endif

// A static member function of the warp bodies, in both builds.
#ifdef __CUDACC__
#define STPU_HD_MEMBER static __host__ __device__ __forceinline__
#else
#define STPU_HD_MEMBER static inline
#endif

// Where a row's bytes lie: head [0, a0), body [a0, e), tail [e, len) from
// p; nt tiles of virtual window, the body at its end after pad zero bytes.
struct CrcRow {
  const uint8_t* p;
  int64_t len, a0, e, nt, pad;
};

STPU_HD CrcRow crc_row(const uint8_t* p, int64_t len) {
  CrcRow r;
  r.p = p;
  r.len = len;
  r.a0 = min_i64((int64_t)((0u - (uint32_t)(uintptr_t)p) & 15u), len);
  r.e = r.a0 + ((len - r.a0) & ~(int64_t)15);
  r.nt = len > kTile ? (len + kTile - 1) / kTile : 1;
  r.pad = r.nt * kTile - (r.e - r.a0);
  return r;
}

// Byte-at-a-time table CRC of reg over p[0, n); the byte table's entry i is
// t0[i * step] (a lane's per-bank copy: step 64; the global table: step 1).
STPU_HD uint32_t crc_bytes(const uint32_t* t0, uint32_t step, uint32_t reg, const uint8_t* p,
                           int64_t n) {
  for (int64_t k = 0; k < n; ++k) reg = t0[((reg ^ p[k]) & 0xFFu) * step] ^ (reg >> 8);
  return reg;
}

// The per-bank slicing tables: entry b of table k (k = 0 .. 3) of lane l's
// copy at word bank_word(k, b, l), so that lane l always reads bank l.
// Tables 2 p and 2 p + 1 share 64 KiB: entry b's 32 + 32 copies fill 256
// bytes, whose offset then comes from b and the lane in one byte permute.
STPU_HD uint32_t bank_word(uint32_t k, uint32_t b, uint32_t l) {
  return 16384u * (k >> 1) + 64u * b + 32u * (k & 1) + l;
}

// Byte offset, in its pair, of the entry of table k (parity in lb) for byte
// j of x; lb = 4 l + 128 (k & 1).
STPU_HD uint32_t bank_off(uint32_t x, uint32_t j, uint32_t lb) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, lb, 0x5504u | (j << 4));
#else
  return (((x >> (8 * j)) & 0xFFu) << 8) | lb;
#endif
}

STPU_HD uint32_t bank_entry(const uint32_t* tb, uint32_t pair, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(reinterpret_cast<const uint8_t*>(tb) + 65536u * pair +
                                            off);
}

// Slicing-by-4 step of lane l: the register of 4 bytes x (a register
// already XORed into them), from the lane's bank copies.
STPU_HD uint32_t slice4(const uint32_t* tb, uint32_t l, uint32_t x) {
  const uint32_t even = 4 * l, odd = 4 * l + 128;
  return bank_entry(tb, 1, bank_off(x, 0, odd)) ^ bank_entry(tb, 1, bank_off(x, 1, even)) ^
         bank_entry(tb, 0, bank_off(x, 2, odd)) ^ bank_entry(tb, 0, bank_off(x, 3, even));
}

// v advanced across 2^j zero bytes, by the level's 4 x 256 table a.
STPU_HD uint32_t adv4(const uint32_t* a, uint32_t v) {
  return a[v & 0xFFu] ^ a[256u + ((v >> 8) & 0xFFu)] ^ a[512u + ((v >> 16) & 0xFFu)] ^
         a[768u + (v >> 24)];
}

// The 16 bytes at p (16-byte aligned) as 4 little-endian words.
STPU_HD void load16(const uint8_t* p, uint32_t w[4]) {
#ifdef __CUDA_ARCH__
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
#else
  memcpy(w, p, 16);
#endif
}

// The 16 virtual bytes at window position v of row r: zeros in the
// padding, else the body's word, the head's register (by the global byte
// table `tables`) XORed into the first.
STPU_HD void body_word(const CrcRow& r, int64_t v, const uint32_t* tables, uint32_t w[4]) {
  w[0] = w[1] = w[2] = w[3] = 0;
  if (v < r.pad) return;
  load16(r.p + r.a0 + (v - r.pad), w);
  if (v == r.pad) w[0] ^= crc_bytes(tables, 1, 0xFFFFFFFFu, r.p, r.a0);
}

// Fold lanes 0 .. 2^levels - 1 of reg into lane 0: level q advances lane l
// across the bytes of lane l + 2^q (the table at adv + 1024 q) and XORs it
// in, in the lanes whose register a later level reads (the others look
// nothing up, so fewer lanes share the one-copy table's banks).  Returns
// lane 0's register.
STPU_HD uint32_t fold_lanes(Lanes<uint32_t>& reg, const uint32_t* adv, uint32_t levels) {
  for (uint32_t q = 0; q < levels; ++q) {
    Lanes<uint32_t> src;
    STPU_LANES(l) { src[l] = l + (1u << q); }
    const Lanes<uint32_t> right = warp_shfl(reg, src);
    STPU_LANES(l) {
      if ((l & ((2u << q) - 1)) == 0) reg[l] = adv4(adv + 1024u * q, reg[l]) ^ right[l];
    }
  }
  return warp_bcast(reg, 0);
}

// A warp body takes the warp's kWarpBytes of a tile in two steps: load()
// brings its 16-byte words into registers (issued a tile ahead, so that
// they arrive while the warp works on the tile before; a head's bytes by
// the global byte table `tables`), crc() gives their zero-init register.
// tb: the per-bank slicing tables; sadv: levels kAdvLo .. kAdvHi; stage:
// the warp's scratch in shared memory.
//
// Layout (i): lane l takes the kPiece bytes at kPiece l of each stride.
struct Interleaved {
  static constexpr uint32_t kStageWords = 0;
  static constexpr uint32_t kPieces = kWarpBytes / kStride;  // pieces a lane
  struct Data {
    uint32_t w[kPieces][kPiece / 4];
  };
  STPU_HD_MEMBER void load(const CrcRow& r, int64_t v0, const uint32_t* tables, Lanes<Data>& d) {
    STPU_LANES(l) {
      if (v0 >= r.pad) {  // all in the body: plain loads, the head's register at its start
        const uint8_t* p = r.p + r.a0 + (v0 - r.pad) + kPiece * l;
        for (uint32_t k = 0; k < kPieces; ++k)
          for (uint32_t h = 0; h < kPiece / 16; ++h)
            load16(p + kStride * k + 16 * h, d[l].w[k] + 4 * h);
        if (v0 == r.pad && l == 0) d[l].w[0][0] ^= crc_bytes(tables, 1, 0xFFFFFFFFu, r.p, r.a0);
      } else {
        for (uint32_t k = 0; k < kPieces; ++k)
          for (uint32_t h = 0; h < kPiece / 16; ++h)
            body_word(r, v0 + kStride * k + kPiece * l + 16 * h, tables, d[l].w[k] + 4 * h);
      }
    }
  }
  STPU_HD_MEMBER uint32_t crc(const Lanes<Data>& d, const uint32_t* tb, const uint32_t* sadv,
                              uint32_t*) {
    const uint32_t* adv_stride = sadv + 1024u * (ilog2(kStride) - kAdvLo);
    Lanes<uint32_t> reg;
    STPU_LANES(l) {
      uint32_t c = 0;
      for (uint32_t k = 0; k < kPieces; ++k) {
        uint32_t x = 0;
        for (uint32_t q = 0; q < kPiece / 4; ++q) x = slice4(tb, l, x ^ d[l].w[k][q]);
        c = adv4(adv_stride, c) ^ x;
      }
      reg[l] = c;
    }
    return fold_lanes(reg, sadv + 1024u * (ilog2(kPiece) - kAdvLo), 5);
  }
};

// Tile slot t: row t / nt_max, its tile j = t % nt_max (no division where
// every row is one tile, a 32-bit one where t fits).
struct TileAt {
  int64_t t, row, j;
  CrcRow r;
};

STPU_HD void tile_slot(int64_t t, int64_t nt_max, int64_t& row, int64_t& j) {
  if (nt_max == 1) {
    row = t, j = 0;
  } else if ((uint64_t)t >> 32 == 0) {
    row = (uint32_t)t / (uint32_t)nt_max, j = (uint32_t)t - (uint32_t)(row * nt_max);
  } else {
    row = t / nt_max, j = t - row * nt_max;
  }
}

// The first tile at or after slot t, stepping by `step`, that a row has
// (slots past a row's nt hold nothing); its row's length is len where the
// caller read it ahead (len_ahead), else read here.
STPU_HD TileAt tile_from(int64_t t, bool len_ahead, int32_t len, int64_t step, int64_t total,
                         int64_t nt_max, const uint8_t* chunks, int64_t stride,
                         const int32_t* lengths) {
  TileAt at;
  for (; t < total; t += step, len_ahead = false) {
    tile_slot(t, nt_max, at.row, at.j);
    at.r = crc_row(chunks + at.row * stride, len_ahead ? len : lengths[at.row]);
    if (at.j < at.r.nt) break;
  }
  at.t = t;
  return at;
}

STPU_HD TileAt next_tile(int64_t t, int64_t step, int64_t total, int64_t nt_max,
                         const uint8_t* chunks, int64_t stride, const int32_t* lengths) {
  return tile_from(t, false, 0, step, total, nt_max, chunks, stride, lengths);
}

// Window position of warp w's bytes in the tile.
STPU_HD int64_t warp_v0(const TileAt& at, uint32_t w) {
  return at.j * kTile + (int64_t)kWarpBytes * w;
}

// The CTA's registers of its kCrcWarps warps, earliest first, folded into
// the tile's register (levels of kWarpBytes .. kTile / 2).
STPU_HD uint32_t fold_warps(const uint32_t* warp_regs, const uint32_t* sadv) {
  Lanes<uint32_t> reg;
  STPU_LANES(l) { reg[l] = l < kCrcWarps ? warp_regs[l] : 0; }
  return fold_lanes(reg, sadv + 1024u * (ilog2(kWarpBytes) - kAdvLo), ilog2(kCrcWarps));
}

// The CRC of row r from its body's register: the head alone where the body
// is empty, then the tail, inverted and masked (framing_format.txt:39-58).
// An empty row has CRC 0.
STPU_HD uint32_t crc_row_finish(const CrcRow& r, uint32_t body_reg, const uint32_t* t0,
                                uint32_t step) {
  uint32_t reg = r.e > r.a0 ? body_reg : crc_bytes(t0, step, 0xFFFFFFFFu, r.p, r.a0);
  reg = crc_bytes(t0, step, reg, r.p + r.e, r.len - r.e);
  const uint32_t crc = r.len == 0 ? 0u : reg ^ 0xFFFFFFFFu;
  return ((crc >> 15) | (crc << 17)) + kMaskDelta;
}

// Where a tile's register goes: the row's CRC where the tile is the
// whole row, else tile_regs[t] for the fold of its tiles.
STPU_HD void finish_tile(const TileAt& at, uint32_t reg, const uint32_t* tb, uint32_t* tile_regs,
                         uint32_t* out) {
  if (at.r.nt == 1)
    out[at.row] = crc_row_finish(at.r, reg, tb, 64);
  else
    tile_regs[at.t] = reg;
}

// The fold of a row of nt > 1 tiles: regs[0, nt) the tiles' registers,
// earliest first; adv the advance tables of levels kFoldLo .. kFoldLo + 10,
// [11][4][256].  One warp per group of 32 tiles (levels 64 KiB .. 1 MiB),
// then warp 0 over the groups (2 MiB .. 32 MiB), 1,024 tiles at a time, the
// earlier ones advanced across 64 MiB.  run_warps(body) runs body(w) for
// each warp w (all at once on the card, in turn in the twin); sync() is the
// CTA's barrier.
template <class RunWarps, class Sync>
STPU_HD uint32_t fold_tiles(const uint32_t* regs, int64_t nt, const uint32_t* adv,
                            uint32_t* warp_regs, RunWarps run_warps, Sync sync) {
  const int64_t span = 32 * kFoldWarps;
  const int64_t groups = (nt + span - 1) / span;
  const int64_t front = groups * span - nt;  // zero registers before tile 0
  uint32_t acc = 0;
  for (int64_t g = 0; g < groups; ++g) {
    run_warps([&](uint32_t w) {
      Lanes<uint32_t> reg;
      STPU_LANES(l) {
        const int64_t t = g * span + 32 * w + l - front;
        reg[l] = t >= 0 ? regs[t] : 0;
      }
      const uint32_t wr = fold_lanes(reg, adv, 5);
      STPU_LANES(l) {
        if (l == 0) warp_regs[w] = wr;
      }
    });
    sync();
    uint32_t group_reg = 0;
    run_warps([&](uint32_t w) {
      if (w != 0) return;
      Lanes<uint32_t> reg;
      STPU_LANES(l) { reg[l] = warp_regs[l]; }
      group_reg = fold_lanes(reg, adv + 1024u * 5, 5);
    });
    acc = adv4(adv + 1024u * 10, acc) ^ group_reg;
    sync();
  }
  return acc;
}

}  // namespace stpu

// Constants of the design, in both builds, for the tests and the
// measurement scripts: params = {kTile, kCrcWarps, shared bytes of a CTA of
// the tile kernel, bytes of its per-bank tables, CTAs of it per SM (the
// card's build; 0 in the twin's)}.
STPU_EXPORT void stpu_crc32c_params(int64_t* params);

#ifdef __CUDACC__

namespace {

// Two sets of the warps' registers, taken by turns from tile to tile.
constexpr size_t kSmemWords = stpu::kBankTabWords + stpu::kAdvWords + 2 * stpu::kCrcWarps;

// The tile kernel: one CTA of kCrcWarps warps per SM walks the tiles, each
// warp loading its words of the next tile before it works on this one.  A
// tile that is a whole row writes its CRC; a tile of a longer row writes its
// register to tile_regs[t] for the fold kernel.
template <class Body>
__global__ void __launch_bounds__(32 * stpu::kCrcWarps)
    crc32c_tiles_kernel(const uint8_t* __restrict__ chunks, int64_t stride,
                        const int32_t* __restrict__ lengths, int64_t n, int64_t nt_max,
                        const uint32_t* __restrict__ tables, const uint32_t* __restrict__ adv,
                        uint32_t* __restrict__ tile_regs, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tb = smem;
  uint32_t* sadv = tb + stpu::kBankTabWords;
  uint32_t* warp_regs = sadv + stpu::kAdvWords;
  uint32_t* stage = warp_regs + 2 * stpu::kCrcWarps + Body::kStageWords * (threadIdx.x / 32);
  const uint32_t tid = threadIdx.x, w = tid / 32, lane = tid & 31;
  // Three tiles in flight: this one (its words in registers), the next
  // (its loads issued), the one after (its row's length read).  The first
  // tile's loads go out before the tables are built.
  const int64_t total = n * nt_max, step = gridDim.x;
  stpu::TileAt at = stpu::next_tile(blockIdx.x, step, total, nt_max, chunks, stride, lengths);
  stpu::Lanes<typename Body::Data> cur, nxt;
  if (at.t < total) Body::load(at.r, stpu::warp_v0(at, w), tables, cur);
  STPU_PROF(0, {
    // the per-bank tables: lane l loads entry 32 k + l of a group of 32,
    // and each entry goes to the 32 words of its bank copies by a shuffle;
    // the advance tables as 16-byte words, every load issued first
    constexpr uint32_t kGroups = 4 * 256 / 32 / stpu::kCrcWarps;
    constexpr uint32_t kThreads = 32 * stpu::kCrcWarps, kAdv16 = stpu::kAdvWords / 4;
    constexpr uint32_t kAdvEach = (kAdv16 + kThreads - 1) / kThreads;
    uint32_t v[kGroups];
    uint4 a16[kAdvEach];
    const uint4* adv_src = reinterpret_cast<const uint4*>(adv + 1024u * stpu::kAdvLo);
#pragma unroll
    for (uint32_t g = 0; g < kGroups; ++g)
      v[g] = __ldg(tables + 32 * (w + stpu::kCrcWarps * g) + lane);
#pragma unroll
    for (uint32_t k = 0; k < kAdvEach; ++k)
      if (tid + kThreads * k < kAdv16) a16[k] = __ldg(adv_src + tid + kThreads * k);
#pragma unroll
    for (uint32_t g = 0; g < kGroups; ++g) {
      const uint32_t first = 32 * (w + stpu::kCrcWarps * g);
#pragma unroll
      for (uint32_t e = 0; e < 32; ++e)
        tb[stpu::bank_word((first + e) / 256, (first + e) % 256, lane)] =
            __shfl_sync(0xFFFFFFFFu, v[g], e);
    }
#pragma unroll
    for (uint32_t k = 0; k < kAdvEach; ++k)
      if (tid + kThreads * k < kAdv16) reinterpret_cast<uint4*>(sadv)[tid + kThreads * k] = a16[k];
    __syncthreads();
  });
  stpu::TileAt next = stpu::next_tile(at.t + step, step, total, nt_max, chunks, stride, lengths);
  STPU_PROF(7, for (uint32_t turn = 0; at.t < total; turn ^= 1) {
    const int64_t after_t = next.t + step;
    int64_t after_row = 0, after_j = 0;
    if (after_t < total) stpu::tile_slot(after_t, nt_max, after_row, after_j);
    const int32_t after_len = after_t < total ? __ldg(lengths + after_row) : 0;
    STPU_PROF(1, if (next.t < total) Body::load(next.r, stpu::warp_v0(next, w), tables, nxt));
    STPU_PROF(2, const uint32_t wr = Body::crc(cur, tb, sadv, stage));
    uint32_t* regs = warp_regs + stpu::kCrcWarps * turn;
    if (lane == 0) regs[w] = wr;
    STPU_PROF(3, __syncthreads());
    STPU_PROF(4, if (w == 0) {
      const uint32_t reg = stpu::fold_warps(regs, sadv);
      if (lane == 0) stpu::finish_tile(at, reg, tb, tile_regs, out);
    });
    STPU_PROF(5, const stpu::TileAt after = stpu::tile_from(after_t, true, after_len, step, total,
                                                           nt_max, chunks, stride, lengths));
    at = next;
    next = after;
    cur = nxt;
  });
}

// The fold kernel: one CTA per row; rows of one tile return at once.  The
// CTA first copies its advance tables into shared memory.
__global__ void __launch_bounds__(32 * stpu::kFoldWarps)
    crc32c_fold_kernel(const uint8_t* __restrict__ chunks, int64_t stride,
                       const int32_t* __restrict__ lengths, int64_t nt_max,
                       const uint32_t* __restrict__ tables, const uint32_t* __restrict__ adv,
                       const uint32_t* __restrict__ tile_regs, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* sadv = smem;
  uint32_t* warp_regs = sadv + stpu::kFoldWords;
  const int64_t row = blockIdx.x;
  const stpu::CrcRow r = stpu::crc_row(chunks + row * stride, lengths[row]);
  if (r.nt == 1) return;
  const uint4* src = reinterpret_cast<const uint4*>(adv + 1024u * stpu::kFoldLo);
  for (uint32_t i = threadIdx.x; i < stpu::kFoldWords / 4; i += blockDim.x)
    reinterpret_cast<uint4*>(sadv)[i] = __ldg(src + i);
  __syncthreads();
  const uint32_t w = threadIdx.x / 32;
  const uint32_t reg = stpu::fold_tiles(
      tile_regs + row * nt_max, r.nt, sadv, warp_regs, [&](auto body) { body(w); },
      [] { __syncthreads(); });
  if (threadIdx.x == 0) out[row] = stpu::crc_row_finish(r, reg, tables, 1);
}

template <class Body>
constexpr size_t tiles_smem() {
  return 4 * (kSmemWords + (size_t)Body::kStageWords * stpu::kCrcWarps);
}

template <class Body>
int tiles_ctas_per_sm() {
  static int blocks = -1;
  if (blocks >= 0) return blocks;
  cudaFuncSetAttribute(crc32c_tiles_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)tiles_smem<Body>());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, crc32c_tiles_kernel<Body>,
                                                32 * stpu::kCrcWarps, tiles_smem<Body>());
  return blocks;
}

// Both launches of one call on `stream`: the tile kernel on a grid of
// (CTAs per SM) x SMs, at most one CTA a tile, then the fold kernel where a
// row has more than one tile.
template <class Body>
int launch_crc(const uint8_t* chunks, int64_t stride, const int32_t* lengths, int n,
               int64_t nt_max, const uint32_t* tables, const uint32_t* adv, uint32_t* tile_regs,
               uint32_t* out, cudaStream_t stream) {
  // the shared-memory limits and the SM count, once per device
  constexpr int kDevices = 64;
  static int sms_of[kDevices];
  const size_t smem = tiles_smem<Body>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int& sms = sms_of[dev % kDevices];
  if (sms == 0) {
    if ((err = cudaFuncSetAttribute(crc32c_tiles_kernel<Body>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) ||
        (err = cudaFuncSetAttribute(crc32c_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)(4 * (stpu::kFoldWords + stpu::kFoldWarps)))) ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
      return (int)err;
  }
  const int64_t total = (int64_t)n * nt_max;
  const int64_t grid =
      stpu::min_i64(total, (int64_t)sms * stpu::max_i64(tiles_ctas_per_sm<Body>(), 1));
  crc32c_tiles_kernel<Body><<<(unsigned)grid, 32 * stpu::kCrcWarps, smem, stream>>>(
      chunks, stride, lengths, n, nt_max, tables, adv, tile_regs, out);
  if ((err = cudaGetLastError()) != cudaSuccess || nt_max == 1) return (int)err;
  const size_t fold_smem = 4 * (stpu::kFoldWords + stpu::kFoldWarps);
  crc32c_fold_kernel<<<n, 32 * stpu::kFoldWarps, fold_smem, stream>>>(
      chunks, stride, lengths, nt_max, tables, adv, tile_regs, out);
  return (int)cudaGetLastError();
}

}  // namespace

STPU_EXPORT void stpu_crc32c_params(int64_t* params) {
  params[0] = stpu::kTile;
  params[1] = stpu::kCrcWarps;
  params[2] = (int64_t)tiles_smem<stpu::Interleaved>();
  params[3] = 4 * stpu::kBankTabWords;
  params[4] = tiles_ctas_per_sm<stpu::Interleaved>();
}

// chunks: uint8 [n, >= stride], row r at chunks + r * stride, any
// alignment; lengths: int32 [n]; nt_max: max(1, ceil(max length / kTile));
// tables: uint32 [4, 256] slicing tables; adv: uint32 [32, 4, 256], the
// "advance by 2^j bytes" tables; tile_regs: uint32 [n * nt_max] scratch
// (unused where nt_max is 1); out: uint32 [n].  Returns the first CUDA
// error of the launches.
STPU_EXPORT int stpu_crc32c_chunks(const uint8_t* chunks, int64_t stride, const int32_t* lengths,
                                   int n, int64_t nt_max, const uint32_t* tables,
                                   const uint32_t* adv, uint32_t* tile_regs, uint32_t* out,
                                   void* stream) {
  return launch_crc<stpu::Interleaved>(chunks, stride, lengths, n, nt_max, tables, adv, tile_regs,
                                       out, (cudaStream_t)stream);
}

#else  // CPU twin: the same tiles, warps and folds; the warps of a CTA in turn

#include <vector>

STPU_EXPORT void stpu_crc32c_params(int64_t* params) {
  params[0] = stpu::kTile;
  params[1] = stpu::kCrcWarps;
  params[2] = 4 * (stpu::kBankTabWords + stpu::kAdvWords + 2 * stpu::kCrcWarps);
  params[3] = 4 * stpu::kBankTabWords;
  params[4] = 0;
}

// The twin of both launches with warp body Body.
template <class Body>
int twin_crc(const uint8_t* chunks, int64_t stride, const int32_t* lengths, int n, int64_t nt_max,
             const uint32_t* tables, const uint32_t* adv, uint32_t* tile_regs, uint32_t* out) {
  std::vector<uint32_t> tb(stpu::kBankTabWords), sadv(stpu::kAdvWords);
  std::vector<uint32_t> stage(Body::kStageWords + 1);
  for (uint32_t e = 0; e < 4 * 256; ++e)
    for (uint32_t l = 0; l < 32; ++l) tb[stpu::bank_word(e / 256, e % 256, l)] = tables[e];
  for (uint32_t i = 0; i < stpu::kAdvWords; ++i) sadv[i] = adv[1024u * stpu::kAdvLo + i];
  uint32_t warp_regs[stpu::kFoldWarps];
  stpu::Lanes<typename Body::Data> data;
  const int64_t total = (int64_t)n * nt_max;
  for (stpu::TileAt at = stpu::next_tile(0, 1, total, nt_max, chunks, stride, lengths);
       at.t < total; at = stpu::next_tile(at.t + 1, 1, total, nt_max, chunks, stride, lengths)) {
    for (uint32_t w = 0; w < stpu::kCrcWarps; ++w) {
      Body::load(at.r, stpu::warp_v0(at, w), tables, data);
      warp_regs[w] = Body::crc(data, tb.data(), sadv.data(), stage.data());
    }
    stpu::finish_tile(at, stpu::fold_warps(warp_regs, sadv.data()), tb.data(), tile_regs, out);
  }
  for (int64_t row = 0; row < n; ++row) {
    const stpu::CrcRow r = stpu::crc_row(chunks + row * stride, lengths[row]);
    if (r.nt == 1) continue;
    const uint32_t reg = stpu::fold_tiles(
        tile_regs + row * nt_max, r.nt, adv + 1024u * stpu::kFoldLo, warp_regs,
        [](auto body) {
          for (uint32_t w = 0; w < stpu::kFoldWarps; ++w) body(w);
        },
        [] {});
    out[row] = stpu::crc_row_finish(r, reg, tables, 1);
  }
  return 0;
}

STPU_EXPORT int stpu_twin_crc32c_chunks(const uint8_t* chunks, int64_t stride,
                                        const int32_t* lengths, int n, int64_t nt_max,
                                        const uint32_t* tables, const uint32_t* adv,
                                        uint32_t* tile_regs, uint32_t* out) {
  return twin_crc<stpu::Interleaved>(chunks, stride, lengths, n, nt_max, tables, adv, tile_regs,
                                     out);
}

#endif
