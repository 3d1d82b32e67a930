"""Measure the block encoder kernel (K3) on one CUDA card: its launch
beside the launches it replaced and beside a staged layout, and where each
block's walk spends its cycles.

    python -m snappy_tpu_torch.testing.encode_layouts [--reps N] [--seed S] [--out FILE]

Four launches of the same walk (``stpu::encode_block_warp``), each
reading only its hash table from shared memory unless named staged:
- ``ordered``, the package's (``encode_blocks._launch``): one CTA an SM of
  walkers, each a warp with its own table, taking rows from a queue on the
  card (``encode_blocks.launch_shape``), costliest first where there are
  more rows than walkers (a first launch times walks of four pieces of
  each row);
- ``persistent``: the same walkers taking the rows in index order;
- ``per_cta``: one one-warp CTA a block, the launch before these (32 KiB
  of shared memory at ways=1, so 6 CTAs an SM; 3 at ways=2);
- ``staged``: layout (a), one one-warp CTA a block with the 64 KiB block
  staged in shared memory beside its table.
All come from one scratch source that includes ``ops/csrc/encode_blocks.cu``
unchanged, built twice under ``build/snappy_tpu_torch/``: as it is, and
with the walk's timing hooks (``STPU_PROF``) defined as ``clock64``
counters in lane 0 around each phase of the walk (probe batches, match
extension, literal copy, copy-tag emit, the step after a match); the hook
around the whole walk, in each kernel, files a walker's counters under the
row it walked.

Two batches: the 768 full 64 KiB blocks of the seeded 48 MiB payload, and
the 3,441 frames of the mainnet beacon state that
``benchmark/configs/beacon_state/generate.py`` makes on the card from
``--seed``.  For each batch and ``ways``: each launch's bytes must equal
the package kernel's; the kernel time of each by CUDA events (the mean of
``reps`` launches after a warm-up, in the order per_cta, persistent,
ordered, staged, then back); registers per thread (``-Xptxas -v``) and CTAs
per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); then, profiled,
the walk's cycles per block and per tag split by phase under the ordered,
persistent and per_cta launches, the makespan of list scheduling those
walks on the launch's walkers in index order, longest first and (ordered)
in the order of its estimates, and on the state the walk cycles of each
frame summed by region (roots and randao, validators, balances and
participation, inactivity and the tail).  First, the latency of the warp
primitives the walk is built from (one warp, a chain of 1,024 dependent
operations each).  Every line names the card and its power limit;
``--out`` takes the JSON of every number, each frame's cycles and
estimate too.  Run from the root of the checkout (it reads
``benchmark/``).  Needs CUDA; exits nonzero without it.
"""

from __future__ import annotations

import argparse
import ctypes
import heapq
import json
import subprocess

PHASES = ("probe batches", "extension after a batch hit", "literal copy", "copy-tag emit",
          "step after a match, with its extension")
WALK = 7  # the hook around the whole walk
PROF_ROWS = 16384  # rows the profiled build files counters under
LAUNCHES = ("per_cta", "persistent", "ordered", "staged")
OCCUPANCY_KIND = {"per_cta": 0, "persistent": 1, "ordered": 1, "staged": 2}  # stpu_enc_occupancy's
REGIONS = ("roots and randao", "validators", "balances and participation", "inactivity and the tail")

# The scratch source.  With STPU_ENC_PROFILE, each phase hook adds its
# cycles and a call to its walker's 16 counters (lane 0 of the warp alone
# writes them): the cycles of hook k in slot k, its calls in slot 8 + k.
# The hook around the whole walk (7), in each kernel where ``row`` is the
# row walked, moves the walker's counters to that row's and puts the walk's
# cycles in slot 7.
_SOURCE = r"""
#ifdef STPU_ENC_PROFILE
constexpr int kProfRows = 16384, kProfWalkers = 4096;
__device__ unsigned long long g_enc_walker[kProfWalkers * 16];
__device__ unsigned long long g_enc_row[kProfRows * 16];
#ifdef __CUDA_ARCH__
__device__ __forceinline__ unsigned long long* prof_walker() {
  return g_enc_walker + (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) % kProfWalkers * 16;
}
__device__ __forceinline__ void prof_add(int k, long long cycles) {
  if ((threadIdx.x & 31) == 0) {
    unsigned long long* w = prof_walker();
    w[k] += cycles;
    w[8 + k] += 1;
  }
}
__device__ __forceinline__ void prof_row(int64_t row, long long cycles) {
  if ((threadIdx.x & 31) == 0) {
    unsigned long long *w = prof_walker(), *r = g_enc_row + row % kProfRows * 16;
    for (int k = 0; k < 16; ++k) r[k] = w[k], w[k] = 0;
    r[7] = cycles;
    r[15] = 1;
  }
}
#define STPU_PROF_CAT2(a, b) a##b
#define STPU_PROF_CAT(a, b) STPU_PROF_CAT2(a, b)
#define STPU_PROF_T STPU_PROF_CAT(prof_t, __LINE__)
#define STPU_PROF_AT(k, ...) \
  const long long STPU_PROF_T = clock64(); __VA_ARGS__; prof_add(k, clock64() - STPU_PROF_T)
#define STPU_PROF_0(...) STPU_PROF_AT(0, __VA_ARGS__)
#define STPU_PROF_1(...) STPU_PROF_AT(1, __VA_ARGS__)
#define STPU_PROF_2(...) STPU_PROF_AT(2, __VA_ARGS__)
#define STPU_PROF_3(...) STPU_PROF_AT(3, __VA_ARGS__)
#define STPU_PROF_4(...) STPU_PROF_AT(4, __VA_ARGS__)
#define STPU_PROF_7(...) \
  const long long STPU_PROF_T = clock64(); __VA_ARGS__; prof_row(row, clock64() - STPU_PROF_T)
#define STPU_PROF(k, ...) STPU_PROF_##k(__VA_ARGS__)
#endif
#endif
#include "encode_blocks.cu"

namespace staged {

// Layout (a): the block in shared memory, 16-byte aligned, with the table
// after it, so that a word's aligned pair reads on into the table.
struct SmemBlock {
  const uint8_t* in;
  uint32_t n;
};
__host__ __device__ __forceinline__ uint32_t block_word(const SmemBlock& b, uint32_t p) {
#ifdef __CUDA_ARCH__
  const uint32_t* w = reinterpret_cast<const uint32_t*>(b.in) + (p >> 2);
  return __funnelshift_r(w[0], w[1], (p & 3) * 8);
#else
  return 0;
#endif
}
__host__ __device__ __forceinline__ uint8_t block_byte(const SmemBlock& b, uint32_t p) {
  return b.in[p];
}

}  // namespace staged

namespace one_warp {

// One one-warp CTA a block, its table at the start of shared memory and,
// with Stage, the block staged before it.
template <int Ways, bool Stage>
constexpr size_t smem_bytes() {
  return (Stage ? stpu::kMaxBlock : 0) + Ways * stpu::kTableSize * sizeof(uint16_t);
}

template <int Ways, bool Stage>
__global__ void __launch_bounds__(32)
    kernel(const uint8_t* __restrict__ blocks, int64_t in_stride,
           const int32_t* __restrict__ lens, uint8_t* __restrict__ out,
           int64_t out_stride, int32_t* __restrict__ out_len) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t lane = threadIdx.x;
  const int64_t row = blockIdx.x;
  const uint32_t n = (uint32_t)lens[row];
  const uint8_t* src = blocks + row * in_stride;
  uint16_t* table = reinterpret_cast<uint16_t*>(smem + (Stage ? stpu::kMaxBlock : 0));
  uint4* tab16 = reinterpret_cast<uint4*>(table);
  const uint32_t tab_chunks = Ways * stpu::table_entries(n) * sizeof(uint16_t) / 16;
  for (uint32_t k = lane; k < tab_chunks; k += 32) tab16[k] = make_uint4(0, 0, 0, 0);
  if constexpr (Stage) {
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      // 16-byte words; the last may run past n but holds a byte of the row
      const uint4* s16 = reinterpret_cast<const uint4*>(src);
      uint4* d16 = reinterpret_cast<uint4*>(smem);
#pragma unroll 8
      for (uint32_t k = lane; k < (n + 15) / 16; k += 32) d16[k] = __ldg(s16 + k);
    } else {
      for (uint32_t k = lane; k < n; k += 32) smem[k] = src[k];
    }
  }
  __syncwarp();
  if constexpr (Stage) {
    const staged::SmemBlock block = {smem, n};
    STPU_PROF(7, const uint32_t len =
                     stpu::encode_block_warp<Ways>(block, out + row * out_stride, table));
    if (lane == 0) out_len[row] = (int32_t)len;
  } else {
    const stpu::Block block = {src, n};
    STPU_PROF(7, const uint32_t len =
                     stpu::encode_block_warp<Ways>(block, out + row * out_stride, table));
    if (lane == 0) out_len[row] = (int32_t)len;
  }
}

template <int Ways, bool Stage>
int launch(const uint8_t* blocks, int64_t in_stride, const int32_t* lens, int n,
           uint8_t* out, int64_t out_stride, int32_t* out_len, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<Ways, Stage>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel<Ways, Stage>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<Ways, Stage><<<n, 32, smem, stream>>>(blocks, in_stride, lens, out, out_stride, out_len);
  return (int)cudaGetLastError();
}

template <int Ways, bool Stage>
int occupancy() {
  int blocks = -1;
  cudaFuncSetAttribute(kernel<Ways, Stage>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes<Ways, Stage>());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel<Ways, Stage>, 32,
                                                smem_bytes<Ways, Stage>());
  return blocks;
}

}  // namespace one_warp

// stpu_encode_blocks's arguments without the launch shape: one one-warp
// CTA a block, the block staged in shared memory where `stage`.
STPU_EXPORT int stpu_encode_blocks_one_warp(const uint8_t* blocks, int64_t in_stride,
                                            const int32_t* lens, int n, uint8_t* out,
                                            int64_t out_stride, int32_t* out_len, int ways,
                                            int stage, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (ways == 1)
    return stage ? one_warp::launch<1, true>(blocks, in_stride, lens, n, out, out_stride, out_len, s)
                 : one_warp::launch<1, false>(blocks, in_stride, lens, n, out, out_stride, out_len, s);
  return stage ? one_warp::launch<2, true>(blocks, in_stride, lens, n, out, out_stride, out_len, s)
               : one_warp::launch<2, false>(blocks, in_stride, lens, n, out, out_stride, out_len, s);
}

// CTAs per SM of the one-warp launch, staged or not; of the package's
// launch at `warps` walkers a CTA.
STPU_EXPORT int stpu_enc_occupancy(int ways, int launch, int warps) {
  if (launch == 0) return ways == 1 ? one_warp::occupancy<1, false>() : one_warp::occupancy<2, false>();
  if (launch == 2) return ways == 1 ? one_warp::occupancy<1, true>() : one_warp::occupancy<2, true>();
  int blocks = -1;
  const size_t smem = warps * (ways == 1 ? table_bytes<1>() : table_bytes<2>());
  if (ways == 1) {
    cudaFuncSetAttribute(encode_blocks_kernel<1, kIndexOrder>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, encode_blocks_kernel<1, kIndexOrder>, 32 * warps, smem);
  } else {
    cudaFuncSetAttribute(encode_blocks_kernel<2, kIndexOrder>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, encode_blocks_kernel<2, kIndexOrder>, 32 * warps, smem);
  }
  return blocks;
}

#ifdef STPU_ENC_PROFILE
// Zero every counter, walkers' and rows'.
STPU_EXPORT int stpu_enc_prof_reset() {
  void *w = nullptr, *r = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&w, g_enc_walker);
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&r, g_enc_row);
  if (err == cudaSuccess) err = cudaMemset(w, 0, sizeof(g_enc_walker));
  if (err == cudaSuccess) err = cudaMemset(r, 0, sizeof(g_enc_row));
  return (int)err;
}
// host: uint64 [kProfRows * 16], each row's 16 counters
STPU_EXPORT int stpu_enc_prof_rows(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_enc_row, sizeof(g_enc_row));
}
#endif
"""

_PRIMITIVES = r"""
#include <cstdint>
#define STPU_EXPORT extern "C" __attribute__((visibility("default")))
constexpr int kChain = 1024;
__global__ void chains(unsigned long long* out, const uint32_t* g) {
  __shared__ uint32_t sm[8192];
  const uint32_t lane = threadIdx.x;
  for (uint32_t i = lane; i < 8192; i += 32) sm[i] = (i * 2654435761u) & 8191;
  __syncwarp();
  uint32_t v = lane * 37, sink = 0;
  long long t = clock64();
  for (int i = 0; i < kChain; ++i) v = sm[v & 8191];
  out[0] = clock64() - t; sink += v;
  v = lane; t = clock64();
  for (int i = 0; i < kChain; ++i) v = __shfl_sync(0xffffffffu, v, (v + 1) & 31);
  out[1] = clock64() - t; sink += v;
  v = lane; t = clock64();
  for (int i = 0; i < kChain; ++i) v = __ballot_sync(0xffffffffu, (v >> (lane & 7)) & 1) + lane;
  out[2] = clock64() - t; sink += v;
  v = lane * 977; t = clock64();
  for (int i = 0; i < kChain; ++i) v = __match_any_sync(0xffffffffu, v) + lane * 977;
  out[3] = clock64() - t; sink += v;
  v = 5; t = clock64();
  for (int i = 0; i < kChain; ++i) v = __match_any_sync(0xffffffffu, v & 7) & 7;
  out[4] = clock64() - t; sink += v;
  v = lane * 4099; t = clock64();
  for (int i = 0; i < kChain; ++i) v = __ldg(g + ((v * 2654435761u) & ((1u << 22) - 1)));
  out[5] = clock64() - t; sink += v;
  out[6] = sink;
}
// out: 8 counters (cycles of each chain); g: 16 MiB of scratch, any contents
STPU_EXPORT int stpu_primitive_chains(unsigned long long* out, const uint32_t* g) {
  chains<<<1, 32>>>(out, g);
  return (int)cudaDeviceSynchronize();
}
"""
PRIMITIVES = ("shared load, random addresses", "shuffle", "ballot",
              "__match_any_sync, 32 distinct values", "__match_any_sync, 32 equal values",
              "global load, random addresses in 16 MiB")


def makespan(walks, slots: int) -> int:
    """The finish of list scheduling ``walks`` in their order on ``slots``
    walkers: each walk starts on the walker that is free first."""
    free = [0] * min(slots, len(walks))
    for w in walks:
        heapq.heapreplace(free, free[0] + int(w))
    return max(free)


def state_regions(cfg: dict, size: int, frame: int = 65536):
    """The first frame of each of REGIONS in the beacon state of ``cfg``
    (``size`` bytes), then the frame count: the lists at the state's end
    are, in generate.py's order, the validators, balances, the two
    participation lists, the inactivity scores, then the execution payload
    header and the queues."""
    v = cfg["validators"]
    tail = (436 + 4 + 144 + cfg["extra_data_bytes"] + 64 * cfg["historical_summaries"]
            + 192 * cfg["pending_deposits"] + 24 * cfg["pending_partial_withdrawals"]
            + 16 * cfg["pending_consolidations"])
    inactivity = size - tail - 8 * v
    balances = inactivity - 10 * v
    validators = balances - cfg["validator_bytes"] * v
    return [0] + [b // frame for b in (validators, balances, inactivity)] + [-(-size // frame)]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=3_000_000_102, help="the beacon state's seed")
    p.add_argument("--out", default=None, help="write every number, as JSON, here")
    args = p.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("encode_layouts: torch.cuda is not available")
    from benchmark.lib import cells, frames
    from snappy_tpu_torch.ops import _build, encode_blocks
    from snappy_tpu_torch.testing import payloads

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    tag = f"[{card}]"

    root = _build.BUILD_DIR / "encode_layouts"
    root.mkdir(parents=True, exist_ok=True)
    src = root / "encode_layouts.cu"
    src.write_text(_SOURCE)
    deps = [_build.CSRC / "encode_blocks.cu", _build.CSRC / "snappy_common.cuh"]
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    cmd = [_build._nvcc(), *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           f"-I{_build.CSRC}"]
    link = [_build._nvcc(), *arch, "-shared"]
    libs, logs = {}, {}
    for name, extra in (("layouts", []), ("profile", ["-DSTPU_ENC_PROFILE"])):
        so = _build._build(f"encode_{name}", cmd + extra, link, [src], deps)
        logs[name] = so.with_suffix(".log").read_text()
        lib = ctypes.CDLL(str(so))
        lib.stpu_encode_blocks.argtypes = _build._ENTRY_POINTS["encode_blocks"]
        lib.stpu_encode_blocks_one_warp.argtypes = _build._ENTRY_POINTS["encode_blocks"][:8] + [
            ctypes.c_int, ctypes.c_void_p]
        lib.stpu_enc_occupancy.argtypes = [ctypes.c_int] * 3
        libs[name] = lib
    libs["profile"].stpu_enc_prof_rows.argtypes = [ctypes.c_void_p]
    f = root / "primitives.cu"
    f.write_text(_PRIMITIVES)
    prim = ctypes.CDLL(str(_build._build("encode_primitives", cmd, link, [f])))
    prim.stpu_primitive_chains.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}:" + line.split("ptxas", 1)[-1])

    dev = torch.device("cuda:0")
    limits = encode_blocks.card_limits(dev)
    chain_out = torch.zeros(8, dtype=torch.int64, device=dev)
    scratch = torch.arange(1 << 22, dtype=torch.int32, device=dev)
    for _ in range(2):  # the second run is the one read
        assert prim.stpu_primitive_chains(chain_out.data_ptr(), scratch.data_ptr()) == 0
    chains = chain_out.cpu().tolist()
    print("latency, cycles per dependent operation of one warp: " + ", ".join(
        f"{name} {chains[k] / 1024:.1f}" for k, name in enumerate(PRIMITIVES)) + f" {tag}")
    del scratch

    nf = payloads.MAIN_PATH_FRAMES
    arr = np.frombuffer(payloads.mixed_payload(), dtype=np.uint8)[: nf * 65536]
    batches = {"payload": (torch.from_numpy(arr.copy()).view(nf, 65536).to(dev),
                           torch.full((nf,), 65536, dtype=torch.int32, device=dev))}
    cell = cells.load("beacon_state.encode_step")
    state, sizes = cell.generator().make(cell.config, args.seed, dev)
    table = frames.table(sizes, 65536)
    batches["state"] = (frames.rows(state, table, 65536),
                        torch.from_numpy(table.length.astype(np.int32)).to(dev))
    regions = state_regions(cell.config, sizes[0])
    del state
    print(f"state: {sizes[0]:,} bytes, {len(table.length):,} frames (seed {args.seed}); regions "
          + ", ".join(f"{r} frames {regions[k]}-{regions[k + 1] - 1}" for k, r in enumerate(REGIONS)))

    result = {"card": card, "limits": limits, "primitive_cycles": dict(zip(PRIMITIVES, chains))}
    per_frame = {}  # (batch, ways, launch) -> each row's walk cycles and tags
    for batch, (blocks, lens) in batches.items():
        n = len(lens)
        enc = torch.empty((n, encode_blocks.ENC_CAP), dtype=torch.uint8, device=dev)
        elen = torch.empty(n, dtype=torch.int32, device=dev)
        queue = torch.empty(1, dtype=torch.int32, device=dev)

        cost = torch.empty(n, dtype=torch.int32, device=dev)

        def launch(lib, which, ways):
            """One launch kind; ``ordered`` is the package's (encode_blocks._launch)."""
            stream = torch.cuda.current_stream(dev).cuda_stream
            if which in ("persistent", "ordered"):
                walkers, ctas = encode_blocks.launch_shape(n, ways, *limits)
                fn = libs[lib].stpu_encode_blocks
                rows = (blocks.data_ptr(), 65536, lens.data_ptr(), n, enc.data_ptr(), encode_blocks.ENC_CAP,
                        elen.data_ptr())
                order = None
                if which == "ordered" and n > walkers:
                    assert fn(*rows, 1, *encode_blocks.launch_shape(n, 1, *limits), queue.data_ptr(),
                              cost.data_ptr(), None, stream) == 0
                    order = torch.argsort(cost, descending=True, stable=True).to(torch.int32)
                rc = fn(*rows, ways, walkers, ctas, queue.data_ptr(), None,
                        None if order is None else order.data_ptr(), stream)
            else:
                rc = libs[lib].stpu_encode_blocks_one_warp(
                    blocks.data_ptr(), 65536, lens.data_ptr(), n, enc.data_ptr(),
                    encode_blocks.ENC_CAP, elen.data_ptr(), ways, which == "staged", stream)
            assert rc == 0, (lib, which, ways, rc)

        def event_ms(which, ways):
            launch("layouts", which, ways)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                launch("layouts", which, ways)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / args.reps

        for ways in (1, 2):
            encode_blocks._launch(blocks, lens, enc, elen, ways)
            want_len, want = elen.cpu(), enc.cpu()
            for lib in libs:
                for which in LAUNCHES:
                    elen.fill_(-1)
                    launch(lib, which, ways)
                    got_len, got = elen.cpu(), enc.cpu()
                    assert torch.equal(got_len, want_len), (batch, lib, which, ways, "lengths")
                    for k, m in enumerate(want_len.tolist()):
                        assert torch.equal(got[k, :m], want[k, :m]), (batch, lib, which, ways, k)
            print(f"{batch} ways={ways}: {', '.join(LAUNCHES)}, with and without the counters, give "
                  f"the package kernel's bytes on {n} blocks ({int(want_len.sum()):,} bytes) {tag}")
            times = {w: [] for w in LAUNCHES}
            for which in LAUNCHES + LAUNCHES[::-1]:
                times[which].append(event_ms(which, ways))
            walkers, ctas = encode_blocks.launch_shape(n, ways, *limits)
            warps = -(-walkers // ctas)
            occ = {w: libs["layouts"].stpu_enc_occupancy(ways, OCCUPANCY_KIND[w], warps) for w in LAUNCHES}
            print(f"{batch} ways={ways}: " + "; ".join(
                f"{w} {times[w][0]:.4f} / {times[w][1]:.4f} ms, {occ[w]} CTAs per SM" for w in LAUNCHES)
                + f"; persistent: {walkers} walkers on {ctas} CTAs of {warps} warps ({n} blocks, "
                f"mean of {args.reps}) {tag}")
            res = result.setdefault(batch, {})[f"ways{ways}"] = {
                "ms": times, "ctas_per_sm": occ, "walkers": walkers, "ctas": ctas}
            prof = libs["profile"]
            for which in ("ordered", "persistent", "per_cta"):
                assert prof.stpu_enc_prof_reset() == 0
                cost.fill_(-1)
                launch("profile", which, ways)
                torch.cuda.synchronize()
                rows = np.zeros((PROF_ROWS, 16), dtype=np.uint64)
                assert prof.stpu_enc_prof_rows(rows.ctypes.data) == 0
                rows = rows[:n].astype(np.int64)
                assert (rows[:, 15] == 1).all(), (batch, which, ways, "a row not walked once")
                c = rows.sum(axis=0)
                walks = rows[:, WALK]
                tags = rows[:, 10] + rows[:, 11]
                parts = ", ".join(
                    f"{ph} {c[k] / n:,.0f} ({100 * c[k] / max(c[WALK], 1):.1f}%, {c[8 + k] / n:,.1f} calls, "
                    f"{c[k] / max(c[8 + k], 1):,.0f} each)" for k, ph in enumerate(PHASES))
                print(f"{batch} ways={ways} {which}, profiled: one block's walk {c[WALK] / n:,.0f} cycles "
                      f"(slowest {int(walks.max()):,}, 90th percentile {int(np.percentile(walks, 90)):,}), "
                      f"{tags.sum() / n:,.1f} tags (literals + copies), "
                      f"{c[WALK] / max(tags.sum(), 1):,.0f} cycles a tag; {parts} {tag}")
                slots = walkers if which != "per_cta" else occ[which] * limits[1]
                model = {"index": makespan(walks, slots), "longest": makespan(np.sort(walks)[::-1], slots)}
                est = cost.cpu().numpy()
                if which == "ordered" and (est >= 0).all():
                    model["estimate"] = makespan(walks[np.argsort(-est, kind="stable")], slots)
                    model["estimate_corr"] = float(np.corrcoef(est, walks)[0, 1])
                print(f"{batch} ways={ways} {which}, list scheduling of these walks on {slots} slots: "
                      f"their sum spread evenly {c[WALK] / slots:,.0f} cycles, makespan in index order "
                      + ", ".join(f"{k} {v:,.3f}" if k == "estimate_corr" else f"{k} {v:,}" for k, v in
                                  model.items()) + f" ({c[WALK] / slots / model['index']:.3f} of index "
                      f"order spread evenly, longest first {model['longest'] / model['index']:.3f}) {tag}")
                res[f"profile_{which}"] = {
                    "walk_cycles": float(c[WALK] / n), "walk_max": int(walks.max()),
                    "tags": float(tags.sum() / n), "cycles": [int(v) for v in c[:5]],
                    "calls": [int(v) for v in c[8:13]], "slots": slots, "model": model}
                per_frame[f"{batch} ways={ways} {which}"] = {"walks": walks.tolist(), "tags": tags.tolist(),
                                                             "cost": est.tolist()}
                if batch != "state":
                    continue
                for k, r in enumerate(REGIONS):
                    lo, hi = regions[k], regions[k + 1]
                    w, t = walks[lo:hi], tags[lo:hi]
                    print(f"state ways={ways} {which}, {r} (frames {lo}-{hi - 1}): walks "
                          f"{int(w.sum()):,} cycles ({100 * w.sum() / c[WALK]:.1f}%), a frame "
                          f"{w.mean():,.0f} (min {int(w.min()):,}, max {int(w.max()):,}), tags a frame "
                          f"{t.mean():,.0f}, {w.sum() / max(t.sum(), 1):,.0f} cycles a tag {tag}")
        del blocks, lens, enc
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({**result, "regions": dict(zip(REGIONS, regions)), "per_frame": per_frame}, fh)
    print(json.dumps({"encode_layouts": result}))


if __name__ == "__main__":
    main()
