"""Measure the block encoder kernel (K3) on one CUDA card: its two layouts
side by side, and where one block's walk spends its cycles.

    python -m snappy_tpu_torch.testing.encode_layouts [--reps N]

Layout (b), the package's: only the hash table in shared memory, the block
read from global memory.  Layout (a): the 64 KiB block staged in shared
memory beside the table, which this script builds as a kernel of its own
around the package's walk (``stpu::encode_block_warp`` on a block type
that reads shared memory).  Both come from one scratch source that
includes ``ops/csrc/encode_blocks.cu`` unchanged, built twice under
``build/snappy_tpu_torch/``: as it is, and with the walk's timing hooks
(``STPU_PROF``) defined as ``clock64`` counters in lane 0 around each
phase of the walk (probe batches, match extension, literal copy, copy-tag
emit, the step after a match) and around the whole walk.

On the 768 full 64 KiB blocks of the seeded 48 MiB payload, for each
``ways``: each build's bytes must equal the package kernel's; the kernel
time of layouts a and b by CUDA events (the mean of ``reps`` launches after
a warm-up, in the order a, b, b, a; layout b is the package kernel);
registers per thread (``-Xptxas -v``) and CTAs per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); then the profiled
layouts' cycles per block (the mean, the slowest and the 90th percentile)
and per tag, split by phase.  First, the latency of the warp primitives the
walk is built from (one warp, a chain of 1,024 dependent operations each: a
shared-memory load at random addresses, a shuffle, a ballot,
__match_any_sync over 32 distinct and 32 equal values, a global load at
random addresses in 16 MiB).  Every line names the card and its power
limit.  Needs CUDA; exits nonzero without it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

PHASES = ("probe batches", "extension after a batch hit", "literal copy", "copy-tag emit",
          "step after a match, with its extension")
WALK = 7  # the hook around the whole walk

# The scratch source.  With STPU_ENC_PROFILE, each hook adds its cycles and
# a call to its CTA's 16 counters (fire-and-forget adds to its own slots,
# so no two warps contend): the cycles of hook k in slot k, its calls in
# slot 8 + k.
_SOURCE = r"""
#ifdef STPU_ENC_PROFILE
__device__ unsigned long long g_enc_prof[1024 * 16];
#ifdef __CUDA_ARCH__
__device__ __forceinline__ void prof_add(int k, long long cycles) {
  if ((threadIdx.x & 31) == 0) {
    unsigned long long* slot = &g_enc_prof[(blockIdx.x & 1023) * 16];
    atomicAdd(slot + k, (unsigned long long)cycles);
    atomicAdd(slot + 8 + k, 1ull);
  }
}
#define STPU_PROF_CAT2(a, b) a##b
#define STPU_PROF_CAT(a, b) STPU_PROF_CAT2(a, b)
#define STPU_PROF(k, ...)                                       \
  const long long STPU_PROF_CAT(prof_t, __LINE__) = clock64();  \
  __VA_ARGS__;                                                  \
  prof_add(k, clock64() - STPU_PROF_CAT(prof_t, __LINE__))
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

template <int Ways>
constexpr size_t smem_bytes() {
  return stpu::kMaxBlock + Ways * stpu::kTableSize * sizeof(uint16_t);
}

template <int Ways>
__global__ void __launch_bounds__(32)
    kernel(const uint8_t* __restrict__ blocks, int64_t in_stride,
           const int32_t* __restrict__ lens, uint8_t* __restrict__ out,
           int64_t out_stride, int32_t* __restrict__ out_len) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t lane = threadIdx.x;
  const int64_t row = blockIdx.x;
  const uint32_t n = (uint32_t)lens[row];
  const uint8_t* src = blocks + row * in_stride;
  uint16_t* table = reinterpret_cast<uint16_t*>(smem + stpu::kMaxBlock);
  uint4* tab16 = reinterpret_cast<uint4*>(table);
  const uint32_t tab_chunks = Ways * stpu::table_entries(n) * sizeof(uint16_t) / 16;
  for (uint32_t k = lane; k < tab_chunks; k += 32) tab16[k] = make_uint4(0, 0, 0, 0);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // 16-byte words; the last may run past n but holds a byte of the row
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    uint4* d16 = reinterpret_cast<uint4*>(smem);
#pragma unroll 8
    for (uint32_t k = lane; k < (n + 15) / 16; k += 32) d16[k] = __ldg(s16 + k);
  } else {
    for (uint32_t k = lane; k < n; k += 32) smem[k] = src[k];
  }
  __syncwarp();
  const SmemBlock block = {smem, n};
  STPU_PROF(7, const uint32_t len =
                   stpu::encode_block_warp<Ways>(block, out + row * out_stride, table));
  if (lane == 0) out_len[row] = (int32_t)len;
}

template <int Ways>
int launch(const uint8_t* blocks, int64_t in_stride, const int32_t* lens, int n,
           uint8_t* out, int64_t out_stride, int32_t* out_len, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel<Ways>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<Ways>());
  if (err != cudaSuccess) return (int)err;
  kernel<Ways><<<n, 32, smem_bytes<Ways>(), stream>>>(blocks, in_stride, lens, out,
                                                       out_stride, out_len);
  return (int)cudaGetLastError();
}

template <class K>
int occupancy(K k, size_t smem) {
  int blocks = -1;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, 32, smem);
  return blocks;
}

}  // namespace staged

// The arguments of stpu_encode_blocks.
STPU_EXPORT int stpu_encode_blocks_staged(const uint8_t* blocks, int64_t in_stride,
                                          const int32_t* lens, int n, uint8_t* out,
                                          int64_t out_stride, int32_t* out_len, int ways,
                                          void* stream) {
  return ways == 1 ? staged::launch<1>(blocks, in_stride, lens, n, out, out_stride, out_len,
                                       (cudaStream_t)stream)
                   : staged::launch<2>(blocks, in_stride, lens, n, out, out_stride, out_len,
                                       (cudaStream_t)stream);
}

// CTAs per SM of layout a (staged) or b.
STPU_EXPORT int stpu_enc_occupancy(int ways, int stage) {
  if (stage)
    return ways == 1 ? staged::occupancy(staged::kernel<1>, staged::smem_bytes<1>())
                     : staged::occupancy(staged::kernel<2>, staged::smem_bytes<2>());
  return ways == 1 ? staged::occupancy(encode_blocks_kernel<1>, enc_smem<1>())
                   : staged::occupancy(encode_blocks_kernel<2>, enc_smem<2>());
}

#ifdef STPU_ENC_PROFILE
// reset: zero the counters; else copy each CTA's 16 into host[1024 * 16]
STPU_EXPORT int stpu_enc_prof(unsigned long long* host, int reset) {
  static unsigned long long zero[1024 * 16];
  if (reset) return (int)cudaMemcpyToSymbol(g_enc_prof, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, g_enc_prof, sizeof(zero));
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


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("encode_layouts: torch.cuda is not available")
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
        for entry in ("stpu_encode_blocks", "stpu_encode_blocks_staged"):
            getattr(lib, entry).argtypes = _build._ENTRY_POINTS["encode_blocks"]
        lib.stpu_enc_occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
        libs[name] = lib
    libs["profile"].stpu_enc_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    f = root / "primitives.cu"
    f.write_text(_PRIMITIVES)
    prim = ctypes.CDLL(str(_build._build("encode_primitives", cmd, link, [f])))
    prim.stpu_primitive_chains.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}:" + line.split("ptxas", 1)[-1])

    dev = torch.device("cuda:0")
    chain_out = torch.zeros(8, dtype=torch.int64, device=dev)
    scratch = torch.arange(1 << 22, dtype=torch.int32, device=dev)
    for _ in range(2):  # the second run is the one read
        assert prim.stpu_primitive_chains(chain_out.data_ptr(), scratch.data_ptr()) == 0
    chains = chain_out.cpu().tolist()
    print("latency, cycles per dependent operation of one warp: " + ", ".join(
        f"{name} {chains[k] / 1024:.1f}" for k, name in enumerate(PRIMITIVES)) + f" {tag}")
    del scratch
    nf = payloads.MAIN_PATH_FRAMES
    payload = payloads.mixed_payload()
    arr = np.frombuffer(payload, dtype=np.uint8)[: nf * 65536]
    blocks = torch.from_numpy(arr.copy()).view(nf, 65536).to(dev)
    lens = torch.full((nf,), 65536, dtype=torch.int32, device=dev)
    enc = torch.empty((nf, encode_blocks.ENC_CAP), dtype=torch.uint8, device=dev)
    elen = torch.empty(nf, dtype=torch.int32, device=dev)

    # (library, layout): layout b of the "package" library is the port's own
    # kernel; each library holds layout a as stpu_encode_blocks_staged
    def launch(lib, layout, ways):
        if lib == "package":
            encode_blocks._launch(blocks, lens, enc, elen, ways)
            return
        entry = "stpu_encode_blocks_staged" if layout == "a" else "stpu_encode_blocks"
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(libs[lib], entry)(
            blocks.data_ptr(), 65536, lens.data_ptr(), nf, enc.data_ptr(),
            encode_blocks.ENC_CAP, elen.data_ptr(), ways, stream)
        assert rc == 0, (lib, layout, ways, rc)

    def event_ms(lib, layout, ways):
        launch(lib, layout, ways)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            launch(lib, layout, ways)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    variants = (("layouts", "a"), ("layouts", "b"), ("profile", "a"), ("profile", "b"))
    result = {"primitive_cycles": {name: chains[k] / 1024 for k, name in enumerate(PRIMITIVES)}}
    for ways in (1, 2):
        launch("package", "b", ways)
        want_len, want = elen.cpu(), enc.cpu()
        for lib, layout in variants:
            elen.fill_(-1)
            launch(lib, layout, ways)
            got_len, got = elen.cpu(), enc.cpu()
            assert torch.equal(got_len, want_len), (lib, layout, ways, "lengths")
            for k, m in enumerate(want_len.tolist()):
                assert torch.equal(got[k, :m], want[k, :m]), (lib, layout, ways, k)
        print(f"ways={ways}: layouts a and b, with and without the counters, give the package "
              f"kernel's bytes on {nf} blocks ({int(want_len.sum())} bytes) {tag}")
        times = {"a": [], "b": []}
        for layout in ("a", "b", "b", "a"):
            times[layout].append(event_ms("layouts" if layout == "a" else "package", layout, ways))
        occ = {layout: libs["layouts"].stpu_enc_occupancy(ways, layout == "a") for layout in "ab"}
        print(f"ways={ways}: " + "; ".join(
            f"layout {layout} {times[layout][0]:.4f} / {times[layout][1]:.4f} ms, "
            f"{occ[layout]} CTAs per SM" for layout in "ab")
            + f" ({nf} x 64 KiB blocks, mean of {args.reps}; layout b is the package kernel) {tag}")
        result[f"ways{ways}"] = {"ms": times, "ctas_per_sm": occ}
        for layout in "ab":
            prof = libs["profile"]
            per_cta = np.zeros((1024, 16), dtype=np.uint64)
            prof_ms = event_ms("profile", layout, ways)
            prof.stpu_enc_prof(None, 1)
            launch("profile", layout, ways)
            torch.cuda.synchronize()
            assert prof.stpu_enc_prof(per_cta.ctypes.data, 0) == 0
            blocks_c = per_cta[:nf].astype(np.int64)
            c = [int(v) for v in blocks_c.sum(axis=0)]
            walks = blocks_c[:, WALK]
            walk = c[WALK] / nf
            tags = (c[8 + 2] + c[8 + 3]) / nf
            parts = ", ".join(
                f"{ph} {c[k] / nf:,.0f} ({100 * c[k] / max(c[WALK], 1):.1f}%, {c[8 + k] / nf:,.1f} calls, "
                f"{c[k] / max(c[8 + k], 1):,.0f} each)" for k, ph in enumerate(PHASES))
            print(f"ways={ways} layout {layout}, profiled: one block's walk {walk:,.0f} cycles "
                  f"(slowest {int(walks.max()):,}, 90th percentile {int(np.percentile(walks, 90)):,}), "
                  f"{tags:,.1f} tags (literals + copies), {walk / max(tags, 1):,.0f} cycles a tag; "
                  f"{parts}; kernel {prof_ms:.4f} ms with the counters {tag}")
            slow = blocks_c[int(np.argmax(walks))]
            slow_tags = int(slow[10] + slow[11])
            print(f"ways={ways} layout {layout}, profiled, the slowest block: {slow_tags:,} tags, "
                  f"{int(slow[WALK]) / max(slow_tags, 1):,.0f} cycles a tag; " + ", ".join(
                      f"{ph} {int(slow[k]):,} ({int(slow[8 + k]):,} calls, "
                      f"{int(slow[k]) / max(int(slow[8 + k]), 1):,.0f} each)"
                      for k, ph in enumerate(PHASES)) + f" {tag}")
            result[f"ways{ways}"][f"profile_{layout}"] = {
                "walk_cycles": walk, "walk_max": int(walks.max()), "tags": tags,
                "cycles": c[:5], "calls": c[8:13], "slowest": [int(v) for v in slow]}
    print(json.dumps({"encode_layouts": result, "card": card}))


if __name__ == "__main__":
    main()
