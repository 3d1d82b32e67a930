"""Measure the chunk decoder kernel (K2) on one CUDA card: its two layouts
at both shapes, and where one chunk's walk spends its cycles.

    python -m snappy_tpu_torch.testing.decode_layouts [--reps N]

Layout (a): the output row in shared memory beside the input ring, written
out at the end (3 CTAs per SM at 64 KiB, 1 at 128 KiB).  Layout (b): the
row written in place in global memory, only the ring in shared memory.  The
package kernel takes one of them per shape (``decode_chunks.cu``,
``dec_row_in_smem``; ``kernel_params`` reads it from a build); this script
launches both instantiations of the same kernel from one scratch source
that includes ``ops/csrc/decode_chunks.cu`` unchanged, built twice under
``build/snappy_tpu_torch/``: as it is, and with the walk's timing hooks
(``STPU_PROF``) defined as ``clock64`` counters in lane 0 around each
phase of a batch and around the whole walk, and its batch hook
(``STPU_DEC_BATCH``) counting batches and tags.

Inputs: the chunk shape's main path, the 768 full 64 KiB blocks of the
seeded 48 MiB payload encoded by the host C encoder (level 1); the big
window's, the 8 unsplittable streams of the seeded serving batch.  For each
shape: every build's verdicts and rows must equal the package kernel's; the
kernel time of layouts a and b by CUDA events (the mean of ``reps``
launches after a warm-up, in the order a, b, b, a) and which of them is the
package kernel's; registers per thread
(``-Xptxas -v``) and CTAs per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); then the profiled
layouts' cycles per chunk (the mean, the slowest, the 90th percentile),
per tag and per batch, split by phase, with tags per batch for the mean
chunk and the slowest.  Every line names the card and its power limit.
Needs CUDA; exits nonzero without it.  ``chip_smoke.py`` phase 9 calls
``measure`` without the profiled build for its layout A/B.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

PHASES = ("staging", "speculative parse", "chain", "positions and checks",
          "lane-strided pass", "ordered copies")
WALK = 7  # the hook around the whole walk
TAGS = 6  # slot 6 counts tags, slot 14 batches

# The scratch source.  With STPU_DEC_PROFILE, each hook adds its cycles and
# a call to its CTA's 16 counters: the cycles of hook k in slot k, its calls
# in slot 8 + k; the batch hook adds the batch's tags to slot 6 and one to
# slot 14.
_SOURCE = r"""
#ifdef STPU_DEC_PROFILE
__device__ unsigned long long g_dec_prof[1024 * 16];
#ifdef __CUDA_ARCH__
__device__ __forceinline__ void prof_add(int k, long long v, long long calls) {
  if ((threadIdx.x & 31) == 0) {
    unsigned long long* slot = &g_dec_prof[(blockIdx.x & 1023) * 16];
    atomicAdd(slot + k, (unsigned long long)v);
    atomicAdd(slot + 8 + k, (unsigned long long)calls);
  }
}
#define STPU_PROF_CAT2(a, b) a##b
#define STPU_PROF_CAT(a, b) STPU_PROF_CAT2(a, b)
#define STPU_PROF(k, ...)                                       \
  const long long STPU_PROF_CAT(prof_t, __LINE__) = clock64();  \
  __VA_ARGS__;                                                  \
  prof_add(k, clock64() - STPU_PROF_CAT(prof_t, __LINE__), 1)
#define STPU_DEC_BATCH(i, o, bt, pl) prof_add(6, (bt).tags, 1)
#endif
#endif
#include "decode_chunks.cu"

// The arguments of stpu_decode_chunks, and the layout: 1 (a) or 0 (b).
STPU_EXPORT int stpu_decode_chunks_layout(const uint8_t* comp, const int64_t* offsets,
                                          const int32_t* declared, int n, uint8_t* out,
                                          int64_t out_cols, uint8_t* ok, int32_t* written,
                                          int row_in_smem, void* stream) {
  return row_in_smem ? launch_decode<true>(comp, offsets, declared, n, out, out_cols, ok,
                                           written, (cudaStream_t)stream)
                     : launch_decode<false>(comp, offsets, declared, n, out, out_cols, ok,
                                            written, (cudaStream_t)stream);
}

// CTAs per SM of layout a or b at out_cols.
STPU_EXPORT int stpu_dec_occupancy(int row_in_smem, int64_t out_cols) {
  int blocks = -1;
  if (row_in_smem) {
    const size_t smem = dec_smem<true>(out_cols);
    cudaFuncSetAttribute(decode_chunks_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, decode_chunks_kernel<true>, 32, smem);
  } else {
    const size_t smem = dec_smem<false>(out_cols);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, decode_chunks_kernel<false>, 32, smem);
  }
  return blocks;
}

#ifdef STPU_DEC_PROFILE
// reset: zero the counters; else copy each CTA's 16 into host[1024 * 16]
STPU_EXPORT int stpu_dec_prof(unsigned long long* host, int reset) {
  static unsigned long long zero[1024 * 16];
  if (reset) return (int)cudaMemcpyToSymbol(g_dec_prof, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, g_dec_prof, sizeof(zero));
}
#endif
"""


def kernel_params(lib, out_cols: int) -> dict:
    """The walk's constants and the layout at width ``out_cols``, as
    ``ops/csrc/decode_chunks.cu`` defines them, read from a build of it
    (``_build.cuda_lib()``, ``_build.twin_lib()`` or a scratch build): the
    lookahead of a batch and the input ring in bytes, the bytes a lane
    moves per piece, and the layout, "a" (the row in shared memory) or "b"
    (in place)."""
    import numpy as np

    fn = lib.stpu_decode_chunks_params
    fn.restype = None
    fn.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    p = np.zeros(4, dtype=np.int64)
    fn(out_cols, p.ctypes.data)
    return {"lookahead": int(p[0]), "ring": int(p[1]), "piece": int(p[2]),
            "layout": "a" if p[3] else "b"}


def measure(reps: int = 10, profile: bool = True) -> dict:
    """Build, check and time both layouts at both shapes (and, with
    ``profile``, split the walk's cycles), printing each line; returns the
    numbers: per shape the package kernel's layout, the times of a and b,
    CTAs per SM, and the profiles, and the registers of each build's
    kernels."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_layouts: torch.cuda is not available")
    from snappy_tpu_torch.formats import varint
    from snappy_tpu_torch.ops import _build, decode_chunks, host_codec
    from snappy_tpu_torch.testing import payloads

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    tag = f"[{card}]"

    root = _build.BUILD_DIR / "decode_layouts"
    root.mkdir(parents=True, exist_ok=True)
    src = root / "decode_layouts.cu"
    src.write_text(_SOURCE)
    deps = [_build.CSRC / "decode_chunks.cu", _build.CSRC / "snappy_common.cuh"]
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    cmd = [_build._nvcc(), *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           f"-I{_build.CSRC}"]
    link = [_build._nvcc(), *arch, "-shared"]
    libs, logs = {}, {}
    builds = (("layouts", []), ("profile", ["-DSTPU_DEC_PROFILE"]))
    for name, extra in builds[: 2 if profile else 1]:
        so = _build._build(f"decode_{name}", cmd + extra, link, [src], deps)
        logs[name] = so.with_suffix(".log").read_text()
        lib = ctypes.CDLL(str(so))
        lib.stpu_decode_chunks_layout.argtypes = (_build._ENTRY_POINTS["decode_chunks"][:-1]
                                                  + [ctypes.c_int, ctypes.c_void_p])
        lib.stpu_dec_occupancy.argtypes = [ctypes.c_int, ctypes.c_int64]
        libs[name] = lib
    if profile:
        libs["profile"].stpu_dec_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    result = {"registers": {}}
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}:" + line.split("ptxas", 1)[-1])
        result["registers"][name] = registers(log)

    dev = torch.device("cuda:0")
    nf = payloads.MAIN_PATH_FRAMES
    payload = payloads.mixed_payload()
    chunks = [host_codec.encode_block(payload[k * 65536 : (k + 1) * 65536]) for k in range(nf)]

    def host_raw(ps):
        return [varint.encode_uint32(len(q)) + b"".join(
            host_codec.encode_block(q[k : k + 65536]) for k in range(0, len(q), 65536)) for q in ps]

    serving, expect = payloads.serving_batch(host_raw)
    first = payloads.SERVING_SMALL
    straddle = serving[first : first + payloads.SERVING_STRADDLE]
    shapes = {
        "chunk": (chunks, [65536] * nf, 65536, f"{nf} chunks of the 48 MiB payload"),
        "big": ([payloads.body_of(s) for s in straddle],
                [len(e) for e in expect[first : first + len(straddle)]], decode_chunks.MAX_OUT,
                f"{len(straddle)} unsplittable serving streams at W={decode_chunks.MAX_OUT}"),
    }
    for shape, (bodies, decl, width, what) in shapes.items():
        offsets = np.zeros(len(bodies) + 1, dtype=np.int64)
        offsets[1:] = np.cumsum([len(b) for b in bodies])
        comp = torch.from_numpy(np.frombuffer(b"".join(bodies), dtype=np.uint8).copy()).to(dev)
        offs = torch.from_numpy(offsets).to(dev)
        declared = torch.tensor(decl, dtype=torch.int32, device=dev)
        n = len(bodies)
        out = torch.empty((n, width), dtype=torch.uint8, device=dev)
        ok = torch.empty(n, dtype=torch.bool, device=dev)
        written = torch.empty(n, dtype=torch.int32, device=dev)

        def launch(lib, layout):
            if lib == "package":
                decode_chunks._launch(comp, offs, declared, out, ok, written)
                return
            rc = libs[lib].stpu_decode_chunks_layout(
                comp.data_ptr(), offs.data_ptr(), declared.data_ptr(), n, out.data_ptr(), width,
                ok.data_ptr(), written.data_ptr(), int(layout == "a"),
                torch.cuda.current_stream(dev).cuda_stream)
            assert rc == 0, (lib, layout, shape, rc)

        def event_ms(lib, layout):
            launch(lib, layout)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                launch(lib, layout)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps

        launch("package", None)
        want = (ok.cpu(), written.cpu(), out.cpu())
        assert bool(want[0].all()), (shape, "the package kernel's verdicts")
        for lib in libs:
            for layout in "ab":
                out.fill_(0xAA)
                launch(lib, layout)
                got = (ok.cpu(), written.cpu(), out.cpu())
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (lib, layout, shape)
        print(f"{shape}: layouts a and b{', with and without the counters,' if profile else ''} "
              f"give the package kernel's verdicts and rows on {what} {tag}")
        times = {"a": [], "b": []}
        for layout in ("a", "b", "b", "a"):
            times[layout].append(event_ms("layouts", layout))
        occ = {layout: libs["layouts"].stpu_dec_occupancy(int(layout == "a"), width) for layout in "ab"}
        package = kernel_params(libs["layouts"], width)["layout"]
        print(f"{shape}: " + "; ".join(
            f"layout {layout} {times[layout][0]:.4f} / {times[layout][1]:.4f} ms, "
            f"{occ[layout]} CTAs per SM" for layout in "ab")
            + f" ({what}, mean of {reps}); the package kernel takes {package} {tag}")
        result[shape] = {"layout": package, "ms": times, "ctas_per_sm": occ}
        for layout in "ab" if profile else "":
            prof = libs["profile"]
            per_cta = np.zeros((1024, 16), dtype=np.uint64)
            prof_ms = event_ms("profile", layout)
            assert prof.stpu_dec_prof(None, 1) == 0
            launch("profile", layout)
            torch.cuda.synchronize()
            assert prof.stpu_dec_prof(per_cta.ctypes.data, 0) == 0
            c = per_cta[:n].astype(np.int64)
            walks = c[:, WALK]
            slow = c[int(np.argmax(walks))]

            def split(v):
                tags, batches = int(v[TAGS]), int(v[8 + TAGS])
                return (f"walk {int(v[WALK]):,} cycles, {tags:,} tags in {batches:,} batches "
                        f"({tags / max(batches, 1):.2f} tags a batch), "
                        f"{int(v[WALK]) / max(tags, 1):,.0f} cycles a tag, "
                        f"{int(v[WALK]) / max(batches, 1):,.0f} a batch; " + ", ".join(
                            f"{ph} {int(v[k]) / max(batches, 1):,.0f} a batch "
                            f"({100 * int(v[k]) / max(int(v[WALK]), 1):.1f}%, {int(v[8 + k]):,} calls)"
                            for k, ph in enumerate(PHASES)))

            mean = c.sum(axis=0) // n
            print(f"{shape} layout {layout}, profiled, the mean chunk: {split(mean)}; slowest walk "
                  f"{int(walks.max()):,}, 90th percentile {int(np.percentile(walks, 90)):,}; "
                  f"kernel {prof_ms:.4f} ms with the counters {tag}")
            print(f"{shape} layout {layout}, profiled, the slowest chunk: {split(slow)} {tag}")
            result[shape][f"profile_{layout}"] = {
                "mean": [int(v) for v in mean], "slowest": [int(v) for v in slow],
                "walk_p90": int(np.percentile(walks, 90))}
        del out
    return result


def registers(log: str) -> dict:
    """Registers per thread of the decoder's two instantiations in a
    build's ``-Xptxas -v`` lines: "a" (the row in shared memory) and "b"
    (in place)."""
    found, layout = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            layout = ("a" if "ILb1E" in name else "b") if "decode_chunks_kernel" in name else None
        elif layout and "Used" in line and "registers" in line:
            found[layout] = int(line.split("Used", 1)[1].split("registers")[0])
            layout = None
    return found


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args()
    print(json.dumps({"decode_layouts": measure(args.reps)}))


if __name__ == "__main__":
    main()
