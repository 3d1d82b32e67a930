"""Measure the CRC kernel (K1) on one CUDA card: its two layouts at both
shapes, with registers, shared memory and CTAs per SM.

    python -m snappy_tpu_torch.testing.crc_layouts [--reps N] [--profile]
    python snappy_tpu_torch/testing/crc_layouts.py --tree DIR [--reps N]

Layout (i), the package kernel (``ops/csrc/crc32c.cu``, ``Interleaved``):
lane l keeps one register over the 16-byte pieces at 16 l of each 512-byte
stride of its warp's 4 KiB, r <- adv512(r) ^ crc0(piece), 1.25 table
lookups a byte.  Layout (ii), built here only: lane l walks its own
contiguous 128-byte segment of the warp's 4 KiB, staged 64 bytes a pass
through a padded [32][80-byte] tile in shared memory with coalesced 16-byte
loads, one slicing-by-4 chain from its register, 1 lookup a byte and one
more pass through shared memory.  Both run in the same tiles, per-bank
tables and folds: this script builds one scratch source under
``build/snappy_tpu_torch/`` that includes ``ops/csrc/crc32c.cu`` unchanged
and adds layout (ii) beside it.

Inputs: the main path's 768 full 64 KiB blocks of the seeded 48 MiB
payload, and the whole payload as one row (the one-shot shape).  For each
shape, the package kernel and both layouts must give the host C CRCs
(``host_codec.masked_crc32c``); then the kernel
time of (i) and (ii) by CUDA events (the mean of ``reps`` calls after a
warm-up, in the order i, ii, ii, i), the registers per thread of each
(``-Xptxas -v``), its shared memory and its CTAs per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  Every line names the
card and its power limit.  ``--profile`` adds a build whose timing hooks
(``STPU_PROF`` in ``crc32c.cu``) count ``clock64`` cycles by phase in lane 0
of each warp.  ``--tree DIR`` instead times the package kernel of the
checkout DIR at both shapes through its wrapper (parent against change).
Needs CUDA; exits nonzero without it.
``chip_smoke.py`` phase 9 calls ``measure``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

_SOURCE = r"""
// With STPU_CRC_PROFILE, each hook adds, in lane 0 of each warp, its cycles
// to slot k of its CTA's 16 counters and a call to slot 8 + k.
#ifdef STPU_CRC_PROFILE
__device__ unsigned long long g_crc_prof[256 * 16];
#ifdef __CUDA_ARCH__
__device__ __forceinline__ void prof_add(int k, long long v) {
  if ((threadIdx.x & 31) == 0) {
    unsigned long long* slot = &g_crc_prof[(blockIdx.x & 255) * 16];
    atomicAdd(slot + k, (unsigned long long)v);
    atomicAdd(slot + 8 + k, 1ull);
  }
}
#define STPU_PROF_CAT2(a, b) a##b
#define STPU_PROF_CAT(a, b) STPU_PROF_CAT2(a, b)
#define STPU_PROF_AT(k, t, ...) \
  const long long t = clock64(); \
  __VA_ARGS__;                   \
  prof_add(k, clock64() - t)
#define STPU_PROF(k, ...) STPU_PROF_AT(k, STPU_PROF_CAT(prof_t, __COUNTER__), __VA_ARGS__)
#endif
#endif
#include "crc32c.cu"

namespace stpu {

// Layout (ii): lane l's contiguous 128-byte segment of the warp's 4 KiB,
// staged in two passes of 64 bytes a segment through rows of 80 bytes (16
// of padding: a lane's 16-byte reads of its own row do not conflict).
struct Staged {
  static constexpr uint32_t kRowBytes = 80;
  static constexpr uint32_t kStageWords = 32 * kRowBytes / 4;
  static constexpr uint32_t kSeg = kWarpBytes / 32;  // bytes of a lane's segment
  static constexpr uint32_t kPasses = kSeg / 64;
  struct Data {
    uint32_t w[kPasses][4][4];
  };
  // pass p, word q of lane l: 16 bytes of segment 8 q + l / 4
  STPU_HD_MEMBER void load(const CrcRow& r, int64_t v0, const uint32_t* tables, Lanes<Data>& d) {
    STPU_LANES(l) {
      for (uint32_t p = 0; p < kPasses; ++p)
        for (uint32_t q = 0; q < 4; ++q)
          body_word(r, v0 + kSeg * (8 * q + l / 4) + 64 * p + 16 * (l % 4), tables, d[l].w[p][q]);
    }
  }
  STPU_HD_MEMBER uint32_t crc(const Lanes<Data>& d, const uint32_t* tb, const uint32_t* sadv,
                              uint32_t* stage) {
    Lanes<uint32_t> reg;
    STPU_LANES(l) { reg[l] = 0; }
    for (uint32_t p = 0; p < kPasses; ++p) {
      STPU_LANES(l) {
        for (uint32_t q = 0; q < 4; ++q) {
          uint32_t* dst = stage + ((8 * q + l / 4) * kRowBytes + 16 * (l % 4)) / 4;
          for (int k = 0; k < 4; ++k) dst[k] = d[l].w[p][q][k];
        }
      }
      warp_sync();
      STPU_LANES(l) {
        uint32_t c = reg[l];
        const uint32_t* src = stage + l * kRowBytes / 4;
        for (uint32_t i = 0; i < 16; i += 4) {
#ifdef __CUDA_ARCH__
          const uint4 q = *reinterpret_cast<const uint4*>(src + i);
          const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#else
          const uint32_t* w = src + i;
#endif
          for (int k = 0; k < 4; ++k) c = slice4(tb, l, c ^ w[k]);
        }
        reg[l] = c;
      }
      warp_sync();
    }
    return fold_lanes(reg, sadv + 1024u * (ilog2(kSeg) - kAdvLo), 5);
  }
};

}  // namespace stpu

// The arguments of stpu_crc32c_chunks, and the layout: 0 (i) or 1 (ii).
STPU_EXPORT int stpu_crc32c_layout(const uint8_t* chunks, int64_t stride, const int32_t* lengths,
                                   int n, int64_t nt_max, const uint32_t* tables,
                                   const uint32_t* adv, uint32_t* tile_regs, uint32_t* out,
                                   int staged, void* stream) {
  return staged ? launch_crc<stpu::Staged>(chunks, stride, lengths, n, nt_max, tables, adv,
                                           tile_regs, out, (cudaStream_t)stream)
                : launch_crc<stpu::Interleaved>(chunks, stride, lengths, n, nt_max, tables, adv,
                                                tile_regs, out, (cudaStream_t)stream);
}

// reps calls of stpu_crc32c_layout from one host loop in C.
STPU_EXPORT int stpu_crc32c_layout_repeat(const uint8_t* chunks, int64_t stride,
                                          const int32_t* lengths, int n, int64_t nt_max,
                                          const uint32_t* tables, const uint32_t* adv,
                                          uint32_t* tile_regs, uint32_t* out, int staged,
                                          int reps, void* stream) {
  for (int k = 0; k < reps; ++k) {
    const int rc = stpu_crc32c_layout(chunks, stride, lengths, n, nt_max, tables, adv, tile_regs,
                                      out, staged, stream);
    if (rc) return rc;
  }
  return 0;
}

#ifdef STPU_CRC_PROFILE
// reset: zero the counters; else copy each CTA's 16 into host[256 * 16]
STPU_EXPORT int stpu_crc_prof(unsigned long long* host, int reset) {
  static unsigned long long zero[256 * 16];
  if (reset) return (int)cudaMemcpyToSymbol(g_crc_prof, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, g_crc_prof, sizeof(zero));
}
#endif

// {shared bytes of a CTA, CTAs per SM} of layout (i) or (ii).
STPU_EXPORT void stpu_crc32c_layout_occupancy(int staged, int64_t* res) {
  res[0] = staged ? (int64_t)tiles_smem<stpu::Staged>() : (int64_t)tiles_smem<stpu::Interleaved>();
  res[1] = staged ? tiles_ctas_per_sm<stpu::Staged>() : tiles_ctas_per_sm<stpu::Interleaved>();
}
"""

LAYOUTS = ("i", "ii")


def registers(log: str) -> dict:
    """Registers per thread of the tile kernel's layouts in a build's
    ``-Xptxas -v`` lines: "i" (``Interleaved``) and "ii" (``Staged``)."""
    found, layout = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            layout = None
            if "crc32c_tiles_kernel" in name:
                layout = "ii" if "Staged" in name else "i"
        elif layout and "Used" in line and "registers" in line:
            found[layout] = int(line.split("Used", 1)[1].split("registers")[0])
            layout = None
    return found


PHASES = ("tables", "load issue", "CRC of the words", "barrier", "fold of the warps",
          "tile after next")
WALK = 7  # the hook around the walk over the tiles


def measure(reps: int = 10, profile: bool = False) -> dict:
    """Build, check and time both layouts at both shapes, printing each
    line.  Each time is taken twice: with the calls made from Python as the
    package makes them (``ms``), and from one host loop in C (``device_ms``,
    without the Python overhead of a call).  Returns per shape the times of
    (i) and (ii) (and with ``profile`` a warp's cycles by phase in layout
    (i)), and per layout the registers, shared bytes and CTAs per SM."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("crc_layouts: torch.cuda is not available")
    from snappy_tpu_torch.ops import _build, crc32c, host_codec
    from snappy_tpu_torch.testing import payloads

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    tag = f"[{card}]"

    root = _build.BUILD_DIR / "crc_layouts"
    root.mkdir(parents=True, exist_ok=True)
    src = root / "crc_layouts.cu"
    src.write_text(_SOURCE)
    deps = [_build.CSRC / "crc32c.cu", _build.CSRC / "snappy_common.cuh"]
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    cmd = [_build._nvcc(), *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           f"-I{_build.CSRC}"]
    link = [_build._nvcc(), *arch, "-shared"]
    so = _build._build("crc_layouts", cmd, link, [src], deps)
    log = so.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(so))
    args = _build._ENTRY_POINTS["crc32c_chunks"][:-1] + [ctypes.c_int]
    lib.stpu_crc32c_layout.argtypes = args + [ctypes.c_void_p]
    lib.stpu_crc32c_layout_repeat.argtypes = args + [ctypes.c_int, ctypes.c_void_p]
    lib.stpu_crc32c_layout_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
    regs = registers(log)
    warps = kernel_params(lib)["warps"]
    result = {"layouts": {}}
    for k, layout in enumerate(LAYOUTS):
        occ = np.zeros(2, dtype=np.int64)
        lib.stpu_crc32c_layout_occupancy(k, occ.ctypes.data)
        result["layouts"][layout] = {
            "registers": regs.get(layout), "smem_bytes": int(occ[0]), "ctas_per_sm": int(occ[1])}
        print(f"layout ({layout}): {regs.get(layout)} registers, {int(occ[0])} bytes of shared "
              f"memory a CTA of {32 * warps} threads, {int(occ[1])} CTAs per SM {tag}")
    if profile:
        so = _build._build("crc_profile", cmd + ["-DSTPU_CRC_PROFILE"], link, [src], deps)
        prof = ctypes.CDLL(str(so))
        prof.stpu_crc32c_layout.argtypes = lib.stpu_crc32c_layout.argtypes
        prof.stpu_crc_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]

    dev = torch.device("cuda:0")
    nf = payloads.MAIN_PATH_FRAMES
    payload = np.frombuffer(payloads.mixed_payload(), dtype=np.uint8)
    shapes = {
        "chunks": (torch.from_numpy(payload[: nf * 65536].copy()).view(nf, 65536).to(dev),
                   [65536] * nf, f"{nf} x 64 KiB chunks"),
        "long": (torch.from_numpy(payload.copy()).view(1, -1).to(dev), [len(payload)],
                 f"the {len(payload)}-byte payload as one row"),
    }
    tabs = torch.from_numpy(crc32c.tables()).to(dev)
    adv = torch.from_numpy(crc32c.adv_tables()).to(dev)
    for shape, (rows, lens, what) in shapes.items():
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        n, nt_max = len(lens), crc32c.tiles_per_row(max(lens))
        out = torch.empty(n, dtype=torch.int32, device=dev)
        tile_regs = torch.empty(max(1, n * nt_max), dtype=torch.int32, device=dev)

        def launch(layout, in_c=0):
            a = (rows.data_ptr(), rows.stride(0), lengths.data_ptr(), n, nt_max, tabs.data_ptr(),
                 adv.data_ptr(), tile_regs.data_ptr(), out.data_ptr(), LAYOUTS.index(layout))
            stream = torch.cuda.current_stream(dev).cuda_stream
            if in_c:
                rc = lib.stpu_crc32c_layout_repeat(*a, in_c, stream)
            else:
                rc = lib.stpu_crc32c_layout(*a, stream)
            assert rc == 0, (layout, shape, rc)

        def event_ms(layout, in_c):
            launch(layout)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            if in_c:
                launch(layout, reps)
            else:
                for _ in range(reps):
                    launch(layout)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps

        host = rows.cpu().numpy()
        want = torch.tensor([host_codec.masked_crc32c(host[k, :n]) for k, n in enumerate(lens)],
                            dtype=torch.int64).to(torch.int32)
        assert torch.equal(crc32c.masked_crc32c_chunks(rows, lengths).cpu().view(torch.int32), want), \
            ("the package kernel against the host C CRC", shape)
        for layout in LAYOUTS:
            out.fill_(0)
            launch(layout)
            assert torch.equal(out.cpu(), want), (layout, shape)
        print(f"{shape}: the package kernel and layouts (i) and (ii) give the host C CRCs on {what} "
              f"{tag}")
        times = {"ms": {layout: [] for layout in LAYOUTS},
                 "device_ms": {layout: [] for layout in LAYOUTS}}
        for layout in ("i", "ii", "ii", "i"):
            times["ms"][layout].append(event_ms(layout, False))
            times["device_ms"][layout].append(event_ms(layout, True))
        print(f"{shape}: " + "; ".join(
            f"layout ({layout}) {times['ms'][layout][0]:.4f} / {times['ms'][layout][1]:.4f} ms "
            f"from Python, {times['device_ms'][layout][0]:.4f} / "
            f"{times['device_ms'][layout][1]:.4f} ms from C" for layout in LAYOUTS)
            + f" ({what}, mean of {reps}); the package kernel takes (i) {tag}")
        result[shape] = times
        if profile:
            assert prof.stpu_crc_prof(None, 1) == 0
            rc = prof.stpu_crc32c_layout(
                rows.data_ptr(), rows.stride(0), lengths.data_ptr(), n, nt_max, tabs.data_ptr(),
                adv.data_ptr(), tile_regs.data_ptr(), out.data_ptr(), 0,
                torch.cuda.current_stream(dev).cuda_stream)
            assert rc == 0
            torch.cuda.synchronize()
            assert torch.equal(out.cpu(), want), ("profiled build", shape)
            per_cta = np.zeros((256, 16), dtype=np.uint64)
            assert prof.stpu_crc_prof(per_cta.ctypes.data, 0) == 0
            c = per_cta.astype(np.int64)
            c = c[c[:, 8 + WALK] > 0]
            warps_n = c[0, 8 + WALK]  # the walk's hook runs once a warp
            mean = c.sum(axis=0) / len(c) / warps_n
            print(f"{shape}, layout (i) profiled, a warp's mean over {len(c)} CTAs: walk "
                  f"{mean[WALK]:,.0f} cycles; " + ", ".join(
                      f"{ph} {mean[k]:,.0f} ({mean[8 + k]:.1f} calls)"
                      for k, ph in enumerate(PHASES)) + f" {tag}")
            result[shape]["profile"] = {ph: float(mean[k]) for k, ph in enumerate(PHASES)}
            result[shape]["profile"]["walk"] = float(mean[WALK])
    return result


def kernel_params(lib) -> dict:
    """The tile kernel's constants, as ``ops/csrc/crc32c.cu`` defines them,
    read from a build of it (``_build.cuda_lib()``, ``_build.twin_lib()`` or
    a scratch build): the tile's bytes, the warps of a CTA, its shared
    bytes, the bytes of its per-bank tables, and its CTAs per SM (0 in the
    twin)."""
    import numpy as np

    fn = lib.stpu_crc32c_params
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p]
    p = np.zeros(5, dtype=np.int64)
    fn(p.ctypes.data)
    return dict(zip(("tile", "warps", "smem_bytes", "table_bytes", "ctas_per_sm"),
                    (int(v) for v in p)))


def time_tree(reps: int = 10) -> dict:
    """The package kernel of the checkout first on sys.path (``--tree``),
    through its wrapper's ``_launch``, at both shapes: the mean of ``reps``
    calls after a warm-up, twice.  Parent against change: run it once with
    each tree."""
    import inspect

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("crc_layouts: torch.cuda is not available")
    from snappy_tpu_torch.ops import crc32c
    from snappy_tpu_torch.testing import payloads

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    nf = payloads.MAIN_PATH_FRAMES
    payload = np.frombuffer(payloads.mixed_payload(), dtype=np.uint8)
    shapes = {
        "chunks": torch.from_numpy(payload[: nf * 65536].copy()).view(nf, 65536).to(dev),
        "long": torch.from_numpy(payload.copy()).view(1, -1).to(dev),
    }
    with_tiles = len(inspect.signature(crc32c._launch).parameters) > 3
    result = {}
    for shape, rows in shapes.items():
        lengths = torch.full((rows.shape[0],), rows.shape[1], dtype=torch.int32, device=dev)
        out = torch.empty(rows.shape[0], dtype=torch.uint32, device=dev)
        extra = (crc32c.tiles_per_row(rows.shape[1]),) if with_tiles else ()

        def one():
            crc32c._launch(rows, lengths, out, *extra)

        times = []
        for _ in range(2):
            one()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                one()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
        print(f"{shape}: the CRC kernel of {crc32c.__file__} {times[0]:.4f} / {times[1]:.4f} ms "
              f"({rows.shape[0]} x {rows.shape[1]} bytes, mean of {reps}) [{card}]")
        result[shape] = times
    return result


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--tree", default=None,
                   help="time the CRC kernel of the package in this checkout instead")
    args = p.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
        print(json.dumps({"crc_tree": time_tree(args.reps)}))
        return
    print(json.dumps({"crc_layouts": measure(args.reps, args.profile)}))


if __name__ == "__main__":
    main()
