"""Measure the CRC kernel (K1) on one CUDA card at both shapes: its time,
registers, shared memory and CTAs per SM, and where a warp spends its
cycles.

    python -m snappy_tpu_torch.testing.crc_layouts [--reps N] [--profile]
    python snappy_tpu_torch/testing/crc_layouts.py --tree DIR [--reps N]

The kernel (``ops/csrc/crc32c.cu``, layout (i), ``Interleaved``): lane l
keeps one register over the 16-byte pieces at 16 l of each 512-byte stride
of its warp's 4 KiB, r <- adv512(r) ^ crc0(piece), 1.25 table lookups a
byte.  Inputs: the main path's 768 full 64 KiB blocks of the seeded 48 MiB
payload, and the whole payload as one row (the one-shot shape).  For each
shape the kernel must give the host C CRCs (``host_codec.masked_crc32c``);
then its time by CUDA events (the mean of ``reps`` calls after a warm-up,
twice), its registers a thread (``-Xptxas -v``), its shared memory and its
CTAs per SM (``kernel_params``).  ``--profile`` adds a build of one scratch
source under ``build/snappy_tpu_torch/`` that includes ``crc32c.cu``
unchanged with its timing hooks (``STPU_PROF``) defined as ``clock64``
counters by phase in lane 0 of each warp.  ``--tree DIR`` instead times
the kernel of the checkout DIR at both shapes through its wrapper (parent
against change).  Every line names the card and its power limit.  Needs
CUDA; exits nonzero without it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

# With STPU_CRC_PROFILE, each hook adds, in lane 0 of each warp, its cycles
# to slot k of its CTA's 16 counters and a call to slot 8 + k.
_PROFILE_SOURCE = r"""
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
#include "crc32c.cu"

// reset: zero the counters; else copy each CTA's 16 into host[256 * 16]
STPU_EXPORT int stpu_crc_prof(unsigned long long* host, int reset) {
  static unsigned long long zero[256 * 16];
  if (reset) return (int)cudaMemcpyToSymbol(g_crc_prof, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, g_crc_prof, sizeof(zero));
}
"""

PHASES = ("tables", "load issue", "CRC of the words", "barrier", "fold of the warps",
          "tile after next")
WALK = 7  # the hook around the walk over the tiles


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def _shapes(dev):
    """The main path's blocks and the payload as one row, on ``dev``."""
    import numpy as np
    import torch

    from snappy_tpu_torch.testing import payloads

    nf = payloads.MAIN_PATH_FRAMES
    payload = np.frombuffer(payloads.mixed_payload(), dtype=np.uint8)
    return {
        "chunks": (torch.from_numpy(payload[: nf * 65536].copy()).view(nf, 65536).to(dev),
                   f"{nf} x 64 KiB chunks"),
        "long": (torch.from_numpy(payload.copy()).view(1, -1).to(dev),
                 f"the {len(payload)}-byte payload as one row"),
    }


def _u32(t) -> list:
    """A uint32 tensor's values, by way of int32, which every torch copies
    to NumPy."""
    import numpy as np
    import torch

    return t.cpu().view(torch.int32).numpy().view(np.uint32).tolist()


def _event_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(reps: int = 10, profile: bool = False) -> dict:
    """Check and time the kernel at both shapes, printing each line; with
    ``profile``, a warp's cycles by phase.  Returns per shape the times
    (and the profile), and the kernel's registers, shared bytes and CTAs
    per SM."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("crc_layouts: torch.cuda is not available")
    from snappy_tpu_torch.ops import _build, crc32c, host_codec

    tag = f"[{_card()}]"
    params = kernel_params(_build.cuda_lib())
    regs = _build.ptxas_usage(_build.cuda_build_log(), "crc32c_tiles_kernel").get("registers")
    result = {"registers": regs, "smem_bytes": params["smem_bytes"], "ctas_per_sm": params["ctas_per_sm"]}
    print(f"crc32c: {regs} registers, {params['smem_bytes']} bytes of shared memory a CTA of "
          f"{32 * params['warps']} threads, {params['ctas_per_sm']} CTAs per SM {tag}")
    if profile:
        root = _build.BUILD_DIR / "crc_layouts"
        root.mkdir(parents=True, exist_ok=True)
        src = root / "crc_profile.cu"
        src.write_text(_PROFILE_SOURCE)
        arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
        cmd = [_build._nvcc(), *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", f"-I{_build.CSRC}"]
        so = _build._build("crc_profile", cmd, [_build._nvcc(), *arch, "-shared"], [src],
                           [_build.CSRC / "crc32c.cu", _build.CSRC / "snappy_common.cuh"])
        prof = ctypes.CDLL(str(so))
        prof.stpu_crc32c_chunks.argtypes = _build._ENTRY_POINTS["crc32c_chunks"]
        prof.stpu_crc_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]

    dev = torch.device("cuda:0")
    tabs = torch.from_numpy(crc32c.tables()).to(dev)
    adv = torch.from_numpy(crc32c.adv_tables()).to(dev)
    for shape, (rows, what) in _shapes(dev).items():
        n, width = rows.shape
        lengths = torch.full((n,), width, dtype=torch.int32, device=dev)
        nt = crc32c.tiles_per_row(width)
        out = torch.empty(n, dtype=torch.uint32, device=dev)
        host = rows.cpu().numpy()
        want = [host_codec.masked_crc32c(r) for r in host]
        assert _u32(crc32c.masked_crc32c_chunks(rows, lengths)) == want, ("host C CRC", shape)
        times = [_event_ms(lambda: crc32c._launch(rows, lengths, out, nt), reps) for _ in range(2)]
        print(f"{shape}: the kernel gives the host C CRCs on {what}; {times[0]:.4f} / {times[1]:.4f} ms "
              f"(mean of {reps}) {tag}")
        result[shape] = {"ms": times}
        if not profile:
            continue
        assert prof.stpu_crc_prof(None, 1) == 0
        regs_t = torch.empty(max(1, n * nt), dtype=torch.int32, device=dev)
        assert prof.stpu_crc32c_chunks(
            rows.data_ptr(), rows.stride(0), lengths.data_ptr(), n, nt, tabs.data_ptr(),
            adv.data_ptr(), regs_t.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream) == 0
        torch.cuda.synchronize()
        assert _u32(out) == want, ("profiled build", shape)
        per_cta = np.zeros((256, 16), dtype=np.uint64)
        assert prof.stpu_crc_prof(per_cta.ctypes.data, 0) == 0
        c = per_cta.astype(np.int64)
        c = c[c[:, 8 + WALK] > 0]
        warps_n = c[0, 8 + WALK]  # the walk's hook runs once a warp
        mean = c.sum(axis=0) / len(c) / warps_n
        print(f"{shape}, profiled, a warp's mean over {len(c)} CTAs: walk {mean[WALK]:,.0f} cycles; "
              + ", ".join(f"{ph} {mean[k]:,.0f} ({mean[8 + k]:.1f} calls)" for k, ph in enumerate(PHASES))
              + f" {tag}")
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
    """The kernel of the checkout first on sys.path (``--tree``), through
    its wrapper's ``_launch``, at both shapes: the mean of ``reps`` calls
    after a warm-up, twice.  Parent against change: run it once with each
    tree."""
    import inspect

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("crc_layouts: torch.cuda is not available")
    from snappy_tpu_torch.ops import crc32c

    card = _card()
    dev = torch.device("cuda:0")
    with_tiles = len(inspect.signature(crc32c._launch).parameters) > 3
    result = {}
    for shape, (rows, _) in _shapes(dev).items():
        lengths = torch.full((rows.shape[0],), rows.shape[1], dtype=torch.int32, device=dev)
        out = torch.empty(rows.shape[0], dtype=torch.uint32, device=dev)
        extra = (crc32c.tiles_per_row(rows.shape[1]),) if with_tiles else ()
        times = [_event_ms(lambda: crc32c._launch(rows, lengths, out, *extra), reps) for _ in range(2)]
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
