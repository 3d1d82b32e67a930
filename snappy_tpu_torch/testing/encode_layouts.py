"""Measure the block encoder kernel (K3) on one CUDA card: its launch, and
where each block's walk spends its cycles.

    python -m snappy_tpu_torch.testing.encode_layouts [--reps N] [--out FILE]

measures the 768 full 64 KiB blocks of the seeded 48 MiB payload;
``measure`` takes any batches of rows (``tools/k3_state_walks.py`` adds the
frames of the benchmark's beacon state, with its regions).

The launch is the package's (``encode_blocks._launch``): one CTA an SM of
walkers, each a warp with its own hash table, taking rows from a queue on
the card (``encode_blocks.launch_shape``), costliest first where there are
more rows than walkers (a first launch times walks of four pieces of each
row).  A scratch source under ``build/snappy_tpu_torch/`` includes
``ops/csrc/encode_blocks.cu`` unchanged with the walk's timing hooks
(``STPU_PROF``) defined as ``clock64`` counters in lane 0 around each
phase of the walk (probe batches, match extension, literal copy, copy-tag
emit, the step after a match); the hook around the whole walk files a
walker's counters under the row it walked.

For each batch and ``ways``: the profiled build's bytes must equal the
package kernel's; the package launch's time by CUDA events (the mean of
``reps`` launches after a warm-up, twice); then, profiled, the walk's
cycles per block and per tag split by phase, the makespan of list
scheduling those walks on the launch's walkers in index order, longest
first and in the order of the launch's estimates, and for a batch given
with regions the walk cycles of its frames summed by region.  Every line
names the card and its power limit; ``--out`` takes the JSON of every
number, each frame's cycles and estimate too.  Needs CUDA; exits nonzero
without it.
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

# Each phase hook adds its cycles and a call to its walker's 16 counters
# (lane 0 of the warp alone writes them): the cycles of hook k in slot k,
# its calls in slot 8 + k.  The hook around the whole walk (7), where
# ``row`` is the row walked, moves the walker's counters to that row's and
# puts the walk's cycles in slot 7.
_PROFILE_SOURCE = r"""
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
#include "encode_blocks.cu"

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
"""


def makespan(walks, slots: int) -> int:
    """The finish of list scheduling ``walks`` in their order on ``slots``
    walkers: each walk starts on the walker that is free first."""
    free = [0] * min(slots, len(walks))
    for w in walks:
        heapq.heapreplace(free, free[0] + int(w))
    return max(free)


def card_label() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def _profiled_lib():
    from snappy_tpu_torch.ops import _build

    root = _build.BUILD_DIR / "encode_layouts"
    root.mkdir(parents=True, exist_ok=True)
    src = root / "encode_profile.cu"
    src.write_text(_PROFILE_SOURCE)
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    cmd = [_build._nvcc(), *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", f"-I{_build.CSRC}"]
    so = _build._build("encode_profile", cmd, [_build._nvcc(), *arch, "-shared"], [src],
                       [_build.CSRC / "encode_blocks.cu", _build.CSRC / "snappy_common.cuh"])
    lib = ctypes.CDLL(str(so))
    lib.stpu_encode_blocks.argtypes = _build._ENTRY_POINTS["encode_blocks"]
    lib.stpu_enc_prof_rows.argtypes = [ctypes.c_void_p]
    return lib


def measure(batches: dict, reps: int = 10, regions: dict = None) -> dict:
    """Check, time and profile the package launch on each of ``batches``
    (name -> (uint8 [N, 65536] rows, int32 [N] lengths) on the card, N at
    most PROF_ROWS), printing each line.  ``regions``: name -> [(region,
    first frame, end frame)] of a batch whose walks to sum by region.
    Returns (the numbers, each row's walk cycles, tags and estimate by
    batch, ways and launch)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("encode_layouts: torch.cuda is not available")
    from snappy_tpu_torch.ops import encode_blocks

    card = card_label()
    tag = f"[{card}]"
    prof = _profiled_lib()
    dev = torch.device("cuda:0")
    limits = encode_blocks.card_limits(dev)
    result = {"card": card, "limits": limits}
    per_frame = {}
    for batch, (blocks, lens) in batches.items():
        n = len(lens)
        enc = torch.empty((n, encode_blocks.ENC_CAP), dtype=torch.uint8, device=dev)
        elen = torch.empty(n, dtype=torch.int32, device=dev)
        queue = torch.empty(1, dtype=torch.int32, device=dev)
        cost = torch.empty(n, dtype=torch.int32, device=dev)

        def event_ms(ways):
            encode_blocks._launch(blocks, lens, enc, elen, ways)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                encode_blocks._launch(blocks, lens, enc, elen, ways)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps

        for ways in (1, 2):
            encode_blocks._launch(blocks, lens, enc, elen, ways)
            want_len, want = elen.cpu(), enc.cpu()
            times = [event_ms(ways) for _ in range(2)]
            walkers, ctas = encode_blocks.launch_shape(n, ways, *limits)
            print(f"{batch} ways={ways}: {times[0]:.4f} / {times[1]:.4f} ms, {walkers} walkers on {ctas} "
                  f"CTAs ({n} blocks, {int(want_len.sum()):,} bytes out, mean of {reps}) {tag}")

            # the package's launch (encode_blocks._launch) on the profiled build
            assert prof.stpu_enc_prof_reset() == 0
            elen.fill_(-1)
            cost.fill_(-1)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rows = (blocks.data_ptr(), blocks.stride(0), lens.data_ptr(), n, enc.data_ptr(),
                    encode_blocks.ENC_CAP, elen.data_ptr())
            order = None
            if n > walkers:
                assert prof.stpu_encode_blocks(*rows, 1, *encode_blocks.launch_shape(n, 1, *limits),
                                               queue.data_ptr(), cost.data_ptr(), None, stream) == 0
                order = torch.argsort(cost, descending=True, stable=True).to(torch.int32)
            assert prof.stpu_encode_blocks(*rows, ways, walkers, ctas, queue.data_ptr(), None,
                                           None if order is None else order.data_ptr(), stream) == 0
            torch.cuda.synchronize()
            got_len, got = elen.cpu(), enc.cpu()
            assert torch.equal(got_len, want_len), (batch, ways, "lengths")
            for k, m in enumerate(want_len.tolist()):
                assert torch.equal(got[k, :m], want[k, :m]), (batch, ways, k)
            counters = np.zeros((PROF_ROWS, 16), dtype=np.uint64)
            assert prof.stpu_enc_prof_rows(counters.ctypes.data) == 0
            counters = counters[:n].astype(np.int64)
            assert (counters[:, 15] == 1).all(), (batch, ways, "a row not walked once")
            c = counters.sum(axis=0)
            walks = counters[:, WALK]
            tags = counters[:, 10] + counters[:, 11]
            parts = ", ".join(
                f"{ph} {c[k] / n:,.0f} ({100 * c[k] / max(c[WALK], 1):.1f}%, {c[8 + k] / n:,.1f} calls, "
                f"{c[k] / max(c[8 + k], 1):,.0f} each)" for k, ph in enumerate(PHASES))
            print(f"{batch} ways={ways}, profiled (the package's bytes): one block's walk "
                  f"{c[WALK] / n:,.0f} cycles (slowest {int(walks.max()):,}, 90th percentile "
                  f"{int(np.percentile(walks, 90)):,}), {tags.sum() / n:,.1f} tags (literals + copies), "
                  f"{c[WALK] / max(tags.sum(), 1):,.0f} cycles a tag; {parts} {tag}")
            model = {"index": makespan(walks, walkers), "longest": makespan(np.sort(walks)[::-1], walkers)}
            est = cost.cpu().numpy()
            if (est >= 0).all():
                model["estimate"] = makespan(walks[np.argsort(-est, kind="stable")], walkers)
                model["estimate_corr"] = float(np.corrcoef(est, walks)[0, 1])
            print(f"{batch} ways={ways}, list scheduling of these walks on {walkers} walkers: their sum "
                  f"spread evenly {c[WALK] / walkers:,.0f} cycles, makespan in index order "
                  + ", ".join(f"{k} {v:,.3f}" if k == "estimate_corr" else f"{k} {v:,}" for k, v in
                              model.items()) + f" ({c[WALK] / walkers / model['index']:.3f} of index "
                  f"order spread evenly, longest first {model['longest'] / model['index']:.3f}) {tag}")
            result.setdefault(batch, {})[f"ways{ways}"] = {
                "ms": times, "walkers": walkers, "ctas": ctas,
                "walk_cycles": float(c[WALK] / n), "walk_max": int(walks.max()),
                "tags": float(tags.sum() / n), "cycles": [int(v) for v in c[:5]],
                "calls": [int(v) for v in c[8:13]], "model": model}
            per_frame[f"{batch} ways={ways}"] = {"walks": walks.tolist(), "tags": tags.tolist(),
                                                 "cost": est.tolist()}
            for name, lo, hi in (regions or {}).get(batch, ()):
                w, t = walks[lo:hi], tags[lo:hi]
                print(f"{batch} ways={ways}, {name} (frames {lo}-{hi - 1}): walks {int(w.sum()):,} "
                      f"cycles ({100 * w.sum() / c[WALK]:.1f}%), a frame {w.mean():,.0f} (min "
                      f"{int(w.min()):,}, max {int(w.max()):,}), tags a frame {t.mean():,.0f}, "
                      f"{w.sum() / max(t.sum(), 1):,.0f} cycles a tag {tag}")
        del enc
    return result, per_frame


def payload_batch(dev) -> dict:
    """The 768 full 64 KiB blocks of the seeded 48 MiB payload on ``dev``."""
    import numpy as np
    import torch

    from snappy_tpu_torch.testing import payloads

    nf = payloads.MAIN_PATH_FRAMES
    arr = np.frombuffer(payloads.mixed_payload(), dtype=np.uint8)[: nf * 65536]
    return {"payload": (torch.from_numpy(arr.copy()).view(nf, 65536).to(dev),
                        torch.full((nf,), 65536, dtype=torch.int32, device=dev))}


def write(result: dict, per_frame: dict, out) -> None:
    """Print the numbers as one JSON line, and write them with each frame's
    to ``out`` where it is given."""
    if out:
        with open(out, "w") as fh:
            json.dump({**result, "per_frame": per_frame}, fh)
    print(json.dumps({"encode_layouts": result}))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--out", default=None, help="write every number, as JSON, here")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("encode_layouts: torch.cuda is not available")
    write(*measure(payload_batch(torch.device("cuda:0")), args.reps), args.out)


if __name__ == "__main__":
    main()
