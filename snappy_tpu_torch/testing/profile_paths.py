"""Time the port's framed and raw decode paths on one CUDA card, stage by
stage.

    python snappy_tpu_torch/testing/profile_paths.py [--tree DIR] [--reps N]

On the seeded 48 MiB payload's level-1 framed stream: ``decode_framed``
end to end (best and median of ``reps`` after a warm-up), its host stages
(the frame scan, the device decode into the output array, ``tobytes``)
and the device time of one call by ``torch.profiler``.  Then the raw
paths: ``decode`` of the payload's level-1 raw stream end to end, its
stages where the package has K4's window route (the host window index,
H2D, the kernels, D2H, ``tobytes``) and its device time, ``decode_batch``
of the seeded serving batch, ``decode`` of its 8 unsplittable streams of
at most 128 KiB one call each (K2 at the big window) and
``streams.sync.compress_framed``.  Then,
where the package has them, ``streams.sync.uncompress_framed`` and
``uncompress_framed_into`` through 8 MiB buffers with re-entry, the latter
with cProfile's top host functions.  ``--tree`` imports
``snappy_tpu_torch`` from another checkout (an older commit, for a
comparison within one run).  Every line names the card and its power
limit.  Needs CUDA; exits nonzero without it.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import statistics
import subprocess
import sys
import time


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=None, help="checkout to import snappy_tpu_torch from")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: torch.cuda is not available")
    import snappy_tpu_torch
    from snappy_tpu_torch import api, engine
    from snappy_tpu_torch.ops import decode_stream
    from snappy_tpu_torch.formats import constants as C
    from snappy_tpu_torch.formats import framing
    from snappy_tpu_torch.testing import payloads

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    tree = args.tree or "."
    tag = f"[{tree}; {card}]"
    print(f"profile_paths: snappy_tpu_torch from {snappy_tpu_torch.__file__} {tag}")
    dev = torch.device("cuda:0")
    payload = payloads.mixed_payload()
    stream = api.encode_framed(payload, device=dev)

    def timed(fn):
        fn()
        times = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return min(times), statistics.median(times)

    best, med = timed(lambda: api.decode_framed(stream, device=dev))
    print(f"decode_framed: best {best:.2f} ms, median {med:.2f} ms {tag}")

    start = len(C.FRAMING_HEADER)
    stages = {"scan": [], "device decode": [], "tobytes": []}
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks = framing.scan_frames(stream, start)
        t1 = time.perf_counter()
        out_arr = np.empty(sum(c.uncompressed_len for c in chunks), dtype=np.uint8)
        written, _ = engine._framed_uncompress_device(stream, chunks, True, out_arr, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out_arr[:written].tobytes()
        t3 = time.perf_counter()
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[k].append(v * 1e3)
    print("decode_framed stages (median ms): " + ", ".join(
        f"{k} {statistics.median(v):.2f}" for k, v in stages.items()) + f" {tag}")

    from torch.profiler import ProfilerActivity, profile

    def device_time(name, fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
        total = sum(e.self_device_time_total for e in rows) / 1e3
        print(f"{name} device time: {total:.2f} ms; " + ", ".join(
            f"{e.key} {e.self_device_time_total / 1e3:.2f}" for e in rows[:5]) + f" {tag}")

    device_time("decode_framed", lambda: api.decode_framed(stream, device=dev))
    raw_paths(api, decode_stream, payload, payloads, dev, timed, device_time, tag)

    if not hasattr(api, "uncompress_framed_into"):
        return
    from snappy_tpu_torch.streams import sync

    best, med = timed(lambda: sync.uncompress_framed(io.BytesIO(stream), io.BytesIO(), device=dev))
    print(f"sync uncompress_framed: best {best:.2f} ms, median {med:.2f} ms {tag}")

    def resume_into(size=8 << 20):
        data, first = stream, True
        while data:
            res = api.uncompress_framed_into(data, bytearray(size), first, device=dev)
            read, _ = res.value
            data, first = data[read:], False

    best, med = timed(resume_into)
    print(f"uncompress_framed_into 8 MiB: best {best:.2f} ms, median {med:.2f} ms {tag}")
    prof_h = cProfile.Profile()
    prof_h.enable()
    resume_into()
    torch.cuda.synchronize()
    prof_h.disable()
    text = io.StringIO()
    pstats.Stats(prof_h, stream=text).sort_stats("tottime").print_stats(12)
    print("uncompress_framed_into 8 MiB, cProfile by own time:")
    for line in text.getvalue().splitlines():
        if line.strip() and ("{" in line or ".py" in line):
            print("  " + line.strip())


def raw_paths(api, decode_stream, payload, payloads, dev, timed, device_time, tag) -> None:
    """The raw decode of the payload's level-1 stream, ``decode_batch`` of
    the serving batch and ``sync.compress_framed``."""
    import numpy as np
    import torch

    raw = api.encode(payload, device=dev)
    best, med = timed(lambda: api.decode(raw, device=dev))
    print(f"decode (raw): best {best:.2f} ms, median {med:.2f} ms {tag}")
    if hasattr(decode_stream, "window_index"):
        body = payloads.body_of(raw)
        stages = {"index": [], "H2D": [], "kernels": [], "D2H": [], "tobytes": []}
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            offs = decode_stream.window_index(body, len(payload))
            t1 = time.perf_counter()
            comp = torch.from_numpy(np.frombuffer(body, dtype=np.uint8).copy()).to(dev)
            offs = offs.to(dev)
            out = torch.empty(len(payload), dtype=torch.uint8, device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            status = decode_stream.decode_stream(comp, len(payload), out, offs)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            host = out.cpu()
            t4 = time.perf_counter()
            host.numpy().tobytes()
            t5 = time.perf_counter()
            assert int(status[0]) == 1
            for k, a, b in zip(stages, (t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
                stages[k].append((b - a) * 1e3)
        print("decode (raw) stages (median ms): " + ", ".join(
            f"{k} {statistics.median(v):.2f}" for k, v in stages.items()) + f" {tag}")
    device_time("decode (raw)", lambda: api.decode(raw, device=dev))

    serving, _ = payloads.serving_batch(lambda ps: api.encode_batch(ps, device=dev))
    best, med = timed(lambda: api.decode_batch(serving, device=dev))
    print(f"decode_batch: best {best:.2f} ms, median {med:.2f} ms {tag}")
    first = payloads.SERVING_SMALL
    small = serving[first : first + payloads.SERVING_STRADDLE]
    size = sum(len(api.decode(s, device=dev)) for s in small)
    best, med = timed(lambda: [api.decode(s, device=dev) for s in small])
    print(f"decode (raw, <= 128 KiB): the {len(small)} unsplittable serving streams one call "
          f"each, {size} bytes: best {best:.2f} ms, median {med:.2f} ms {tag}")
    from snappy_tpu_torch.streams import sync

    best, med = timed(lambda: sync.compress_framed(io.BytesIO(payload), io.BytesIO(), device=dev))
    print(f"sync compress_framed: best {best:.2f} ms, median {med:.2f} ms {tag}")


if __name__ == "__main__":
    main()
