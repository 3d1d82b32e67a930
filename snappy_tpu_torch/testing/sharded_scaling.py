"""The sharded paths on a group of ranks, one card each, beside the
engine's call on one card.

    torchrun --standalone --nproc-per-node N -m snappy_tpu_torch.testing.sharded_scaling [--reps 5]

Every rank joins an nccl group (``multihost.initialize`` from torchrun's
environment, on ``cuda:<LOCAL_RANK>``) and builds the seeded payload
(48 MiB by default).  Each rank holds ``sharded_framed_compress`` and
``sharded_raw_compress`` to the engine's bytes on its own card (and, at
the default size, to the pinned framed-L1 and raw-L1 digests) and
``sharded_framed_uncompress`` to the payload.  Then each path is timed on
the group, from a barrier to a barrier after every rank's synchronize
(best and median of ``reps`` after a warm-up), beside the engine's call
on rank 0's card alone, and traced once for its all-gathers' bytes and
ms.  Rank 0 prints one line per path and per all-gather with every card's
name and power limit, then one JSON line.  ``--backend gloo --device cpu
--bytes N`` runs the same on the CPU with the plain versions, to rehearse
without cards.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import time
from datetime import timedelta


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--backend", default="nccl", help="the process group's backend")
    p.add_argument("--device", default=None, help="default: cuda:<LOCAL_RANK>")
    p.add_argument("--bytes", type=int, default=None, help="payload size; default the main path's")
    args = p.parse_args()
    import torch
    import torch.distributed as dist

    from snappy_tpu_torch import api
    from snappy_tpu_torch.parallel import mesh, multihost
    from snappy_tpu_torch.testing import payloads

    multihost.initialize(backend=args.backend, timeout=timedelta(seconds=300))
    m = mesh.default_mesh(device=args.device)
    dev = m.device
    size = payloads.MAIN_PATH_BYTES if args.bytes is None else args.bytes
    payload = payloads.mixed_payload(size)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    framed = mesh.sharded_framed_compress(payload, m)
    raw = mesh.sharded_raw_compress(payload, m)
    checks = {
        "framed": framed == api.encode_framed(payload, device=dev),
        "raw": raw == api.encode(payload, device=dev),
        "decode": mesh.sharded_framed_uncompress(framed, m) == (payload, "ok"),
    }
    if size == payloads.MAIN_PATH_BYTES:
        checks["digests"] = (sha(framed), sha(raw)) == (payloads.GOLDEN_SHA256, payloads.RAW_L1_SHA256)
    every = [None] * m.size
    dist.all_gather_object(every, checks)
    if not all(all(c.values()) for c in every):  # every rank stops here alike
        raise SystemExit(f"sharded_scaling: checks failed {every}")

    def timed(fn):
        """(best, median) seconds of fn() on the group, barrier to barrier."""
        fn()
        sync()
        times = []
        for _ in range(args.reps):
            dist.barrier()
            t = time.perf_counter()
            fn()
            sync()
            dist.barrier()
            times.append(time.perf_counter() - t)
        return min(times), statistics.median(times)

    paths = (
        ("sharded_framed_compress", "encode_framed", lambda: mesh.sharded_framed_compress(payload, m),
         lambda: api.encode_framed(payload, device=dev)),
        ("sharded_framed_uncompress", "decode_framed", lambda: mesh.sharded_framed_uncompress(framed, m),
         lambda: api.decode_framed(framed, device=dev)),
        ("sharded_raw_compress", "encode", lambda: mesh.sharded_raw_compress(payload, m),
         lambda: api.encode(payload, device=dev)),
    )
    rows = []
    for name, single_name, sharded, single in paths:
        on_group = timed(sharded)
        on_one = timed(single if m.rank == 0 else lambda: None)
        m.trace = []
        sharded()
        rows.append({"path": name, "ranks": m.size, "ms": [t * 1e3 for t in on_group],
                     single_name + "_one_card_ms": [t * 1e3 for t in on_one],
                     "gathers": [(g.name, g.rows, g.sent, g.ms) for g in m.trace]})
        m.trace = None
    card = "cpu"
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        card = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True,
        ).stdout.strip()
    cards = [None] * m.size
    dist.all_gather_object(cards, f"{card} (rank {m.rank}, {dev})")
    if m.rank == 0:
        tag = "[" + "; ".join(cards) + "]"
        for row in rows:
            (best, med), single = row["ms"], [k for k in row if k.endswith("_one_card_ms")][0]
            print(f"sharded_scaling: {row['path']} on {m.size} ranks, {size} bytes: best {best:.2f} ms, "
                  f"median {med:.2f} ms; {single[: -len('_one_card_ms')]} on one card best "
                  f"{row[single][0]:.2f} ms, median {row[single][1]:.2f} ms; one card / group (best) "
                  f"{row[single][0] / best:.3f} {tag}")
            for g_name, g_rows, sent, ms in row["gathers"]:
                share = -(-g_rows // m.size)
                print(f"sharded_scaling: all-gather, rank 0, {row['path']}: {g_name} of {g_rows} chunks: "
                      f"{sent} bytes sent ({sent / max(share, 1):.1f} per chunk of the largest share), "
                      f"{ms:.4f} ms {tag}")
        print(json.dumps({"sharded_scaling": rows, "cards": cards, "bytes": size,
                          "world": m.size, "torch": torch.__version__,
                          "local_world": int(os.environ.get("LOCAL_WORLD_SIZE", m.size))}))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
