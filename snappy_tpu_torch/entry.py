"""The flagship step and the multi-device dry run.

JAX counterpart: __graft_entry__.py (``entry``, ``dryrun_multichip`` and
its ``__main__``).  The flagship step is the hot path of production framed
Snappy: the masked CRC32C of each frame and the block encode of each
frame.  ``entry`` returns it as a function with example arguments;
``dryrun_multichip`` runs the sharded framed and raw round trips over a
mesh of n devices (parallel/mesh.py, one rank a device), a leg on the
other device route, the resumable decode of the sharded stream through a
64 KiB buffer, and the shard balance.

    python -m snappy_tpu_torch.entry

runs the step once on the example arguments on the card, then the dry run
over every card of the machine.

Divergences from the JAX package on purpose (ROADMAP queue 3):

* the step's route follows ``config.device_kernel()``, as every device
  entry point of the port does: on ``scalar`` (the default) K1 and K3 at
  level 1, whose bytes are the host C encoder's; on any other value K1 and
  the array encoder (ops/encode_array.py), the JAX entry's own
  ``encode_jax.encode_blocks``, so that its outputs equal the JAX entry's
  element for element;
* the dry run's second leg runs the array route
  (``SNAPPY_TPU_TORCH_DEVICE_KERNEL=xla``), where the JAX entry's forces
  its kernels: each package's second leg runs the route that is not its
  default;
* one rank a device (``mesh.default_mesh``): inside an initialized group
  of n ranks every rank runs the legs; without a group, n = 1 runs in this
  process and n > 1 spawns n ranks (nccl, rank r on ``cuda:r``; gloo where
  ``device="cpu"``), where JAX runs one process over n devices;
* the shard balance counts each rank's share of ``mesh.shard_bounds``, the
  split the mesh uses, where JAX counts chunk i on device i % n.

Nothing here falls back to the CPU, to a plain version or to another
backend.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import api, config, engine, telemetry
from .formats import constants as C
from .formats import framing
from .parallel import mesh as pmesh
from .parallel import multihost

EXAMPLE_B = 4096  # the example frames' width (__graft_entry__.py:26)
ROUTE_VAR = "SNAPPY_TPU_TORCH_DEVICE_KERNEL"  # config.device_kernel()'s variable
WINDOW = 65536  # the resumable leg's output buffer
GROUP_TIMEOUT = timedelta(seconds=300)  # of the spawned ranks' collectives
SPAWN_WAIT_S = 600  # for the spawned ranks to finish


def max_comp(b: int) -> int:
    """The step's encoded width for frames of ``b`` bytes
    (__graft_entry__.py:28); ``max_compressed_len(b)`` fits in it, and
    ``max_comp(65536)`` is K3's row width, ``encode_blocks.ENC_CAP``."""
    return b + b // 6 + 64


def step(frames_u8: torch.Tensor, flens: torch.Tensor):
    """The flagship step: ``(crcs, enc, totals)`` of the frames
    ``frames_u8[i, :flens[i]]``.

    frames_u8: uint8 [N, B], B <= 65536, zero past each row's length;
    flens: int32 [N].  Returns the masked CRC32C of each frame (uint32
    [N]), the raw tag stream of each frame at level 1 (uint8 [N,
    max_comp(B)], frame i's in ``enc[i, :totals[i]]``) and ``totals``
    (int32 [N]), on the frames' device: ``engine.encode_frames``, K1, then
    K3 or, off the ``scalar`` route, the array encoder.  ``enc`` is the
    encoder's own buffer: at B = 65536 the whole of K3's rows, below it a
    view of their first columns."""
    with telemetry.span("entry.step"):
        b = frames_u8.shape[1]
        if b > C.MAX_BLOCK_LEN:
            raise ValueError(f"frames of {b} bytes: the step takes at most {C.MAX_BLOCK_LEN}")
        width = max_comp(b)
        crcs, enc, totals = engine.encode_frames(frames_u8, flens, 1, width=width)
        return crcs, enc[:, :width], totals


def entry(device: config.DeviceLike = None):
    """``(fn, example_args)``: the flagship step and the JAX entry's example
    arguments (__graft_entry__.py:36-41), two frames of 4096 bytes of a
    17-byte word, on ``device`` (``cuda`` by default)."""
    dev = config.resolve_device(device)
    b = EXAMPLE_B
    rng = np.random.default_rng(0)
    word = rng.integers(0, 256, 17, dtype=np.uint8).tobytes()
    payload = (word * (2 * b // len(word) + 1))[: 2 * b]
    frames = torch.frombuffer(bytearray(payload), dtype=torch.uint8).view(2, b)
    flens = torch.full((2,), b, dtype=torch.int32)
    return step, (frames.to(dev), flens.to(dev))


def dryrun_payload(n_devices: int) -> bytes:
    """The dry run's payload, the JAX entry's (__graft_entry__.py:76-85):
    per device a word of 11 + k bytes repeated to 20,000 bytes, then 1,000
    random bytes."""
    rng = np.random.default_rng(1)
    parts = []
    for k in range(n_devices):
        word = rng.integers(0, 256, 11 + k, dtype=np.uint8).tobytes()
        parts.append((word * 2000)[: 40_000 // 2])
        parts.append(rng.integers(0, 256, 1000, dtype=np.uint8).tobytes())
    return b"".join(parts)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _legs(mesh: pmesh.Mesh) -> dict:
    """The dry run's legs on this rank of ``mesh``; raises where one fails."""
    n, dev = mesh.size, mesh.device
    payload = dryrun_payload(n)

    # (a) the sharded round trips on the configured route
    route = config.device_kernel()
    enc = pmesh.sharded_framed_compress(payload, mesh)
    out, reason = pmesh.sharded_framed_uncompress(enc, mesh)
    _require(reason == "ok", f"sharded decode failed: {reason}")
    _require(out == payload, "sharded round-trip mismatch")
    raw = pmesh.sharded_raw_compress(payload, mesh)
    _require(api.decode(raw, device=dev) == payload, "sharded raw round-trip mismatch")

    # (b) the array route: the sharded bytes equal the engine's on one
    # device on the same route
    small = payload[: 3 * 65536 + 1234]
    prev = os.environ.get(ROUTE_VAR)
    os.environ[ROUTE_VAR] = "xla"
    try:
        enc_s = pmesh.sharded_framed_compress(small, mesh)
        _require(enc_s == engine.framed_compress(small, device=dev, backend="device"),
                 "sharded array-route encode != single-device array-route encode")
        out_s, reason_s = pmesh.sharded_framed_uncompress(enc_s, mesh)
        _require(reason_s == "ok" and out_s == small, "array-route sharded round-trip")
        raw_s = pmesh.sharded_raw_compress(small, mesh)
        _require(api.decode(raw_s, device=dev) == small, "array-route sharded raw round-trip")
    finally:
        if prev is None:
            os.environ.pop(ROUTE_VAR, None)
        else:
            os.environ[ROUTE_VAR] = prev

    # (c) the resumable decode of (a)'s stream through a 64 KiB buffer
    out_buf = bytearray(WINDOW)
    got = []
    view, first, calls = enc, True, 0
    while True:
        res = api.uncompress_framed_into(view, out_buf, check_header=first, device=dev)
        _require(res.is_ok(), f"resumable decode failed: {res}")
        read, written = res.unwrap()
        calls += 1
        got.append(bytes(out_buf[:written]))
        if read >= len(view):
            break
        _require(written > 0, "no forward progress in resumable decode")
        view, first = view[read:], False
    _require(b"".join(got) == payload, "resumable round-trip mismatch")

    # (d) the shard balance of the mesh's own split
    chunks = framing.scan_frames(enc, len(C.FRAMING_HEADER))
    per_shard = np.diff(pmesh.shard_bounds(len(chunks), n))
    nonzero = per_shard[per_shard > 0]
    balance = float(nonzero.max()) / max(1, int(nonzero.min()))
    _require(balance <= 2.0, f"shard imbalance {per_shard.tolist()}")

    line = (f"dryrun_multichip OK on {n} devices ({len(payload)} B -> framed {len(enc)} B, "
            f"raw {len(raw)} B; array-route sharded leg OK; resumable windows OK "
            f"({calls} calls); shard balance {balance:.2f})")
    return {
        "n_devices": n, "device": str(dev), "payload": len(payload), "framed": len(enc),
        "raw": len(raw), "balance": balance, "per_shard": per_shard.tolist(), "calls": calls,
        "line": line,
        "first_leg": {"route": route, "framed": enc, "raw": raw},
        "array_leg": {"input": len(small), "framed": enc_s, "raw": raw_s},
    }


def _rank(rank: int, n: int, port: int, backend: str, device: str, out: str) -> None:
    """One spawned rank of the dry run: joins the group, runs the legs and
    writes its result to ``out``."""
    os.environ["LOCAL_RANK"] = str(rank)  # multihost.initialize's and default_mesh's card
    multihost.initialize(f"127.0.0.1:{port}", n, rank, backend=backend, timeout=GROUP_TIMEOUT)
    try:
        res = _legs(pmesh.default_mesh(n, None if device == "cuda" else device))
        with open(os.path.join(out, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(n: int, device: config.DeviceLike) -> dict:
    """The legs on ``n`` spawned ranks; rank 0's result, once every rank
    gave the same.  Raises where a rank fails or outlives SPAWN_WAIT_S, and
    kills the ranks that are left."""
    dev = config.resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip: {n} ranks need {n} cards, "
                           f"this machine has {torch.cuda.device_count()}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(_rank, args=(n, multihost.free_port(), backend, dev.type, out),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + SPAWN_WAIT_S
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"dryrun_multichip: ranks still running after {SPAWN_WAIT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(n):
            with open(os.path.join(out, f"rank_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    for r, res in enumerate(results[1:], 1):
        _require({k: v for k, v in res.items() if k != "device"}
                 == {k: v for k, v in results[0].items() if k != "device"},
                 f"rank {r}'s result differs from rank 0's")
    return results[0]


def dryrun_multichip(n_devices: int, device: config.DeviceLike = None) -> dict:
    """Run the sharded framed and raw round trips, the array-route leg, the
    resumable decode and the shard balance over a mesh of ``n_devices``
    ranks, one device a rank (``cuda`` unless ``device="cpu"``); print one
    line and return its numbers and the two legs' bytes.

    Inside an initialized group of ``n_devices`` ranks, every rank runs the
    legs (rank 0 prints).  Without a group, ``n_devices`` 1 runs here, and
    more spawn that many ranks: nccl with rank r on ``cuda:r`` (fewer cards
    than ranks raises), gloo on ``device="cpu"``."""
    if dist.is_available() and dist.is_initialized():
        res = _legs(pmesh.default_mesh(n_devices, device))
        if dist.get_rank() == 0:
            print(res["line"])
        return res
    res = _legs(pmesh.default_mesh(1, device)) if n_devices == 1 else _spawn(n_devices, device)
    print(res["line"])
    return res


def main() -> None:
    fn, args = entry()
    crcs, enc, totals = fn(*args)
    torch.cuda.synchronize()
    print(f"entry: {config.device_kernel()} route on {torch.cuda.get_device_name(0)}: frames "
          f"{tuple(args[0].shape)} -> crcs {tuple(crcs.shape)} {crcs.dtype}, enc {tuple(enc.shape)}, "
          f"totals {totals.tolist()}")
    dryrun_multichip(torch.cuda.device_count())


if __name__ == "__main__":
    main()
