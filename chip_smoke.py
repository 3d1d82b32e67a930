"""Drive the port's framed, raw and stream-layer paths once on one CUDA
card and check them, the same entry points on the host backend, and the
sharded paths on process groups over that card.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. setup    — torch and CUDA versions, the card, its name and power limit;
2. build    — nvcc builds the six kernel sources from
              snappy_tpu_torch/ops/csrc into build/snappy_tpu_torch/ (first
              use, one nvcc per source, all at once);
3. kernels  — each kernel against its plain version: CRC32C, the level-1
              and level-2 block encoders and the chunk decoder on 8 chunks
              (text, SSZ-like records, runs, period 8, random, a 64 KiB
              block, a 17-byte block, an empty block), the chunk decoder
              also on malformed and truncated streams; the chunk decoder at
              its 128 KiB big-window shape on payloads.big_window_cases and
              the streaming decoders (grid mode K4, scan mode K5) on
              payloads.stream_cases and scan_edge_cases (segments across
              window edges, far copies, the scan's 64 KiB history limit,
              mutants; K5's verdicts include `unsupported`); K4 also on
              payloads.window_cases, each case on the route that
              decode_raw_stream_bytes takes (the window route where the
              host index builds, with copies reaching earlier windows
              decoded again by its ordered pass, else the whole-stream
              walk); K5 also on window_cases, scan_differential_cases,
              scan_window_cases (ragged steps, resyncs after walked
              windows, the MARGIN stop, the history limit inside a
              window, a bad tag after a walked window, a declared length
              past the stream and of 0) and on scan_forced_index_cases'
              indices, on both of its routes (pass 2 alone, and K2 over
              the windows then pass 2 where an index exists): the 16 state
              words, every step's length and the bytes equal its plain
              scan, and the steps walked by pass 2 are as expected; the
              GF(2) CRC (K6) on the 8 blocks; equal, or it
              fails; then K6 against the host C CRC on seeded rows in
              batches of N = 1, 7, 131, 132, 133, 264, 769 and 2048 (the
              counts around its grid of 2 CTAs an SM) with lengths of
              0-65,536, and on the lengths 0, 1, 31, 32, 33, 511, 512,
              4095, 4096, 65,535 and 65,536; then the CRC differential: K1 on 512 seeded rows of
              0-64 KiB at every start offset and on prefixes of the payload
              of 64 KiB + 1 up to 48 MiB as single rows equals the host C
              CRC (host_codec.masked_crc32c), and K1 on one row of 1 MiB + 7
              equals its plain version, or it fails; then the encoder
              differential: at levels 1 and 2,
              K3's bytes on payloads.encoder_blocks (the named
              batch-logic cases, then blocks of every payload kind and the
              adversarial kinds at random lengths, 1,200 in all) equal the
              host C encoder's (host_codec.encode_block), or it fails;
              then K3's persistent grid at both levels: the first 1, 7,
              8, 924 and 925 of those blocks (the edges of 7 walkers an
              SM on 132 SMs), a ragged batch of 932 rows of 65,536, 856,
              16 and 0 bytes, and two launches back to back on one stream
              without a synchronise (the second finds its row queue
              zeroed) equal the host C encoder, k3.walkers rises by
              encode_blocks.launch_shape's walkers a launch and
              k3.ordered by one where the rows outnumber the walkers (the
              costliest walked first), or it fails;
              then the decoder differential: 600 seeded raw streams of
              30 B to 200 KB, 60% of them mutated (bit flips, truncations,
              insertions, duplications; payloads.mutation_streams), through
              engine.raw_uncompress_batch (K2 at both shapes, K4 above
              128 KiB) and through K2 directly at W = 64 KiB and 128 KiB,
              against the host C decoder (host_codec.decode_tags, by
              payloads.host_raw_decode): verdicts and bytes equal, and
              K2's written counts and whole rows (zeros included) equal
              its plain version's on the same rows, or it fails;
4. framed   — encode_framed / decode_framed of the seeded 48 MiB mixed
              payload: the stream's SHA-256 equals the digest pinned from
              the JAX package and decodes back to the payload; then the
              error-order cases and check_integrity=False;
5. raw      — encode of the payload at levels 1 and 2 (SHA-256 equal to the
              pinned JAX digests), decode of the level-1 stream (the
              streaming decoder's window route, no window decoded twice),
              encode_batch against per-payload encode,
              decode_batch of the seeded serving batch against the plain
              versions, compress_into / uncompress_into, and
              encode_framed(level=2) against its digest;
6. streams  — the stream layer: the sync adapters and the asyncio ones
              (over an in-memory StreamReader) on the 48 MiB payload (the
              framed-L1 and raw-L1 digests, and back to the payload);
              uncompress_framed_into through 1 MiB and 8 MiB buffers with
              re-entry, and payloads.framed_vectors against their pinned
              results; decode_raw_stream_bytes of the level-1 stream in
              scan mode (K5's window route: K2 over the windows and one
              pass-2 launch, no step walked); cli.main in a temporary
              directory: framed L1 and L2 round trips, then `-d --raw`
              with SNAPPY_TPU_TORCH_STREAM_MODE=scan set for the call (K5 on its
              window route, no step walked), and a far-copy stream (K5
              without an index, then the whole-stream walk of K4: one
              literal over the boundaries);
6b. host    — the same entry points on the host backend
              (config.set_backend("host"): the native C runtime on this
              machine's cores): encode_framed and encode of the payload at
              levels 1 and 2 (the pinned JAX digests), decode_framed and
              decode back to the payload, decode_batch of the serving batch
              equal to the device backend's results, uncompress_framed_into
              through 1 MiB and 8 MiB buffers (the device backend's
              (read, written) steps), payloads.framed_vectors, the sync and
              asyncio adapters (digests, and back to the payload) and
              masked_crc32c; no kernel launches;
7. fused CRC — crc32c_mma.masked_crc32c_chunks_fused over the 769 frames
              of the payload, equal to K1's CRCs of the same frames; then
              the one-shot masked_crc32c of the whole payload (K1 over
              every SM, its tiles folded by a second launch), equal to the
              host C CRC;
10. sharded — (runs after 7, so that 8 and 9 count and time it) the
              multi-GPU layer (snappy_tpu_torch.parallel) on the 48 MiB
              payload: (a) a one-rank nccl group on cuda:0 (tcp:// on a
              free local port): sharded_framed_compress and
              sharded_raw_compress give the framed-L1 and raw-L1 digests,
              sharded_framed_uncompress the payload, the error-order cases
              of phase 4 plus a bad verbatim CRC after a bad compressed
              chunk (`crc`, the JAX mesh's order, where the engine says
              `invalid`) and check_integrity=False, then
              compress_framed_span / uncompress_framed_span on the one
              rank; (b) two gloo ranks on the same card (nccl refuses two
              ranks on one GPU), spawned processes that each launch their
              kernels on cuda:0: the same digests and the payload on every
              rank, the header and both span blobs in rank order give the
              framed-L1 digest, the decoded spans at their offsets the
              payload; a rank that fails or outlives 600 s fails the phase;
12. array   — (runs after 10, while its nccl rank is up, before 11) the
              array route, SNAPPY_TPU_TORCH_DEVICE_KERNEL=xla for the phase
              only (the array encoder and decoder, ops/encode_array.py and
              ops/decode_array.py, the JAX package's XLA kernels, in place
              of K2-K5; K1 for the CRCs): encode_framed and encode of the
              payload at levels 1 and 2 (which the route ignores) give the
              digests pinned from the JAX package's array route
              (payloads.FRAMED_XLA_SHA256, RAW_XLA_SHA256, with their
              lengths), decode_framed and decode of those streams and of
              the level-1 K3 streams return the payload (each raw decode
              one whole-stream array decode), decode_batch of the serving
              batch equals the scalar route's results and encode_batch
              per-payload encode, uncompress_framed_into through 8 MiB
              buffers gives the scalar route's (read, written) steps, the
              sync adapter round-trips, phase 4's error-order cases and
              check_integrity=False hold, the 600 mutation streams through
              raw_uncompress_batch equal the host C decoder's verdicts
              and bytes, and on the nccl rank of phase 10
              sharded_framed_compress and sharded_raw_compress give the
              array digests and sharded_framed_uncompress the payload;
13. cpp     — (runs after 12, before 11) the port against google/snappy
              (testing/cpp_differential.py): where libsnappy.so.1 loads on
              this host, (a) google/snappy's stream of the payload decodes
              back with decode in grid mode (K4's window route; k4.redecoded
              printed), in scan mode (K5's window route; k5.walked printed)
              and on the array route, its streams of the serving batch
              with decode_batch (K2 at both shapes) and of the batch's
              64-128 KiB payloads with decode (K2 at 128 KiB), and (b)
              google/snappy decodes the port's streams of the payload at
              levels 1 and 2 (K3) and on the array route, and encode_batch's
              of the serving inputs, their sizes printed beside its own;
              where it does not load, one line says so, and the port's
              streams must equal those that google/snappy decoded where
              the pins were made (testing/cpp_pins.json).  Then, live or
              pinned: the 600 mutation streams, google/snappy's 31 seed
              streams and 400 mutants of them, and the 48 streams of the
              far-copy battery (payloads.farcopy_placement_cases: copies
              reaching more than 64 KiB back, near ones, literals, placed
              at and across the 64 KiB boundaries) through every decode
              route (raw_uncompress_batch; decode in grid and scan mode;
              the array route; decode_raw_stream_bytes on every stream in
              grid mode, K4 on its window route or its walk, and in scan
              mode, K5 then K4 on `unsupported`), the host C decoder and
              the oracle (not on the mutation streams): each verdict and
              each output's SHA-256 equal google/snappy's, or it fails;
11. guards  — (runs after 10, 12 and 13, before 8 and 9) the card's stand-in for
              compute-sanitizer, which does not run on its machine
              (testing/guards.py): each kernel through its wrapper's
              _launch on phase 3's cases (the smoke blocks, the CRC
              differential's rows at every start offset and the payload's
              prefixes as single rows, K6's batches and edge lengths, the
              encoder differential's blocks at both levels, the chunk,
              big-window, stream, window and scan cases, K4 and K5 on both
              routes), the 600 mutation streams each alone (K2 at both
              widths where they fit, K4 and K5 on both routes) and the
              main-path shapes (768 x 64 KiB for K1, K2, K3 and K6, the
              48 MiB level-1 stream on K4's and K5's window routes): every
              buffer a kernel writes is a view inside 4 KiB guard bands of
              a fixed pattern, unchanged after the launch, and every buffer
              it reads has a 4 KiB tail guard filled with 0x00, 0xFF and
              seeded random bytes in turn, with the same result each time;
              then a raw stream declared 2^31 + 3 * 65536 + 5 bytes long (runs
              and period-8 data, a body of 139 MB) on K4's and K5's window
              routes (K2 over 32,772 windows), input guards 0x00 and 0xFF:
              ok, and the SHA-256 of the output equal to the host C
              decoder's, or it fails;
8. counters — each kernel was launched by its path (4, 5, 6, 7 or 10), the
              counts set to 0 just before each path and read just after;
              every count reads 0 across the host phase (6b);
              for scan mode, K5's pass-2 and pass-1 launches, K4's
              launches after `unsupported` and the steps pass 2 walked;
              for the sharded paths, K1's, K2's and K3's launches on the
              nccl rank and on each gloo rank, each above 0 on a rank that
              holds frames; the guard phase's launches, counted by the
              wrappers, equal its guarded launches; on the array route
              (phase 12) K1 launched, and K2-K6 (K4's and K5's routes
              too) never; in phase 13 K2 at both shapes, K3 at both levels,
              K4 and K5, and on the far-copy battery K4's window route, its
              walk and its second pass, and K5's window route;
9. timings  — each kernel at its main-path shape and on its small set
              beside its plain version, its bound on the card, and the
              end-to-end rates; for K4 also the host index, each pass of
              the window route alone and one whole-stream walk of the
              48 MiB stream; for K5 each pass of its window route alone
              (pass 1 is K2 over the windows) and its route without an
              index once (every step walked); for K3 the host C encoder on one host thread
              over the same 768 blocks, the same-machine control, and
              likewise the host C CRC for K1; for K1 (crc32c at 768 x
              64 KiB, crc32c_long on the payload as one row) its registers,
              shared memory and CTAs per SM and the A/B of its two layouts
              (testing/crc_layouts.measure); for K6 its registers,
              spills, shared memory and CTAs per SM; for K2
              the registers of each shape's kernel (ptxas) and its CTAs per
              SM, and the A/B of its two layouts at both shapes
              (testing/decode_layouts.measure: the row in shared memory,
              or written in place in global memory); then the end-to-end
              rates once more on the host backend, each beside the device
              backend's, with the CPU model and os.cpu_count(); each
              end-to-end path's peak device memory above what was
              allocated before it, and its time and peak on the array
              route beside the scalar route's (best and median of 3); the sharded
              framed encode, framed decode and raw encode on the nccl rank
              beside the engine's call on one device (engine, sharded,
              sharded, engine), each gloo rank's times, and each
              all-gather's bytes, bytes per chunk and ms;
14. entry   — (last, after 9, once 10 has destroyed its group) the
              flagship step and the dry run (snappy_tpu_torch/entry.py, the
              counterpart of __graft_entry__.py): (a) entry()'s example
              step on the card on the kernel route and on the array route
              (SNAPPY_TPU_TORCH_DEVICE_KERNEL=xla) equal to the step on the
              CPU (the plain versions): crcs, totals and each enc[i,
              :totals[i]]; (b) the step on the payload's 769 frames of
              64 KiB on both routes: its CRCs equal the stored CRCs of the
              engine's framed stream on that route (phases 4 and 12), each
              compressed chunk's body equals enc[k, :totals[k]], K1
              launches once a step and K3 once on the kernel route and
              never on the array route, no other kernel; the step timed
              with CUDA events (mean of 10 after a warm-up) and its peak
              device memory; (c) dryrun_multichip(torch.cuda.device_count())
              and its line; the launches of (b) and (c) counted as in 8.

Any failure raises and the exit code is not 0.  The line before the last
is a JSON object of the kernels: per kernel, the launch count of its path,
the largest difference from its plain version, ``ms`` (one call at the
main-path shape), ``plain_ms`` (the plain version on the small set),
``ms_small`` (the kernel on that same set), ``bound_ms`` (the larger of the
bytes the call moves over 3.35 TB/s and its int8 operations over 1,979
TOP/s, from this run's inputs) with ``bound_by``, and ``library_ms`` (null:
no single PyTorch call computes any of these functions), and ``guarded``
(its launches inside the guard bands of phase 11); K1, K2 and K3 also
carry ``sharded_launches`` (the nccl rank's and each gloo rank's), and
every kernel ``array_launches`` (its launches in phase 12: K1's, and 0 for
the others), ``cpp_launches`` (its launches in phase 13),
``entry_launches`` (per route, its launches in one step of phase 14 at
full width) and ``dryrun_launches`` (its launches in this process during
the dry run of phase 14: none where the dry run spawns its ranks).  The
last line is the JSON result.  Exits nonzero, printing no result, where torch.cuda is not
available.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import hashlib
import io
import json
import multiprocessing
import os
import platform
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

KERNELS = {
    # name: (CUDA source, the TPU kernel it replaces, its main path)
    "crc32c": ("snappy_tpu_torch/ops/csrc/crc32c.cu",
               "snappy_tpu/ops/crc32c_pallas.py:52", "framed"),
    "decode_chunks": ("snappy_tpu_torch/ops/csrc/decode_chunks.cu",
                      "snappy_tpu/ops/decode_scalar.py:151", "framed"),
    "encode_blocks": ("snappy_tpu_torch/ops/csrc/encode_blocks.cu",
                      "snappy_tpu/ops/encode_scalar.py:56", "framed"),
    "encode_blocks_l2": ("snappy_tpu_torch/ops/csrc/encode_blocks.cu",
                         "snappy_tpu/ops/encode_scalar.py:56", "raw"),
    "decode_chunks_big": ("snappy_tpu_torch/ops/csrc/decode_chunks.cu",
                          "snappy_tpu/ops/decode_scalar.py:450", "raw"),
    "decode_stream": ("snappy_tpu_torch/ops/csrc/decode_stream.cu",
                      "snappy_tpu/ops/decode_stream.py:799", "raw"),
    "decode_stream_scan": ("snappy_tpu_torch/ops/csrc/decode_stream_scan.cu",
                           "snappy_tpu/ops/decode_stream.py:75", "streams"),
    "crc32c_mma": ("snappy_tpu_torch/ops/csrc/crc32c_mma.cu",
                   "snappy_tpu/ops/crc32c_mxu.py:165", "fused_crc"),
    "crc32c_long": ("snappy_tpu_torch/ops/csrc/crc32c.cu",
                    "snappy_tpu/ops/crc32c_pallas.py:52", "one_shot"),
}
CRC_DIFFERENTIAL = 32  # rows per start offset held against the host C CRC
MMA_SWEEP = (1, 7, 131, 132, 133, 264, 769, 2048)  # K6's batches held against the host C CRC
MMA_EDGES = [0, 1, 31, 32, 33, 511, 512, 4095, 4096, 65535, 65536]
K3_SLICES = (1, 7, 8, 924, 925)  # K3's batches across its walker and grid edges (7 walkers an SM, 132 SMs)
K3_RAGGED = (65536, 856, 16, 0) * 233  # the rows of K3's ragged batch
ENCODER_DIFFERENTIAL = 1200  # blocks per level held against the host C encoder
DECODER_DIFFERENTIAL = 600  # raw streams held against the host C decoder
K2_SHAPE = {"decode_chunks": "chunk", "decode_chunks_big": "big"}  # decode_layouts' shapes
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: HBM3 rate, dense int8 tensor-core peak
INT8_OPS_PER_S = 1.979e15
SHARDED = ("crc32c", "decode_chunks", "encode_blocks")  # the kernels of the sharded paths
SHARDED_WORLD = 2  # gloo ranks on the one card in phase 10 (b)
GROUP_TIMEOUT_S = 300  # of every process group's collectives
RANK_WAIT_S = 600  # for the ranks of phase 10 (b)
LONG_STREAM = (1 << 31) + 3 * 65536 + 5  # the guard phase's declared length above 2^31


def bound(nbytes: int, int8_ops: int = 0):
    """(least ms, what bounds it) for a call that moves nbytes and does
    int8_ops tensor-core operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int8_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def env_var(name: str, value: str):
    """The environment variable ``name`` set to ``value`` inside, restored
    after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def stream_mode(mode: str):
    """SNAPPY_TPU_TORCH_STREAM_MODE set to ``mode`` inside, restored after."""
    return env_var("SNAPPY_TPU_TORCH_STREAM_MODE", mode)


def array_route():
    """The engine on its array route inside (the array encoder and decoder
    in place of K2-K5), restored after."""
    return env_var("SNAPPY_TPU_TORCH_DEVICE_KERNEL", "xla")


def card_label() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cpu_label() -> str:
    """The host CPU as /proc/cpuinfo names it (the first processor's
    vendor, family, model and model name, as far as they are given), the
    machine and the core count."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for ln in f:
            key, _, value = ln.partition(":")
            fields.setdefault(key.strip(), value.strip())
    names = ("vendor_id", "cpu family", "model", "model name", "CPU implementer", "CPU part")
    model = "; ".join(f"{k} {fields[k]}" for k in names if fields.get(k)) or "not in /proc/cpuinfo"
    return f"{model}; {platform.machine()}, os.cpu_count() {os.cpu_count()}"


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean host time of fn() in ms over reps calls."""
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def e2e(fn, reps=3):
    """(best, median) host seconds of fn(), ended by a synchronize, after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return min(times), statistics.median(times)


def ragged(bodies):
    """(comp uint8, offsets int64 [N + 1]) of a list of tag streams."""
    offsets = np.zeros(len(bodies) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(b) for b in bodies])
    comp = np.frombuffer(b"".join(bodies), dtype=np.uint8).copy()
    return torch.from_numpy(comp), torch.from_numpy(offsets)


def block_batch(blocks, dev):
    rows = np.zeros((len(blocks), 65536), dtype=np.uint8)
    for k, b in enumerate(blocks):
        rows[k, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    lens = torch.tensor([len(b) for b in blocks], dtype=torch.int32)
    return torch.from_numpy(rows).to(dev), lens.to(dev)


def gathers(trace) -> list:
    """A mesh's trace as (name, rows, bytes sent, ms) per all-gather."""
    return [(g.name, g.rows, g.sent, g.ms) for g in trace]


def sharded_rank(rank: int, world: int, port: int, out: str) -> None:
    """Phase 10 (b), in a spawned process: rank ``rank`` of a gloo group of
    ``world`` ranks that all launch their kernels on cuda:0.  Runs the
    sharded paths and the span API on the 48 MiB payload, counts its K1, K2
    and K3 launches, times the sharded paths, and writes its results and
    its span bytes under ``out``."""
    from snappy_tpu_torch import telemetry
    from snappy_tpu_torch.parallel import mesh as pmesh
    from snappy_tpu_torch.parallel import multihost
    from snappy_tpu_torch.testing import payloads

    dev = torch.device("cuda:0")
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                         timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    m = pmesh.default_mesh(world, device=dev)
    payload = payloads.mixed_payload()
    telemetry.reset_counters()
    framed = pmesh.sharded_framed_compress(payload, m)
    raw = pmesh.sharded_raw_compress(payload, m)
    back = pmesh.sharded_framed_uncompress(framed, m)
    launches = {"crc32c": telemetry.counter("k1.launches"), "decode_chunks": telemetry.counter("k2.launches"),
                "encode_blocks": telemetry.counter("k3.launches")}
    span = len(payload) // (world * 65536) * 65536
    blob, off, total = multihost.compress_framed_span(
        payload[:span] if rank == 0 else payload[span:], device=dev)
    part, out_off, total_out, span_reason = multihost.uncompress_framed_span(framed, device=dev)
    paths = (("sharded_framed_compress", lambda: pmesh.sharded_framed_compress(payload, m)),
             ("sharded_framed_uncompress", lambda: pmesh.sharded_framed_uncompress(framed, m)),
             ("sharded_raw_compress", lambda: pmesh.sharded_raw_compress(payload, m)))
    times = {name: e2e(fn, 3) for name, fn in paths}
    traced = []  # (path, its all-gathers) of one call each
    for name, fn in paths:
        m.trace = []
        fn()
        traced.append((name, gathers(m.trace)))
    with open(os.path.join(out, f"blob_{rank}"), "wb") as f:
        f.write(blob)
    with open(os.path.join(out, f"part_{rank}"), "wb") as f:
        f.write(part or b"")
    with open(os.path.join(out, f"rank_{rank}.json"), "w") as f:
        json.dump({
            "framed_sha256": hashlib.sha256(framed).hexdigest(),
            "raw_sha256": hashlib.sha256(raw).hexdigest(),
            "decoded": back[1] == "ok" and back[0] == payload, "reason": back[1],
            "launches": launches, "span": [off, total], "part_at": [out_off, total_out, span_reason],
            "times": times, "gathers": traced,
            "frames": int(np.diff(pmesh.shard_bounds(-(-len(payload) // 65536), world))[rank]),
        }, f)
    dist.barrier()
    dist.destroy_process_group()


def run_sharded_ranks(world: int, out: str) -> list:
    """Phase 10 (b): spawn ``world`` ranks of ``sharded_rank`` (spawn, since
    CUDA is up in this process) and return each rank's results.  Raises if
    a rank fails or is still running after RANK_WAIT_S; kills every rank
    that is left."""
    from snappy_tpu_torch.parallel import multihost

    ctx = multiprocessing.get_context("spawn")
    port = multihost.free_port()
    procs = [ctx.Process(target=sharded_rank, args=(r, world, port, out)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + RANK_WAIT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise RuntimeError(f"sharded: ranks {hung} of {world} still running after {RANK_WAIT_S} s")
        failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"sharded: ranks failed (rank, exit code): {failed}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank_{r}.json")) as f:
            res = json.load(f)
        for name in ("blob", "part"):
            with open(os.path.join(out, f"{name}_{r}"), "rb") as f:
                res[name] = f.read()
        results.append(res)
    return results


def google_phase(dev, payload: bytes, inputs: list, tag: str) -> dict:
    """Phase 13: the port against google/snappy (testing/cpp_differential.py).
    Where libsnappy.so.1 loads here, (a) google/snappy's stream of the
    payload through decode in grid mode (K4) and in scan mode (K5) and on
    the array route, its streams of the serving batch through decode_batch
    and of the batch's 64-128 KiB payloads through decode (K2 at 128 KiB),
    and (b) google/snappy decoding the port's streams of the payload
    (levels 1 and 2, the array route) and of the serving inputs
    (encode_batch); where it does not, one line says so, and (b) holds the
    port's streams to the pinned ones that google/snappy decoded where the
    pins were made.  Then, live or pinned, the mutation streams, the seeds
    and their mutants and the far-copy battery through every route of
    cd.ROUTES against google/snappy's verdicts, beside the host C decoder
    and the oracle.  Returns what phase 8 prints."""
    from snappy_tpu_torch import api, telemetry
    from snappy_tpu_torch.testing import cpp_differential as cd
    from snappy_tpu_torch.testing import cpp_snappy, oracle, payloads

    def ctr():  # K4 window route, K4 walk, windows decoded again; K5 pass 2, K5 pass 1, steps walked
        return tuple(telemetry.counter(c) for c in (
            "k4.launches_windows", "k4.launches_walk", "k4.redecoded",
            "k5.launches", "k5.launches_windows", "k5.walked"))

    def since(before):
        return tuple(a - b for a, b in zip(ctr(), before))

    t0 = time.perf_counter()
    pins = cd.load_pins()
    live = cpp_snappy.available()
    res = {"live": live}
    if live:
        print(f"cpp: google/snappy loads on this host ({cpp_snappy.version()}): (a) and (b) run live")
        g48 = cpp_snappy.encode(payload)
        got = {}
        before = ctr()
        with stream_mode("grid"):
            got["grid"] = api.decode(g48, device=dev)
        grid_ctr = since(before)
        before = ctr()
        with stream_mode("scan"):
            got["scan"] = api.decode(g48, device=dev)
        scan_ctr = since(before)
        with array_route():
            got["array"] = api.decode(g48, device=dev)
        for name, back in got.items():
            assert back == payload, ("google -> port: decode of the payload's stream", name)
        serving_g, expect_g = payloads.serving_batch(lambda ps: [cpp_snappy.encode(p) for p in ps])
        assert api.decode_batch(serving_g, device=dev) == [e if e is not None else b"" for e in expect_g], \
            "google -> port: decode_batch"
        mid = [e for e in expect_g if e is not None and 65536 < len(e) <= 131072]
        for p in mid:
            assert api.decode(cpp_snappy.encode(p), device=dev) == p, ("google -> port: K2 at 128 KiB", len(p))
        res.update(redecoded=grid_ctr[2], walked=scan_ctr[5])
        print(f"cpp: (a) google/snappy's {len(g48)}-byte stream of the payload decodes back with decode in "
              f"grid mode (K4 window-route launches, walks, windows decoded again: {grid_ctr[:3]}), in scan "
              f"mode (K5 pass-2 launches, pass-1 launches, steps walked: {scan_ctr[3:]}) and on the array "
              f"route; decode_batch of the serving batch re-encoded by google/snappy ({len(serving_g)} "
              f"streams) gives its payloads; {len(mid)} google streams of 64-128 KiB decode with decode; "
              f"k4.redecoded {grid_ctr[2]}, k5.walked {scan_ctr[5]} {tag}")
    else:
        print(f"cpp: google/snappy (libsnappy.so.1) does not load on this host: (a) google -> port and (b) "
              f"port -> google do not run live; the pinned part runs, on the verdicts pinned from "
              f"{pins['library']}")
    ports = {"raw_l1": api.encode(payload, level=1, device=dev), "raw_l2": api.encode(payload, level=2, device=dev)}
    with array_route():
        ports["array"] = api.encode(payload, device=dev)
    batch = api.encode_batch(inputs, device=dev)
    if live:
        for name, s in ports.items():
            assert cpp_snappy.decode(s) == payload, ("port -> google", name)
        assert all(cpp_snappy.decode(s) == p for s, p in zip(batch, inputs)), "port -> google: encode_batch"
        g_sizes = {"payload": len(g48), "serving_inputs": sum(len(cpp_snappy.encode(p)) for p in inputs)}
        how = "google/snappy decodes each back to its payload (live)"
    else:
        port = pins["port_streams"]
        for name, s in ports.items():
            assert (len(s), cd.digest(s)) == (port[name]["len"], port[name]["sha256"]), ("pinned stream", name)
            assert port[name]["google_decodes"], ("google/snappy did not decode the pinned stream", name)
        assert (sum(map(len, batch)), cd.list_digest(batch)) == \
            (port["encode_batch"]["len"], port["encode_batch"]["sha256"]), "pinned encode_batch streams"
        assert port["encode_batch"]["google_decodes"]
        g_sizes = pins["google_sizes"]
        how = ("each stream is the one that google/snappy decoded back to its payload where the pins were "
               "made (pinned, not live; google/snappy's sizes pinned there)")
    sizes = {name: len(s) for name, s in ports.items()}
    res["sizes"] = dict(sizes, encode_batch=sum(map(len, batch)), google=g_sizes)
    print(f"cpp: (b) the port's streams of the {len(payload)}-byte payload: level 1 (K3) {sizes['raw_l1']} "
          f"bytes, level 2 {sizes['raw_l2']}, array route {sizes['array']}, google/snappy "
          f"{g_sizes['payload']} (level 1 / google {sizes['raw_l1'] / g_sizes['payload']:.6f}); encode_batch "
          f"of the {len(inputs)} serving inputs {sum(map(len, batch))} bytes, google/snappy "
          f"{g_sizes['serving_inputs']}; {how}")

    sets = cd.battery(pins["seeds"])
    if live:  # the pins against this host's library
        for name, streams in sets.items():
            assert [cd.digest(cpp_snappy.decode(s)) for s, _ in streams] == pins["verdicts"][name], \
                ("google/snappy here differs from its pinned verdicts", name)
    div = collections.Counter()  # (route, set, what differs, stream kind)
    farcopy = {}
    for name, streams in sets.items():
        ss, kinds, want = [s for s, _ in streams], [k for _, k in streams], pins["verdicts"][name]
        runs = [("host C", list(range(len(ss))), [payloads.host_raw_decode(s) for s in ss], [], ())]
        if name != "mutation_streams":  # the oracle: pure Python, the small sets
            runs.append(("oracle", list(range(len(ss))), [oracle.uncompress(s)[0] for s in ss], [], ()))
        for route in cd.ROUTES:
            before = ctr()
            runs.append((route,) + cd.run_route(route, ss, dev) + (since(before),))
        parts = []
        for route, idx, outs, firsts, moved in runs:
            for i, what in cd.disagreements(want, idx, outs):
                div[route, name, what, kinds[i]] += 1
            extra = ""
            if route == "K4":
                extra = f", window-route / walk launches, windows decoded again {moved[:3]}"
            elif route == "K5":
                extra = (f", K5 says {dict(collections.Counter(firsts))}, pass-2 / pass-1 launches, steps "
                         f"walked {moved[3:]}")
            parts.append(f"{route} {len(idx)} streams, {sum(o is not None for o in outs)} accepted{extra}")
            if name == "farcopy":
                farcopy[route] = (moved, collections.Counter(firsts))
        print(f"cpp: {name}: {len(ss)} streams ({dict(collections.Counter(kinds))}), google/snappy accepts "
              f"{sum(w is not None for w in want)} ({'live' if live else 'pinned'}): " + "; ".join(parts))
    n = sum(map(len, sets.values()))
    print(f"cpp: {n} streams on {len(cd.ROUTES)} device routes, the host C decoder and the oracle against "
          f"google/snappy's verdicts and bytes: {sum(div.values())} divergences {dict(div)} (tolerance: "
          f"exact); {time.perf_counter() - t0:.1f} s {tag}")
    assert not div, ("google/snappy differential", dict(div))
    assert farcopy["K5"][1]["ok"] > 0 and farcopy["K5"][1]["unsupported"] > 0, ("far-copy battery", farcopy)
    res.update(streams=n, farcopy_k4=farcopy["K4"][0][:3], farcopy_k5=farcopy["K5"][0][3:])
    return res


def main() -> None:
    # 1. setup ---------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available")
    from snappy_tpu_torch import api, cli, config, engine, telemetry
    from snappy_tpu_torch.formats import constants as C
    from snappy_tpu_torch.formats import framing, varint
    from snappy_tpu_torch.ops import (
        _build, crc32c, crc32c_mma, decode_chunks, decode_stream, encode_blocks, host_codec,
    )
    from snappy_tpu_torch.streams import aio, sync
    from snappy_tpu_torch.testing import payloads

    counted = {  # chip_smoke's row key: the telemetry counter it prints
        "crc32c": "k1.launches",
        "decode_chunks": "k2.launches",
        "encode_blocks": "k3.launches",
        "encode_blocks_l2": "k3.launches_l2",
        "decode_chunks_big": "k2.launches_big",
        "decode_stream": "k4.launches",
        "decode_stream_scan": "k5.launches",
        "crc32c_mma": "k6.launches",
        "crc32c_long": "k1.launches",
    }

    def counts():
        return {key: telemetry.counter(name) for key, name in counted.items()}

    reset_counts = telemetry.reset_counters

    def routes():
        return tuple(telemetry.counter(c) for c in ("k4.launches_windows", "k4.launches_walk", "k4.redecoded"))

    def scan_routes():
        return tuple(telemetry.counter(c) for c in (
            "k5.launches", "k5.launches_windows", "k4.launches_walk", "k4.launches_windows", "k5.walked"))

    dev = torch.device("cuda:0")
    card = card_label()
    tag = f"[{card}]"
    print(f"setup: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    print(card)

    # 2. build ---------------------------------------------------------------
    t = time.perf_counter()
    _build.cuda_lib()
    print(f"build: {time.perf_counter() - t:.2f} s (nvcc sm_90a, {len(_build.SOURCES)} sources)")
    for line in _build.cuda_build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("build: ptxas" + line.split("ptxas", 1)[-1])
    t = time.perf_counter()
    host_codec.lib()
    print(f"build: {time.perf_counter() - t:.2f} s (cc, the native host runtime)")

    # 3. kernels against their plain versions, on the card -------------------
    named = payloads.smoke_blocks()
    blocks = [b for _, b in named]
    frames, lens = block_batch(blocks, dev)
    frames_h, lens_h = frames.cpu(), lens.cpu()
    err = {}

    got = crc32c.masked_crc32c_chunks(frames, lens).cpu()
    want = crc32c._crc32c_plain(frames_h, lens_h)
    err["crc32c"] = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    assert torch.equal(got, want), ("crc32c", got, want)

    # the CRC differential: K1 against the host C CRC, on seeded rows of
    # 0-64 KiB at every start offset (a row stride skewed past 16 bytes
    # moves each row's offset) and on prefixes of the payload as single rows
    payload = payloads.mixed_payload()
    rnd = payloads.Rand(9)
    crc_rows, crc_bad = 0, []
    width = 65536
    for off in range(16):
        stride = width + 16 + int(rnd.ints(0, 16, 1)[0])
        buf = torch.from_numpy(rnd.bytes(CRC_DIFFERENTIAL * stride + 64)).to(dev)
        view = buf[(-buf.data_ptr()) % 16 + off :].as_strided((CRC_DIFFERENTIAL, width), (stride, 1))
        d_lens = rnd.ints(0, width + 1, CRC_DIFFERENTIAL)
        d_lens[:7] = [0, 1, 15, 16, 17, 65535, 65536]
        got_d = crc32c.masked_crc32c_chunks(view, torch.from_numpy(d_lens.astype(np.int32)).to(dev))
        host_rows = view.cpu().numpy()
        for r, (n, g) in enumerate(zip(d_lens.tolist(), got_d.cpu().numpy().tolist())):
            if g != host_codec.masked_crc32c(host_rows[r, :n]):
                crc_bad.append((off, r, n))
        crc_rows += CRC_DIFFERENTIAL
    payload_d = torch.from_numpy(np.frombuffer(payload, dtype=np.uint8).copy()).to(dev)
    long_lens = [65537, 131075, (1 << 20) + 7, (8 << 20) + 5, len(payload)]
    for n in long_lens:
        for off in (0, 3):
            m = min(n, len(payload) - off)
            g = crc32c.masked_crc32c_chunks(payload_d[off : off + m].view(1, m),
                                            torch.tensor([m], dtype=torch.int32, device=dev))
            if int(g[0]) != host_codec.masked_crc32c(payload[off : off + m]):
                crc_bad.append((off, None, m))
            crc_rows += 1
    print(f"kernels: CRC differential: crc32c equals the host C CRC on {crc_rows} rows "
          f"({16 * CRC_DIFFERENTIAL} of 0-65536 bytes at start offsets 0-15, and payload prefixes "
          f"of {long_lens[0]} to {len(payload)} bytes as single rows at offsets 0 and 3): "
          f"{len(crc_bad)} mismatches {crc_bad[:8]} (tolerance: exact)")
    assert not crc_bad, ("CRC differential", crc_bad[:8])
    mid = (1 << 20) + 7  # K1 on one row of several tiles against its plain version
    mid_row = payload_d[3 : 3 + mid].view(1, mid)
    mid_len = torch.tensor([mid], dtype=torch.int32, device=dev)
    mid_row_h, mid_len_h = mid_row.cpu(), mid_len.cpu()
    got = crc32c.masked_crc32c_chunks(mid_row, mid_len).cpu()
    want = crc32c._crc32c_plain(mid_row_h, mid_len_h)
    err["crc32c_long"] = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    assert torch.equal(got, want), ("crc32c on one row of several tiles", got, want)

    streams = {}
    for name, level in (("encode_blocks", 1), ("encode_blocks_l2", 2)):
        enc, elen = encode_blocks.encode_blocks(frames, lens, level)
        enc, elen = enc.cpu(), elen.cpu()
        penc, pelen = encode_blocks._encode_blocks_plain(frames_h, lens_h, level)
        assert torch.equal(elen, pelen), (name, "lengths", elen, pelen)
        e_err = 0
        for k, n in enumerate(elen.tolist()):
            d = (enc[k, :n].to(torch.int32) - penc[k, :n].to(torch.int32)).abs()
            e_err = max(e_err, int(d.max()) if n else 0)
        err[name] = e_err
        assert e_err == 0, f"{name} bytes differ from the plain version"
        streams[level] = [enc[k, :n].numpy().tobytes() for k, n in enumerate(elen.tolist())]
    assert sum(map(len, streams[2])) < sum(map(len, streams[1])), "level 2 is not denser"
    streams = streams[1]

    cases = [(s, len(b)) for s, b in zip(streams, blocks)]
    cases += payloads.malformed_chunks()
    for s, n in zip(streams, (len(b) for b in blocks)):
        if s:
            cases += [(s[:cut], n) for cut in (1, len(s) // 3, len(s) // 2, len(s) - 1)]
    comp, offsets = ragged([c for c, _ in cases])
    declared = torch.tensor([n for _, n in cases], dtype=torch.int32)
    chunk_cases = (comp, offsets, declared)  # for phase 11
    out = torch.empty((len(cases), 65536), dtype=torch.uint8, device=dev)
    ok, written = decode_chunks.decode_chunks(comp.to(dev), offsets.to(dev), declared.to(dev), out)
    pout = torch.empty((len(cases), 65536), dtype=torch.uint8)
    pok, pwritten = decode_chunks._decode_chunks_plain(comp, offsets, declared, pout)
    ok, written, out = ok.cpu(), written.cpu(), out.cpu()
    assert torch.equal(ok, pok) and torch.equal(written, pwritten), "decode_chunks verdicts"
    err["decode_chunks"] = int((out.to(torch.int32) - pout.to(torch.int32)).abs().max())
    assert err["decode_chunks"] == 0, "decode_chunks bytes differ from the plain version"
    for k, b in enumerate(blocks):
        assert bool(ok[k]) and out[k, : len(b)].numpy().tobytes() == b, ("roundtrip", k)
    assert not bool(ok[len(blocks):].any()), "a malformed or truncated stream decoded"

    big_cases = payloads.big_window_cases()
    bw_comp, bw_offs = ragged([c for c, _ in big_cases])
    bw_decl = torch.tensor([n for _, n in big_cases], dtype=torch.int32)
    BIG = decode_chunks.MAX_OUT
    out = torch.empty((len(big_cases), BIG), dtype=torch.uint8, device=dev)
    ok, written = decode_chunks.decode_chunks(bw_comp.to(dev), bw_offs.to(dev), bw_decl.to(dev), out)
    bw_pout = torch.empty((len(big_cases), BIG), dtype=torch.uint8)
    pok, pwritten = decode_chunks._decode_chunks_plain(bw_comp, bw_offs, bw_decl, bw_pout)
    ok, written, out = ok.cpu(), written.cpu(), out.cpu()
    assert torch.equal(ok, pok) and torch.equal(written, pwritten), "decode_chunks_big verdicts"
    err["decode_chunks_big"] = int((out.to(torch.int32) - bw_pout.to(torch.int32)).abs().max())
    assert err["decode_chunks_big"] == 0, "decode_chunks_big bytes differ from the plain version"
    assert bool(ok[:3].all()) and not bool(ok[3]), "big-window verdicts"

    st_cases = payloads.stream_cases()
    win_cases = payloads.window_cases()
    st_dev = []  # (comp, declared, out, in_offs or None) on the card, per case
    st_redecoded = []  # windows pass 2 decoded per case (None: the walk)
    s_err = 0
    for body, m, case_payload in st_cases + win_cases:
        comp_d = torch.from_numpy(np.frombuffer(body, dtype=np.uint8).copy()).to(dev)
        out_d = torch.zeros(max(m, 1), dtype=torch.uint8, device=dev)
        offs = decode_stream.window_index(body, m) if m > 0 else None
        offs_d = None if offs is None else offs.to(dev)
        status4 = torch.empty(4, dtype=torch.int64, device=dev)
        before = routes()
        decode_stream.decode_stream(comp_d, m, out_d, offs_d, status4)
        status4 = status4.cpu().tolist()
        walked = routes()[1] - before[1]
        assert walked == (offs is None) and routes()[0] - before[0] == (offs is not None), \
            ("decode_stream route", len(body), m, routes(), before)
        status = status4[:3]
        st_redecoded.append(None if offs is None else status4[3])
        pout_s = torch.zeros(max(m, 1), dtype=torch.uint8)
        pstatus = decode_stream._decode_stream_plain(torch.from_numpy(np.frombuffer(body, dtype=np.uint8).copy()), m, pout_s).tolist()
        assert status == pstatus, ("decode_stream status", len(body), m, status, pstatus)
        w = status[1]
        d = (out_d[:w].cpu().to(torch.int32) - pout_s[:w].to(torch.int32)).abs()
        s_err = max(s_err, int(d.max()) if w else 0)
        if case_payload is not None:
            assert status == [1, m, len(body)] and out_d[:m].cpu().numpy().tobytes() == case_payload
        st_dev.append((comp_d, m, out_d, offs_d))
    err["decode_stream"] = s_err
    assert s_err == 0, "decode_stream bytes differ from the plain version"
    # window_cases: 3 block-encoded streams, one deferred window, a chain of
    # three, ten mutants and a literal across a boundary (no index)
    w_red = st_redecoded[len(st_cases):]
    assert w_red[:3] == [0, 0, 0] and w_red[3] >= 1 and w_red[4] == 3 and w_red[15] is None, w_red
    assert all(r is not None for r in w_red[5:15]), w_red
    n_win = sum(r is not None for r in st_redecoded)

    # K5 on both of its routes: pass 2 alone (no index), and K2 over the
    # windows then pass 2 where the host index builds; the forced-index cases
    # on the indices that payloads gives them
    sw_cases = payloads.scan_window_cases()
    sc_cases = [(b, m) for b, m, _ in st_cases + payloads.scan_edge_cases() + win_cases
                + payloads.scan_differential_cases() + sw_cases]
    forced = payloads.scan_forced_index_cases()
    sc_dev = []  # (comp on the card, comp on the host, declared, out, index on the card, on the host)
    sc_err, verdicts, sc_walked = 0, set(), []
    for i, (body, m) in enumerate(sc_cases + [(b, m) for b, m, _ in forced]):
        comp_h = torch.from_numpy(np.frombuffer(body, dtype=np.uint8).copy())
        comp_d = comp_h.to(dev)
        pout = torch.zeros(max(m, 1), dtype=torch.uint8)
        pstate, pwr = decode_stream.decode_stream_scan(comp_h, m, pout)
        w = int(pstate[decode_stream.S_WRITTEN])
        offs = decode_stream.window_index(body, m) if m > 0 else None
        if i >= len(sc_cases):
            offs = torch.from_numpy(forced[i - len(sc_cases)][2])
        walked = []
        for offs_h in (None, offs) if offs is not None else (None,):
            nwin = 0 if offs_h is None else offs_h.shape[0] - 1
            offs_d = None if offs_h is None else offs_h.to(dev)
            out_d = torch.zeros(max(m, nwin * 65536, 1), dtype=torch.uint8, device=dev)
            state_d = torch.empty(decode_stream.STATE_WORDS + 1, dtype=torch.int64, device=dev)
            before = telemetry.counter("k5.launches_windows")
            state, wr = decode_stream.decode_stream_scan(
                comp_d, m, out_d, offs_d, state_d, None if offs_h is None else offs_h.numpy())
            assert telemetry.counter("k5.launches_windows") - before == (offs_h is not None), "K5 route"
            assert torch.equal(state.cpu(), pstate) and torch.equal(wr.cpu(), pwr), \
                ("decode_stream_scan state", len(body), m, nwin, state.cpu().tolist(), pstate.tolist())
            d = (out_d[:w].cpu().to(torch.int32) - pout[:w].to(torch.int32)).abs()
            sc_err = max(sc_err, int(d.max()) if w else 0)
            walked.append(int(state_d[decode_stream.S_WALKED]))
        ok, _, unsup, _, _ = decode_stream.scan_status(pstate.tolist(), len(body), m)
        verdicts.add("ok" if ok else "unsupported" if unsup else "invalid")
        sc_walked.append(walked)
        if i < len(sc_cases):
            sc_dev.append((comp_d, comp_h, m, out_d, offs_d, None if offs is None else offs.numpy()))
    err["decode_stream_scan"] = sc_err
    assert sc_err == 0, "decode_stream_scan bytes differ from the plain version"
    assert verdicts == {"ok", "invalid", "unsupported"}, verdicts
    # walked steps on the window route: none for the block-encoded window
    # cases, every step of the ragged stream, one to three for the streams
    # whose windows copy from the window before or stop at the MARGIN; of
    # the forced indices, none for the declared-long case, three where a
    # copy is pending at a window's start, two where the first window does
    # not start at input 0
    sw_walked = sc_walked[len(sc_cases) - len(sw_cases) : len(sc_cases)]
    w_walked = sc_walked[len(st_cases) + 6 : len(st_cases) + 6 + len(win_cases)]
    assert [w[1] for w in w_walked[:3]] == [0, 0, 0], w_walked
    assert sw_walked[0][1] == sw_walked[0][0] > 4, sw_walked
    assert [w[1] for w in sw_walked[1:7]] == [1, 1, 1, 2, 3, 3], sw_walked
    assert [w[1] for w in sc_walked[len(sc_cases):]] == [0, 3, 2], sc_walked[len(sc_cases):]
    n_sc_win = sum(len(w) == 2 for w in sc_walked)
    got = crc32c_mma.masked_crc32c_chunks_fused(frames, lens).cpu()
    want = crc32c_mma._crc32c_mma_plain(frames_h, lens_h)
    err["crc32c_mma"] = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    assert torch.equal(got, want), ("crc32c_mma", got, want)
    # K6 against the host C CRC: batches of seeded rows at the counts around
    # its persistent grid (CTAs per SM x SMs), then the kernel's edge lengths
    pool_h = payloads.Rand(29).bytes(max(MMA_SWEEP) * 65536).reshape(-1, 65536)
    pool = torch.from_numpy(pool_h).to(dev)
    col = torch.arange(65536, device=dev)
    rnd = payloads.Rand(31)
    sweep = [(n_sw, rnd.ints(0, 65537, n_sw)) for n_sw in MMA_SWEEP]
    for n_sw, sw_lens in sweep:
        sw_lens[rnd.ints(0, 4, n_sw) == 0] = 65536  # a quarter full chunks
    sweep.append((len(MMA_EDGES), np.array(MMA_EDGES, dtype=np.int64)))
    for n_sw, sw_lens in sweep:
        sw_lens_d = torch.from_numpy(sw_lens.astype(np.int32)).to(dev)
        rows_sw = pool[:n_sw].masked_fill(col >= sw_lens_d[:, None], 0)
        got_sw = crc32c_mma.masked_crc32c_chunks_fused(rows_sw, sw_lens_d).cpu().numpy().tolist()
        want_sw = [host_codec.masked_crc32c(pool_h[k, :n]) for k, n in enumerate(sw_lens.tolist())]
        bad = [k for k in range(n_sw) if got_sw[k] != want_sw[k]]
        assert not bad, ("crc32c_mma against the host C CRC", n_sw, [(k, int(sw_lens[k])) for k in bad[:8]])
    del pool, rows_sw
    print(f"kernels: crc32c_mma equals the host C CRC on {sum(len(l) for _, l in sweep)} seeded rows: "
          f"batches of N = {', '.join(str(n_sw) for n_sw in MMA_SWEEP)} with lengths 0-65,536, and "
          f"the edge lengths {MMA_EDGES} (tolerance: exact)")
    diff_blocks = payloads.encoder_blocks(ENCODER_DIFFERENTIAL)
    d_rows, d_lens = block_batch(diff_blocks, dev)
    diff_want = {}  # level -> the host C encoder's bytes of each block
    for level in (1, 2):
        enc, elen = encode_blocks.encode_blocks(d_rows, d_lens, level)
        enc, elen = enc.cpu().numpy(), elen.cpu().tolist()
        diff_want[level] = [host_codec.encode_block(b, level) for b in diff_blocks]
        for k, (b, want_b) in enumerate(zip(diff_blocks, diff_want[level])):
            assert enc[k, : elen[k]].tobytes() == want_b, \
                ("encoder differential", level, k, len(b), elen[k], len(want_b))
    print(f"kernels: encoder differential: encode_blocks at levels 1 and 2 equals the host C "
          f"encoder on {len(diff_blocks)} blocks of {sum(map(len, diff_blocks))} bytes "
          f"(tolerance: exact)")
    # K3's persistent grid: leading slices of the differential's blocks
    # across its walker and grid edges, a ragged batch, and two launches
    # back to back on one stream (the second finds its queue zeroed)
    rag_pool = payloads.mixed_payload(len(K3_RAGGED) * 65536, seed=71)
    rag_blocks = [rag_pool[k * 65536 : k * 65536 + m] for k, m in enumerate(K3_RAGGED)]
    r_rows, r_lens = block_batch(rag_blocks, dev)
    limits = encode_blocks.card_limits(dev)
    k3_walkers = {}  # (level, batch) -> walkers a launch
    for level in (1, 2):
        ways = 2 if level >= 2 else 1
        rag_want = [host_codec.encode_block(b, level) for b in rag_blocks]
        batches = [(f"n={n_sl}", d_rows[:n_sl], d_lens[:n_sl], diff_want[level][:n_sl]) for n_sl in K3_SLICES]
        batches.append((f"ragged n={len(rag_blocks)}", r_rows, r_lens, rag_want))
        for name, rows_b, lens_b, want in batches:
            before = [telemetry.counter(c) for c in ("k3.walkers", "k3.ordered")]
            enc, elen = encode_blocks.encode_blocks(rows_b, lens_b, level)
            walkers, ordered = (telemetry.counter(c) - b for c, b in zip(("k3.walkers", "k3.ordered"), before))
            k3_walkers[level, name] = walkers
            assert walkers == encode_blocks.launch_shape(len(want), ways, *limits)[0], \
                ("K3 walkers", level, name, walkers, limits)
            assert ordered == (len(want) > walkers), ("K3 order", level, name, ordered, walkers)
            enc, elen = enc.cpu().numpy(), elen.cpu().tolist()
            bad = [k for k, w in enumerate(want) if enc[k, : elen[k]].tobytes() != w]
            assert not bad, ("K3 persistent grid", level, name, bad[:8])
        pair = ((d_rows, d_lens, diff_want[level]), (r_rows, r_lens, rag_want))
        outs = [(torch.empty((len(w), encode_blocks.ENC_CAP), dtype=torch.uint8, device=dev),
                 torch.full((len(w),), -1, dtype=torch.int32, device=dev)) for _, _, w in pair]
        for (rows_b, lens_b, _), (enc, elen) in zip(pair, outs):
            encode_blocks._launch(rows_b, lens_b, enc, elen, ways)  # no synchronise between them
        torch.cuda.synchronize(dev)
        for (_, _, want), (enc, elen) in zip(pair, outs):
            enc, elen = enc.cpu().numpy(), elen.cpu().tolist()
            bad = [k for k, w in enumerate(want) if enc[k, : elen[k]].tobytes() != w]
            assert not bad, ("K3 back to back", level, len(want), bad[:8])
        del outs
    del d_rows, d_lens, r_rows, r_lens
    print(f"kernels: K3's persistent grid equals the host C encoder at levels 1 and 2 on the "
          f"differential's first {', '.join(map(str, K3_SLICES))} blocks, a ragged batch of "
          f"{len(rag_blocks)} rows of 65,536, 856, 16 and 0 bytes, and two launches back to back "
          f"without a synchronise ({len(diff_blocks)} blocks, then the ragged batch), the rows "
          f"costliest first where they outnumber the walkers; walkers a "
          f"launch (card: {limits[0]:,} bytes of opt-in shared memory a CTA, {limits[1]} SMs): "
          + "; ".join(f"level {lv} " + ", ".join(f"{nm} {w}" for (lk, nm), w in k3_walkers.items() if lk == lv)
                      for lv in (1, 2)) + " (tolerance: exact)")

    mutated = payloads.mutation_streams(DECODER_DIFFERENTIAL)
    m_streams = [m for m, _ in mutated]
    m_want = [payloads.host_raw_decode(m) for m in m_streams]
    divergences = collections.Counter()  # (route, what differs, mutation kind)

    def k2_and_k4():
        return tuple(telemetry.counter(c) for c in ("k2.launches", "k2.launches_big", "k4.launches"))

    before = k2_and_k4()
    m_batch = engine.raw_uncompress_batch(m_streams, device=dev)
    m_routed = tuple(a - b for a, b in zip(k2_and_k4(), before))
    for (got_m, _), want_m, (_, kind) in zip(m_batch, m_want, mutated):
        if got_m != want_m:
            what = "verdict" if (got_m is None) != (want_m is None) else "bytes"
            divergences["raw_uncompress_batch", what, kind] += 1
    m_direct = {}
    for width in (decode_chunks.CHUNK, decode_chunks.MAX_OUT):
        rows = []  # (body, declared, mutation kind) of the streams that fit W
        for m, kind in mutated:
            m_decl, read = varint.decode_uint32(m)
            if m_decl is not None and m_decl <= width:
                rows.append((m[read:], m_decl, kind))
        m_comp, m_offs = ragged([b for b, _, _ in rows])
        m_decls = torch.tensor([d for _, d, _ in rows], dtype=torch.int32)
        m_out = torch.empty((len(rows), width), dtype=torch.uint8, device=dev)
        m_ok, m_written = decode_chunks.decode_chunks(m_comp.to(dev), m_offs.to(dev), m_decls.to(dev), m_out)
        m_ok, m_written, m_out = m_ok.cpu().numpy(), m_written.cpu().numpy(), m_out.cpu().numpy()
        # the plain version on the same rows: written and the whole row,
        # the bytes before the first bad tag and the zeros after them
        p_out = torch.empty((len(rows), width), dtype=torch.uint8)
        p_ok, p_written = decode_chunks._decode_chunks_plain(m_comp, m_offs, m_decls, p_out)
        p_ok, p_written, p_out = p_ok.numpy(), p_written.numpy(), p_out.numpy()
        for r, (body, m_decl, kind) in enumerate(rows):
            host_m, host_written = host_codec.decode_tags(body, m_decl)
            host_ok = host_m is not None and host_written == m_decl
            route = f"decode_chunks W={width}"
            if bool(m_ok[r]) != host_ok or bool(m_ok[r]) != bool(p_ok[r]):
                divergences[route, "verdict", kind] += 1
            elif host_ok and m_out[r, :m_decl].tobytes() != host_m:
                divergences[route, "bytes", kind] += 1
            elif m_written[r] != p_written[r]:
                divergences[route, "written", kind] += 1
            elif not np.array_equal(m_out[r], p_out[r]):
                divergences[route, "row", kind] += 1
        m_direct[width] = (len(rows), int(m_ok.sum()))
        del m_out, p_out
    kinds = collections.Counter(kind for _, kind in mutated)
    print(f"kernels: decoder differential: {len(mutated)} seeded raw streams of "
          f"{sum(map(len, m_streams))} bytes ({kinds.pop('valid')} valid, "
          f"{sum(kinds.values())} mutants: " + ", ".join(f"{n} {k}" for k, n in sorted(kinds.items()))
          + f"; {sum(w is not None for w in m_want)} valid by the host C decoder) through "
          f"engine.raw_uncompress_batch (launches of decode_chunks, decode_chunks_big, "
          f"decode_stream: {m_routed}) and decode_chunks directly (streams, of them valid: "
          f"{m_direct[decode_chunks.CHUNK]} at W={decode_chunks.CHUNK}, "
          f"{m_direct[decode_chunks.MAX_OUT]} at W={decode_chunks.MAX_OUT}), against the host C "
          f"decoder, and decode_chunks' written counts and whole rows against its plain version: "
          f"{sum(divergences.values())} divergences {dict(divergences)} (tolerance: exact)")
    assert not divergences, ("decoder differential", dict(divergences))
    assert m_routed[0] > 0 and m_routed[1] > 0 and m_routed[2] > 0, ("decoder differential routes", m_routed)
    print(f"kernels: crc32c, crc32c_mma, encode_blocks (levels 1 and 2), decode_chunks equal "
          f"their plain versions on {len(blocks)} blocks and {len(cases) - len(blocks)} "
          f"malformed/truncated streams; decode_chunks at W={BIG} on {len(big_cases)} big-window "
          f"cases; decode_stream on {len(st_dev)} stream and window cases ({n_win} on the window "
          f"route, {sum(r or 0 for r in st_redecoded)} windows decoded again by its ordered pass, "
          f"{len(st_dev) - n_win} on the whole-stream walk) and decode_stream_scan on "
          f"{len(sc_cases) + len(forced)} stream cases without an index and {n_sc_win} on the window route "
          f"(steps walked by pass 2, without / with the index: {sc_walked}; verdicts "
          f"{sorted(verdicts)}) (tolerance: exact)")

    # 4. framed main path ----------------------------------------------------
    reset_counts()
    stream = api.encode_framed(payload, device=dev)
    decoded = api.decode_framed(stream, device=dev)
    framed_launches = counts()
    digest = hashlib.sha256(stream).hexdigest()
    assert digest == payloads.GOLDEN_SHA256, ("digest", digest)
    assert decoded == payload, "decode_framed did not return the payload"
    print(f"framed: {len(payload)} bytes -> {len(stream)} framed bytes, sha256 {digest} "
          f"equals the pinned JAX digest; decodes back to the payload")

    chunks = framing.scan_frames(stream, len(C.FRAMING_HEADER))
    data_chunks = [c for c in chunks if c.id in (C.CHUNK_COMPRESSED, C.CHUNK_UNCOMPRESSED)]
    a, b = data_chunks[5], data_chunks[9]
    assert a.id == b.id == C.CHUNK_COMPRESSED, "frames 5 and 9 must be compressed"

    def corrupt(s: bytes, bad_crc, bad_tags) -> bytes:
        s = bytearray(s)
        if bad_crc is not None:
            s[bad_crc.data_pos] ^= 0x55
        if bad_tags is not None:
            _, read = varint.decode_uint32(
                s[bad_tags.data_pos + 4 : bad_tags.data_pos + 9])
            p = bad_tags.data_pos + 4 + read
            s[p : p + 2] = b"\x01\xff"  # a copy before any output: invalid
        return bytes(s)

    _, reason = engine.framed_uncompress(corrupt(stream, a, b), device=dev)
    assert reason == "crc", ("bad crc in frame 5, bad tags in frame 9", reason)
    _, reason = engine.framed_uncompress(corrupt(stream, b, a), device=dev)
    assert reason == "invalid", ("bad tags in frame 5, bad crc in frame 9", reason)
    bad = corrupt(stream, a, None)
    assert api.decode_framed(bad, device=dev) == b""
    assert api.decode_framed(bad, check_integrity=False, device=dev) == payload
    print("framed: error order ok (crc@5 + invalid@9 -> crc; invalid@5 + crc@9 -> "
          "invalid); check_integrity=False accepts the bad CRC")

    # 5. raw main path -------------------------------------------------------
    captured = {}

    def encode_batch_on_card(ps):
        captured["in"], captured["out"] = ps, api.encode_batch(ps, device=dev)
        return captured["out"]

    reset_counts()
    raw1 = api.encode(payload, level=1, device=dev)
    raw2 = api.encode(payload, level=2, device=dev)
    before = routes()
    raw_decoded = api.decode(raw1, device=dev)
    decode_route = tuple(a - b for a, b in zip(routes(), before))
    serving, expect = payloads.serving_batch(encode_batch_on_card)
    batch_out = api.decode_batch(serving, device=dev)
    one_mb = payload[: 1 << 20]
    into = bytearray(C.max_compressed_len(len(one_mb)))
    res_c = api.compress_into(one_mb, into, device=dev)
    back = bytearray(len(one_mb))
    res_u = api.uncompress_into(bytes(into[: res_c.value]), back, device=dev)
    framed2 = api.encode_framed(payload, level=2, device=dev)
    framed2_back = api.decode_framed(framed2, device=dev)
    raw_launches = counts()

    for name, s, pinned in (("raw L1", raw1, payloads.RAW_L1_SHA256),
                            ("raw L2", raw2, payloads.RAW_L2_SHA256),
                            ("framed L2", framed2, payloads.FRAMED_L2_SHA256)):
        d = hashlib.sha256(s).hexdigest()
        assert d == pinned, (name, d)
        print(f"raw: {name} {len(payload)} bytes -> {len(s)} bytes, sha256 {d} equals the pinned JAX digest")
    assert raw_decoded == payload, "decode did not return the payload"
    assert decode_route == (1, 0, 0), \
        ("decode of the 48 MiB stream: (window route, walk, windows decoded again)", decode_route)
    assert framed2_back == payload, "decode_framed of the level-2 stream"
    per_payload = [api.encode(p, device=dev) for p in captured["in"]]
    assert captured["out"] == per_payload, "encode_batch differs from per-payload encode"
    plain_batch = api.decode_batch(serving, device="cpu")
    assert batch_out == plain_batch, "decode_batch differs from its plain versions"
    assert batch_out == [e if e is not None else b"" for e in expect], "decode_batch payloads"
    assert res_c.is_ok() and bytes(into[: res_c.value]) == api.encode(one_mb, device=dev)
    assert res_u.is_ok() and res_u.value == len(one_mb) and bytes(back) == one_mb
    n_bad = sum(e is None for e in expect)
    print(f"raw: decode of the level-1 stream returns the payload (window route launches, walk "
          f"launches, windows decoded again: {decode_route}); encode_batch of "
          f"{len(captured['in'])} payloads equals per-payload encode; decode_batch of "
          f"{len(serving)} streams ({len(serving) - n_bad} valid, {n_bad} malformed, "
          f"{sum(map(len, serving))} bytes) equals the plain versions; compress_into / "
          f"uncompress_into of 1 MiB round-trip; framed L2 decodes back")

    # 6. the stream layer ----------------------------------------------------
    def run_pipe(feed: bytes, coro_factory) -> bytes:
        async def run():
            reader = asyncio.StreamReader()
            reader.feed_data(feed)
            reader.feed_eof()
            sink = bytearray()

            class Sink:
                def write(self, data):
                    sink.extend(data)

                async def drain(self):
                    await asyncio.sleep(0)

            await coro_factory(reader, Sink())
            return bytes(sink)

        return asyncio.run(run())

    def resume_into(data: bytes, size: int):
        """uncompress_framed_into through buffers of ``size`` bytes,
        re-entered with data[read:] until the input is used up."""
        steps, parts, first = [], [], True
        while data:
            buf = bytearray(size)
            res = api.uncompress_framed_into(data, buf, first, device=dev)
            assert res.is_ok(), ("uncompress_framed_into", size, res)
            read, written = res.value
            assert read and written <= size, (read, written, size)
            steps.append((read, written))
            parts.append(bytes(buf[:written]))
            data, first = data[read:], False
        return steps, b"".join(parts)

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    far_body, far_m, far_payload = payloads.scan_edge_cases()[1]
    reset_counts()
    before = scan_routes()
    scan_raw = decode_stream.decode_raw_stream_bytes(payloads.body_of(raw1), len(payload), mode="scan",
                                                     device=dev)
    scan_raw_route = tuple(a - b for a, b in zip(scan_routes(), before))
    dst = io.BytesIO()
    sync.compress_framed(io.BytesIO(payload), dst, device=dev)
    sync_framed = dst.getvalue()
    dst = io.BytesIO()
    sync.compress(io.BytesIO(payload), len(payload), dst, device=dev)
    sync_raw = dst.getvalue()
    dst = io.BytesIO()
    sync.uncompress_framed(io.BytesIO(sync_framed), dst, device=dev)
    sync_back = dst.getvalue()
    aio_framed = run_pipe(payload, lambda r, w: aio.compress_framed(r, w, device=dev))
    aio_raw = run_pipe(payload, lambda r, w: aio.compress(r, len(payload), w, device=dev))
    aio_back = run_pipe(stream, lambda r, w: aio.uncompress_framed(r, w, device=dev))
    into = {size: resume_into(stream, size) for size in (1 << 20, 8 << 20)}
    vectors = []
    for name, data, budget, check_integrity, expected in payloads.framed_vectors():
        res = api.uncompress_framed_into(data, bytearray(budget), True, check_integrity, device=dev)
        got_v = ("ok",) + tuple(res.value) if res.is_ok() else ("err", res.error.name)
        vectors.append((name, got_v, expected))
    cli_out = {}
    with tempfile.TemporaryDirectory() as td:
        def path(name):
            return os.path.join(td, name)

        with open(path("payload"), "wb") as f:
            f.write(payload)
        for level in (1, 2):
            assert cli.main(["-l", str(level), "-o", path(f"l{level}.sz"), path("payload")]) == 0
            assert cli.main(["-d", "-o", path(f"l{level}.out"), path(f"l{level}.sz")]) == 0
        with open(path("raw.rawsz"), "wb") as f:
            f.write(sync_raw)
        with open(path("far.rawsz"), "wb") as f:
            f.write(varint.encode_uint32(far_m) + far_body)
        cli_launches = {}
        with stream_mode("scan"):
            for name in ("raw", "far"):
                before = scan_routes()
                assert cli.main(["-d", "--raw", "-o", path(f"{name}.out"), path(f"{name}.rawsz")]) == 0
                cli_launches[name] = tuple(a - b for a, b in zip(scan_routes(), before))
        for name in ("l1.sz", "l1.out", "l2.sz", "l2.out", "raw.out", "far.out"):
            with open(path(name), "rb") as f:
                cli_out[name] = f.read()
    stream_launches = counts()
    stream_scan = scan_routes()

    for name, got_s, pinned in (("sync compress_framed", sync_framed, payloads.GOLDEN_SHA256),
                                ("aio compress_framed", aio_framed, payloads.GOLDEN_SHA256),
                                ("sync compress", sync_raw, payloads.RAW_L1_SHA256),
                                ("aio compress", aio_raw, payloads.RAW_L1_SHA256),
                                ("cli -l 1", cli_out["l1.sz"], payloads.GOLDEN_SHA256),
                                ("cli -l 2", cli_out["l2.sz"], payloads.FRAMED_L2_SHA256)):
        assert sha(got_s) == pinned, (name, sha(got_s))
    for name, back in (("sync uncompress_framed", sync_back), ("aio uncompress_framed", aio_back),
                       ("cli -d (L1)", cli_out["l1.out"]), ("cli -d (L2)", cli_out["l2.out"]),
                       ("cli -d --raw (scan mode)", cli_out["raw.out"])):
        assert back == payload, f"{name} did not return the payload"
    assert cli_out["far.out"] == far_payload, "cli -d --raw of the far-copy stream"
    for size, (steps, back) in into.items():
        assert back == payload, ("uncompress_framed_into re-entry", size)
        assert sum(r for r, _ in steps) == len(stream) and len(steps) >= len(payload) // size
    for name, got_v, expected in vectors:
        assert got_v[: len(expected)] == expected, (name, got_v, expected)
    # the 48 MiB level-1 stream in scan mode: K2 over its windows and one
    # pass-2 launch, no step walked; the far-copy stream has no index (one
    # literal over the boundaries): pass 2 alone walks it, then K4's walk
    assert scan_raw == (payload, "ok"), "decode_raw_stream_bytes in scan mode"
    assert scan_raw_route == (1, 1, 0, 0, 0), ("scan-mode decode of the 48 MiB stream", scan_raw_route)
    assert cli_launches["raw"] == (1, 1, 0, 0, 0), cli_launches
    assert cli_launches["far"][:4] == (1, 0, 1, 0) and cli_launches["far"][4] > 0, cli_launches
    print(f"streams: sync and aio compress_framed / compress of the payload equal the pinned "
          f"framed-L1 / raw-L1 digests and uncompress_framed returns the payload; "
          f"uncompress_framed_into re-entered {len(into[1 << 20][0])} times through 1 MiB and "
          f"{len(into[8 << 20][0])} through 8 MiB buffers returns the payload; {len(vectors)} "
          f"framed vectors give their pinned results; cli framed L1 / L2 round trips match the "
          f"digests; decode_raw_stream_bytes in scan mode returns the payload (K5 pass-2 launches, "
          f"K5 pass-1 launches of K2, K4 walks, K4 window routes, steps walked by pass 2: "
          f"{scan_raw_route}); cli -d --raw in scan mode {cli_launches['raw']}, and on a far-copy "
          f"stream {cli_launches['far']}")

    # 6b. the host backend ---------------------------------------------------
    # The same entry points with the backend set to host: the native C
    # runtime on this machine's cores, no kernel.
    payload_crc = host_codec.masked_crc32c(payload)
    config.set_backend("host")
    reset_counts()
    try:
        host_framed = {level: api.encode_framed(payload, level=level) for level in (1, 2)}
        host_raw = {level: api.encode(payload, level=level) for level in (1, 2)}
        host_framed_back = api.decode_framed(host_framed[1])
        host_raw_back = api.decode(host_raw[1])
        host_batch = api.decode_batch(serving)
        host_into = {size: resume_into(stream, size) for size in (1 << 20, 8 << 20)}
        host_vectors = []
        for name, data, budget, check_integrity, expected in payloads.framed_vectors():
            res = api.uncompress_framed_into(data, bytearray(budget), True, check_integrity)
            host_vectors.append((name, ("ok",) + tuple(res.value) if res.is_ok() else
                                 ("err", res.error.name), expected))
        dst = io.BytesIO()
        sync.compress_framed(io.BytesIO(payload), dst)
        host_sync = {"sync compress_framed": dst.getvalue()}
        dst = io.BytesIO()
        sync.compress(io.BytesIO(payload), len(payload), dst)
        host_sync["sync compress"] = dst.getvalue()
        dst = io.BytesIO()
        sync.uncompress_framed(io.BytesIO(stream), dst)
        host_sync_back = dst.getvalue()
        host_aio = {"aio compress_framed": run_pipe(payload, aio.compress_framed),
                    "aio compress": run_pipe(payload, lambda r, w: aio.compress(r, len(payload), w))}
        host_aio_back = run_pipe(stream, aio.uncompress_framed)
        host_crc = engine.masked_crc32c(payload)
    finally:
        config.set_backend("device")
    host_launches = counts()
    host_routes = routes() + scan_routes()

    for name, got_s, pinned in (("encode_framed L1", host_framed[1], payloads.GOLDEN_SHA256),
                                ("encode_framed L2", host_framed[2], payloads.FRAMED_L2_SHA256),
                                ("encode L1", host_raw[1], payloads.RAW_L1_SHA256),
                                ("encode L2", host_raw[2], payloads.RAW_L2_SHA256),
                                ("sync compress_framed", host_sync["sync compress_framed"],
                                 payloads.GOLDEN_SHA256),
                                ("aio compress_framed", host_aio["aio compress_framed"],
                                 payloads.GOLDEN_SHA256),
                                ("sync compress", host_sync["sync compress"], payloads.RAW_L1_SHA256),
                                ("aio compress", host_aio["aio compress"], payloads.RAW_L1_SHA256)):
        assert sha(got_s) == pinned, ("host backend", name, sha(got_s))
        print(f"host: {name} {len(payload)} bytes -> {len(got_s)} bytes, sha256 {sha(got_s)} "
              f"equals the pinned JAX digest")
    for name, back in (("decode_framed", host_framed_back), ("decode", host_raw_back),
                       ("sync uncompress_framed", host_sync_back), ("aio uncompress_framed", host_aio_back)):
        assert back == payload, f"host backend: {name} did not return the payload"
    assert host_batch == batch_out, "host backend: decode_batch differs from the device backend's"
    for size, (steps, back) in host_into.items():
        assert back == payload and steps == into[size][0], ("host backend: uncompress_framed_into", size)
    for name, got_v, expected in host_vectors:
        assert got_v[: len(expected)] == expected, ("host backend", name, got_v, expected)
    assert host_crc == payload_crc, ("host backend: masked_crc32c", host_crc, payload_crc)
    assert not any(host_launches.values()) and not any(host_routes), \
        ("the host backend launched a kernel", host_launches, host_routes)
    print(f"host: decode_framed, decode and the sync and aio uncompress_framed return the payload; "
          f"decode_batch of {len(serving)} streams equals the device backend's; "
          f"uncompress_framed_into through 1 MiB and 8 MiB buffers gives the device backend's "
          f"(read, written) steps ({len(host_into[1 << 20][0])} and {len(host_into[8 << 20][0])}) and "
          f"the payload; {len(host_vectors)} framed vectors give their pinned results; masked_crc32c "
          f"equals the host C CRC; no kernel launched")

    # 7. the fused CRC --------------------------------------------------------
    all_frames, all_lens = engine._split_blocks(np.frombuffer(payload, dtype=np.uint8), dev)
    reset_counts()
    fused = crc32c_mma.masked_crc32c_chunks_fused(all_frames, all_lens)
    fused_launches = counts()
    by_k1 = crc32c.masked_crc32c_chunks(all_frames, all_lens)
    assert torch.equal(fused.cpu(), by_k1.cpu()), "crc32c_mma differs from crc32c on the frames"
    print(f"fused CRC: crc32c_mma equals crc32c on the {len(all_lens)} frames of the payload")

    # the one-shot masked_crc32c of the whole payload: K1 over every SM
    reset_counts()
    one_shot = engine.masked_crc32c(payload, device=dev)
    one_shot_launches = counts()
    assert one_shot == payload_crc, ("one-shot masked_crc32c", one_shot, payload_crc)
    print(f"one-shot CRC: masked_crc32c of the {len(payload)}-byte payload equals the host C CRC")

    # 10. sharded (before 8 and 9, which count and time it) -------------------
    # (a) a one-rank nccl group on this card
    from snappy_tpu_torch.parallel import mesh as pmesh
    from snappy_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, backend="nccl",
                         timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    world1 = pmesh.default_mesh(1, device=dev)
    assert world1.group is not None and world1.collective_device == dev, "a one-rank nccl mesh"
    reset_counts()
    sh_framed = pmesh.sharded_framed_compress(payload, world1)
    sh_raw = pmesh.sharded_raw_compress(payload, world1)
    sh_back = pmesh.sharded_framed_uncompress(sh_framed, world1)
    sharded_launches = counts()
    for name, got_s, pinned in (("sharded_framed_compress", sh_framed, payloads.GOLDEN_SHA256),
                                ("sharded_raw_compress", sh_raw, payloads.RAW_L1_SHA256)):
        assert sha(got_s) == pinned, ("sharded", name, sha(got_s))
    assert sh_back == (payload, "ok"), ("sharded_framed_uncompress", sh_back[1])
    # the JAX mesh's error order: every verbatim CRC before any compressed
    # chunk, so a bad verbatim CRC after a bad compressed chunk wins there,
    # where the engine reports the earlier chunk
    later = next(k for k in range(6, len(data_chunks)) if data_chunks[k].id == C.CHUNK_UNCOMPRESSED)
    order = corrupt(stream, data_chunks[later], a)
    assert engine.framed_uncompress(order, device=dev) == (None, "invalid"), "engine order case"
    for name, s, check_integrity, want in (
            ("crc@5 + invalid@9", corrupt(stream, a, b), True, "crc"),
            ("invalid@5 + crc@9", corrupt(stream, b, a), True, "invalid"),
            (f"invalid@5 + verbatim crc@{later}", order, True, "crc"),
            ("crc@5, check_integrity=False", bad, False, "ok")):
        got_r = pmesh.sharded_framed_uncompress(s, world1, check_integrity)
        assert got_r[1] == want and (got_r[0] == payload if want == "ok" else got_r[0] is None), \
            ("sharded error order", name, got_r[1])
    blob, off, total = multihost.compress_framed_span(payload, device=dev)
    assert (C.FRAMING_HEADER + blob, off, total) == (stream, len(C.FRAMING_HEADER), len(stream)), \
        "compress_framed_span on one rank"
    assert multihost.uncompress_framed_span(stream, device=dev) == (payload, 0, len(payload), "ok"), \
        "uncompress_framed_span on one rank"
    print(f"sharded: one nccl rank on {dev}: sharded_framed_compress and sharded_raw_compress of the "
          f"payload equal the pinned framed-L1 / raw-L1 digests, sharded_framed_uncompress returns the "
          f"payload; error order (crc@5 + invalid@9 -> crc; invalid@5 + crc@9 -> invalid; invalid@5 + "
          f"verbatim crc@{later} -> crc, the JAX mesh's order, where engine.framed_uncompress says "
          f"invalid); check_integrity=False accepts the bad CRC; compress_framed_span and "
          f"uncompress_framed_span give the stream and the payload")
    # (b) two gloo ranks on this card, in spawned processes
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as td:
        ranks = run_sharded_ranks(SHARDED_WORLD, td)
    for r, res in enumerate(ranks):
        assert res["framed_sha256"] == payloads.GOLDEN_SHA256, ("rank", r, "framed", res["framed_sha256"])
        assert res["raw_sha256"] == payloads.RAW_L1_SHA256, ("rank", r, "raw", res["raw_sha256"])
        assert res["decoded"], ("rank", r, "sharded_framed_uncompress", res["reason"])
        assert res["span"][1] == ranks[0]["span"][1] and res["part_at"][2] == "ok", ("rank", r, "spans")
    offsets = [len(C.FRAMING_HEADER)] + [len(C.FRAMING_HEADER) + len(ranks[0]["blob"])]
    assert [res["span"][0] for res in ranks] == offsets, [res["span"] for res in ranks]
    spans = C.FRAMING_HEADER + b"".join(res["blob"] for res in ranks)
    assert len(spans) == ranks[0]["span"][1] and sha(spans) == payloads.GOLDEN_SHA256, \
        "the span blobs in rank order"
    joined = bytearray(len(payload))
    for res in ranks:
        out_off, total_out, _ = res["part_at"]
        assert total_out == len(payload)
        joined[out_off : out_off + len(res["part"])] = res["part"]
    assert bytes(joined) == payload, "the decoded spans at their offsets"
    print(f"sharded: {SHARDED_WORLD} gloo ranks on {dev} (compute mode {mode}), frames per rank "
          f"{[res['frames'] for res in ranks]}: every rank's sharded_framed_compress and "
          f"sharded_raw_compress equal the pinned digests and its sharded_framed_uncompress returns "
          f"the payload; the header and the compress_framed_span blobs in rank order give the pinned "
          f"framed-L1 digest, and the uncompress_framed_span parts at their offsets the payload")

    # 12. the array route (after 10, while its nccl rank is up; before 11,
    # 8 and 9) -----------------------------------------------------------------
    # SNAPPY_TPU_TORCH_DEVICE_KERNEL=xla for this phase only: the array
    # encoder and decoder (ops/encode_array.py, ops/decode_array.py) in place
    # of K2-K5, K1 for the CRCs, the JAX package's SNAPPY_TPU_DEVICE_KERNEL=xla
    t_array = time.perf_counter()
    reset_counts()
    with array_route():
        assert engine._array_route(), "SNAPPY_TPU_TORCH_DEVICE_KERNEL=xla did not select the array route"
        arr_framed = {level: api.encode_framed(payload, level=level, device=dev) for level in (1, 2)}
        arr_raw = {level: api.encode(payload, level=level, device=dev) for level in (1, 2)}
        arr_back = {"decode_framed of its L1 stream": api.decode_framed(arr_framed[1], device=dev),
                    "decode_framed of K3's L1 stream": api.decode_framed(stream, device=dev),
                    "decode of its L1 stream": api.decode(arr_raw[1], device=dev),
                    "decode of K3's L1 stream": api.decode(raw1, device=dev)}
        arr_batch = api.decode_batch(serving, device=dev)
        arr_enc_batch = api.encode_batch(captured["in"], device=dev)
        arr_per_payload = [api.encode(p, device=dev) for p in captured["in"]]
        arr_into = resume_into(stream, 8 << 20)
        dst = io.BytesIO()
        sync.compress_framed(io.BytesIO(payload), dst, device=dev)
        arr_sync = dst.getvalue()
        dst = io.BytesIO()
        sync.uncompress_framed(io.BytesIO(arr_sync), dst, device=dev)
        arr_sync_back = dst.getvalue()
        arr_order = (engine.framed_uncompress(corrupt(stream, a, b), device=dev)[1],
                     engine.framed_uncompress(corrupt(stream, b, a), device=dev)[1])
        arr_unchecked = (api.decode_framed(bad, device=dev),
                         api.decode_framed(bad, check_integrity=False, device=dev))
        arr_mutated = engine.raw_uncompress_batch(m_streams, device=dev)
        arr_sharded = {"sharded_framed_compress": pmesh.sharded_framed_compress(payload, world1),
                       "sharded_raw_compress": pmesh.sharded_raw_compress(payload, world1)}
        arr_sharded_back = pmesh.sharded_framed_uncompress(arr_sharded["sharded_framed_compress"], world1)
    array_launches = counts()
    array_routes = routes() + scan_routes()
    array_s = time.perf_counter() - t_array

    pinned_xla = {"framed": (payloads.FRAMED_XLA_LEN, payloads.FRAMED_XLA_SHA256),
                  "raw": (payloads.RAW_XLA_LEN, payloads.RAW_XLA_SHA256)}
    for name, got_s, fmt in (("encode_framed L1", arr_framed[1], "framed"),
                             ("encode_framed L2", arr_framed[2], "framed"),
                             ("encode L1", arr_raw[1], "raw"), ("encode L2", arr_raw[2], "raw"),
                             ("sync compress_framed", arr_sync, "framed"),
                             ("sharded_framed_compress", arr_sharded["sharded_framed_compress"], "framed"),
                             ("sharded_raw_compress", arr_sharded["sharded_raw_compress"], "raw")):
        assert (len(got_s), sha(got_s)) == pinned_xla[fmt], ("array route", name, len(got_s), sha(got_s))
        print(f"array: {name} {len(payload)} bytes -> {len(got_s)} bytes, sha256 {sha(got_s)} equals the "
              f"digest pinned from the JAX package's array route")
    for name, back in arr_back.items():
        assert back == payload, f"array route: {name} did not return the payload"
    assert arr_sync_back == payload, "array route: sync uncompress_framed"
    assert arr_sharded_back == (payload, "ok"), ("array route: sharded_framed_uncompress", arr_sharded_back[1])
    assert arr_batch == batch_out, "array route: decode_batch differs from the scalar route's"
    assert arr_enc_batch == arr_per_payload, "array route: encode_batch differs from per-payload encode"
    assert arr_into == into[8 << 20], "array route: uncompress_framed_into differs from the scalar route's steps"
    assert arr_order == ("crc", "invalid"), ("array route: error order", arr_order)
    assert arr_unchecked == (b"", payload), "array route: check_integrity=False"
    arr_div = collections.Counter()
    for (got_m, _), want_m, (_, kind) in zip(arr_mutated, m_want, mutated):
        if got_m != want_m:
            arr_div["verdict" if (got_m is None) != (want_m is None) else "bytes", kind] += 1
    print(f"array: decode_framed and decode of its streams and of K3's level-1 streams return the "
          f"payload (the raw decodes one whole-stream array decode each); decode_batch of "
          f"{len(serving)} streams equals the scalar route's; encode_batch of {len(captured['in'])} "
          f"payloads equals per-payload encode; uncompress_framed_into through 8 MiB buffers gives the "
          f"scalar route's {len(arr_into[0])} (read, written) steps; the sync round trip returns the "
          f"payload; error order (crc@5 + invalid@9 -> {arr_order[0]}; invalid@5 + crc@9 -> "
          f"{arr_order[1]}); check_integrity=False accepts the bad CRC; sharded_framed_uncompress on "
          f"the nccl rank returns the payload; {len(m_streams)} mutation streams through "
          f"raw_uncompress_batch against the host C decoder: {sum(arr_div.values())} divergences "
          f"{dict(arr_div)} (tolerance: exact); {array_s:.1f} s {tag}")
    assert not arr_div, ("array route: mutation streams against the host C decoder", dict(arr_div))

    # 13. google/snappy (after 12, before 11) ------------------------------------
    reset_counts()
    cpp = google_phase(dev, payload, captured["in"], tag)
    cpp_launches = counts()

    # 11. guards (after 10, before 8 and 9) ------------------------------------
    # the card's stand-in for compute-sanitizer: each kernel through its
    # wrapper's _launch, every buffer it writes inside guard bands and every
    # buffer it reads with a tail guard filled 0x00, 0xFF and at random
    from snappy_tpu_torch.testing import guards

    t_guard = time.perf_counter()
    reset_counts()
    routes_before = routes()
    guard = guards.Guard(dev)
    frames_np, lens_np = frames.cpu().numpy(), lens.cpu().numpy()
    guard.crc32c(frames_np.reshape(-1), 0, 65536, len(lens_np), 65536, lens_np, "smoke blocks")
    guard.crc32c_mma(frames_np, lens_np, "smoke blocks")
    for level in (1, 2):
        guard.encode_blocks(frames_np, lens_np, level, "smoke blocks")
    rnd = payloads.Rand(9)  # phase 3's CRC differential: the same rows
    for off in range(16):
        stride = 65536 + 16 + int(rnd.ints(0, 16, 1)[0])
        buf = rnd.bytes(CRC_DIFFERENTIAL * stride + 64)
        d_lens = rnd.ints(0, 65537, CRC_DIFFERENTIAL)
        d_lens[:7] = [0, 1, 15, 16, 17, 65535, 65536]
        guard.crc32c(buf, off, stride, CRC_DIFFERENTIAL, 65536, d_lens, f"offset {off}")
    for n in long_lens + [mid]:
        for off in (0, 3):
            m = min(n, len(payload) - off)
            guard.crc32c(payload_d[off : off + m], 0, m, 1, m, [m], f"one row of {m} at {off}")
    for n_sw, sw_lens in sweep:
        rows_sw = pool_h[:n_sw].copy()
        rows_sw[np.arange(65536)[None, :] >= sw_lens[:, None]] = 0
        guard.crc32c_mma(rows_sw, sw_lens, f"N = {n_sw}")
    del rows_sw
    diff_rows = np.zeros((len(diff_blocks), 65536), dtype=np.uint8)
    for k, b in enumerate(diff_blocks):
        diff_rows[k, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    diff_lens = np.array([len(b) for b in diff_blocks], dtype=np.int32)
    for level in (1, 2):
        guard.encode_blocks(diff_rows, diff_lens, level, "encoder differential")
    del diff_rows
    guard.decode_chunks(*chunk_cases, 65536, "smoke, malformed and truncated streams")
    guard.decode_chunks(bw_comp, bw_offs, bw_decl, BIG, "big-window cases")
    for k, (body, m, _) in enumerate(st_cases + win_cases):
        guard.stream_routes(body, m, f"stream case {k}")
    for k, (body, m) in enumerate(sc_cases):
        guard.decode_stream_scan(body, m, None, f"scan case {k}")
        offs = decode_stream.window_index(body, m) if m > 0 else None
        if offs is not None:
            guard.decode_stream_scan(body, m, offs.numpy(), f"scan case {k}")
    for k, (body, m, offs) in enumerate(forced):
        guard.decode_stream_scan(body, m, offs, f"forced index {k}")
    m_guarded = guard.chunk_streams(m_streams, "mutation stream")
    small_cases = dict(guard.cases)
    # the main-path shapes: 768 x 64 KiB for K1, K2, K3 and K6, and the
    # 48 MiB level-1 stream on K4's and K5's window routes
    nf = payloads.MAIN_PATH_FRAMES
    main_rows = payload_d[: nf * 65536].view(nf, 65536)
    main_lens = np.full(nf, 65536, dtype=np.int32)
    guard.crc32c(payload_d[: nf * 65536], 0, 65536, nf, 65536, main_lens, "main path")
    guard.crc32c_mma(main_rows, main_lens, "main path")
    for level in (1, 2):
        guard.encode_blocks(main_rows, main_lens, level, "main path")
    g_body = payloads.body_of(raw1)
    g_offs = decode_stream.window_index(g_body, len(payload)).numpy()
    guard.decode_chunks(g_body, g_offs[: nf + 1], main_lens, 65536, "main path")
    guard.decode_stream(g_body, len(payload), g_offs, "the 48 MiB stream")
    guard.decode_stream_scan(g_body, len(payload), g_offs, "the 48 MiB stream")
    del main_rows
    # declared lengths above 2^31: K2 over more than 32,768 windows
    long_info = guards.long_stream(guard, LONG_STREAM)
    guard_launches = counts()
    guard_routes = tuple(a - b for a, b in zip(routes(), routes_before))
    guard_s = time.perf_counter() - t_guard
    torch.cuda.empty_cache()
    print(f"guards: {sum(guard.cases.values())} cases ({small_cases} of phase 3 and {m_guarded} of "
          f"the {len(m_streams)} mutation streams, those with a declared length up to 64 MiB, then the "
          f"main-path shapes and the long stream), each once an input guard of "
          f"{[f if isinstance(f, str) else hex(f) for f in guards.FILLS]} (the long stream 0x00 "
          f"and 0xFF), every buffer a kernel writes inside {guards.GUARD}-byte guard bands: "
          f"guarded launches {dict(guard.guarded)}; {len(guard.failures)} failures "
          f"{guard.failures[:6]}; {guard_s:.1f} s {tag}")
    print(f"guards: long stream: {long_info} {tag}")
    assert not guard.failures, ("guard phase", guard.failures[:20])
    for name in KERNELS:
        assert guard.guarded[name] > 0, f"the guard phase never launched {name}"

    # 8. counters ------------------------------------------------------------
    path_launches = {"framed": framed_launches, "raw": raw_launches,
                     "streams": stream_launches, "host": host_launches, "fused_crc": fused_launches,
                     "one_shot": one_shot_launches}
    for name, got_c in path_launches.items():
        print(f"counters: {name} path {got_c}")
    # every guarded launch of phase 11 went through its wrapper's counter
    print(f"counters: guard phase {guard_launches}, K4 window route and walk "
          f"{guard_routes[:2]}")
    g_k1 = guard.guarded["crc32c"] + guard.guarded["crc32c_long"]
    assert guard_launches["crc32c"] == g_k1 and sum(guard_routes[:2]) == guard.guarded["decode_stream"], \
        ("guard phase counters", guard_launches, guard_routes, dict(guard.guarded))
    for name in ("decode_chunks", "decode_chunks_big", "encode_blocks", "encode_blocks_l2",
                 "decode_stream_scan", "crc32c_mma"):
        assert guard_launches[name] == guard.guarded[name], ("guard phase counters", name)
    print(f"counters: decode of the 48 MiB stream (K4 window route, K4 walk, windows decoded "
          f"again) {decode_route}")
    print(f"counters: the stream path's scan mode (K5 pass-2 launches, K5 pass-1 launches of K2, "
          f"K4 walks, K4 window routes, steps walked by pass 2) {stream_scan}: the 48 MiB stream "
          f"{scan_raw_route}, cli -d --raw {cli_launches['raw']}, the far-copy stream {cli_launches['far']}")
    assert stream_scan == tuple(a + b + c for a, b, c in zip(scan_raw_route, cli_launches["raw"],
                                                             cli_launches["far"])), stream_scan
    for name in ("crc32c", "decode_chunks", "encode_blocks"):
        assert framed_launches[name] > 0, f"the framed main path never launched {name}"
    for name in ("encode_blocks_l2", "decode_chunks_big", "decode_stream", "crc32c",
                 "decode_chunks", "encode_blocks"):
        assert raw_launches[name] > 0, f"the raw main path never launched {name}"
    for name in ("decode_stream_scan", "crc32c", "decode_chunks", "encode_blocks"):
        assert stream_launches[name] > 0, f"the stream layer never launched {name}"
    assert fused_launches["crc32c_mma"] > 0, "the fused CRC path never launched crc32c_mma"
    print(f"counters: array route (phase 12) {array_launches}, K4 / K5 routes {array_routes}")
    assert array_launches["crc32c"] > 0, "the array route never launched crc32c"
    assert not any(n for name, n in array_launches.items() if name not in ("crc32c", "crc32c_long")) \
        and not any(array_routes), ("the array route launched a kernel other than K1", array_launches)
    assert one_shot_launches["crc32c"] == 1, ("the one-shot CRC's launches of crc32c", one_shot_launches)
    print(f"counters: google/snappy phase (13) {cpp_launches}; on the far-copy battery K4 window-route / "
          f"walk launches and windows decoded again {cpp['farcopy_k4']}, K5 pass-2 / pass-1 launches and "
          f"steps walked {cpp['farcopy_k5']}")
    for name in ("decode_chunks", "decode_chunks_big", "encode_blocks", "encode_blocks_l2", "decode_stream",
                 "decode_stream_scan"):
        assert cpp_launches[name] > 0, f"the google/snappy phase never launched {name}"
    assert all(cpp["farcopy_k4"]) and cpp["farcopy_k5"][1] > 0, \
        ("the far-copy battery: K4's window route, its walk and pass 2; K5's window route", cpp)
    launches = {name: path_launches[p][name] for name, (_, _, p) in KERNELS.items()}
    # the sharded paths (phase 10): one nccl rank, then each gloo rank
    print(f"counters: sharded path, one nccl rank {sharded_launches}")
    for r, res in enumerate(ranks):
        print(f"counters: sharded path, gloo rank {r} of {SHARDED_WORLD} ({res['frames']} frames) "
              f"{res['launches']}")
    for name in SHARDED:
        assert sharded_launches[name] > 0, f"the sharded path never launched {name}"
        for r, res in enumerate(ranks):
            assert res["frames"] == 0 or res["launches"][name] > 0, \
                f"gloo rank {r} of the sharded path never launched {name}"

    # 9. timings -------------------------------------------------------------
    nf = payloads.MAIN_PATH_FRAMES
    arr = np.frombuffer(payload, dtype=np.uint8)[: nf * 65536]
    big = torch.from_numpy(arr.copy()).view(nf, 65536).to(dev)
    big_lens = torch.full((nf,), 65536, dtype=torch.int32, device=dev)
    crc_out = torch.empty(nf, dtype=torch.uint32, device=dev)
    long_row, long_nt = payload_d.view(1, -1), crc32c.tiles_per_row(len(payload))
    long_len = torch.tensor([len(payload)], dtype=torch.int32, device=dev)
    long_out = torch.empty(1, dtype=torch.uint32, device=dev)
    mid_out = torch.empty(1, dtype=torch.uint32, device=dev)
    big_enc = torch.empty((nf, encode_blocks.ENC_CAP), dtype=torch.uint8, device=dev)
    big_elen = torch.empty(nf, dtype=torch.int32, device=dev)
    encode_blocks._launch(big, big_lens, big_enc, big_elen)
    big_elen_h = big_elen.cpu()
    big_enc_h = big_enc.cpu().numpy()
    l1_bytes = int(big_elen_h.sum())
    encode_blocks._launch(big, big_lens, big_enc, big_elen, 2)
    big_enc_l2 = (big_enc.cpu().numpy(), big_elen.cpu().tolist())
    l2_bytes = sum(big_enc_l2[1])
    bcomp, boffs = ragged([big_enc_h[k, :n].tobytes() for k, n in enumerate(big_elen_h.tolist())])
    bcomp, boffs = bcomp.to(dev), boffs.to(dev)
    big_out = torch.empty((nf, 65536), dtype=torch.uint8, device=dev)
    big_ok = torch.empty(nf, dtype=torch.bool, device=dev)
    big_w = torch.empty(nf, dtype=torch.int32, device=dev)
    decode_chunks._launch(bcomp, boffs, big_lens, big_out, big_ok, big_w)
    assert bool(big_ok.all()) and torch.equal(big_out, big), "768-chunk decode"

    # the 8 unsplittable serving-batch streams at the big-window shape
    first = payloads.SERVING_SMALL
    straddle = serving[first : first + payloads.SERVING_STRADDLE]
    sb_comp, sb_offs = ragged([payloads.body_of(s) for s in straddle])
    sb_decl = torch.tensor([len(e) for e in expect[first : first + len(straddle)]], dtype=torch.int32)
    sb_comp, sb_offs, sb_decl = sb_comp.to(dev), sb_offs.to(dev), sb_decl.to(dev)
    sb_out = torch.empty((len(straddle), BIG), dtype=torch.uint8, device=dev)
    sb_ok = torch.empty(len(straddle), dtype=torch.bool, device=dev)
    sb_w = torch.empty(len(straddle), dtype=torch.int32, device=dev)
    decode_chunks._launch(sb_comp, sb_offs, sb_decl, sb_out, sb_ok, sb_w)
    assert bool(sb_ok.all()), "big-window serving streams"
    # the whole 48 MiB level-1 stream through the streaming decoder
    r_body = payloads.body_of(raw1)
    r_comp = torch.from_numpy(np.frombuffer(r_body, dtype=np.uint8).copy()).to(dev)
    r_out = torch.empty(len(payload), dtype=torch.uint8, device=dev)
    r_status = torch.empty(4, dtype=torch.int64, device=dev)
    index_ms = host_ms(lambda: decode_stream.window_index(r_body, len(payload)), 3)
    r_offs = decode_stream.window_index(r_body, len(payload))
    assert r_offs is not None, "the 48 MiB level-1 stream has no window index"
    r_nwin = r_offs.shape[0] - 1
    spans = r_offs.diff()
    r_offs = r_offs.to(dev)
    r_rec = torch.empty(3 * r_nwin, dtype=torch.int64, device=dev)
    r_walk_out = torch.empty(len(payload), dtype=torch.uint8, device=dev)
    r_walk_status = torch.empty(4, dtype=torch.int64, device=dev)
    # K5 on the same stream: its window route (K2 over the windows, pass 2)
    r_out_scan = torch.empty(r_nwin * 65536, dtype=torch.uint8, device=dev)
    r_steps = decode_stream.n_steps(len(r_body), len(payload))
    r_state = torch.empty(decode_stream.STATE_WORDS + 1, dtype=torch.int64, device=dev)
    r_writtens = torch.empty(r_steps, dtype=torch.int64, device=dev)
    r_win = (r_offs, torch.from_numpy(decode_stream.window_lengths(len(payload))).to(dev),
             torch.empty(r_nwin, dtype=torch.bool, device=dev),
             torch.empty(r_nwin, dtype=torch.int32, device=dev))
    r_walk_scan_out = torch.empty(len(payload), dtype=torch.uint8, device=dev)
    r_walk_state = torch.empty(decode_stream.STATE_WORDS + 1, dtype=torch.int64, device=dev)
    r_walk_writtens = torch.empty(r_steps, dtype=torch.int64, device=dev)
    fused_out = torch.empty(nf, dtype=torch.uint32, device=dev)
    s_fused = torch.empty(len(blocks), dtype=torch.uint32, device=dev)

    def scan_main(passes: int = 3):
        decode_stream._launch_scan(r_comp, len(payload), r_out_scan, r_state, r_writtens, r_win, passes)

    def scan_set_kernel():  # each case on its route, as decode_raw_stream_bytes takes it
        for comp_d, _, m, out_d, offs_d, offs_h in sc_dev:
            decode_stream.decode_stream_scan(comp_d, m, out_d, offs_d, None, offs_h)

    def scan_set_plain():
        for _, comp_h, m, _, _, _ in sc_dev:
            decode_stream.decode_stream_scan(comp_h, m, torch.empty(max(m, 1), dtype=torch.uint8))

    s_out = torch.empty(len(blocks), dtype=torch.uint32, device=dev)
    s_enc = torch.empty((len(blocks), encode_blocks.ENC_CAP), dtype=torch.uint8, device=dev)
    s_elen = torch.empty(len(blocks), dtype=torch.int32, device=dev)
    s_comp, s_offs = ragged(streams)
    s_comp, s_offs = s_comp.to(dev), s_offs.to(dev)
    s_dout = torch.empty((len(blocks), 65536), dtype=torch.uint8, device=dev)
    s_ok = torch.empty(len(blocks), dtype=torch.bool, device=dev)
    s_w = torch.empty(len(blocks), dtype=torch.int32, device=dev)
    bw_comp_d, bw_offs_d, bw_decl_d = bw_comp.to(dev), bw_offs.to(dev), bw_decl.to(dev)
    bw_out = torch.empty((len(big_cases), BIG), dtype=torch.uint8, device=dev)
    bw_ok = torch.empty(len(big_cases), dtype=torch.bool, device=dev)
    bw_w = torch.empty(len(big_cases), dtype=torch.int32, device=dev)
    st_status = torch.empty(4, dtype=torch.int64, device=dev)
    s_comp_h, s_offs_h = s_comp.cpu(), s_offs.cpu()
    s_pout = torch.empty((len(blocks), 65536), dtype=torch.uint8)
    st_host = [(torch.from_numpy(np.frombuffer(b, dtype=np.uint8).copy()), m)
               for b, m, _ in st_cases + win_cases]

    def stream_set_kernel():  # each case on its route, as in phase 3
        for comp_d, m, out_d, offs_d in st_dev:
            if offs_d is None:
                decode_stream._launch(comp_d, m, out_d, st_status)
            else:
                decode_stream._launch_windows(comp_d, m, out_d, offs_d, st_status)

    def stream_set_plain():
        for comp_h, m in st_host:
            decode_stream._decode_stream_plain(comp_h, m, torch.empty(max(m, 1), dtype=torch.uint8))

    sb_payload = int(sb_decl.sum())
    stream_bytes = len(r_body) + len(payload) + 8 * (r_nwin + 1) + 32

    def windows_main(passes: int = 3):
        decode_stream._launch_windows(r_comp, len(payload), r_out, r_offs, r_status, r_rec, passes)

    # K4's passes alone, and the whole-stream walk once (the earlier design)
    windows_main()
    pass1_ms = event_ms(lambda: windows_main(1), 5)
    pass2_ms = event_ms(lambda: windows_main(2), 5)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    decode_stream._launch(r_comp, len(payload), r_walk_out, r_walk_status)
    end.record()
    torch.cuda.synchronize()
    walk_ms = start.elapsed_time(end)
    assert int(r_walk_status[0]) == 1, "the whole-stream walk of the 48 MiB stream"
    print(f"timing: decode_stream on the {len(r_body)}-byte level-1 stream: host index "
          f"{index_ms:.3f} ms ({r_nwin} windows of {int(spans.min())} to {int(spans.max())} input "
          f"bytes, median {int(spans.median())}), pass 1 {pass1_ms:.4f} ms, pass 2 {pass2_ms:.4f} ms, "
          f"whole-stream walk {walk_ms:.2f} ms (one call) {tag}")
    # K5's passes alone, and its route without an index once (every step walked)
    scan_main()
    scan_pass1_ms = event_ms(lambda: scan_main(1), 5)
    scan_pass2_ms = event_ms(lambda: scan_main(2), 5)
    torch.cuda.synchronize()
    start.record()
    decode_stream._launch_scan(r_comp, len(payload), r_walk_scan_out, r_walk_state, r_walk_writtens)
    end.record()
    torch.cuda.synchronize()
    scan_walk_ms = start.elapsed_time(end)
    scan_walked = int(r_walk_state[decode_stream.S_WALKED])
    assert torch.equal(r_walk_state[:16], r_state[:16]) and torch.equal(r_walk_writtens, r_writtens), \
        "K5 without an index differs from its window route on the 48 MiB stream"
    print(f"timing: decode_stream_scan on the {len(r_body)}-byte level-1 stream ({r_steps} steps): "
          f"window route pass 1 (K2 over the {r_nwin} windows) {scan_pass1_ms:.4f} ms, pass 2 "
          f"{scan_pass2_ms:.4f} ms ({int(r_state[decode_stream.S_WALKED])} steps walked); the route "
          f"without an index {scan_walk_ms:.2f} ms (one call, {scan_walked} steps walked) {tag}")
    views = [memoryview(arr)[k * 65536 : (k + 1) * 65536] for k in range(nf)]
    kernel_out = {1: (big_enc_h, big_elen_h.tolist()), 2: big_enc_l2}
    for level in (1, 2):
        t = time.perf_counter()
        host_blocks = [host_codec.encode_block(v, level) for v in views]
        host_s = time.perf_counter() - t
        k_enc, k_len = kernel_out[level]
        for k, b in enumerate(host_blocks):
            assert k_enc[k, : k_len[k]].tobytes() == b, ("host C control", level, k)
        print(f"timing: host C encoder (control), level {level}, one host thread: {host_s * 1e3:.2f} ms "
              f"for the {nf} x 64 KiB blocks ({nf * 65536 / host_s / 1e9:.3f} GB/s), the same bytes "
              f"as encode_blocks {tag}")
    del kernel_out, big_enc_l2
    crc32c._launch(big, big_lens, crc_out, 1)
    t = time.perf_counter()
    host_crcs = [host_codec.masked_crc32c(v) for v in views]
    host_s = time.perf_counter() - t
    assert host_crcs == crc_out.cpu().numpy().tolist(), "host C CRC control"
    print(f"timing: host C CRC (control), one host thread: {host_s * 1e3:.3f} ms for the {nf} x "
          f"64 KiB blocks ({nf * 65536 / host_s / 1e9:.3f} GB/s), the same CRCs as crc32c {tag}")
    timing = {
        # name: (main-path shape, its description, bytes out, reps,
        #        kernel on the small set, plain on the small set, small set,
        #        bytes the main-path call moves, its int8 operations)
        "crc32c": (lambda: crc32c._launch(big, big_lens, crc_out, 1),
                   f"{nf} x 64 KiB chunks", nf * 65536, 10,
                   lambda: crc32c._launch(frames, lens, s_out, 1),
                   lambda: crc32c._crc32c_plain(frames_h, lens_h), "8 chunks",
                   nf * 65536 + 8 * nf, 0),
        "encode_blocks": (lambda: encode_blocks._launch(big, big_lens, big_enc, big_elen),
                          f"{nf} x 64 KiB blocks", nf * 65536, 10,
                          lambda: encode_blocks._launch(frames, lens, s_enc, s_elen),
                          lambda: encode_blocks._encode_blocks_plain(frames_h, lens_h), "8 blocks",
                          nf * 65536 + l1_bytes + 8 * nf, 0),
        "encode_blocks_l2": (lambda: encode_blocks._launch(big, big_lens, big_enc, big_elen, 2),
                             f"{nf} x 64 KiB blocks", nf * 65536, 10,
                             lambda: encode_blocks._launch(frames, lens, s_enc, s_elen, 2),
                             lambda: encode_blocks._encode_blocks_plain(frames_h, lens_h, 2), "8 blocks",
                             nf * 65536 + l2_bytes + 8 * nf, 0),
        "decode_chunks": (lambda: decode_chunks._launch(bcomp, boffs, big_lens, big_out, big_ok, big_w),
                          f"{nf} chunks", nf * 65536, 10,
                          lambda: decode_chunks._launch(s_comp, s_offs, lens, s_dout, s_ok, s_w),
                          lambda: decode_chunks._decode_chunks_plain(s_comp_h, s_offs_h, lens_h, s_pout),
                          "8 chunks", bcomp.numel() + 8 * (nf + 1) + 4 * nf + nf * 65536 + 5 * nf, 0),
        "decode_chunks_big": (lambda: decode_chunks._launch(sb_comp, sb_offs, sb_decl, sb_out, sb_ok, sb_w),
                              f"{len(straddle)} unsplittable serving streams at W={BIG}",
                              sb_payload, 10,
                              lambda: decode_chunks._launch(bw_comp_d, bw_offs_d, bw_decl_d, bw_out, bw_ok, bw_w),
                              lambda: decode_chunks._decode_chunks_plain(bw_comp, bw_offs, bw_decl, bw_pout),
                              f"{len(big_cases)} big-window cases",
                              sb_comp.numel() + 8 * (len(straddle) + 1) + sb_payload + 9 * len(straddle), 0),
        "decode_stream": (windows_main,
                          f"the {len(r_body)}-byte level-1 stream of the payload, {r_nwin} windows "
                          f"(both passes, the host index made before)", len(payload), 10,
                          stream_set_kernel, stream_set_plain,
                          f"{len(st_dev)} stream and window cases", stream_bytes, 0),
        "decode_stream_scan": (scan_main,
                               f"the {len(r_body)}-byte level-1 stream of the payload, {r_steps} "
                               f"steps, {r_nwin} windows (both passes, the host index made before)",
                               len(payload), 10, scan_set_kernel, scan_set_plain,
                               f"{len(sc_dev)} stream cases, each on its route",
                               len(r_body) + len(payload) + 8 * (r_nwin + 1) + 8 * (17 + r_steps), 0),
        "crc32c_mma": (lambda: crc32c_mma._launch(big, big_lens, fused_out),
                       f"{nf} x 64 KiB chunks", nf * 65536, 10,
                       lambda: crc32c_mma._launch(frames, lens, s_fused),
                       lambda: crc32c_mma._crc32c_mma_plain(frames_h, lens_h), "8 chunks",
                       nf * 65536 + 8 * nf + 4 * len(crc32c_mma.consts()), 2 * nf * 65536 * 8 * 32),
        "crc32c_long": (lambda: crc32c._launch(long_row, long_len, long_out, long_nt),
                        f"the {len(payload)}-byte payload as one row ({long_nt} tiles)",
                        len(payload), 10,
                        lambda: crc32c._launch(mid_row, mid_len, mid_out, crc32c.tiles_per_row(mid)),
                        lambda: crc32c._crc32c_plain(mid_row_h, mid_len_h), f"one row of {mid} bytes",
                        len(payload) + 4 + 4, 0),
    }
    rows = []
    for name, (source, replaces, _) in KERNELS.items():
        main_fn, shape, nbytes, reps, small_fn, plain_fn, small_set, moved, ops = timing[name]
        ms = event_ms(main_fn, reps)
        ms_small = event_ms(small_fn, 3)
        plain_ms = host_ms(plain_fn, 1)
        bound_ms, bound_by = bound(moved, ops)
        print(f"timing: {name} kernel {ms:.4f} ms for {shape} ({nbytes / ms / 1e6:.3f} GB/s "
              f"of output; bound {bound_ms:.4f} ms by {bound_by}: {moved} bytes, {ops} int8 ops); "
              f"on {small_set} kernel {ms_small:.4f} ms, plain {plain_ms:.2f} ms {tag}")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "ms_small": ms_small, "shape": shape, "small_set": small_set,
                     "guarded": guard.guarded[name]})
        if name == "decode_stream":
            rows[-1].update({"pass1_ms": pass1_ms, "pass2_ms": pass2_ms, "index_ms": index_ms,
                             "walk_ms": walk_ms, "walk_over_ms": walk_ms / ms})
        if name == "decode_stream_scan":
            rows[-1].update({"timed_route": "window route: K2 over the windows, then pass 2",
                             "pass1_source": KERNELS["decode_chunks"][0],
                             "pass1_ms": scan_pass1_ms, "pass2_ms": scan_pass2_ms,
                             "walked": int(r_state[decode_stream.S_WALKED]),
                             "no_index_ms": scan_walk_ms, "no_index_walked": scan_walked})
    # K2: registers and CTAs per SM of each shape's kernel, and both layouts
    from snappy_tpu_torch.testing import decode_layouts

    k2_regs = decode_layouts.registers(_build.cuda_build_log())
    k2_layouts = decode_layouts.measure(reps=10, profile=False)
    for row in rows:
        if row["name"] in K2_SHAPE:
            shape = K2_SHAPE[row["name"]]
            layout, times = k2_layouts[shape]["layout"], k2_layouts[shape]["ms"]
            row.update({"layout": layout, "registers": k2_regs[layout],
                        "ctas_per_sm": k2_layouts[shape]["ctas_per_sm"][layout],
                        "layouts_ms": times})
            print(f"timing: {row['name']} ({shape} shape) layout {layout}: {row['registers']} "
                  f"registers, {row['ctas_per_sm']} CTAs per SM; the A/B (a, b, b, a): layout a "
                  f"{times['a'][0]:.4f} / {times['a'][1]:.4f} ms, layout b {times['b'][0]:.4f} / "
                  f"{times['b'][1]:.4f} ms {tag}")
    # K1: registers, shared memory and CTAs per SM, and both layouts
    from snappy_tpu_torch.testing import crc_layouts

    k1 = crc_layouts.kernel_params(_build.cuda_lib())
    k1_regs = crc_layouts.registers(_build.cuda_build_log())["i"]
    k1_layouts = crc_layouts.measure(reps=10)
    for row in rows:
        if row["name"] in ("crc32c", "crc32c_long"):
            times = k1_layouts["chunks" if row["name"] == "crc32c" else "long"]["ms"]
            row.update({"layout": "i", "registers": k1_regs, "ctas_per_sm": k1["ctas_per_sm"],
                        "smem_bytes": k1["smem_bytes"], "table_bytes": k1["table_bytes"],
                        "layouts_ms": times})
            print(f"timing: {row['name']} layout (i): {k1_regs} registers, {k1['smem_bytes']} bytes "
                  f"of shared memory a CTA ({k1['table_bytes']} of per-bank tables), "
                  f"{k1['ctas_per_sm']} CTAs per SM of {32 * k1['warps']} threads; the A/B (i, ii, "
                  f"ii, i): layout (i) {times['i'][0]:.4f} / {times['i'][1]:.4f} ms, layout (ii) "
                  f"{times['ii'][0]:.4f} / {times['ii'][1]:.4f} ms {tag}")
    # K6: registers, spills, shared memory and CTAs per SM
    from snappy_tpu_torch.testing import mma_layouts

    k6 = mma_layouts.kernel_params(_build.cuda_lib())
    k6_regs = mma_layouts.registers(_build.cuda_build_log()).get(mma_layouts.PACKAGE, {})
    for row in rows:
        if row["name"] == "crc32c_mma":
            row.update({**k6_regs, "ctas_per_sm": k6["ctas_per_sm"], "smem_bytes": k6["smem_bytes"]})
            print(f"timing: crc32c_mma: {k6_regs.get('registers')} registers, "
                  f"{k6_regs.get('spill_bytes')} bytes spilled, {k6['smem_bytes']} bytes of shared "
                  f"memory a CTA of {32 * k6['warps']} threads, {k6['ctas_per_sm']} CTAs per SM {tag}")
    torch.cuda.synchronize()
    assert int(long_out[0]) == payload_crc, "crc32c on the payload as one row"
    payload_t = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    assert r_status.tolist() == [1, len(payload), len(r_body), 0] and torch.equal(r_out.cpu(), payload_t), \
        ("window route decode of the 48 MiB stream", r_status.tolist())
    assert torch.equal(r_walk_out.cpu(), payload_t), "whole-stream walk of the 48 MiB stream"
    scan_state = r_state.cpu().tolist()
    scan_status = decode_stream.scan_status(scan_state, len(r_body), len(payload))
    assert scan_status[0] == 1 and torch.equal(r_out_scan[: len(payload)].cpu(), payload_t), \
        ("scan-mode decode of the 48 MiB stream", scan_status)
    assert scan_state[decode_stream.S_WALKED] == 0, ("steps walked on the 48 MiB stream", scan_state)
    assert torch.equal(r_walk_scan_out.cpu(), payload_t), "K5 without an index on the 48 MiB stream"
    assert torch.equal(fused_out.cpu(), crc_out.cpu()), "crc32c_mma at the main-path shape"

    def sync_uncompress():
        sync.uncompress_framed(io.BytesIO(stream), io.BytesIO(), device=dev)

    def scan_decode():
        with stream_mode("scan"):
            api.decode(raw1, device=dev)

    batch_bytes = sum(len(e) for e in expect if e is not None)
    end_to_end = (
        ("encode_framed L1", lambda: api.encode_framed(payload, device=dev), len(payload), 3),
        ("decode_framed", lambda: api.decode_framed(stream, device=dev), len(payload), 3),
        ("encode_framed L2", lambda: api.encode_framed(payload, level=2, device=dev), len(payload), 3),
        ("encode L1", lambda: api.encode(payload, device=dev), len(payload), 3),
        ("encode L2", lambda: api.encode(payload, level=2, device=dev), len(payload), 3),
        ("decode", lambda: api.decode(raw1, device=dev), len(payload), 3),
        ("decode_batch", lambda: api.decode_batch(serving, device=dev), batch_bytes, 3),
        ("sync compress_framed", lambda: sync.compress_framed(io.BytesIO(payload), io.BytesIO(), device=dev),
         len(payload), 3),
        ("sync uncompress_framed", sync_uncompress, len(payload), 3),
        ("uncompress_framed_into 8 MiB", lambda: resume_into(stream, 8 << 20), len(payload), 3),
        ("decode (scan mode)", scan_decode, len(payload), 3),
        ("masked_crc32c", lambda: engine.masked_crc32c(payload, device=dev), len(payload), 3),
    )
    def e2e_peak(fn, reps):
        """e2e(fn, reps) and the most device memory the calls held above
        what was allocated before them."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = e2e(fn, reps)
        return times, torch.cuda.max_memory_allocated() - base

    rates, peaks = {}, {}
    for name, fn, nbytes, reps in end_to_end:
        rates[name], peaks[name] = e2e_peak(fn, reps)
        best, med = rates[name]
        print(f"timing: {name} {nbytes} bytes: best {best * 1e3:.2f} ms "
              f"({nbytes / best / 1e9:.3f} GB/s), median {med * 1e3:.2f} ms "
              f"({nbytes / med / 1e9:.3f} GB/s), peak device memory {peaks[name]} bytes {tag}")
    # the same calls on the array route, each beside the scalar route's
    with array_route():
        for name, fn, nbytes, reps in end_to_end:
            if name in ("decode (scan mode)", "masked_crc32c"):
                continue  # a mode of the scalar route's stream decoder; K1 on both routes
            (best, med), peak = e2e_peak(fn, reps)
            print(f"timing: array route {name} {nbytes} bytes: best {best * 1e3:.2f} ms "
                  f"({nbytes / best / 1e9:.3f} GB/s), median {med * 1e3:.2f} ms "
                  f"({nbytes / med / 1e9:.3f} GB/s), peak device memory {peak} bytes; scalar route "
                  f"best {rates[name][0] * 1e3:.2f} ms, median {rates[name][1] * 1e3:.2f} ms, peak "
                  f"{peaks[name]} bytes; array / scalar time: best {best / rates[name][0]:.3f}, "
                  f"median {med / rates[name][1]:.3f} {tag}")
    # the same calls on the host backend: the native C runtime on this
    # machine's cores, the same-machine control
    host_tag = f"[host backend: {cpu_label()}; {card}]"
    config.set_backend("host")
    try:
        for name, fn, nbytes, reps in end_to_end:
            if name == "decode (scan mode)":
                continue  # a mode of the device backend's stream decoder
            best, med = e2e(fn, reps)
            print(f"timing: host backend {name} {nbytes} bytes: best {best * 1e3:.2f} ms "
                  f"({nbytes / best / 1e9:.3f} GB/s), median {med * 1e3:.2f} ms "
                  f"({nbytes / med / 1e9:.3f} GB/s); host / device time: best "
                  f"{best / rates[name][0]:.3f}, median {med / rates[name][1]:.3f} {host_tag}")
    finally:
        config.set_backend("device")
    # where the host decodes' time goes: the native work alone, into a
    # buffer written before (no page faults, no tobytes)
    warm = np.empty(len(payload), dtype=np.uint8)
    chunks = framing.scan_frames(stream, len(C.FRAMING_HEADER))
    r_read = len(raw1) - len(r_body)
    for name, fn in (
        ("frame scan", lambda: framing.scan_frames(stream, len(C.FRAMING_HEADER))),
        ("framed decode and CRC into a written buffer",
         lambda: host_codec.framed_uncompress_scanned(stream, chunks, True, warm)),
        ("raw decode into a written buffer",
         lambda: host_codec.decode_raw_body_into(memoryview(raw1)[r_read:], len(payload), warm)),
    ):
        best, med = e2e(fn, 3)
        print(f"timing: host backend stage: {name}: best {best * 1e3:.2f} ms, median {med * 1e3:.2f} ms "
              f"{host_tag}")

    # the sharded paths of phase 10 (a), each beside the engine's call on one
    # device, in turns (engine, sharded, sharded, engine); then one traced
    # call of each, for the all-gathers
    sharded_paths = (
        ("sharded_framed_compress", "encode_framed", lambda: api.encode_framed(payload, device=dev),
         lambda: pmesh.sharded_framed_compress(payload, world1)),
        ("sharded_framed_uncompress", "decode_framed", lambda: api.decode_framed(stream, device=dev),
         lambda: pmesh.sharded_framed_uncompress(stream, world1)),
        ("sharded_raw_compress", "encode", lambda: api.encode(payload, device=dev),
         lambda: pmesh.sharded_raw_compress(payload, world1)),
    )
    for name, single_name, single, sharded in sharded_paths:
        t = [e2e(single), e2e(sharded), e2e(sharded), e2e(single)]
        print(f"timing: {name}, one nccl rank, of {len(payload)} bytes: best / median "
              f"{t[1][0] * 1e3:.2f} / {t[1][1] * 1e3:.2f} and {t[2][0] * 1e3:.2f} / {t[2][1] * 1e3:.2f} ms; "
              f"{single_name} on one device {t[0][0] * 1e3:.2f} / {t[0][1] * 1e3:.2f} and "
              f"{t[3][0] * 1e3:.2f} / {t[3][1] * 1e3:.2f} ms; sharded / engine (best) "
              f"{min(t[1][0], t[2][0]) / min(t[0][0], t[3][0]):.3f} {tag}")
    traced = {"one nccl rank": (world1.size, [])}
    for name, _, _, sharded in sharded_paths:
        world1.trace = []
        sharded()
        traced["one nccl rank"][1].append((name, gathers(world1.trace)))
    world1.trace = None
    for r, res in enumerate(ranks):
        traced[f"gloo rank {r} of {SHARDED_WORLD}"] = (SHARDED_WORLD, res["gathers"])
        for name, (best, med) in res["times"].items():
            print(f"timing: sharded, gloo rank {r} of {SHARDED_WORLD} on one card (not compared: both "
                  f"ranks share it): {name} best {best * 1e3:.2f} ms, median {med * 1e3:.2f} ms {tag}")
    for who, (size, by_path) in traced.items():
        for path_name, trace in by_path:
            for name, n_rows, sent, ms in trace:
                share = -(-n_rows // size)
                print(f"timing: all-gather, {who}, {path_name}: {name} of {n_rows} chunks: {sent} "
                      f"bytes sent ({sent / max(share, 1):.1f} per chunk of the largest share, "
                      f"{share} chunks), {ms:.4f} ms {tag}")
    dist.destroy_process_group()

    # 14. the flagship step and the dry run (after 10's group is gone) --------
    from snappy_tpu_torch import entry

    step_launches = {}
    fn, ex_args = entry.entry()
    assert all(a.device == dev for a in ex_args), "entry()'s example arguments are not on the card"
    _, cpu_args = entry.entry("cpu")
    full = engine._split_blocks(np.frombuffer(payload, dtype=np.uint8), dev)
    # the engine's framed streams of the payload on each route: stored CRCs
    # and compressed chunk bodies
    route_streams = {"scalar": stream, "array": arr_framed[1]}
    for route, ctx in (("scalar", contextlib.nullcontext), ("array", array_route)):
        with ctx():
            got = [t.cpu().numpy() for t in fn(*ex_args)]
            want = [t.numpy() for t in fn(*cpu_args)]  # the plain versions
            assert got[0].shape == want[0].shape and np.array_equal(got[0], want[0]), ("entry crcs", route)
            assert np.array_equal(got[2], want[2]), ("entry totals", route, got[2], want[2])
            assert got[1].shape == want[1].shape == (2, entry.max_comp(entry.EXAMPLE_B)), ("entry enc", route)
            for i, t in enumerate(want[2].tolist()):
                assert np.array_equal(got[1][i, :t], want[1][i, :t]), ("entry enc", route, i)
            print(f"entry: ({route} route) the example step on {dev}: frames {tuple(ex_args[0].shape)} -> "
                  f"crcs {got[0].tolist()}, enc {got[1].shape}, totals {got[2].tolist()}, equal to the step "
                  f"on the CPU (plain versions; tolerance: exact)")
            reset_counts()
            crcs_d, enc_d, totals_d = fn(*full)
            torch.cuda.synchronize()
            step_launches[route] = counts()
            crcs_h, totals_h = crcs_d.cpu().numpy(), totals_d.cpu().numpy()
            enc_h = enc_d.cpu().numpy()
            s = route_streams[route]
            chunks = framing.scan_frames(s, len(C.FRAMING_HEADER))
            assert len(chunks) == len(crcs_h) == full[0].shape[0], ("entry at full width", route, len(chunks))
            n_comp = 0
            for k, ch in enumerate(chunks):
                stored = int.from_bytes(s[ch.data_pos : ch.data_pos + 4], "little")
                assert int(crcs_h[k]) == stored, ("entry crc against the framed stream", route, k)
                if ch.id == C.CHUNK_COMPRESSED:
                    blob = s[ch.data_pos + 4 : ch.data_pos + ch.data_len]
                    _, skip = varint.decode_uint32(blob[:5])
                    assert enc_h[k, : totals_h[k]].tobytes() == blob[skip:], ("entry enc against the stream", route, k)
                    n_comp += 1
            others = {k: v for k, v in step_launches[route].items()
                      if k not in ("crc32c", "crc32c_long", "encode_blocks") and v}
            want_k3 = 1 if route == "scalar" else 0
            assert step_launches[route]["crc32c"] == 1 and step_launches[route]["encode_blocks"] == want_k3 \
                and not others, ("entry launches", route, step_launches[route])
            del crcs_d, enc_d, totals_d
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            step_ms = event_ms(lambda: fn(*full), 10)
            peak_mb = (torch.cuda.max_memory_allocated() - before) / 1e6
            moved = len(payload) + int(totals_h.sum()) + 8 * len(totals_h)
            step_bound, step_by = bound(moved)
            print(f"entry: ({route} route) the step at full width, {full[0].shape[0]} frames of 64 KiB: "
                  f"{len(chunks)} CRCs equal the stored CRCs of the engine's framed stream on this route, "
                  f"{n_comp} compressed chunks' bodies equal enc[:totals]; launches K1 "
                  f"{step_launches[route]['crc32c']}, K3 {step_launches[route]['encode_blocks']}, others 0")
            print(f"timing: entry step ({route} route) {step_ms:.4f} ms for {full[0].shape[0]} x 64 KiB "
                  f"(CUDA events, mean of 10 after a warm-up; bound {step_bound:.4f} ms by {step_by}: "
                  f"{moved} bytes); peak device memory above the inputs {peak_mb:.1f} MB {tag}")
    reset_counts()
    t_dry = time.perf_counter()
    dry = entry.dryrun_multichip(torch.cuda.device_count())
    dry_launches = counts()
    if torch.cuda.device_count() == 1:  # the legs ran in this process
        assert dry_launches["crc32c"] and dry_launches["encode_blocks"] and \
            dry_launches["decode_chunks"] + dry_launches["decode_chunks_big"], ("dry run launches", dry_launches)
    print(f"entry: dryrun_multichip({torch.cuda.device_count()}) in {time.perf_counter() - t_dry:.2f} s: "
          f"payload {dry['payload']} B, framed {dry['framed']} B, raw {dry['raw']} B, balance "
          f"{dry['balance']:.2f}; launches in this process {dry_launches} {tag}")

    for row in rows:
        row["entry_launches"] = {route: step_launches[route][row["name"]] for route in step_launches}
        row["dryrun_launches"] = dry_launches[row["name"]]
        if row["name"] in SHARDED:
            row["sharded_launches"] = {"nccl_world_1": sharded_launches[row["name"]],
                                       "gloo_world_2": [res["launches"][row["name"]] for res in ranks]}
        row["array_launches"] = array_launches[row["name"]]
        row["cpp_launches"] = cpp_launches[row["name"]]

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
