"""Drive the port's framed main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. setup    — torch and CUDA versions, the card, its name and power limit;
2. build    — nvcc builds the three kernels from snappy_tpu_torch/ops/csrc
              into build/snappy_tpu_torch/ (first use);
3. kernels  — each kernel against its plain version on 8 chunks (text,
              SSZ-like records, runs, period 8, random, a 64 KiB block, a
              17-byte block, an empty block), and the decoder also on
              malformed and truncated tag streams; equal, or it fails;
4. main     — encode_framed / decode_framed of the seeded 48 MiB mixed
              payload on the card: the stream's SHA-256 equals the digest
              pinned from the JAX package and decodes back to the payload;
              then the error-order cases and check_integrity=False;
5. counters — each kernel was launched by the main path;
6. timings  — each kernel at main-path shapes (768 chunks) and on the
              8-chunk set beside its plain version, and the end-to-end
              framed encode and decode rates.

Any failure raises and the exit code is not 0.  The line before the last
is a JSON object of the kernels: per kernel, the main path's launch count,
the largest difference from its plain version, ``ms`` (one launch over the
768 main-path chunks), ``plain_ms`` (the plain version over the 8-chunk
set) and ``ms_8_chunks`` (the kernel over that same set).  The last line
is the JSON result.  Exits nonzero, printing no result, where torch.cuda
is not available.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    # name: (CUDA source, the TPU kernel it replaces)
    "crc32c": ("snappy_tpu_torch/ops/csrc/crc32c.cu",
               "snappy_tpu/ops/crc32c_pallas.py:52"),
    "decode_chunks": ("snappy_tpu_torch/ops/csrc/decode_chunks.cu",
                      "snappy_tpu/ops/decode_scalar.py:151"),
    "encode_blocks": ("snappy_tpu_torch/ops/csrc/encode_blocks.cu",
                      "snappy_tpu/ops/encode_scalar.py:56"),
}


def card_label() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


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


def main() -> None:
    # 1. setup ---------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available")
    from snappy_tpu_torch import api, engine
    from snappy_tpu_torch.formats import constants as C
    from snappy_tpu_torch.formats import framing, varint
    from snappy_tpu_torch.ops import _build, crc32c, decode_chunks, encode_blocks
    from snappy_tpu_torch.testing import payloads

    mods = {"crc32c": crc32c, "decode_chunks": decode_chunks, "encode_blocks": encode_blocks}
    dev = torch.device("cuda:0")
    card = card_label()
    tag = f"[{card}]"
    print(f"setup: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    print(card)

    # 2. build ---------------------------------------------------------------
    t = time.perf_counter()
    _build.cuda_lib()
    print(f"build: {time.perf_counter() - t:.2f} s (nvcc sm_90a, 3 kernels)")
    for line in _build.cuda_build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("build: ptxas" + line.split("ptxas", 1)[-1])

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

    enc, elen = encode_blocks.encode_blocks(frames, lens)
    enc, elen = enc.cpu(), elen.cpu()
    penc, pelen = encode_blocks._encode_blocks_plain(frames_h, lens_h)
    assert torch.equal(elen, pelen), ("encode_blocks lengths", elen, pelen)
    e_err = 0
    for k, n in enumerate(elen.tolist()):
        d = (enc[k, :n].to(torch.int32) - penc[k, :n].to(torch.int32)).abs()
        e_err = max(e_err, int(d.max()) if n else 0)
    err["encode_blocks"] = e_err
    assert e_err == 0, "encode_blocks bytes differ from the plain version"
    streams = [enc[k, :n].numpy().tobytes() for k, n in enumerate(elen.tolist())]

    cases = [(s, len(b)) for s, b in zip(streams, blocks)]
    cases += payloads.malformed_chunks()
    for s, n in zip(streams, (len(b) for b in blocks)):
        if s:
            cases += [(s[:cut], n) for cut in (1, len(s) // 3, len(s) // 2, len(s) - 1)]
    comp, offsets = ragged([c for c, _ in cases])
    declared = torch.tensor([n for _, n in cases], dtype=torch.int32)
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
    print(f"kernels: crc32c, encode_blocks, decode_chunks equal their plain versions "
          f"on {len(blocks)} blocks and {len(cases) - len(blocks)} malformed/truncated "
          f"streams (tolerance: exact)")

    # 4. main path -----------------------------------------------------------
    payload = payloads.mixed_payload()
    for mod in mods.values():
        mod.LAUNCHES = 0
    stream = api.encode_framed(payload, device=dev)
    decoded = api.decode_framed(stream, device=dev)
    launches = {name: mod.LAUNCHES for name, mod in mods.items()}
    digest = hashlib.sha256(stream).hexdigest()
    assert digest == payloads.GOLDEN_SHA256, ("digest", digest)
    assert decoded == payload, "decode_framed did not return the payload"
    print(f"main: {len(payload)} bytes -> {len(stream)} framed bytes, sha256 {digest} "
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
    print("main: error order ok (crc@5 + invalid@9 -> crc; invalid@5 + crc@9 -> "
          "invalid); check_integrity=False accepts the bad CRC")

    # 5. counters ------------------------------------------------------------
    print(f"counters: main-path launches {launches}")
    for name, n in launches.items():
        assert n > 0, f"the main path never launched {name}"

    # 6. timings -------------------------------------------------------------
    nf = payloads.MAIN_PATH_FRAMES
    arr = np.frombuffer(payload, dtype=np.uint8)[: nf * 65536]
    big = torch.from_numpy(arr.copy()).view(nf, 65536).to(dev)
    big_lens = torch.full((nf,), 65536, dtype=torch.int32, device=dev)
    crc_out = torch.empty(nf, dtype=torch.uint32, device=dev)
    big_enc = torch.empty((nf, encode_blocks.ENC_CAP), dtype=torch.uint8, device=dev)
    big_elen = torch.empty(nf, dtype=torch.int32, device=dev)
    encode_blocks._launch(big, big_lens, big_enc, big_elen)
    big_elen_h = big_elen.cpu()
    big_enc_h = big_enc.cpu().numpy()
    bcomp, boffs = ragged([big_enc_h[k, :n].tobytes() for k, n in enumerate(big_elen_h.tolist())])
    bcomp, boffs = bcomp.to(dev), boffs.to(dev)
    big_out = torch.empty((nf, 65536), dtype=torch.uint8, device=dev)
    big_ok = torch.empty(nf, dtype=torch.bool, device=dev)
    big_w = torch.empty(nf, dtype=torch.int32, device=dev)
    main_shape = {
        "crc32c": lambda: crc32c._launch(big, big_lens, crc_out),
        "encode_blocks": lambda: encode_blocks._launch(big, big_lens, big_enc, big_elen),
        "decode_chunks": lambda: decode_chunks._launch(bcomp, boffs, big_lens, big_out, big_ok, big_w),
    }
    decode_chunks._launch(bcomp, boffs, big_lens, big_out, big_ok, big_w)
    assert bool(big_ok.all()) and torch.equal(big_out, big), "768-chunk decode"

    s_out = torch.empty(len(blocks), dtype=torch.uint32, device=dev)
    s_enc = torch.empty((len(blocks), encode_blocks.ENC_CAP), dtype=torch.uint8, device=dev)
    s_elen = torch.empty(len(blocks), dtype=torch.int32, device=dev)
    s_comp, s_offs = ragged(streams)
    s_comp, s_offs = s_comp.to(dev), s_offs.to(dev)
    s_dout = torch.empty((len(blocks), 65536), dtype=torch.uint8, device=dev)
    s_ok = torch.empty(len(blocks), dtype=torch.bool, device=dev)
    s_w = torch.empty(len(blocks), dtype=torch.int32, device=dev)
    small_kernel = {
        "crc32c": lambda: crc32c._launch(frames, lens, s_out),
        "encode_blocks": lambda: encode_blocks._launch(frames, lens, s_enc, s_elen),
        "decode_chunks": lambda: decode_chunks._launch(s_comp, s_offs, lens, s_dout, s_ok, s_w),
    }
    s_comp_h, s_offs_h = s_comp.cpu(), s_offs.cpu()
    s_pout = torch.empty((len(blocks), 65536), dtype=torch.uint8)
    small_plain = {
        "crc32c": lambda: crc32c._crc32c_plain(frames_h, lens_h),
        "encode_blocks": lambda: encode_blocks._encode_blocks_plain(frames_h, lens_h),
        "decode_chunks": lambda: decode_chunks._decode_chunks_plain(s_comp_h, s_offs_h, lens_h, s_pout),
    }
    rows = []
    for name, (source, replaces) in KERNELS.items():
        ms = event_ms(main_shape[name], 10)
        ms8 = event_ms(small_kernel[name], 10)
        plain_ms = host_ms(small_plain[name], 1)
        print(f"timing: {name} kernel {ms:.4f} ms for {nf} x 64 KiB chunks "
              f"({nf * 65536 / ms / 1e6:.2f} GB/s); on the 8-chunk set kernel "
              f"{ms8:.4f} ms, plain {plain_ms:.2f} ms ({plain_ms / len(blocks):.2f} ms "
              f"per chunk) {tag}")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                     "ms_8_chunks": ms8, "chunks": nf, "plain_chunks": len(blocks)})

    def e2e(fn, reps=3):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return min(times), statistics.median(times)

    for name, fn in (("encode_framed", lambda: api.encode_framed(payload, device=dev)),
                     ("decode_framed", lambda: api.decode_framed(stream, device=dev))):
        best, med = e2e(fn)
        print(f"timing: {name} {len(payload)} bytes: best {best * 1e3:.2f} ms "
              f"({len(payload) / best / 1e9:.3f} GB/s), median {med * 1e3:.2f} ms "
              f"({len(payload) / med / 1e9:.3f} GB/s) {tag}")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
