"""Pin google/snappy's verdicts for the port's third-party differential.

    PYTHONPATH=. python tools/pin_cpp_snappy.py

Needs the system's ``libsnappy.so.1`` (``snappy_tpu_torch.testing.
cpp_snappy``); imports neither jax nor ``snappy_tpu``.  Writes
``snappy_tpu_torch/testing/cpp_pins.json`` (``cpp_differential.PINS``):

* ``library``: the name of the library file that made the pins (its
  release);
* ``seeds``: google/snappy's encodings of ``cpp_differential.
  seed_payloads()``, in base64, from which ``seed_mutants`` derives its
  mutants on any machine;
* ``verdicts``: for each set of ``cpp_differential.battery`` (the 600
  mutation streams, the seeds and their 400 mutants, the far-copy
  battery), google/snappy's verdict on every stream: the SHA-256 of its
  output, or null where it rejects the stream;
* ``port_streams``: the port's raw streams of the 48 MiB payload at levels
  1 and 2 (the host backend, K3's bytes) and on the array route (its CPU
  version, in pieces of 32 blocks, as ``tools/pin_array_digests.py``
  joins them), and its per-payload encodings of the serving batch's
  inputs (``encode_batch``'s bytes), each with its length, SHA-256 and
  whether google/snappy decodes it back to its payload;
* ``google_sizes``: google/snappy's own stream of the payload and of the
  serving inputs, in bytes.

The card's machine, where the library may not load, holds the port to
these (chip_smoke.py phase 13); tests/test_torch_cpp_differential.py
checks them against the library here.  About 60 s, most of it the array
route.
"""

from __future__ import annotations

import base64
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from snappy_tpu_torch import engine  # noqa: E402
from snappy_tpu_torch.formats import varint  # noqa: E402
from snappy_tpu_torch.testing import cpp_differential as cd  # noqa: E402
from snappy_tpu_torch.testing import cpp_snappy, payloads  # noqa: E402

PIECE = 32 * 65536  # the array route's piece, as in tools/pin_array_digests.py


def array_stream(payload: bytes) -> bytes:
    """The port's raw stream of ``payload`` on the array route on the CPU,
    in pieces (every block is encoded on its own, so the pieces' bodies
    join to the whole payload's)."""
    parts = [varint.encode_uint32(len(payload))]
    with cd.env("SNAPPY_TPU_TORCH_DEVICE_KERNEL", "xla"):
        for lo in range(0, len(payload), PIECE):
            piece = engine.raw_compress(payload[lo : lo + PIECE], device="cpu", backend="device")
            parts.append(payloads.body_of(piece))
    return b"".join(parts)


def main() -> None:
    if not cpp_snappy.available():
        raise SystemExit("pin_cpp_snappy: libsnappy.so.1 does not load here")
    t = time.perf_counter()
    seeds = [cpp_snappy.encode(p) for p in cd.seed_payloads()]
    sets = cd.battery(seeds)
    verdicts = {name: [cd.digest(cpp_snappy.decode(s)) for s, _ in streams]
                for name, streams in sets.items()}

    payload = payloads.mixed_payload()
    inputs = []

    def encode_inputs(ps):
        inputs.extend(ps)
        return [engine.raw_compress(p, backend="host") for p in ps]

    payloads.serving_batch(encode_inputs)
    batch = [engine.raw_compress(p, backend="host") for p in inputs]
    streams = {
        "raw_l1": (engine.raw_compress(payload, 1, backend="host"), payloads.RAW_L1_SHA256),
        "raw_l2": (engine.raw_compress(payload, 2, backend="host"), payloads.RAW_L2_SHA256),
        "array": (array_stream(payload), payloads.RAW_XLA_SHA256),
    }
    port_streams = {}
    for name, (s, pinned) in streams.items():
        if cd.digest(s) != pinned:
            raise SystemExit(f"pin_cpp_snappy: the port's {name} stream is not the pinned one")
        port_streams[name] = {"len": len(s), "sha256": pinned,
                              "google_decodes": cpp_snappy.decode(s) == payload}
    port_streams["encode_batch"] = {
        "len": sum(map(len, batch)), "sha256": cd.list_digest(batch),
        "google_decodes": all(cpp_snappy.decode(s) == p for s, p in zip(batch, inputs)),
    }
    pins = {
        "library": os.path.basename(cpp_snappy.version() or "libsnappy.so.1"),
        "seeds": [base64.b64encode(s).decode() for s in seeds],
        "verdicts": verdicts,
        "port_streams": port_streams,
        "google_sizes": {"payload": len(cpp_snappy.encode(payload)),
                         "serving_inputs": sum(len(cpp_snappy.encode(p)) for p in inputs)},
    }
    with open(cd.PINS, "w") as f:
        json.dump(pins, f, indent=0, sort_keys=True)
        f.write("\n")
    accepted = {name: sum(v is not None for v in vs) for name, vs in verdicts.items()}
    print(f"{cd.PINS}: {pins['library']}; streams accepted / pinned "
          f"{ {n: (accepted[n], len(v)) for n, v in verdicts.items()} }; port streams "
          f"{ {n: (v['len'], v['google_decodes']) for n, v in port_streams.items()} }; google sizes "
          f"{pins['google_sizes']}; {time.perf_counter() - t:.1f} s")


if __name__ == "__main__":
    main()
