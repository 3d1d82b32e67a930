"""The port against google/snappy: the third-party differential's data,
its pinned verdicts, and the decode routes it drives.

JAX counterpart: tests/test_cpp_differential.py's mutation agreement
(google/snappy's verdict and bytes on every stream), here over the port's
decode routes.  chip_smoke.py's phase 13 runs it on the card and
tests/test_torch_cpp_differential.py on the CPU.

* ``battery(seeds)`` — the three sets of streams: the 600
  ``payloads.mutation_streams`` (host C encodings of seeded payloads, 60%
  mutated), google/snappy's encodings of ``seed_payloads()`` with 400
  mutants of them (``seed_mutants``), and the far-copy battery
  (``payloads.farcopy_placement_cases``).
* ``PINS`` (``cpp_pins.json``, written by ``tools/pin_cpp_snappy.py``
  where ``libsnappy.so.1`` loads) — google/snappy's encodings of the seed
  payloads, its verdict on every stream of the battery as the SHA-256 of
  its output (None where it rejects the stream), and its view of the
  port's encodings of the 48 MiB payload and the serving batch (they
  decode back; its own sizes).  A machine without the library holds the
  port to these.
* ``ROUTES`` and ``run_route`` — every device decode route of the port:
  the batch decoder (K2 at both shapes), the raw decode in grid mode (K2
  up to 128 KiB, then K4) and in scan mode (K5, whose ``unsupported``
  goes to K4), the array route, and the streaming decoders on every
  stream whatever its size (K4 on its window route or its walk; K5,
  then K4 on ``unsupported``).
"""

from __future__ import annotations

import base64
import contextlib
import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from .. import config, engine
from ..formats import varint
from ..ops import decode_stream
from . import payloads

PINS = Path(__file__).with_name("cpp_pins.json")
MUTATION_STREAMS = 600  # payloads.mutation_streams(MUTATION_STREAMS)
SEED_MUTANTS = 400  # mutants of google/snappy's seed encodings
SETS = ("mutation_streams", "seed_mutants", "farcopy")
ROUTES = ("decode_batch", "decode grid", "decode scan", "array", "K4", "K5")
DIRECT_CAP = 64 << 20  # the streaming decoders run directly on declared lengths up to this


def seed_payloads(seed: int = 91) -> List[bytes]:
    """The payloads whose google/snappy encodings seed the mutants: 20 of
    30-599 bytes, half a repeated 2-16 byte word then random bytes (the
    JAX differential's ``_payload``); 8 slices of the mixed payload of
    1-8 KB; 3 of 140-200 KB (runs, a sixteenth of text, period-8 data, so
    that their encodings stay small), which decode above 128 KiB on the
    streaming decoders."""
    rng = payloads.Rand(seed)

    def draw(lo: int, hi: int) -> int:
        return int(rng.ints(lo, hi, 1)[0])

    out = []
    for _ in range(20):
        n = draw(30, 600)
        word = rng.bytes(draw(2, 17)).tobytes()
        rep = (word * (n // len(word) + 1))[: n // 2]
        out.append(rep + rng.bytes(n - len(rep)).tobytes())
    for _ in range(8):
        out.append(payloads.mixed_payload(draw(1000, 8000), seed=draw(0, 1 << 30)))
    for n in (140_000, 170_000, 200_000):
        text = payloads.KINDS["text"](rng, n // 16).tobytes()
        out.append(payloads.KINDS["runs"](rng, n // 2).tobytes() + text
                   + payloads.KINDS["period8"](rng, n - n // 2 - len(text)).tobytes())
    return out


def seed_mutants(seeds: List[bytes], count: int = SEED_MUTANTS, seed: int = 97) -> List[Tuple[bytes, str]]:
    """The seed streams themselves ("valid"), then ``count`` mutants of
    them in turn, one mutation each (``payloads.mutate``): (stream, kind)."""
    rng = payloads.Rand(seed)
    out = [(s, "valid") for s in seeds]
    for t in range(count):
        kind = payloads.MUTATIONS[int(rng.ints(0, len(payloads.MUTATIONS), 1)[0])]
        out.append((payloads.mutate(seeds[t % len(seeds)], kind, rng), kind))
    return out


def battery(seeds: List[bytes]) -> Dict[str, List[Tuple[bytes, str]]]:
    """The three sets, each a list of (raw stream, kind): the mutation
    streams, the seeds and their mutants, the far-copy battery (kind
    "farcopy k" for its stream kind k, see
    ``payloads.farcopy_placement_cases``)."""
    farcopy = payloads.farcopy_placement_cases()
    return {
        "mutation_streams": payloads.mutation_streams(MUTATION_STREAMS),
        "seed_mutants": seed_mutants(seeds),
        "farcopy": [(s, f"farcopy {k % 3}") for k, (s, _) in enumerate(farcopy)],
    }


def digest(out: Optional[bytes]) -> Optional[str]:
    """A verdict as the pins keep it: the SHA-256 of the output, or None
    for a rejected stream."""
    return None if out is None else hashlib.sha256(out).hexdigest()


def list_digest(streams: List[bytes]) -> str:
    """The SHA-256 of a list of streams, each after its length as 8 bytes
    little-endian."""
    h = hashlib.sha256()
    for s in streams:
        h.update(len(s).to_bytes(8, "little"))
        h.update(s)
    return h.hexdigest()


def load_pins() -> dict:
    with open(PINS) as f:
        pins = json.load(f)
    pins["seeds"] = [base64.b64decode(s) for s in pins["seeds"]]
    return pins


@contextlib.contextmanager
def env(name: str, value: str) -> Iterator[None]:
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


def _direct(stream: bytes, mode: str, device) -> Tuple[bool, Optional[bytes], Optional[str]]:
    """(ran, payload or None, the first verdict) of one stream through the
    streaming decoder in ``mode`` alone; scan's ``unsupported`` goes on to
    grid mode, as in ``engine.raw_uncompress``.  Not run (ran False) where
    the declared length is unreadable, 0 or above ``DIRECT_CAP``."""
    declared, read = varint.decode_uint32(stream)
    if declared is None or declared == 0 or declared > DIRECT_CAP:
        return False, None, None
    body = stream[read:]
    out, reason = decode_stream.decode_raw_stream_bytes(body, declared, mode=mode, device=device)
    first = reason
    if reason == "unsupported":
        out, reason = decode_stream.decode_raw_stream_bytes(body, declared, mode="grid", device=device)
    return True, (out if reason == "ok" else None), first


def run_route(route: str, streams: List[bytes], device: config.DeviceLike = None
              ) -> Tuple[List[int], List[Optional[bytes]], List[Optional[str]]]:
    """(indices, outputs, first verdicts) of ``streams`` through ``route``
    (one of ``ROUTES``) on ``device``: the output is the payload or None
    for a rejected stream.  The routes of the engine take every stream;
    K4 and K5 the streams whose declared length is 1 to ``DIRECT_CAP``,
    and their first verdict is the streaming decoder's own ("ok",
    "invalid", or for K5 "unsupported" before K4 took the stream)."""
    if route in ("K4", "K5"):
        idx, outs, firsts = [], [], []
        for i, s in enumerate(streams):
            ran, out, first = _direct(s, "grid" if route == "K4" else "scan", device)
            if ran:
                idx.append(i)
                outs.append(out)
                firsts.append(first)
        return idx, outs, firsts
    if route == "decode_batch":
        outs = [out for out, _ in engine.raw_uncompress_batch(streams, device=device, backend="device")]
    elif route == "array":
        with env("SNAPPY_TPU_TORCH_DEVICE_KERNEL", "xla"):
            outs = [engine.raw_uncompress(s, device=device, backend="device")[0] for s in streams]
    else:
        with env("SNAPPY_TPU_TORCH_STREAM_MODE", route.split()[1]):
            outs = [engine.raw_uncompress(s, device=device, backend="device")[0] for s in streams]
    return list(range(len(streams))), outs, [None] * len(streams)


def disagreements(want: List[Optional[str]], idx: List[int], outs: List[Optional[bytes]]
                  ) -> List[Tuple[int, str]]:
    """(stream index, "verdict" or "bytes") where an output differs from
    the pinned or live verdict ``want`` (one per stream)."""
    bad = []
    for i, out in zip(idx, outs):
        if (out is None) != (want[i] is None):
            bad.append((i, "verdict"))
        elif out is not None and digest(out) != want[i]:
            bad.append((i, "bytes"))
    return bad
