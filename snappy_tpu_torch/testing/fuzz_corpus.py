"""The seed corpus of the sanitizer and fuzz legs, from fixed seeds.

JAX counterpart: tools/gen_corpus.py, whose regimes are copied here (the
port imports nothing under tools/): wordy text (copy-rich), markup (mixed
literal and copy), runs (overlapping copies), incompressible bytes, a small
text and three hand-made malformed raw streams, the same bytes as that
script writes.  To them ``write`` adds the malformed raw vectors of
``payloads.MALFORMED_RAW`` and a share of ``payloads.mutation_streams``;
``kernel_seeds`` adds the raw streams that reach the decoders' window
routes (``payloads.window_cases``, ``stream_cases``, ``scan_window_cases``,
``scan_edge_cases``, ``scan_differential_cases``, ``big_window_cases``),
for the twins' fuzzer.  Raw streams are written with their varint header.

    python -m snappy_tpu_torch.testing.fuzz_corpus OUTDIR
"""

from __future__ import annotations

import random
import sys
from pathlib import Path
from typing import List

from ..formats import varint
from . import payloads

MUTATION_SEEDS = 8  # of payloads.mutation_streams, in write()


def _words(rng, n_vocab=800):
    vocab = []
    for _ in range(n_vocab):
        ln = rng.randint(2, 11)
        vocab.append("".join(rng.choice("etaoinshrdlucmfwypvbgkjqxz") for _ in range(ln)))
    return vocab


def gen_text(rng, size):
    """English-like text: zipfy word reuse gives snappy real matches."""
    vocab = _words(rng)
    out = []
    total = 0
    while total < size:
        w = vocab[min(int(rng.expovariate(1 / 80.0)), len(vocab) - 1)]
        out.append(w)
        total += len(w) + 1
    return " ".join(out).encode()[:size]


def gen_markup(rng, size):
    """HTML-ish markup: long repeated tags and varying attribute text."""
    tags = ["<div class='r%d'>", "<span id='x%d'>", "<a href='/p/%d'>", "<td>%d</td>"]
    out = []
    total = 0
    while total < size:
        t = rng.choice(tags) % rng.randint(0, 999)
        out.append(t)
        total += len(t)
    return "".join(out).encode()[:size]


def gen_rle(rng, size):
    """Long single-byte runs: overlapping-copy expansion."""
    out = bytearray()
    while len(out) < size:
        out += bytes([rng.randint(0, 255)]) * rng.randint(30, 4000)
    return bytes(out[:size])


def gen_random(rng, size):
    """Incompressible: every block stored as a literal."""
    return bytes(rng.getrandbits(8) for _ in range(size))


def gen_baddata(rng, kind):
    """Hand-made malformed raw streams."""
    if kind == 0:  # declared length far beyond the payload
        return b"\xff\xff\xff\x7f" + bytes(rng.getrandbits(8) for _ in range(64))
    if kind == 1:  # copy with offset 0
        return b"\x08" + b"\x04aaaa" + b"\x01\x00"
    return b"\x20\xf0"  # truncated extended literal


def generated() -> dict:
    """tools/gen_corpus.py's files: name -> bytes."""
    rng = random.Random(0xC0FFEE)
    return {
        "gen_text.txt": gen_text(rng, 180_000),
        "gen_markup.html": gen_markup(rng, 120_000),
        "gen_rle.bin": gen_rle(rng, 100_000),
        "gen_random.bin": gen_random(rng, 80_000),
        "gen_small.txt": gen_text(rng, 900),
        "gen_bad1.snappy": gen_baddata(rng, 0),
        "gen_bad2.snappy": gen_baddata(rng, 1),
        "gen_bad3.snappy": gen_baddata(rng, 2),
    }


def _write_all(outdir: Path, files: dict) -> List[Path]:
    outdir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, blob in files.items():
        path = outdir / name
        path.write_bytes(blob)
        paths.append(path)
    return paths


def write(outdir, mutation_seeds: int = MUTATION_SEEDS) -> List[Path]:
    """Write the corpus of every leg into ``outdir``: the generated files,
    the non-empty malformed raw vectors and the first ``mutation_seeds``
    mutation streams.  Returns the paths."""
    files = generated()
    for k, v in enumerate(payloads.MALFORMED_RAW):
        if v:
            files[f"malformed_{k:02d}.snappy"] = v
    for k, (stream, kind) in enumerate(payloads.mutation_streams(mutation_seeds)):
        files[f"mutation_{k:02d}_{kind}.snappy"] = stream
    return _write_all(Path(outdir), files)


def kernel_seeds(outdir) -> List[Path]:
    """Write the raw streams that reach the decoders' window routes,
    deferred windows, far copies and the scan's edges into ``outdir``."""
    files = {}
    groups = {
        "window": payloads.window_cases(),
        "stream": payloads.stream_cases(),
        "scan_window": payloads.scan_window_cases(),
        "scan_edge": payloads.scan_edge_cases(),
        "scan_diff": payloads.scan_differential_cases(),
        "big_window": payloads.big_window_cases(),
    }
    for group, cases in groups.items():
        for k, case in enumerate(cases):
            body, declared = case[0], case[1]
            files[f"{group}_{k:02d}.snappy"] = varint.encode_uint32(declared) + body
    return _write_all(Path(outdir), files)


if __name__ == "__main__":
    out = Path(sys.argv[1] if len(sys.argv) > 1 else "build/snappy_tpu_torch/corpus")
    paths = write(out) + kernel_seeds(out / "kernel_seeds")
    print(f"wrote {len(paths)} corpus files to {out}")
