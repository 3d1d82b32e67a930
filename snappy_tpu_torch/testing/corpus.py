"""Locate the Snappy benchmark corpus and its golden files.

JAX counterpart: snappy_tpu/testing/corpus.py (the same locators).

The reference ships the standard corpus (``tests/data``) and framed
streams made from it (``tests/stream_compressed``); the golden
``.rawsnappy`` file was written by C++ google/snappy.  The port reads them
in place from the directory that ``SNAPPY_TPU_TORCH_CORPUS`` names (the
one holding ``data/``), read at each call.  Where it is not set or holds
no ``data/``, every locator returns None or an empty list, and the tests
that need the corpus skip.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

# The benchmark corpus (nim-snappy tests/benchmark.nim, README.md table).
CORPUS_FILES = [
    "html",
    "urls.10K",
    "fireworks.jpeg",
    "paper-100k.pdf",
    "html_x_4",
    "alice29.txt",
    "asyoulik.txt",
    "lcet10.txt",
    "plrabn12.txt",
    "geo.protodata",
    "kppkn.gtb",
    "Mark.Twain-Tom.Sawyer.txt",
]

BAD_FILES = ["baddata1.snappy", "baddata2.snappy", "baddata3.snappy"]

# Framed streams made from the corpus: (compressed, plaintext) pairs
# (test_framed.nim:117-119 decodes all three).
STREAM_FILES = [
    ("alice29.txt.sz-32k", "alice29.txt"),
    ("alice29.txt.sz-64k", "alice29.txt"),
    ("house.jpg.sz", "house.jpg"),
]

GOLDEN_RAWSNAPPY = "Mark.Twain-Tom.Sawyer.txt.rawsnappy"


def corpus_root() -> Optional[Path]:
    root = os.environ.get("SNAPPY_TPU_TORCH_CORPUS")
    if root and (Path(root) / "data").is_dir():
        return Path(root)
    return None


def data_path(name: str) -> Optional[Path]:
    root = corpus_root()
    if root is None:
        return None
    p = root / "data" / name
    return p if p.is_file() else None


def stream_path(name: str) -> Optional[Path]:
    root = corpus_root()
    if root is None:
        return None
    p = root / "stream_compressed" / name
    return p if p.is_file() else None


def read_data(name: str) -> Optional[bytes]:
    p = data_path(name)
    return p.read_bytes() if p else None


def read_stream(name: str) -> Optional[bytes]:
    p = stream_path(name)
    return p.read_bytes() if p else None


def available_corpus() -> List[str]:
    return [n for n in CORPUS_FILES if data_path(n)]
