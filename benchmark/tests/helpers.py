"""Cells cut to a few frames, run on the CPU through the program's plain paths.

The cells are those of ``BENCHMARK.json``.  A configuration's CPU size is
``tiny.json`` beside its ``config.json``: the keys it sets over the
configuration keep a CPU run to a second or two and leave every width as
the spec's.  So a cell that a later change adds, of any configuration and
step kind, is cut and run here from its own files.
"""

import json
import time
from pathlib import Path

import torch

from benchmark.lib import cells, harness

SPEC = cells.read_spec()
CELLS = tuple(w["name"] for w in SPEC["workloads"])


def tiny_sizes(config_dir: Path) -> dict:
    return json.loads((config_dir / "tiny.json").read_text())


TINY = {c["name"]: tiny_sizes((cells.ROOT / c["file"]).parent) for c in SPEC["configs"]}


def tiny_cell(name: str, sample_frames: int = 4, root: Path = cells.ROOT) -> cells.Cell:
    cell = cells.load(name, root=root)
    cell.config = dict(cell.config, **tiny_sizes(cell.config_dir))
    cell.traffic = dict(cell.traffic, warmup_steps=0, sample_frames=sample_frames)
    return cell


def run_cell(cell: cells.Cell, seed: int = 2**31 + 5, traced: bool = False):
    """(result line, {check: value}) of one short run of ``cell`` on the CPU."""
    line, checks = harness.execute(cell, seed, 0.0, traced, time.perf_counter(), torch.device("cpu"))
    return line, {n: v for n, v, _ in checks}


def run_cpu(name: str, seed: int = 2**31 + 5, sample_frames: int = 4, root: Path = cells.ROOT):
    """(result line, {check: value}) of one short run of the tiny cell."""
    return run_cell(tiny_cell(name, sample_frames, root), seed)
