"""Cells cut to a few frames, run on the CPU through the program's plain paths."""

import time

import torch

from benchmark.lib import cells, harness

# sizes that keep a CPU run to a second or two; widths stay the spec's
TINY = {
    "beacon_state": dict(validators=256, epochs_per_historical_vector=64, slots_per_historical_root=64,
                         epochs_per_slashings_vector=64, historical_roots=8, eth1_data_votes=8,
                         historical_summaries=8, pending_deposits=8),
    "blob_sidecars": dict(responses=1, sidecars_per_response=4),
}
CELLS = ("beacon_state.encode_step", "beacon_state.decode_step",
         "blob_sidecars.decode_step", "blob_sidecars.encode_step")


def tiny_cell(name: str, sample_frames: int = 4) -> cells.Cell:
    cell = cells.load(name)
    cell.config = dict(cell.config, **TINY[cell.config_name])
    cell.traffic = dict(cell.traffic, warmup_steps=0, sample_frames=sample_frames)
    return cell


def run_cpu(name: str, seed: int = 2**31 + 5, sample_frames: int = 4):
    """(result line, {check: value}) of one short run of the tiny cell."""
    line, checks = harness.execute(tiny_cell(name, sample_frames), seed, 0.0, False, time.perf_counter(),
                                   torch.device("cpu"))
    return line, {n: v for n, v, _ in checks}
