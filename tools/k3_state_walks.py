"""K3's walks on the frames of the benchmark's beacon state, by region.

    python3 tools/k3_state_walks.py [--seed S] [--reps N] [--out FILE]

from the root of a checkout, on a CUDA card.  It makes the mainnet beacon
state of ``benchmark/configs/beacon_state`` on the card from ``--seed``,
as the cell ``beacon_state.encode_step`` does, cuts it into its 64 KiB
frames, and runs ``snappy_tpu_torch.testing.encode_layouts.measure`` on
them beside the seeded 48 MiB payload: the package launch's time, each
frame's walk cycles by phase, the makespans of the launch's orders, and
the walk cycles of the state's regions (roots and randao, validators,
balances and participation, inactivity and the tail).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REGIONS = ("roots and randao", "validators", "balances and participation", "inactivity and the tail")


def state_regions(cfg: dict, size: int, frame: int = 65536):
    """(region, first frame, end frame) of each of REGIONS in the beacon
    state of ``cfg`` (``size`` bytes): the lists at the state's end are, in
    generate.py's order, the validators, balances, the two participation
    lists, the inactivity scores, then the execution payload header and the
    queues."""
    v = cfg["validators"]
    tail = (436 + 4 + 144 + cfg["extra_data_bytes"] + 64 * cfg["historical_summaries"]
            + 192 * cfg["pending_deposits"] + 24 * cfg["pending_partial_withdrawals"]
            + 16 * cfg["pending_consolidations"])
    inactivity = size - tail - 8 * v
    balances = inactivity - 10 * v
    validators = balances - cfg["validator_bytes"] * v
    edges = [0] + [b // frame for b in (validators, balances, inactivity)] + [-(-size // frame)]
    return [(r, edges[k], edges[k + 1]) for k, r in enumerate(REGIONS)]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=3_000_000_102, help="the beacon state's seed")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--out", default=None, help="write every number, as JSON, here")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k3_state_walks: torch.cuda is not available")
    from benchmark.lib import cells, frames
    from snappy_tpu_torch.testing import encode_layouts

    dev = torch.device("cuda:0")
    cell = cells.load("beacon_state.encode_step")
    state, sizes = cell.generator().make(cell.config, args.seed, dev)
    table = frames.table(sizes, 65536)
    batches = encode_layouts.payload_batch(dev)
    batches["state"] = (frames.rows(state, table, 65536),
                        torch.from_numpy(table.length.astype(np.int32)).to(dev))
    regions = state_regions(cell.config, sizes[0])
    del state
    print(f"state: {sizes[0]:,} bytes, {len(table.length):,} frames (seed {args.seed}); regions "
          + ", ".join(f"{r} frames {lo}-{hi - 1}" for r, lo, hi in regions))
    result, per_frame = encode_layouts.measure(batches, args.reps, {"state": regions})
    encode_layouts.write({**result, "regions": regions}, per_frame, args.out)


if __name__ == "__main__":
    main()
