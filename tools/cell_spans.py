"""The port's spans in each benchmark cell's step, without a profiler.

    python3 tools/cell_spans.py [--cells CELL ...] [--seed N] [--rounds 3]

from the root of a checkout, on a CUDA card.  For each cell of
``BENCHMARK.json`` it stages the cell's step as ``benchmark/run.py`` does
and runs it in turns: steps with the spans off, then steps inside
``snappy_tpu_torch.telemetry.recording()``, each step followed by a
synchronize.  It prints the step's host ms both ways and, per step, each
span's total, self and outermost ms, its calls and the reads it declares:
where the host time of an untraced step goes inside the port.  Every line
names the card and its power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = {  # steps a round: about a second of each cell
    "beacon_state.encode_step": 60, "beacon_state.decode_step": 300,
    "blob_sidecars.decode_step": 2000, "blob_sidecars.encode_step": 120,
}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", nargs="*", default=list(STEPS))
    p.add_argument("--seed", type=int, default=3_000_000_102)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cell_spans: torch.cuda is not available")
    from benchmark.lib import cells, steps as step_kinds
    from snappy_tpu_torch import telemetry

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    for k, name in enumerate(args.cells):
        cell = cells.load(name)
        data, sizes = cell.generator().make(cell.config, args.seed + k, dev)
        step = step_kinds.make(cell.traffic, cell.config, data, sizes, data.cpu().numpy(), dev, cell.bench_dir)
        del data
        for _ in range(cell.traffic["warmup_steps"]):
            step()
        torch.cuda.synchronize()
        n = STEPS.get(name, 100)

        def host_ms() -> float:
            t = time.perf_counter()
            for _ in range(n):
                step()
                torch.cuda.synchronize()
            return (time.perf_counter() - t) / n * 1e3

        off, on = [], []
        telemetry.reset()
        for _ in range(args.rounds):
            off.append(host_ms())
            with telemetry.recording():
                on.append(host_ms())
        steps = args.rounds * n
        print(f"{name} seed {args.seed + k}: step host ms, spans off {statistics.median(off):.4f} "
              f"({', '.join(f'{x:.4f}' for x in off)}), recording {statistics.median(on):.4f} "
              f"({', '.join(f'{x:.4f}' for x in on)}) [{card}]")
        for span, st in telemetry.spans().items():
            print(f"  {span}: total {st.total_s / steps * 1e3:.4f}, self {st.self_s / steps * 1e3:.4f}, "
                  f"outermost {st.outer_s / steps * 1e3:.4f} ms a step; {st.count / steps:g} calls, "
                  f"{st.reads / steps:g} reads; in {st.parent}")
        telemetry.reset()
        step.release()
        del step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
