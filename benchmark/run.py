"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload beacon_state.encode_step --seed 7 --seconds 10 --trace 0

from the root of a checkout of the repository, on a machine with the
cards the cell asks for.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a ``torch.profiler``
trace of the window.  The last line of standard output is the result
(JSON); the last lines of standard error are the numbers compared with
the reference, each with its limit.  Without a card, or with fewer than
the cell asks for, the run prints no result and exits 2.
"""

import time

T0 = time.perf_counter()  # set-up starts here, before the imports

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# kernel caches at fixed paths inside the checkout (the port's own build
# directory is build/snappy_tpu_torch there)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from benchmark.lib import harness

    return harness.main(args.workload, args.seed, args.seconds, bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
