"""The controls of ``correct``: runs of a cell that must come out not correct.

    python3 benchmark/control.py --workload beacon_state.encode_step --seeds 1,2,3 --seconds 1

runs the cell once a seed, in one process, with its control switched in,
and prints one JSON line a seed with the numbers compared and ``correct``.
The benchmark's own runs never run a control.

The controls break one guarantee that the configurations state:

* ``array`` (encode cells): the program's own array route
  (``SNAPPY_TPU_TORCH_DEVICE_KERNEL=xla``), whose encoder writes valid
  streams that are not the level-1 encoder's bytes;
* ``crc_head`` (decode cells): K1 replaced by the reference's masked
  CRC32C of each row's first 4 KiB only, a checksum that reads less of
  each chunk;
* a step kind of its own (``entries/<entry>.py``) names its control there,
  as ``CONTROL = (name, context manager)``: ``api_decode``'s
  ``no_integrity`` calls the API with ``check_integrity=False``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HEAD = 4096  # bytes of a row that the crc_head control reads
ROUTE_VAR = "SNAPPY_TPU_TORCH_DEVICE_KERNEL"


@contextlib.contextmanager
def array_route():
    prev = os.environ.get(ROUTE_VAR)
    os.environ[ROUTE_VAR] = "xla"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(ROUTE_VAR, None)
        else:
            os.environ[ROUTE_VAR] = prev


@contextlib.contextmanager
def crc_head():
    import numpy as np
    import torch

    from benchmark.reference import crc32c as ref_crc
    from snappy_tpu_torch.ops import crc32c

    real = crc32c.masked_crc32c_chunks

    def head(chunks_u8, lengths):
        lens = np.minimum(lengths.cpu().numpy(), HEAD)
        got = ref_crc.masked_crc32c_rows(chunks_u8, lens)
        return torch.from_numpy(got.view(np.int32)).to(chunks_u8.device).view(torch.uint32)

    crc32c.masked_crc32c_chunks = head
    try:
        yield
    finally:
        crc32c.masked_crc32c_chunks = real


CONTROLS = {"encode": ("array", array_route), "decode": ("crc_head", crc_head)}  # by the step's kind


def control_of(cell):
    """(name, context manager) of the control of ``cell``'s step kind."""
    entry = cell.traffic["entry"]
    if entry in CONTROLS:
        return CONTROLS[entry]
    from benchmark.lib import kinds

    return kinds.module(cell.bench_dir, entry).CONTROL


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    from benchmark.lib import cells, device, harness

    cell = cells.load(args.workload)
    dev = device.require_cards(cell.chips)
    name, control = control_of(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with control():
            line, checks = harness.execute(cell, seed, args.seconds, False, t0, dev)
        print(json.dumps({"workload": cell.name, "control": name, "seed": seed, "correct": line["correct"],
                          "steps": line["attempted"], "checks": {n: v for n, v, _ in checks},
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
