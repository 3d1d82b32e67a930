"""The yardstick of the per-layer metrics: peaks, and shares of them.

Peaks of one H100 SXM (NVIDIA's data sheet; dense rates at the full 700 W
power limit; the run records the card's own limit beside them).  A
kernel's least time is max(bytes / HBM bandwidth, operations / peak): the
snappy kernels do byte work with no floating-point or tensor-core
operations to count, so bytes bound them.  Bytes are each input read once
and each output written once, counted from the step's inputs and its
verified outputs by the step kind (``steps.*.work``), whatever the kernel
reads again.
"""

from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
BF16_FLOPS_PER_S = 9.89e14

# substrings of the CUDA kernels' names in the trace (csrc/*.cu)
K1 = ("crc32c_tiles_kernel", "crc32c_fold_kernel")
K2 = ("decode_chunks_kernel",)
K3 = ("encode_blocks_kernel",)


def share(run, kernels, work_key: str, ops: float = 0.0) -> Optional[float]:
    """Percent of ``kernels``' roofline over the traced window, or None
    where the trace holds none of them or the step kind counts no bytes
    for them."""
    tr = run.trace
    if tr is None or work_key not in run.work:
        return None
    t = tr.kernel_time(*kernels)
    if t <= 0:
        return None
    least = max(run.work[work_key] / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * tr.steps
    return 100.0 * least / t
