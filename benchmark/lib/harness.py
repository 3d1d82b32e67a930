"""One run of one cell: set-up, the measured window, the check, the result.

Set-up makes the cell's messages from the seed on the device, keeps a
host copy for the reference, stages the step's inputs and runs the
traffic's warm-up steps, which build or load every kernel the window
runs.  The window then runs steps back to back (a closed loop of one
client) until ``seconds`` have passed, each timed by CUDA events from its
first launch to its end, and the host clock around the whole.  With
``trace`` the window, cut to ``TRACE_WINDOW_S``, runs under
``torch.profiler``.  Once it has closed, the peak device memory is read,
the step's inputs are freed, and the reference judges the last step's
outputs.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.lib import cells, device as devinfo, steps as step_kinds, trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "snappy_tpu")  # top-level module names
TRACE_WINDOW_S = 10.0  # a traced window's longest: its trace stays near 100 MB


@dataclass
class Run:
    """What the metric readers read."""
    cell: str
    payload_bytes: int
    setup_s: float = 0.0
    steps: int = 0
    failed: int = 0
    window_s: float = 0.0
    step_ms: List[float] = field(default_factory=list)
    memory_peak_bytes: int = 0
    work: Dict[str, float] = field(default_factory=dict)
    trace: Optional[tracing.Trace] = None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _window(step, seconds: float, dev: torch.device, traced: bool):
    """Run steps until ``seconds`` have passed; (last outputs, steps,
    failed steps, window seconds, each step's ms, profiler or None)."""
    cuda = dev.type == "cuda"
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        seconds = min(seconds, TRACE_WINDOW_S)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks: List[Tuple] = []
    n = failed = 0
    last = None
    with prof if prof is not None else contextlib.nullcontext():
        start = time.perf_counter()
        while True:
            last = None  # a caller keeps no step's results past the next
            scope = torch.profiler.record_function(tracing.STEP) if traced else contextlib.nullcontext()
            with scope:
                if cuda:
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                    last = step()
                    b.record()
                    torch.cuda.synchronize()
                    marks.append((a, b))
                else:
                    t = time.perf_counter()
                    last = step()
                    marks.append((t, time.perf_counter()))
            n += 1
            failed += step.failed(last)
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
    step_ms = [a.elapsed_time(b) if cuda else (b - a) * 1e3 for a, b in marks]
    return last, n, failed, window_s, step_ms, prof


def execute(cell: cells.Cell, seed: int, seconds: float, traced: bool, t0: float,
            dev: torch.device) -> Tuple[dict, List[Tuple[str, float, float]]]:
    """The result line (without its ``checks``) and the numbers compared."""
    data, sizes = cell.generator().make(cell.config, seed, dev)
    host = data.cpu().numpy()  # the reference's copy, taken before the program sees the data
    step = step_kinds.make(cell.traffic, cell.config, data, sizes, host, dev, cell.bench_dir)
    del data
    if hasattr(step, "describe"):
        sys.stderr.write(f"{cell.name} seed {seed}: {step.describe()}\n")
    for _ in range(cell.traffic["warmup_steps"]):
        step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    run = Run(cell=cell.name, payload_bytes=step.payload_bytes, setup_s=time.perf_counter() - t0)
    last, run.steps, run.failed, run.window_s, run.step_ms, prof = _window(step, seconds, dev, traced)
    sys.stderr.write(f"steps {run.steps} in {run.window_s:.3f} s, {run.failed} failed\n")
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    run.work = step.work(last)
    if prof is not None:
        run.trace = tracing.read(prof, run.steps)
    step.release()
    t_check = time.perf_counter()
    checks = step.check(last, host, sizes, seed, dev)
    sys.stderr.write(f"reference check {time.perf_counter() - t_check:.1f} s\n")
    checks.append(("failed_steps", run.failed, 0))
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = run.steps > 0 and all(v <= lim for _, v, lim in checks)
    line = {"correct": bool(correct), "attempted": run.steps, "failed": run.failed, "metrics": metrics}
    if dev.type == "cuda":
        line["device"] = devinfo.record(dev, cell.chips, run.memory_peak_bytes)
    else:
        line["device"] = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.trace is not None:
        line["device"]["busy_s"] = run.trace.busy_s
        line["device"]["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                             "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    return line, checks


def main(workload: str, seed: int, seconds: float, traced: bool, t0: float) -> int:
    cell = cells.load(workload)
    dev = devinfo.require_cards(cell.chips)
    line, checks = execute(cell, seed, seconds, traced, t0, dev)
    bad = forbidden_modules()
    if bad:
        sys.stderr.write(f"modules loaded that the port must not use: {', '.join(bad)}\n")
        return 3
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    for name, value, limit in checks:
        sys.stderr.write(f"check {name} {value} limit {limit}\n")
    return 0
