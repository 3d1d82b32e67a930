"""What a ``torch.profiler`` trace of the window says about the device.

The window is traced with CPU and CUDA activity and every step inside a
``bench/step`` range.  The trace is written as Chrome JSON to a temporary
file, read here, and deleted.  ``summarize`` returns the traced window's
length, the time in which a kernel, copy or fill ran on the card, the
kernels' own union, each kernel's total time, and the idle gaps named by
what the host was doing meanwhile: the innermost host operation that
covers the middle of the gap (``python`` where only the step's range
covers it, ``between steps`` where nothing does).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

STEP = "bench/step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")  # but the step's range
LOOKBACK = 64  # host events before a gap's middle searched for the innermost cover


@dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float  # union of kernels, copies and fills
    kernel_union_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)  # full kernel name -> seconds
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_time(self, *parts: str) -> float:
        """Seconds of every kernel whose name contains one of ``parts``."""
        return sum(s for name, s in self.kernel_s.items() if any(p in name for p in parts))


def short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", name, maxsplit=1)[0]


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted intervals of iv (float [n, 2])."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(new)
    stops = ends[np.append(last[1:] - 1, len(iv) - 1)]
    return np.stack([starts, stops], 1)


def _top(totals: Dict[str, float], n: int = 10) -> List[Tuple[str, float]]:
    return sorted(totals.items(), key=lambda kv: -kv[1])[:n]


def summarize(events: List[dict], steps: int) -> Trace:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == STEP]
    if not marks:
        raise ValueError(f"no {STEP} ranges in the trace")
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    ops = {e["args"]["External id"]: e["name"] for e in xs
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS and lo <= e["ts"] <= hi]
    kernel_us: Dict[str, float] = defaultdict(float)
    named_us: Dict[str, float] = defaultdict(float)
    for e in dev:
        name = e["name"]
        if e["cat"] == "kernel":
            kernel_us[name] += e["dur"]
        label = short(name)
        if label.startswith("at::native::"):  # PyTorch's own kernels: name the op that launched them
            op = ops.get(e.get("args", {}).get("External id"))
            label = f"{op}/{label.removeprefix('at::native::')}" if op else label
        named_us[label] += e["dur"]
    busy = _union(np.array([[e["ts"], min(hi, e["ts"] + e["dur"])] for e in dev]).reshape(-1, 2))
    kern = _union(np.array([[e["ts"], min(hi, e["ts"] + e["dur"])] for e in dev
                            if e["cat"] == "kernel"]).reshape(-1, 2))
    edges = np.concatenate(([lo], busy.reshape(-1), [hi])).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                  if e.get("cat") in HOST_CATS and e.get("name") != STEP)
    step_lo = np.sort([e["ts"] for e in marks])
    step_hi = np.sort([e["ts"] + e["dur"] for e in marks])
    gap_us: Dict[str, float] = defaultdict(float)
    if len(gaps) and host:
        h_start = np.array([h[0] for h in host])
        h_end = np.array([h[1] for h in host])
        mid = gaps.mean(1)
        at = np.searchsorted(h_start, mid, side="right") - 1
        best = np.full(len(gaps), -1)
        best_dur = np.full(len(gaps), np.inf)
        for back in range(LOOKBACK):
            j = at - back
            ok = (j >= 0) & (h_end[np.maximum(j, 0)] >= mid)
            dur = np.where(ok, h_end[np.maximum(j, 0)] - h_start[np.maximum(j, 0)], np.inf)
            better = dur < best_dur
            best = np.where(better, j, best)
            best_dur = np.where(better, dur, best_dur)
        in_step = np.searchsorted(step_lo, mid, side="right") > np.searchsorted(step_hi, mid, side="left")
        for g, j, inside in zip(gaps, best, in_step):
            name = host[j][2] if j >= 0 else "python" if inside else "between steps"
            gap_us[name] += float(g[1] - g[0])
    else:
        for g in gaps:
            gap_us["between steps"] += float(g[1] - g[0])
    span = lambda iv: float((iv[:, 1] - iv[:, 0]).sum()) * 1e-6  # noqa: E731
    return Trace(
        steps=steps, window_s=(hi - lo) * 1e-6, busy_s=span(busy), kernel_union_s=span(kern),
        kernel_s={k: v * 1e-6 for k, v in kernel_us.items()},
        device_ops=[(k, v * 1e-6) for k, v in _top(named_us)],
        idle_gaps=[(k, v * 1e-6) for k, v in _top(gap_us)],
    )


def read(prof, steps: int) -> Trace:
    """Summarize a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return summarize(doc["traceEvents"] if isinstance(doc, dict) else doc, steps)
