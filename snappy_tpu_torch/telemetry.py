"""Spans and counters inside the port.

A span marks one layer boundary of the hot path::

    with telemetry.span("k1"):
        ...
    with telemetry.span("read.k1_lengths", reads=2):
        lo, hi = (int(v) for v in torch.aminmax(lengths))

Spans are off unless ``torch.profiler`` is recording or the caller is
inside ``recording()``.  Off, ``span`` returns the shared no-op ``OFF``
after one check: no profiler range, no allocation, no clock read.  On, a
span enters ``torch.profiler.record_function("snappy." + name)`` while the
profiler records, so it lands in the profiler's trace as a
``user_annotation`` beside the card's kernels and copies, and it adds to
an in-memory store keyed by its name (``spans()``): calls, host seconds,
self seconds (less its child spans), seconds of calls made outside every
other span, the reads it declares and its enclosing span.  A span named
``read.*`` holds one blocking device-to-host read site and declares how
many reads it makes.

Counters (``count``, ``counter``) are always on: cumulative integers by
name, made on the card only (a CPU tensor runs a plain version and counts
nothing):

    k1.launches          ops/crc32c.py: K1 launches (both kernels of a call count once)
    k2.launches          ops/decode_chunks.py: K2 launches at W <= 65536
    k2.launches_big      ... and at the big-window shape, W > 65536
    k3.launches          ops/encode_blocks.py: K3 calls at level 1 (ways=1; an ordered call's two launches count once)
    k3.launches_l2       ... and at level >= 2 (ways=2)
    k3.walkers           walkers (warps that take rows from K3's queue) launched, both levels
    k3.ordered           K3 calls with more rows than walkers, whose rows went costliest first
    k4.launches          ops/decode_stream.py: decode_stream calls, either route
    k4.launches_windows  launches of K4's window route (pass 1 and pass 2)
    k4.launches_walk     launches of the whole-stream walk
    k4.redecoded         windows that pass 2 decoded, summed by decode_raw_stream_bytes
    k5.launches          K5's pass-2 launches: one per decode_stream_scan call
    k5.launches_windows  K2 launches made as K5's pass 1, on the window route
    k5.walked            steps that K5's pass 2 walked, summed by decode_raw_stream_bytes
    k6.launches          ops/crc32c_mma.py: masked_crc32c_chunks_fused launches

The store and the counters are process-wide; ``reset`` and
``reset_counters`` clear them.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import torch

PREFIX = "snappy."  # of every span's name in the profiler's trace
READ = "read."  # of the spans that hold a blocking device-to-host read

_profiling = torch._C._autograd._profiler_enabled


@dataclass
class Stat:
    """What the store holds of one span name."""
    count: int = 0
    total_s: float = 0.0
    self_s: float = 0.0  # total less the time of its child spans
    outer_s: float = 0.0  # of the calls made outside every other span
    reads: int = 0  # the reads its calls declared
    parent: Optional[str] = None  # the enclosing span of its latest call


_store: Dict[str, Stat] = {}
_counters: Dict[str, int] = {}
_recording = 0
_lock = threading.Lock()  # over every update of the store, the counters and _recording
_local = threading.local()  # each thread's stack of open spans


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "reads", "parent", "child_s", "t0", "range")

    def __init__(self, name: str, reads: int):
        self.name, self.reads = name, reads

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.range = None
        if _profiling():
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.child_s = 0.0
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        if self.parent is not None:
            self.parent.child_s += dt
        with _lock:
            st = _store.get(self.name)
            if st is None:
                st = _store[self.name] = Stat()
            st.count += 1
            st.total_s += dt
            st.self_s += dt - self.child_s
            st.reads += self.reads
            if self.parent is None:
                st.outer_s += dt
                st.parent = None
            else:
                st.parent = self.parent.name
        return False


def span(name: str, reads: int = 0):
    """A context manager over one layer boundary named ``name``; ``reads``:
    the blocking device-to-host reads it makes (a ``read.*`` span)."""
    if _recording or _profiling():
        return _Span(name, reads)
    return OFF


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, Stat]]:
    """Turn spans on without a profiler; yields the store."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield _store
    finally:
        with _lock:
            _recording -= 1


def spans() -> Dict[str, Stat]:
    """The store: each span name recorded so far and its ``Stat``."""
    return _store


def reset() -> None:
    """Empty the store."""
    with _lock:
        _store.clear()


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def reset_counters() -> None:
    with _lock:
        _counters.clear()
