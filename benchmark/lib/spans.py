"""Host time inside one of the port's spans, per traced step."""

from __future__ import annotations

from typing import Optional


def span_ms(run, name: str) -> Optional[float]:
    """The host ms a traced step spent inside the port's span ``name``
    (``snappy_tpu_torch/telemetry.py``), every call of it counted, over the
    traced window's steps.  None where the port recorded no such span or
    the run was not traced."""
    try:
        from snappy_tpu_torch import telemetry
    except ImportError:  # a port without spans
        return None
    stat = telemetry.spans().get(name)
    tr = run.trace
    if stat is None or not stat.count or not tr or not tr.steps:
        return None
    return stat.total_s / tr.steps * 1e3
