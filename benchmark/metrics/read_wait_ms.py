"""read_wait_ms.<kind>[.<config>]: the host ms a traced step spent inside
the port's ``read.*`` spans (``snappy_tpu_torch/telemetry.py``), each a
blocking device-to-host read and the wait for the work queued before it,
over the traced window's steps.  None where the port records no span."""


def read(run):
    try:
        from snappy_tpu_torch import telemetry
    except ImportError:  # a port without spans
        return None
    stats = telemetry.spans()
    tr = run.trace
    if not stats or not tr or not tr.steps:
        return None
    return sum(s.total_s for name, s in stats.items() if name.startswith(telemetry.READ)) / tr.steps * 1e3
