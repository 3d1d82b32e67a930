"""program_host_ms.<kind>[.<config>]: the host ms a traced step spent
inside the port's outermost spans (``snappy_tpu_torch/telemetry.py``),
less the time of its ``read.*`` spans: the port's own checks, allocation,
launches and padding, over the traced window's steps.  Beside
``glue_ms`` it splits the glue between the port and the harness.  None
where the port records no span."""


def read(run):
    try:
        from snappy_tpu_torch import telemetry
    except ImportError:  # a port without spans
        return None
    stats = telemetry.spans()
    tr = run.trace
    if not stats or not tr or not tr.steps:
        return None
    outer = sum(s.outer_s for s in stats.values())
    waits = sum(s.total_s for name, s in stats.items() if name.startswith(telemetry.READ))
    return (outer - waits) / tr.steps * 1e3
