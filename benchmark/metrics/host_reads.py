"""host_reads.<kind>[.<config>]: the blocking device-to-host reads a traced
step made inside the port, per step: the reads that its ``read.*`` spans
declared (``snappy_tpu_torch/telemetry.py``), over the traced window's
steps.  None where the port records no span."""


def read(run):
    try:
        from snappy_tpu_torch import telemetry
    except ImportError:  # a port without spans
        return None
    stats = telemetry.spans()
    tr = run.trace
    if not stats or not tr or not tr.steps:
        return None
    return sum(s.reads for name, s in stats.items() if name.startswith(telemetry.READ)) / tr.steps
