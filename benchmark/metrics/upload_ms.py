"""upload_ms.<kind>[.<config>]: the host ms a traced step spent in the port's
``engine.upload`` span: the host-to-device copies of the staged bodies,
offsets, lengths and payload rows."""

from benchmark.lib import spans


def read(run):
    return spans.span_ms(run, "engine.upload")
