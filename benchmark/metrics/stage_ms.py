"""stage_ms.<kind>[.<config>]: the host ms a traced step spent in the port's
``engine.stage`` span: the walk over the chunks, and the host copies that
stage the compressed bodies and the stored chunks' payloads."""

from benchmark.lib import spans


def read(run):
    return spans.span_ms(run, "engine.stage")
