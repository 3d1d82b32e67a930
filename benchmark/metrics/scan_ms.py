"""scan_ms.<kind>[.<config>]: the host ms a traced step spent in the port's
``engine.scan`` span: the walk over the stream's chunk headers
(``formats/framing.scan_frames``)."""

from benchmark.lib import spans


def read(run):
    return spans.span_ms(run, "engine.scan")
