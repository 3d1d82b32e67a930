"""assemble_ms.<kind>[.<config>]: the host ms a traced step spent in the
port's ``engine.assemble`` span: the copies of the decoded rows, read
back, into the payload at their offsets, and the chunks' verdicts."""

from benchmark.lib import spans


def read(run):
    return spans.span_ms(run, "engine.assemble")
