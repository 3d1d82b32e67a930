"""tobytes_ms.<kind>[.<config>]: the host ms a traced step spent in the
port's ``engine.tobytes`` span: the copy of the assembled payload into the
``bytes`` that the API returns."""

from benchmark.lib import spans


def read(run):
    return spans.span_ms(run, "engine.tobytes")
