"""k2_roofline: K2's (ops/decode_chunks.py) share of its roofline: its
least time by bytes (compressed bodies read, decoded bytes written) over
its device time in the trace."""

from benchmark.lib import roofline


def read(run):
    return roofline.share(run, roofline.K2, "k2")
