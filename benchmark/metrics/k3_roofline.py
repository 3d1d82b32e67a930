"""k3_roofline: K3's (ops/encode_blocks.py) share of its roofline: its
least time by bytes (payload read, level-1 tag streams written) over its
device time in the trace."""

from benchmark.lib import roofline


def read(run):
    return roofline.share(run, roofline.K3, "k3")
