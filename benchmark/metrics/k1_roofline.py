"""k1_roofline.<kind>[.<config>]: K1's (ops/crc32c.py) share of its
roofline in the step: its least time by bytes (each row's checksummed
bytes read, 4 bytes a row written) over its device time in the trace."""

from benchmark.lib import roofline


def read(run):
    return roofline.share(run, roofline.K1, "k1")
