"""step_p95_ms.<kind>[.<config>]: the 95th percentile over every step of
the window, each timed by CUDA events from its first launch to its end."""

import numpy as np


def read(run):
    return float(np.percentile(run.step_ms, 95)) if run.step_ms else None
