"""encode_gbps: payload bytes of every step of the window, over the
window's host-clock time, in GB/s (1e9 bytes)."""


def read(run):
    return run.payload_bytes * run.steps / run.window_s / 1e9 if run.steps else None
