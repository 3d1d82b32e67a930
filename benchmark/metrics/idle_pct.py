"""idle_pct.<kind>[.<config>]: the share of the traced window in which no
kernel, copy or fill ran on the card."""


def read(run):
    tr = run.trace
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr and tr.window_s > 0 else None
