"""glue_ms.<kind>[.<config>]: the time of a traced step that no kernel
covers, in ms, averaged over the traced window's steps: launches, the
wrappers' checks and host reads, allocation, copies and fills."""


def read(run):
    tr = run.trace
    return (tr.window_s - tr.kernel_union_s) / tr.steps * 1e3 if tr and tr.steps else None
