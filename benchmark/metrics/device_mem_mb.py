"""device_mem_mb: torch.cuda.max_memory_allocated() over the window, once
the inputs are staged, in MB (1e6 bytes): inputs and the step's scratch."""


def read(run):
    return run.memory_peak_bytes / 1e6 if run.memory_peak_bytes else None
