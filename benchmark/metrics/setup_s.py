"""setup_s: from the process's start to the first timed step: imports,
CUDA start, the kernels' build or load, the data, staging and warm-up."""


def read(run):
    return run.setup_s
