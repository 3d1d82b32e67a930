"""Distribution over a process group: sharded block and frame codec
pipelines (JAX counterpart: snappy_tpu/parallel/)."""

from .mesh import (  # noqa: F401
    default_mesh,
    sharded_framed_compress,
    sharded_framed_uncompress,
    sharded_raw_compress,
)
