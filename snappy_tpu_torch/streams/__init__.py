"""Stream adapters (sync and asyncio) over the port's kernels.

JAX counterpart: snappy_tpu/streams/__init__.py.
"""

from . import aio, sync  # noqa: F401
from .sync import (  # noqa: F401
    compress,
    compress_bytes,
    compress_framed,
    compress_framed_bytes,
    uncompress_framed,
    uncompress_framed_bytes,
)
