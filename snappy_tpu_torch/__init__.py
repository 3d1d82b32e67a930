"""snappy_tpu_torch — the Snappy codec of snappy_tpu on PyTorch and CUDA.

JAX counterpart: snappy_tpu/__init__.py.  This package imports torch and
never jax.  Its first slice is the framed format's main path: masked
CRC32C, the chunk decoder and the level-1 block encoder run as CUDA
kernels written for the H100 (sm_90a), built from ``ops/csrc`` at first
use; ``device="cpu"`` runs their plain PyTorch versions.

Public API surface of this slice:

    encode_framed / decode_framed        framed format, bytes in/out
    uncompressed_len_framed              stream sizing
    max_compressed_len[_framed]          worst-case output sizing
    is_framed_stream                     magic sniff
    masked_crc32c                        masked CRC32C of one buffer
"""

from .api import (  # noqa: F401
    decode_framed,
    encode_framed,
    is_framed_stream,
    uncompressed_len_framed,
)
from .engine import masked_crc32c  # noqa: F401
from .formats.constants import (  # noqa: F401
    max_compressed_len,
    max_compressed_len_framed,
)
from .formats.errors import (  # noqa: F401
    CodecError,
    Err,
    FrameError,
    InputTooLarge,
    MalformedSnappyData,
    Ok,
    SnappyDecodingError,
    SnappyEncodingError,
    SnappyError,
    UnexpectedEofError,
)

# Kept equal to the JAX package's version (pinned by the port's tests).
__version__ = "0.6.0"
