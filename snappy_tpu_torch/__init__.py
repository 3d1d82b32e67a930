"""snappy_tpu_torch — the Snappy codec of snappy_tpu on PyTorch and CUDA.

JAX counterpart: snappy_tpu/__init__.py.  This package imports torch and
never jax.  Masked CRC32C (by table and by GF(2) products on the int8
tensor cores), the chunk decoder (chunk and big-window shapes), the
streaming raw decoders (grid and scan mode) and the block encoder (levels
1 and 2) run as CUDA kernels written for the H100 (sm_90a), built from
``ops/csrc`` at first use; ``device="cpu"`` runs their plain PyTorch
versions.  ``streams`` holds the sync and asyncio adapters, ``cli`` the
command line (``python -m snappy_tpu_torch.cli``).

Public API surface:

    encode / decode                      raw format, bytes in/out
    encode_batch / decode_batch          many raw streams, shared launches
    compress_into / uncompress_into      raw format, caller buffers, Result
    encode_framed / decode_framed        framed format, bytes in/out
    compress_framed_into                 framed, caller buffer, Result
    uncompress_framed_into               resumable framed decode, Result
    uncompressed_len[_framed]            stream sizing
    max_compressed_len[_framed]          worst-case output sizing
    is_framed_stream                     magic sniff
    masked_crc32c                        masked CRC32C of one buffer
"""

from .api import (  # noqa: F401
    compress_framed_into,
    compress_into,
    decode,
    decode_batch,
    decode_framed,
    encode,
    encode_batch,
    encode_framed,
    is_framed_stream,
    uncompress_framed_into,
    uncompress_into,
    uncompressed_len,
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
