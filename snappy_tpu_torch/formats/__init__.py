"""Wire-format spec layer: constants, varint, length math, frame scanning,
typed error model.  Pure Python/NumPy — no device code lives here.

JAX counterpart: snappy_tpu/formats/ (copied, because importing
``snappy_tpu.formats`` imports ``snappy_tpu`` and with it jax)."""

from . import constants, errors, framing, varint  # noqa: F401
from .constants import (  # noqa: F401
    MAX_BLOCK_LEN,
    MAX_COMPRESSED_BLOCK_LEN,
    MAX_COMPRESSED_FRAME_DATA_LEN,
    MAX_UNCOMPRESSED_FRAME_DATA_LEN,
    MAX_UNCOMPRESSED_LEN,
    max_compressed_len,
    max_compressed_len_framed,
)
from .errors import (  # noqa: F401
    CodecError,
    Err,
    FrameError,
    Ok,
    Result,
    SnappyDecodingError,
    SnappyEncodingError,
    SnappyError,
)
from .framing import (  # noqa: F401
    decode_frame_header,
    is_snappy_framed_stream,
    uncompressed_len,
    uncompressed_len_framed,
)
