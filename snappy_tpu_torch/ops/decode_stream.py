"""Streaming raw-format decoder (kernel K4): one raw stream of any size.

JAX counterpart: snappy_tpu/ops/decode_stream.py in grid mode (the TPU
kernel ``_kernel_grid``, launched by ``decode_raw_stream_grid`` and
``decode_raw_stream_bytes(mode="grid")``).  The CUDA kernel is
``csrc/decode_stream.cu``: one CTA walks the stream in 64 KiB output
windows staged in shared memory, with 64-bit cursors, so any declared
length up to ``MAX_UNCOMPRESSED_LEN`` is taken; every legal copy offset is
served, so the TPU's ``unsupported`` verdict does not arise.

The verdict is grid mode's: ``ok`` = no malformed tag, ``consumed ==
len(body)`` and ``written == declared``; ``written`` is the output produced
before the first bad tag and ``consumed`` that tag's offset (or the body's
end), as the sequential decoder reports them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .decode_chunks import decode_tags

LAUNCHES = 0  # kernel launches made by decode_stream


def _check(comp_u8: torch.Tensor, declared: int, out: torch.Tensor) -> None:
    if comp_u8.dtype != torch.uint8 or comp_u8.dim() != 1 or not comp_u8.is_contiguous():
        raise TypeError("comp_u8 must be a contiguous 1-D uint8 tensor")
    if out.dtype != torch.uint8 or out.dim() != 1 or not out.is_contiguous():
        raise TypeError("out must be a contiguous 1-D uint8 tensor")
    if out.device != comp_u8.device:
        raise ValueError("comp_u8 and out must be on one device")
    if declared < 0 or declared > out.shape[0]:
        raise ValueError("declared must lie in [0, len(out)]")
    if out.data_ptr() % 16:
        raise ValueError("out must be 16-byte aligned")


def decode_stream(comp_u8: torch.Tensor, declared: int, out: torch.Tensor) -> torch.Tensor:
    """Decode the raw tag stream ``comp_u8`` (no varint header) with
    declared length ``declared`` into ``out[:declared]``.

    Returns int64 [3] = (ok, written, consumed) on out's device; the first
    ``written`` bytes of ``out`` are the output, the rest is left as it
    was."""
    _check(comp_u8, declared, out)
    dev = out.device
    if dev.type == "cpu":
        return _decode_stream_plain(comp_u8, declared, out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    status = torch.empty(3, dtype=torch.int64, device=dev)
    _launch(comp_u8, declared, out, status)
    return status


def _launch(comp_u8, declared: int, out, status) -> None:
    """Launch the kernel on checked CUDA tensors, no checks."""
    _build.launch(
        "decode_stream", out.device,
        comp_u8.data_ptr(), comp_u8.shape[0], declared, out.data_ptr(), status.data_ptr(),
    )
    global LAUNCHES
    LAUNCHES += 1


def _decode_stream_plain(comp_u8, declared: int, out) -> torch.Tensor:
    """The plain version: the sequential tag walk over the whole stream."""
    ok, written, consumed, produced = decode_tags(comp_u8.numpy().tobytes(), declared)
    out.numpy()[:written] = np.frombuffer(produced, dtype=np.uint8)
    return torch.tensor([int(ok), written, consumed], dtype=torch.int64)
