"""Snappy chunk decoder (kernel K2), at the chunk and big-window shapes.

JAX counterpart: snappy_tpu/ops/decode_scalar.py (the TPU kernel
``_make_kernel``/``_kernel``, launched by ``decode_chunks_words`` at the
chunk shape, <= 64 KiB out, and by ``decode_raw_words`` /
``decode_raw_batch_words`` at the raw format's big-window shape, <= 128 KiB
out), with the in-kernel helpers of scalar_emit.py and emit_long.py folded
in.  The CUDA kernel is ``csrc/decode_chunks.cu``, one warp per chunk;
the width ``W`` of ``out`` is its shape.

Inputs arrive ragged: one uint8 buffer of tag streams and int64 offsets,
chunk ``i`` being ``comp_u8[offsets[i]:offsets[i + 1]]``.  There is no
per-chunk capacity (the TPU layout pads each chunk to ``CW_PAD`` words), so
a valid body longer than ``max_compressed_len(65536)`` decodes here too.

The verdict is the TPU kernel's (decode_scalar.py:327): ``ok`` = no
malformed tag, all input consumed and ``written == declared``; ``written``
is the output produced before the first bad tag.  Row ``i`` of ``out``
holds the ``written`` bytes, then zeros.

Output comes in two forms.  The row form: ``out`` is uint8 [N, W] and
chunk ``i`` owns row ``i``.  The ragged form (``out_offsets`` given): ``out``
is one uint8 buffer and chunk ``i`` owns the slot
``out[out_offsets[i]:out_offsets[i + 1]]``, at least ``declared[i]`` bytes
and 16-byte aligned, so a batch of small chunks takes about the bytes it
decodes to rather than N x W; the widest slot picks the layout, as W does.
No write of the kernel leaves a chunk's row or slot, whatever its verdict.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import telemetry
from . import _build

CHUNK = 65536  # the chunk shape: MAX_UNCOMPRESSED_FRAME_DATA_LEN
MAX_OUT = 131072  # the big-window shape (decode_scalar.RAW_OUT_WORDS * 4)


def _check(comp_u8, comp_offsets, declared, out, out_offsets=None) -> None:
    """Types, shapes and devices: no values, so no copy from the card."""
    if comp_u8.dtype != torch.uint8 or comp_u8.dim() != 1:
        raise TypeError("comp_u8 must be a 1-D uint8 tensor")
    if comp_offsets.dtype != torch.int64 or comp_offsets.dim() != 1:
        raise TypeError("comp_offsets must be a 1-D int64 tensor")
    n = comp_offsets.shape[0] - 1
    if n < 0:
        raise ValueError("comp_offsets needs N + 1 entries")
    if declared.dtype != torch.int32 or declared.shape != (n,):
        raise TypeError("declared must be an int32 tensor [N]")
    ins = (comp_u8, comp_offsets, declared)
    if out_offsets is not None:
        if out.dtype != torch.uint8 or out.dim() != 1:
            raise TypeError("out must be a 1-D uint8 tensor in the ragged form")
        if out_offsets.dtype != torch.int64 or out_offsets.shape != (n + 1,):
            raise TypeError("out_offsets must be an int64 tensor [N + 1]")
        if not out.is_contiguous() or out.data_ptr() % 16:
            raise ValueError("out must be contiguous and 16-byte aligned")
        ins += (out_offsets,)
    else:
        if out.dtype != torch.uint8 or out.dim() != 2 or out.shape[0] != n:
            raise TypeError("out must be a uint8 tensor [N, W]")
        cols = out.shape[1]
        if cols > MAX_OUT or cols % 16 or not out.is_contiguous() or out.data_ptr() % 16:
            raise ValueError("out must be contiguous, 16-byte aligned, W <= 131072, W % 16 == 0")
    dev = out.device
    for t in ins:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("inputs must be contiguous, on out's device")


def check_values(offsets: np.ndarray, declared: np.ndarray, comp_len: int, cols: int) -> None:
    """The values the kernel trusts, on host arrays: offsets inside the
    buffer and not decreasing, each declared length in [0, W]."""
    if len(declared):
        if int(offsets[0]) < 0 or int(offsets[-1]) > comp_len:
            raise ValueError("comp_offsets out of the buffer")
        if bool((offsets[1:] < offsets[:-1]).any()):
            raise ValueError("comp_offsets must not decrease")
        if int(declared.min()) < 0 or int(declared.max()) > cols:
            raise ValueError("declared must lie in [0, W]")


def check_slots(out_offsets: np.ndarray, declared: np.ndarray, out_len: int) -> int:
    """The ragged form's slots, on host arrays: 16-byte aligned, in order,
    inside ``out``, each at least its chunk's declared length and at most
    131072 bytes.  Returns the widest slot (0 for none)."""
    if len(out_offsets) < 2:
        return 0
    width = np.diff(out_offsets)
    if int(out_offsets[0]) < 0 or int(out_offsets[-1]) > out_len:
        raise ValueError("out_offsets out of the buffer")
    if bool((out_offsets % 16).any()):
        raise ValueError("out_offsets must be multiples of 16")
    if bool((width < declared).any()):
        raise ValueError("each slot must hold its declared length (and slots must not decrease)")
    widest = int(width.max())
    if widest > MAX_OUT:
        raise ValueError("a slot must be at most 131072 bytes")
    return widest


def decode_chunks(
    comp_u8: torch.Tensor,
    comp_offsets: torch.Tensor,
    declared: torch.Tensor,
    out: torch.Tensor,
    host_values: Optional[Tuple[np.ndarray, ...]] = None,
    out_offsets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode N tag streams into the rows, or the slots, of ``out``.

    comp_u8: uint8 [C]; comp_offsets: int64 [N + 1]; declared: int32 [N];
    out: uint8 [N, W] (W <= 131072, a multiple of 16), written in place;
    or, with ``out_offsets`` (int64 [N + 1], multiples of 16), the ragged
    form: out is uint8 [B] and chunk i decodes into
    ``out[out_offsets[i]:out_offsets[i + 1]]``, a slot of at least
    ``declared[i]`` and at most 131072 bytes.  ``host_values``: the host
    arrays (offsets, declared), and in the ragged form out_offsets, that
    the tensors were uploaded from, for a caller that has them; their
    values are then checked there instead of copying the tensors back from
    the card.  Returns (ok bool [N], written int32 [N]) on out's device."""
    ragged = out_offsets is not None
    with telemetry.span("k2"):
        _check(comp_u8, comp_offsets, declared, out, out_offsets)
        if host_values is None:
            tensors = (comp_offsets, declared) + ((out_offsets,) if ragged else ())
            with telemetry.span("read.k2_values", reads=len(tensors)):
                host_values = tuple(t.cpu().numpy() for t in tensors)
        if ragged:
            width = check_slots(host_values[2], host_values[1], out.shape[0])
        else:
            width = out.shape[1]
        check_values(host_values[0], host_values[1], comp_u8.shape[0], width)
        dev = out.device
        if dev.type == "cpu":
            return _decode_chunks_plain(comp_u8, comp_offsets, declared, out, out_offsets)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        n = declared.shape[0]
        ok = torch.empty(n, dtype=torch.bool, device=dev)
        written = torch.empty(n, dtype=torch.int32, device=dev)
        if n and ragged:
            _launch_ragged(comp_u8, comp_offsets, declared, out, out_offsets, width, ok, written)
        elif n:
            _launch(comp_u8, comp_offsets, declared, out, ok, written)
        return ok, written


def _launch(comp_u8, comp_offsets, declared, out, ok, written) -> None:
    """Launch the kernel on checked CUDA tensors (N >= 1), no checks."""
    _build.launch(
        "decode_chunks", out.device,
        comp_u8.data_ptr(), comp_offsets.data_ptr(), declared.data_ptr(),
        declared.shape[0], out.data_ptr(), out.shape[1], ok.data_ptr(),
        written.data_ptr(),
    )
    telemetry.count("k2.launches" if out.shape[1] <= CHUNK else "k2.launches_big")


def _launch_ragged(comp_u8, comp_offsets, declared, out, out_offsets, width, ok, written) -> None:
    """Launch the ragged form on checked CUDA tensors (N >= 1), the widest
    slot ``width`` picking the layout; it counts as a launch at that
    shape, and as a ragged one."""
    _build.launch(
        "decode_chunks_ragged", out.device,
        comp_u8.data_ptr(), comp_offsets.data_ptr(), declared.data_ptr(),
        declared.shape[0], out.data_ptr(), out_offsets.data_ptr(), width, ok.data_ptr(),
        written.data_ptr(),
    )
    telemetry.count("k2.launches" if width <= CHUNK else "k2.launches_big")
    telemetry.count("k2.launches_ragged")


def kernel_params(lib, out_cols: int) -> Dict[str, Union[int, str]]:
    """The walk's constants and the layout at width ``out_cols``, as
    ``csrc/decode_chunks.cu`` defines them, read from a build of it
    (``_build.cuda_lib()``, ``_build.twin_lib()`` or a scratch build): the
    lookahead of a batch and the input ring in bytes, the bytes a lane
    moves per piece, and the layout, "a" (the row in shared memory) or "b"
    (in place)."""
    fn = lib.stpu_decode_chunks_params
    fn.restype = None
    fn.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    p = np.zeros(4, dtype=np.int64)
    fn(out_cols, p.ctypes.data)
    return {"lookahead": int(p[0]), "ring": int(p[1]), "piece": int(p[2]),
            "layout": "a" if p[3] else "b"}


def decode_tags(body: bytes, m: int) -> Tuple[bool, int, int, bytes]:
    """Decode one tag stream with declared length ``m`` by the sequential
    walk (decoder.nim:20-155): (ok, written, consumed, output produced),
    where ``consumed`` is the offset of the first bad tag, or
    ``len(body)``.  The plain version's per-chunk body, and the streaming
    decoder's."""
    n = len(body)
    out = bytearray()
    i = 0
    bad = False
    while i < n:
        b = body[i]
        tag = b & 3
        if tag == 0:  # literal
            lc = b >> 2
            hdr, length = 1, lc + 1
            if lc >= 60:
                extra = lc - 59
                if extra > n - i - 1:
                    bad = True
                    break
                hdr = 1 + extra
                length = int.from_bytes(body[i + 1 : i + hdr], "little") + 1
            if length > n - i - hdr or length > m - len(out):
                bad = True
                break
            out += body[i + hdr : i + hdr + length]
            i += hdr + length
            continue
        hdr = (0, 2, 3, 5)[tag]
        if hdr > n - i:
            bad = True
            break
        if tag == 1:
            length = 4 + ((b >> 2) & 7)
            offset = ((b & 0xE0) << 3) | body[i + 1]
        else:
            length = 1 + (b >> 2)
            offset = int.from_bytes(body[i + 1 : i + hdr], "little")
        o = len(out)
        if offset == 0 or offset > o or length > m - o:
            bad = True
            break
        if offset >= length:
            out += out[o - offset : o - offset + length]
        else:  # self-overlapping: the pattern repeats
            pattern = out[o - offset :]
            out += (pattern * (length // offset + 1))[:length]
        i += hdr
    return (not bad) and len(out) == m, len(out), i, bytes(out)


def _decode_chunks_plain(comp_u8, comp_offsets, declared, out, out_offsets=None):
    """The plain version: ``decode_tags`` on each chunk in turn, into its
    row or its slot; the bytes of ``out`` outside every slot stay."""
    comp = comp_u8.cpu().numpy().tobytes()
    offs = comp_offsets.tolist()
    decl = declared.tolist()
    ok = np.zeros(len(decl), dtype=bool)
    written = np.zeros(len(decl), dtype=np.int32)
    if out_offsets is None:
        rows = np.zeros(tuple(out.shape), dtype=np.uint8)
        slots = [(k * out.shape[1], out.shape[1]) for k in range(len(decl))]
    else:
        rows = out.cpu().numpy().copy()
        at = out_offsets.tolist()
        slots = [(at[k], at[k + 1] - at[k]) for k in range(len(decl))]
    flat = rows.reshape(-1)
    for k, m in enumerate(decl):
        ok[k], written[k], _, produced = decode_tags(comp[offs[k] : offs[k + 1]], m)
        lo, width = slots[k]
        flat[lo : lo + width] = 0
        flat[lo : lo + len(produced)] = np.frombuffer(produced, dtype=np.uint8)
    out.copy_(torch.from_numpy(rows))
    return torch.from_numpy(ok).to(out.device), torch.from_numpy(written).to(out.device)


def from_jax_packed(meta: np.ndarray, comp_words: np.ndarray):
    """Turn ``snappy_tpu.ops.decode_scalar.pack_chunks`` output (meta int32
    [nb, 1, 2] of (comp_len, declared), comp_words int32 [nb * CW_PAD]) into
    this module's ragged inputs (comp_u8, comp_offsets, declared), on the
    CPU."""
    nb = meta.shape[0]
    rows = np.ascontiguousarray(comp_words).view(np.uint8).reshape(nb, -1)
    lens = meta[:, 0, 0].astype(np.int64)
    offsets = np.zeros(nb + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(lens)
    comp = b"".join(rows[k, : lens[k]].tobytes() for k in range(nb))
    return (
        torch.from_numpy(np.frombuffer(comp, dtype=np.uint8).copy()),
        torch.from_numpy(offsets),
        torch.from_numpy(meta[:, 0, 1].astype(np.int32)),
    )
