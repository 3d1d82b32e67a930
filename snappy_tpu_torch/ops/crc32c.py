"""Masked CRC32C of a batch of chunks (kernel K1).

JAX counterpart: snappy_tpu/ops/crc32c_pallas.py (the TPU kernel
``_kernel_factory``, launched by ``_lane_fold_pallas``) and its XLA twin
``snappy_tpu/ops/crc32c_jax.masked_crc32c_chunks``, which the JAX main path
calls.  One CUDA source, ``csrc/crc32c.cu``, replaces both: a tile
kernel on a persistent grid (every row cut into tiles of 64 KiB, one CTA of
16 warps a tile, lanes on coalesced 16-byte loads, conflict-free table
lookups, warp-level folds) and, where a row is longer than one tile, a fold
kernel over its tiles.  Both launches of one call count as one launch.

``masked_crc32c_chunks`` launches the kernel for a CUDA tensor and runs the
plain version ``_crc32c_plain`` for a CPU tensor.  The kernel reads only
the first ``lengths[i]`` bytes of row ``i``: what lies past them does not
matter, so callers need not zero it.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build

POLY = 0x82F63B78  # reflected CRC32C polynomial (crc32c_jax.py:31)
MASK_DELTA = 0xA282EAD8  # snappy masking constant (crc32c_jax.py:32)

LAUNCHES = 0  # kernel launches made by masked_crc32c_chunks

TILE = 65536  # bytes of a tile (kTile of csrc/crc32c.cu)

_consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


@functools.cache
def tables() -> np.ndarray:
    """Slicing-by-4 tables, uint32 [4, 256]: row k advances a register by
    one byte followed by k zero bytes."""
    t = np.zeros((4, 256), dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        t[0, i] = c
    for k in range(1, 4):
        for i in range(256):
            p = int(t[k - 1, i])
            t[k, i] = (p >> 8) ^ int(t[0, p & 0xFF])
    return t


def _gf2_apply(cols, v: int) -> int:
    acc = 0
    for i in range(32):
        if (v >> i) & 1:
            acc ^= int(cols[i])
    return acc


@functools.cache
def shift_matrices() -> np.ndarray:
    """uint32 [32, 32]: row j holds the 32 columns of the GF(2) matrix that
    advances a register across 2^j zero bytes."""
    t0 = tables()[0]
    m = [((1 << i) >> 8) ^ int(t0[(1 << i) & 0xFF]) for i in range(32)]
    mats = [m]
    for _ in range(31):
        prev = mats[-1]
        mats.append([_gf2_apply(prev, c) for c in prev])
    return np.array(mats, dtype=np.uint32)


@functools.cache
def adv_tables() -> np.ndarray:
    """uint32 [32, 4, 256]: entry [j, p, b] advances the register b << 8p
    across 2^j zero bytes, so that advancing v is the XOR over its 4 bytes."""
    cols = shift_matrices().astype(np.uint32)  # [32 levels, 32 columns]
    b = np.arange(256, dtype=np.uint32)
    out = np.zeros((32, 4, 256), dtype=np.uint32)
    for p in range(4):
        for bit in range(8):
            on = ((b >> bit) & 1).astype(bool)
            out[:, p, on] ^= cols[:, 8 * p + bit, None]
    return out


def tiles_per_row(max_len: int) -> int:
    """Tile slots of each row in a call whose longest row has max_len
    bytes (nt_max of csrc/crc32c.cu)."""
    return max(1, -(-max_len // TILE))


def mask(crc: int) -> int:
    """Snappy CRC masking (framing_format.txt:39-58)."""
    return (((crc >> 15) | (crc << 17)) + MASK_DELTA) & 0xFFFFFFFF


def _check(chunks_u8: torch.Tensor, lengths: torch.Tensor) -> int:
    """Raise on what the kernels do not take; return the longest length."""
    if chunks_u8.dtype != torch.uint8 or chunks_u8.dim() != 2:
        raise TypeError("chunks_u8 must be a uint8 tensor [N, W]")
    if chunks_u8.shape[0] and chunks_u8.stride(1) != 1:
        raise ValueError("chunks_u8 rows must be contiguous")
    if lengths.dtype != torch.int32 or lengths.shape != chunks_u8.shape[:1]:
        raise TypeError("lengths must be an int32 tensor [N]")
    if lengths.device != chunks_u8.device or not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous, on the chunks' device")
    if not len(lengths):
        return 0
    lo, hi = (int(v) for v in torch.aminmax(lengths))
    if lo < 0 or hi > chunks_u8.shape[1]:
        raise ValueError("lengths must lie in [0, W]")
    return hi


def masked_crc32c_chunks(
    chunks_u8: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Masked CRC32C of ``chunks_u8[i, :lengths[i]]`` for each row.

    chunks_u8: uint8 [N, W]; lengths: int32 [N].  Returns uint32 [N] on the
    same device."""
    max_len = _check(chunks_u8, lengths)
    dev = chunks_u8.device
    if dev.type == "cpu":
        return _crc32c_plain(chunks_u8, lengths)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(len(lengths), dtype=torch.uint32, device=dev)
    if len(lengths):
        _launch(chunks_u8, lengths, out, tiles_per_row(max_len))
    return out


def _launch(chunks_u8: torch.Tensor, lengths: torch.Tensor, out: torch.Tensor,
            nt_max: int, tile_regs: Optional[torch.Tensor] = None) -> None:
    """Launch the kernels on checked CUDA tensors (N >= 1), no checks;
    ``nt_max``: ``tiles_per_row`` of the longest row; ``tile_regs``: the
    fold's scratch, int32 [N * nt_max], made here unless given."""
    dev = chunks_u8.device
    if dev not in _consts:
        _consts[dev] = (
            torch.from_numpy(tables()).to(dev),
            torch.from_numpy(adv_tables()).to(dev),
        )
    tabs, adv = _consts[dev]
    # scratch for the fold of rows longer than a tile; no kernel touches it
    # at nt_max 1, so no allocation is made there
    if tile_regs is None:
        tile_regs = torch.empty(len(lengths) * nt_max, dtype=torch.int32, device=dev) if nt_max > 1 \
            else out
    _build.launch(
        "crc32c_chunks", dev,
        chunks_u8.data_ptr(), chunks_u8.stride(0), lengths.data_ptr(), len(lengths), nt_max,
        tabs.data_ptr(), adv.data_ptr(), tile_regs.data_ptr(), out.data_ptr(),
    )
    global LAUNCHES
    LAUNCHES += 1


def _crc32c_plain(chunks_u8: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The plain version: the byte-at-a-time table CRC of each row."""
    tab = tables()[0].tolist()
    rows = chunks_u8.cpu().numpy()
    out = np.zeros(len(rows), dtype=np.uint32)
    for k, n in enumerate(lengths.tolist()):
        crc = 0xFFFFFFFF
        for b in rows[k, :n].tolist():
            crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
        out[k] = mask(crc ^ 0xFFFFFFFF)
    return torch.from_numpy(out).to(chunks_u8.device)
