"""The framing format's masked CRC32C, in plain PyTorch.

``crc32c`` is the byte-at-a-time textbook loop (RFC 3720 B.4 polynomial,
reflected).  ``masked_crc32c_rows`` computes the same function for many
rows at once: each step folds the next ``SLICE`` bytes of every row into
its register with one gather from ``SLICE`` tables (slicing-by-N), so a
64 KiB row takes 2,048 steps of a dozen tensor operations whatever the
number of rows.  It runs on whichever device its rows are on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x82F63B78  # CRC32C (Castagnoli), reflected
MASK_DELTA = 0xA282EAD8  # framing_format.txt section 3
SLICE = 32  # bytes folded a step by masked_crc32c_rows


@functools.cache
def tables(n: int = SLICE) -> np.ndarray:
    """uint32 [n, 256]: row k advances a register by one byte followed by
    k zero bytes; row 0 is the byte-at-a-time table."""
    t = np.zeros((n, 256), dtype=np.uint64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        t[0, i] = c
    for k in range(1, n):
        t[k] = (t[k - 1] >> np.uint64(8)) ^ t[0][(t[k - 1] & np.uint64(0xFF)).astype(np.intp)]
    return t.astype(np.uint32)


def mask(crc: int) -> int:
    """Rotate right by 15 and add MASK_DELTA (framing_format.txt)."""
    return (((crc >> 15) | (crc << 17)) + MASK_DELTA) & 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """Plain CRC32C of ``data``."""
    t0 = tables()[0].tolist()
    crc = 0xFFFFFFFF
    for b in data:
        crc = t0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    return mask(crc32c(data))


def _fold(rows: torch.Tensor) -> torch.Tensor:
    """Unmasked CRC32C of every row of ``rows`` (uint8 [n, L]) as int64."""
    dev = rows.device
    n, length = rows.shape
    tab = torch.from_numpy(tables().astype(np.int64)).to(dev)
    t0 = tab[0]
    flat = tab.flip(0).reshape(-1)  # byte k of a slice reads table SLICE-1-k
    base = torch.arange(SLICE, device=dev) * 256
    crc = torch.full((n,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    steps = length // SLICE
    if steps:
        body = rows[:, : steps * SLICE].reshape(n, steps, SLICE).transpose(0, 1).long()
        shifts = torch.arange(0, 32, 8, device=dev)
        lo = (body[:, :, :4] << shifts).sum(-1)  # [steps, n]: the bytes the register meets
        hi = body[:, :, 4:] + base[4:]  # [steps, n, SLICE - 4]: table indices
        for j in range(steps):
            x = crc ^ lo[j]
            idx = torch.cat((((x[:, None] >> shifts) & 0xFF) + base[:4], hi[j]), 1)
            g = flat[idx]
            w = SLICE
            while w > 1:
                w //= 2
                g = g[:, :w] ^ g[:, w:]
            crc = g[:, 0]
    for j in range(steps * SLICE, length):
        crc = t0[(crc ^ rows[:, j].long()) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c_rows(rows: torch.Tensor, lens, block_rows: int = 4096) -> np.ndarray:
    """Masked CRC32C of ``rows[i, :lens[i]]`` for each row (uint8 [N, W]
    on any device), as a uint32 numpy array.  Rows of one length go
    through ``_fold`` together, ``block_rows`` at a time."""
    lens = np.asarray(lens, dtype=np.int64)
    out = np.zeros(len(lens), dtype=np.uint32)
    for length in np.unique(lens):
        sel = np.flatnonzero(lens == length)
        for lo in range(0, len(sel), block_rows):
            part = torch.from_numpy(sel[lo : lo + block_rows]).to(rows.device)
            crc = _fold(rows.index_select(0, part)[:, : int(length)]).cpu().numpy()
            rot = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
            out[sel[lo : lo + block_rows]] = ((rot + MASK_DELTA) & 0xFFFFFFFF).astype(np.uint32)
    return out
