"""Masked CRC32C as GF(2) products on the int8 tensor cores (kernel K6).

JAX counterpart: snappy_tpu/ops/crc32c_mxu.py (the TPU kernel
``_fused_kernel``, launched by ``_fused_registers`` and reached through
``masked_crc32c_chunks_fused``).  CRC is linear over GF(2): the zero-init
register of a 512-byte super-lane is ``A . bits`` mod 2 with a fixed
int8 [4096, 32] matrix ``A``, and the 128 super-lane registers of a
64 KiB chunk combine into the chunk's register by the matrix ``B`` or by
the GF(2) combine tree; the plain version computes exactly that.  The CUDA
kernel ``csrc/crc32c_mma.cu`` runs the same product as a Horner walk over
32-byte steps on ``mma.sync`` u8 products: ``A32`` (the last 256 rows of
``A``) for the step's bits and ``M32`` (the advance over 32 bytes) for the
register so far, packed here as its B fragments, with the "advance by 2^j
bytes" tables of its folds, the inverse shift matrices of the zero tail
and the init term, all built on the host from the tables of
``ops/crc32c.py``.

The fused variant's contract: chunks of ``CHUNK`` bytes, zero past their
length (checked on the CPU path; the kernel trusts it).  Unlike the JAX
function, any N is taken.  The JAX package has no engine route to this
kernel, and neither has the port: K1 (``ops/crc32c.py``) computes the same
CRCs on the main path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from .. import telemetry
from . import _build
from .crc32c import _gf2_apply, adv_tables, mask, shift_matrices, tables

CHUNK = 65536
SUPER = 512  # super-lane of the TPU kernel: 512 bytes = 4096 bits
N_SUPER = CHUNK // SUPER  # 128
SBITS = SUPER * 8  # 4096
# The CUDA kernel's geometry (csrc/crc32c_mma.cu): a CTA's warps take a
# chunk's units, an mma row of a warp a stripe of its unit, 32 bytes a step.
WARPS = 8
UNIT = CHUNK // WARPS  # 8 KiB
STRIPE = UNIT // 16  # 512 bytes
STEP = 32
STEPS = STRIPE // STEP  # 16
MMA_K_STEPS = 9  # bit planes 0 .. 7, then the register so far
ADV_LEVELS = (5, 9, 10, 11, 12, 13, 14, 15)  # the advance tables it takes (2^j bytes)

_consts: Dict[torch.device, torch.Tensor] = {}


def _bits(v: int) -> np.ndarray:
    return ((v >> np.arange(32)) & 1).astype(np.int8)


@functools.cache
def matrices() -> Tuple[np.ndarray, np.ndarray]:
    """(A, B), int8 [4096, 32] each (crc32c_mxu.py:58-99).  A[8 b + j, r]:
    bit r of the register contribution of bit j of byte b of a super-lane;
    B[32 s + i, r]: bit r of super-lane s's register bit i advanced to the
    chunk's end."""
    t0 = tables()[0]
    A = np.zeros((SBITS, 32), dtype=np.int8)
    for j in range(8):
        v = int(t0[1 << j])  # the byte's contribution with no byte after it
        for byte in range(SUPER - 1, -1, -1):
            A[8 * byte + j] = _bits(v)
            v = _gf2_apply(shift_matrices()[0], v)  # over one zero byte
    adv = shift_matrices()[9]  # over 512 zero bytes
    B = np.zeros((SBITS, 32), dtype=np.int8)
    for i in range(32):
        v = 1 << i
        for s in range(N_SUPER - 1, -1, -1):
            B[32 * s + i] = _bits(v)
            v = _gf2_apply(adv, v)
    return A, B


def _gf2_inverse(cols: np.ndarray) -> np.ndarray:
    """Inverse of a GF(2) 32 x 32 matrix given by its columns."""
    rows = [sum(((int(cols[i]) >> r) & 1) << i for i in range(32)) for r in range(32)]
    inv = [1 << r for r in range(32)]
    for c in range(32):
        p = next(r for r in range(c, 32) if (rows[r] >> c) & 1)
        rows[c], rows[p] = rows[p], rows[c]
        inv[c], inv[p] = inv[p], inv[c]
        for r in range(32):
            if r != c and (rows[r] >> c) & 1:
                rows[r] ^= rows[c]
                inv[r] ^= inv[c]
    return np.array([sum(((inv[r] >> i) & 1) << r for r in range(32)) for i in range(32)],
                    dtype=np.uint32)


@functools.cache
def inverse_shift_matrices() -> np.ndarray:
    """uint32 [17, 32]: row j undoes the advance over 2^j zero bytes (the
    zero-tail cancellation, crc32c_mxu.py:248-255)."""
    return np.stack([_gf2_inverse(shift_matrices()[j]) for j in range(17)])


def init_term() -> int:
    """The register of an all-ones initial value advanced over 64 KiB."""
    return _gf2_apply(shift_matrices()[16], 0xFFFFFFFF)


def finish(regs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Zero-init registers of padded chunks -> masked CRC32C of their
    first ``lengths`` bytes (crc_finish of crc32c_mma.cu)."""
    inv = inverse_shift_matrices()
    out = np.zeros(len(regs), dtype=np.uint32)
    for k, (reg, n) in enumerate(zip(regs.tolist(), lengths.tolist())):
        reg ^= init_term()
        pad = CHUNK - n
        for j in range(17):
            if (pad >> j) & 1:
                reg = _gf2_apply(inv[j], reg)
        out[k] = mask(reg ^ 0xFFFFFFFF)
    return out


def a32() -> np.ndarray:
    """int8 [256, 32]: row 8 b + j holds the register contribution of bit j
    of byte b of a 32-byte block (A's last 256 rows)."""
    t0 = tables()[0]
    out = np.zeros((8 * STEP, 32), dtype=np.int8)
    for j in range(8):
        v = int(t0[1 << j])
        for byte in range(STEP - 1, -1, -1):
            out[8 * byte + j] = _bits(v)
            v = _gf2_apply(shift_matrices()[0], v)
    return out


def m32() -> np.ndarray:
    """uint32 [32]: the columns of the advance over 32 zero bytes."""
    return shift_matrices()[5]


@functools.cache
def fragments() -> np.ndarray:
    """The kernel's B fragments, uint32 [9, 32, 4, 2] ([k-step][lane][n-tile]
    [b0, b1], 4 u8 a word).  Lane (g, t), byte i of b_r holds row slot
    4t + i + 16r, column 8 nt + g.  k-steps 0 .. 7: the slot is byte 8t +
    4r + i of the step's block (the lane's loads), the weight A32[8 byte +
    kk] scaled by 2^(7 - kk).  k-step 8: the slot is bit 16r + 8(i // 2) +
    2t + i % 2 of the register so far (the C fragment's columns of the
    lane), the weight M32's, 0/1."""
    A, M = a32().astype(np.uint32), m32()
    kk, lane, nt, r, i = np.meshgrid(
        np.arange(MMA_K_STEPS), np.arange(32), np.arange(4), np.arange(2), np.arange(4),
        indexing="ij",
    )
    g, t = lane // 4, lane % 4
    col = 8 * nt + g
    byte = 8 * t + 4 * r + i
    data = A[8 * byte + np.minimum(kk, 7), col] << (7 - np.minimum(kk, 7)).astype(np.uint32)
    bit = 16 * r + 8 * (i // 2) + 2 * t + i % 2
    state = (M[bit] >> col.astype(np.uint32)) & 1
    vals = np.where(kk < 8, data, state).astype(np.uint32)
    return (vals << (8 * np.arange(4, dtype=np.uint32))).sum(axis=-1, dtype=np.uint32)


@functools.cache
def consts() -> np.ndarray:
    """The kernel's constants, uint32 (offsets in crc32c_mma.cu): the B
    fragments, the advance tables of ``ADV_LEVELS`` [8, 4, 256], the 17
    inverse shift matrices and the init term."""
    return np.concatenate([
        fragments().reshape(-1), adv_tables()[list(ADV_LEVELS)].reshape(-1),
        inverse_shift_matrices().reshape(-1), np.array([init_term()], dtype=np.uint32),
    ])


def _check(chunks_u8: torch.Tensor, lengths: torch.Tensor) -> None:
    if chunks_u8.dtype != torch.uint8 or chunks_u8.dim() != 2 or chunks_u8.shape[1] != CHUNK:
        raise TypeError("chunks_u8 must be a uint8 tensor [N, 65536]")
    if not chunks_u8.is_contiguous() or chunks_u8.data_ptr() % 16:
        raise ValueError("chunks_u8 must be contiguous and 16-byte aligned")
    if lengths.dtype != torch.int32 or lengths.shape != chunks_u8.shape[:1]:
        raise TypeError("lengths must be an int32 tensor [N]")
    if lengths.device != chunks_u8.device or not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous, on the chunks' device")
    if len(lengths) and (int(lengths.min()) < 0 or int(lengths.max()) > CHUNK):
        raise ValueError("lengths must lie in [0, 65536]")


def masked_crc32c_chunks_fused(chunks_u8: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Masked CRC32C of ``chunks_u8[i, :lengths[i]]`` for each row.

    chunks_u8: uint8 [N, 65536], zero past each length; lengths: int32
    [N].  Returns uint32 [N] on the same device."""
    _check(chunks_u8, lengths)
    dev = chunks_u8.device
    if dev.type == "cpu":
        past = torch.arange(CHUNK) >= lengths[:, None].to(torch.int64)
        if bool((chunks_u8 * past).any()):
            raise ValueError("chunks_u8 must be zero past each length")
        return _crc32c_mma_plain(chunks_u8, lengths)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(len(lengths), dtype=torch.uint32, device=dev)
    if len(lengths):
        _launch(chunks_u8, lengths, out)
    return out


def _launch(chunks_u8: torch.Tensor, lengths: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on checked CUDA tensors (N >= 1), no checks."""
    dev = chunks_u8.device
    if dev not in _consts:
        _consts[dev] = torch.from_numpy(consts()).to(dev)
    _build.launch(
        "crc32c_mma", dev,
        chunks_u8.data_ptr(), lengths.data_ptr(), len(lengths), _consts[dev].data_ptr(),
        out.data_ptr(),
    )
    telemetry.count("k6.launches")


def kernel_params(lib) -> Dict[str, int]:
    """The kernel's constants, as ``csrc/crc32c_mma.cu`` defines them, read
    from a build of it (``_build.cuda_lib()`` or ``_build.twin_lib()``): the
    chunk's bytes, the warps of a CTA, a stripe's bytes, the steps loaded
    ahead, the shared bytes of a CTA, its CTAs per SM (0 in the twin) and
    the words of the constants."""
    fn = lib.stpu_crc32c_mma_params
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p]
    p = np.zeros(7, dtype=np.int64)
    fn(p.ctypes.data)
    keys = ("chunk", "warps", "stripe", "ring", "smem_bytes", "ctas_per_sm", "const_words")
    return dict(zip(keys, (int(v) for v in p)))


def registers_plain(chunks_u8: torch.Tensor) -> np.ndarray:
    """Zero-init registers of [N, 65536] chunks by the int32 matmul
    formulation (crc32c_mxu._registers, :102-113), 8 chunks at a time."""
    A, B = (torch.from_numpy(m.astype(np.int32)) for m in matrices())
    shifts = torch.arange(8, dtype=torch.int32)
    weights = torch.tensor([1 << r for r in range(32)], dtype=torch.int64)
    regs = []
    for rows in torch.split(chunks_u8.cpu(), 8):
        n = rows.shape[0]
        bits = ((rows.to(torch.int32)[..., None] >> shifts) & 1).reshape(n * N_SUPER, SBITS)
        r1 = ((bits @ A) & 1).reshape(n, N_SUPER * 32)
        r2 = (r1 @ B) & 1
        regs.append((r2.to(torch.int64) * weights).sum(dim=1))
    return torch.cat(regs).numpy().astype(np.uint32) if regs else np.zeros(0, np.uint32)


def _crc32c_mma_plain(chunks_u8: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The plain version: stage 1 and stage 2 as int32 matmuls, then the
    init term, the zero-tail cancellation and the mask."""
    out = finish(registers_plain(chunks_u8), lengths.cpu().numpy())
    return torch.from_numpy(out).to(chunks_u8.device)
