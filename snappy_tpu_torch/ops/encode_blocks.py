"""Snappy block encoder, levels 1 and 2 (kernel K3).

JAX counterpart: snappy_tpu/ops/encode_scalar.py (the TPU kernel
``_kernel`` at ``ways=1`` and ``ways=2``, launched by
``encode_blocks_words``).  The CUDA kernel is ``csrc/encode_blocks.cu``:
one warp walks a block, 32 probes a batch; a persistent grid of such
walkers (``launch_shape``) takes the blocks from a queue on the card,
costliest first where there are more blocks than walkers.
The bytes equal the host C encoder at the same level
(snappy_codec.c:127-222), which equals the TPU kernel's.  Level >= 2
selects ``ways=2``, two-entry FIFO hash buckets, as the JAX engine does
(engine.py:222).

Each row's encoded bytes are ``enc[i, :enc_len[i]]``; what lies past them
is unspecified.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from .. import telemetry
from ..formats import constants as C
from . import _build

BLOCK = C.MAX_BLOCK_LEN
# Output capacity per block: the format's worst case plus 16 bytes of slack
# (snappy_codec.c:52-64 writes literal bursts up to 16 bytes past the end).
ENC_CAP = C.max_compressed_len(BLOCK) + 16

_TABLE_BITS = 14
_K_HASH = 0x1E35A7BD
TABLE_BYTES = 2 << _TABLE_BITS  # one way of a walker's uint16 hash table


def _check(blocks_u8: torch.Tensor, lens: torch.Tensor) -> None:
    if blocks_u8.dtype != torch.uint8 or blocks_u8.dim() != 2:
        raise TypeError("blocks_u8 must be a uint8 tensor [N, W]")
    if blocks_u8.shape[0] and blocks_u8.stride(1) != 1:
        raise ValueError("blocks_u8 rows must be contiguous")
    if lens.dtype != torch.int32 or lens.shape != blocks_u8.shape[:1]:
        raise TypeError("lens must be an int32 tensor [N]")
    if lens.device != blocks_u8.device or not lens.is_contiguous():
        raise ValueError("lens must be contiguous, on the blocks' device")
    if not len(lens):
        return
    with telemetry.span("read.k3_lengths", reads=2):
        lo, hi = int(lens.min()), int(lens.max())
    if lo < 0 or hi > min(BLOCK, blocks_u8.shape[1]):
        raise ValueError("lens must lie in [0, min(W, 65536)]")


def encode_blocks(
    blocks_u8: torch.Tensor, lens: torch.Tensor, level: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``blocks_u8[i, :lens[i]]`` to a raw tag stream (no varint
    header) for each row, at ``level`` (1, or >= 2 for two-way buckets).

    blocks_u8: uint8 [N, W]; lens: int32 [N], each <= 65536.  Returns
    (enc uint8 [N, ENC_CAP], enc_len int32 [N]) on the same device."""
    with telemetry.span("k3"):
        _check(blocks_u8, lens)
        ways = 2 if level >= 2 else 1
        dev = blocks_u8.device
        if dev.type == "cpu":
            return _encode_blocks_plain(blocks_u8, lens, ways)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        n = len(lens)
        enc = torch.empty((n, ENC_CAP), dtype=torch.uint8, device=dev)
        enc_len = torch.empty(n, dtype=torch.int32, device=dev)
        if n:
            _launch(blocks_u8, lens, enc, enc_len, ways)
        return enc, enc_len


def launch_shape(n: int, ways: int, smem_optin: int, sms: int) -> Tuple[int, int]:
    """K3's grid for ``n`` >= 1 blocks at ``ways`` on a card of ``sms``
    SMs whose CTAs may opt in to ``smem_optin`` bytes of shared memory:
    (walkers, CTAs).  A walker is a warp with its own hash table of ``ways
    * TABLE_BYTES``; a CTA holds as many as that memory allows, at least
    one, and there is at most one CTA an SM.  The grid holds no more
    walkers than blocks, spread over as many SMs as there are blocks: each
    CTA has ceil(walkers / CTAs) warps, and warp w of CTA c walks as
    walker w * CTAs + c where that is below ``walkers``."""
    per_cta = max(1, smem_optin // (ways * TABLE_BYTES))
    return min(n, per_cta * sms), min(n, sms)


def card_limits(dev: torch.device) -> Tuple[int, int]:
    """(opt-in shared memory per CTA in bytes, SMs) of the CUDA device ``dev``."""
    return _card_limits(torch.cuda.current_device() if dev.index is None else dev.index)


@functools.cache
def _card_limits(index: int) -> Tuple[int, int]:
    fn = _build.cuda_lib().stpu_encode_blocks_limits
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    limits = np.zeros(2, dtype=np.int64)
    rc = fn(index, limits.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"encode_blocks: CUDA error {rc} reading device {index}'s limits")
    return int(limits[0]), int(limits[1])


def _launch(blocks_u8, lens, enc, enc_len, ways: int = 1) -> None:
    """Launch the kernel on checked CUDA tensors (N >= 1), no checks.
    With more rows than walkers the rows are walked costliest first: a
    first launch times level-1 walks of four pieces of each row."""
    dev = blocks_u8.device
    n = len(lens)
    limits = card_limits(dev)
    walkers, ctas = launch_shape(n, ways, *limits)
    queue = torch.empty(1, dtype=torch.int32, device=dev)  # the next entry; each launch zeroes it
    rows = (blocks_u8.data_ptr(), blocks_u8.stride(0), lens.data_ptr(), n, enc.data_ptr(),
            enc.shape[1], enc_len.data_ptr())
    order = None
    if n > walkers:  # the last walks to start set the end: start the longest first
        cost = torch.empty(n, dtype=torch.int32, device=dev)
        _build.launch("encode_blocks", dev, *rows, 1, *launch_shape(n, 1, *limits), queue.data_ptr(),
                      cost.data_ptr(), None)
        order = torch.argsort(cost, descending=True, stable=True).to(torch.int32)
        telemetry.count("k3.ordered")
    _build.launch("encode_blocks", dev, *rows, ways, walkers, ctas, queue.data_ptr(), None,
                  None if order is None else order.data_ptr())
    telemetry.count("k3.launches" if ways == 1 else "k3.launches_l2")
    telemetry.count("k3.walkers", walkers)


def _literal(out: bytearray, lit: bytes) -> None:
    n = len(lit) - 1
    if n < 60:
        out.append(n << 2)
    elif n < 256:
        out += bytes((60 << 2, n))
    else:
        out += bytes((61 << 2, n & 0xFF, n >> 8))
    out += lit


def _copy(out: bytearray, offset: int, length: int) -> None:
    def copy2(ln):
        out.extend((((ln - 1) << 2) | 2, offset & 0xFF, offset >> 8))

    while length >= 68:
        copy2(64)
        length -= 64
    if length > 64:
        copy2(60)
        length -= 60
    if length >= 12 or offset >= 2048:
        copy2(length)
    else:
        out.extend((((offset >> 8) << 5) | (((length - 4) & 7) << 2) | 1, offset & 0xFF))


def table_bits(n: int) -> int:
    """log2 of the hash table's entries per way for a block of n bytes
    (snappy_codec.c:138): the least power of two >= n, from 256 to 16 K."""
    size = 256
    while size < (1 << _TABLE_BITS) and size < n:
        size <<= 1
    return size.bit_length() - 1


def hash_word(u, bits: int):
    """The bucket of the 4-byte word ``u`` (an int, or a numpy uint64
    array) in a table of 2^bits entries."""
    return ((u * _K_HASH) & 0xFFFFFFFF) >> (32 - bits)


def encode_block(data: bytes, ways: int = 1) -> bytes:
    """Greedy encode of one block (<= 64 KiB) with ``ways``-entry hash
    buckets: the plain version's per-block body, a line-for-line port of
    encode_block_impl.  At ways=2 bucket ``h`` is the FIFO
    ``table[2h]`` (newest), ``table[2h + 1]``."""
    n = len(data)
    out = bytearray()
    if n < C.MIN_NON_LITERAL_BLOCK_SIZE:
        if n:
            _literal(out, data)
        return bytes(out)
    bits = table_bits(n)
    table = [0] * (ways << bits)

    def load(p):
        return int.from_bytes(data[p : p + 4], "little")

    def hsh(u):
        return hash_word(u, bits)

    ip = 1
    ip_limit = n - C.INPUT_MARGIN
    next_emit = 0
    while True:
        skip = 32
        next_ip = ip
        while True:  # probe loop with the 1/32 skip heuristic
            ip = next_ip
            step = skip >> 5
            skip += step
            next_ip = ip + step
            if next_ip > ip_limit:
                if next_emit < n:
                    _literal(out, data[next_emit:])
                return bytes(out)
            cur = load(ip)
            h = hsh(cur)
            if ways == 1:
                candidate = table[h]
                table[h] = ip
                if cur == load(candidate):
                    break
            else:
                c1, c2 = table[2 * h], table[2 * h + 1]
                table[2 * h + 1], table[2 * h] = c1, ip
                if cur == load(c1):
                    candidate = c1
                    break
                if cur == load(c2):
                    candidate = c2
                    break
        if next_emit < ip:
            _literal(out, data[next_emit:ip])
        while True:  # match extension loop
            base = ip
            s1, s2 = candidate + 4, ip + 4
            while s2 < n and data[s1] == data[s2]:
                s1 += 1
                s2 += 1
            ip = s2
            _copy(out, base - candidate, ip - base)
            next_emit = ip
            if ip > ip_limit:
                if next_emit < n:
                    _literal(out, data[next_emit:])
                return bytes(out)
            hp = hsh(load(ip - 1))
            cur = load(ip)
            h = hsh(cur)
            if ways == 1:
                table[hp] = ip - 1
                candidate = table[h]
                table[h] = ip
                if cur != load(candidate):
                    ip += 1
                    break
            else:
                table[2 * hp + 1], table[2 * hp] = table[2 * hp], ip - 1
                c1, c2 = table[2 * h], table[2 * h + 1]
                table[2 * h + 1], table[2 * h] = c1, ip
                if cur == load(c1):
                    candidate = c1
                elif cur == load(c2):
                    candidate = c2
                else:
                    ip += 1
                    break


def _encode_blocks_plain(blocks_u8: torch.Tensor, lens: torch.Tensor, ways: int = 1):
    """The plain version: ``encode_block`` on each row in turn."""
    rows = blocks_u8.cpu().numpy()
    enc = np.zeros((len(rows), ENC_CAP), dtype=np.uint8)
    enc_len = np.zeros(len(rows), dtype=np.int32)
    for k, n in enumerate(lens.tolist()):
        e = encode_block(rows[k, :n].tobytes(), ways)
        enc[k, : len(e)] = np.frombuffer(e, dtype=np.uint8)
        enc_len[k] = len(e)
    dev = blocks_u8.device
    return torch.from_numpy(enc).to(dev), torch.from_numpy(enc_len).to(dev)


def from_jax_packed(meta: np.ndarray, in_words: np.ndarray):
    """Turn ``snappy_tpu.ops.encode_scalar.pack_blocks`` output (meta int32
    [nb, 1, 1] block lengths, in_words int32 [nb, 1, IN_PAD]) into this
    module's inputs (blocks_u8 [nb, 65536], lens int32 [nb]), on the CPU."""
    nb = meta.shape[0]
    rows = np.ascontiguousarray(in_words).view(np.uint8).reshape(nb, -1)
    return (
        torch.from_numpy(np.ascontiguousarray(rows[:, :BLOCK])),
        torch.from_numpy(meta[:, 0, 0].astype(np.int32)),
    )
