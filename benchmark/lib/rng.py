"""Seeded data on any device: splitmix64 of a counter.

Word ``i`` of stream ``s`` under seed ``k`` is splitmix64's output for the
counter ``key(k, s) + i * GOLDEN``, computed with int64 tensor operations
that wrap the same way on the CPU and the card.  The same seed gives the
same bytes on every device and every release of NumPy and PyTorch; any
whole number is a seed (taken modulo 2^64).  Where a share of a
configuration is a count, ``permutation`` places exactly that count, so
that every seed gives the same amount of each kind of work.
"""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15
_C1 = 0xBF58476D1CE4E5B9
_C2 = 0x94D049BB133111EB


def _signed(v: int) -> int:
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def _mix(z: int) -> int:
    z = ((z ^ (z >> 30)) * _C1) & _M64
    z = ((z ^ (z >> 27)) * _C2) & _M64
    return z ^ (z >> 31)


def key(seed: int, stream: int) -> int:
    """The counter base of ``stream`` under ``seed``."""
    return _mix((_mix(seed & _M64) + stream * GOLDEN) & _M64)


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 words."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def words(seed: int, stream: int, n: int, device) -> torch.Tensor:
    """int64 [n]: 64 random bits each."""
    z = torch.arange(n, dtype=torch.int64, device=device) * _signed(GOLDEN) + _signed(key(seed, stream))
    z = (z ^ _srl(z, 30)) * _signed(_C1)
    z = (z ^ _srl(z, 27)) * _signed(_C2)
    return z ^ _srl(z, 31)


def random_bytes(seed: int, stream: int, n: int, device) -> torch.Tensor:
    """uint8 [n]."""
    return words(seed, stream, -(-n // 8), device).view(torch.uint8)[:n]


def uniform(seed: int, stream: int, n: int, device) -> torch.Tensor:
    """float64 [n] in [0, 1), 53 bits each."""
    return _srl(words(seed, stream, n, device), 11).double() * 2.0**-53


def permutation(seed: int, stream: int, n: int, device) -> torch.Tensor:
    """int64 [n]: 0 .. n - 1 in an order drawn from the seed."""
    return torch.argsort(words(seed, stream, n, device))


def below(seed: int, stream: int, n: int, bound: int, device) -> torch.Tensor:
    """int64 [n] in [0, bound)."""
    return (uniform(seed, stream, n, device) * bound).long().clamp_(max=bound - 1)
