"""Array-parallel Snappy raw-stream decoder: the JAX package's second device
route, in PyTorch tensor operations on the device of its inputs.

JAX counterpart: snappy_tpu/ops/decode_jax.py (``_parse_all_positions``,
``_reachable``, ``_decode_raw_padded``, ``decode_raw``, ``decode_chunks``),
an XLA program that reaches no Pallas kernel.  The same three phases:

1. a speculative tag parse at every byte, then the true tag starts as the
   positions reachable from 0 under the jump function, by pointer doubling;
   the sequential decoder's checks as predicates over the reached set;
2. an exclusive prefix sum of the tags' output lengths places each tag,
   and a running maximum hands each output byte its tag;
3. copy chains resolved by pointer doubling, then two gathers for the
   bytes.

Every function here is batched: rows are independent streams, which is
JAX's ``vmap`` of the one-stream function.

The results are JAX's element for element on every input, valid or not:
the whole ``out`` row, ``ok`` and ``written``.  For that:

* every value is int64, and each operation that is uint32 in JAX is masked
  with ``& 0xFFFFFFFF`` (``_u32``), each int32 result wrapped to 32 bits
  (``_s32``): a literal length extension of ``0xFFFFFFFF`` wraps to 0, a
  consumed count can wrap, and so can the output prefix sum;
* a JAX gather counts a negative index from the end once and then clamps
  it (``_take``), a JAX scatter counts a negative index from the end once
  and drops what is still out of range (``_scatter_max``, whose dropped
  updates land in a spare slot that is sliced off).  Where an index is in
  range by construction, a comment says why and a plain ``gather`` is used;
* ``lax.while_loop`` becomes a Python loop that ends when nothing changed
  or after JAX's ``max_iters`` rounds, one ``.item()`` a round.  Over a
  batch it runs until every row is at its fixpoint, where JAX's batched
  loop leaves each row too (a doubling round at the fixpoint changes
  nothing).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
_I64 = torch.int64


def _u32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as JAX's uint32 holds it."""
    return x & M32


def _s32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as JAX's int32 holds it (two's complement wrap)."""
    return ((x + (1 << 31)) & M32) - (1 << 31)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` by JAX's gather rule: a negative index counts from
    the end once, then the index is clamped into ``[0, n)``."""
    n = x.shape[-1]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return torch.gather(x, -1, idx)


def _scatter_max(base: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``base.at[..., idx].max(val, mode="drop")`` in JAX: a negative index
    counts from the end once, and what is still out of range is dropped."""
    n = base.shape[-1]
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    out = torch.cat([base, base[..., :1]], dim=-1)  # slot n takes the dropped updates
    out.scatter_reduce_(-1, idx, val, "amax", include_self=True)
    return out[..., :n]


def max_iters(size: int) -> int:
    """JAX's cap on the doubling rounds over ``size`` positions."""
    return max(1, int(np.ceil(np.log2(size)))) + 1


def reach_by_doubling(jump: torch.Tensor, reach: torch.Tensor) -> torch.Tensor:
    """The positions reachable from those marked in ``reach`` (int [N,
    size], 1 or 0) under ``jump`` (int64 [N, size]): each round marks the
    targets of the marked positions and squares the jump function
    (decode_jax._reachable's and encode_jax._reach_from_zero's loop)."""
    limit = max_iters(jump.shape[-1])
    it, changed = 0, True
    while changed and it < limit:
        new = _scatter_max(reach, jump, reach)
        jump = _take(jump, jump)
        changed = bool((new != reach).any())
        reach = new
        it += 1
    return reach


def _parse_all_positions(comp_ext: torch.Tensor, c_pad: int):
    """A tag parsed at every position of the rows of ``comp_ext`` (int64
    [N, c_pad + 4], values as JAX's uint32 holds them).  Returns, over
    [N, c_pad]: consumed, outlen, hdr, offset (uint32 values), is_lit,
    wrap_bad (bool): decode_jax._parse_all_positions."""
    b = comp_ext[:, :c_pad]
    e1 = comp_ext[:, 1 : c_pad + 1]
    e2 = comp_ext[:, 2 : c_pad + 2]
    e3 = comp_ext[:, 3 : c_pad + 3]
    e4 = comp_ext[:, 4 : c_pad + 4]
    zero = torch.zeros((), dtype=_I64, device=b.device)

    t = b & 3
    lc = b >> 2
    is_lit = t == 0
    ex = (_s32(lc) - 59).clamp(0, 4)
    ext_val = _u32(
        torch.where(ex >= 1, e1, zero)
        | (torch.where(ex >= 2, e2, zero) << 8)
        | (torch.where(ex >= 3, e3, zero) << 16)
        | (torch.where(ex >= 4, e4, zero) << 24)
    )
    lit_len = _u32(torch.where(lc < 60, lc + 1, ext_val + 1))
    wrap_bad = is_lit & (lc >= 60) & (ext_val == M32)

    copy1_len = 4 + (lc & 7)
    copy1_off = _u32(((b & 0xE0) << 3) | e1)
    copy2_len = _u32(1 + lc)
    copy2_off = _u32(e1 | (e2 << 8))
    copy4_off = _u32(e1 | (e2 << 8) | (e3 << 16) | (e4 << 24))

    hdr = torch.where(is_lit, 1 + ex, torch.where(t == 1, 2, torch.where(t == 2, 3, 5)))
    outlen = torch.where(is_lit, lit_len, torch.where(t == 1, copy1_len, copy2_len))
    offset = torch.where(
        t == 1, copy1_off, torch.where(t == 2, copy2_off, torch.where(t == 3, copy4_off, zero))
    )
    consumed = _u32(hdr + torch.where(is_lit, lit_len, zero))
    return consumed, outlen, hdr, offset, is_lit, wrap_bad


def _reachable(next_pos: torch.Tensor, c_pad: int, comp_len: torch.Tensor):
    """decode_jax._reachable over rows: ``next_pos`` int64 [N, c_pad + 2]
    with the absorbing sentinels DONE = c_pad and ERR = c_pad + 1,
    ``comp_len`` int64 [N].  Returns (reached bool [N, c_pad], done bool
    [N], err bool [N])."""
    reach = torch.zeros(next_pos.shape, dtype=torch.int32, device=next_pos.device)
    reach[:, 0] = (comp_len > 0).to(torch.int32)
    reach = reach_by_doubling(next_pos, reach)
    return reach[:, :c_pad] > 0, reach[:, c_pad] > 0, reach[:, c_pad + 1] > 0


def decode_chunks(
    comp: torch.Tensor, comp_lens, out_lens, u_pad: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode the tag streams in the rows of ``comp`` (byte values [N,
    c_pad], any integer dtype, zero-padded beyond ``comp_lens``), each into
    ``u_pad`` bytes (decode_jax.decode_chunks, ``_decode_raw_padded`` over
    rows).  ``comp_lens`` and ``out_lens`` (the declared sizes) are [N]
    int32 values.  Returns (out uint8 [N, u_pad], ok bool [N], written
    int32 [N]) on ``comp``'s device."""
    dev = comp.device
    n, c_pad = comp.shape
    cx = torch.cat([comp.to(_I64), torch.zeros((n, 4), dtype=_I64, device=dev)], dim=1)
    consumed, outlen, hdr, offset, is_lit, wrap_bad = _parse_all_positions(_u32(cx), c_pad)
    cl = _s32(torch.as_tensor(comp_lens, device=dev).to(_I64).reshape(n))
    ol = _s32(torch.as_tensor(out_lens, device=dev).to(_I64).reshape(n))

    idx = torch.arange(c_pad, dtype=_I64, device=dev).expand(n, c_pad)
    remaining = _u32(_u32(cl)[:, None] - idx)
    tag_in_ok = (idx < cl[:, None]) & (consumed <= remaining)
    raw_next = _s32(torch.where(tag_in_ok, _u32(idx + consumed), 0))
    nxt = torch.where(
        tag_in_ok, torch.where(raw_next == cl[:, None], c_pad, raw_next), c_pad + 1
    )
    sentinels = torch.tensor([c_pad, c_pad + 1], dtype=_I64, device=dev).expand(n, 2)
    reached, done, err = _reachable(torch.cat([nxt, sentinels], dim=1), c_pad, cl)
    del remaining, tag_in_ok, raw_next, nxt, consumed

    # Output layout: exclusive prefix sum of the capped output lengths.
    out_len_u = _u32(ol)[:, None]
    contrib = torch.where(reached, torch.minimum(outlen, _u32(out_len_u + 1)), 0)
    incl = _u32(torch.cumsum(contrib, dim=1))
    out_start = _u32(incl - contrib)
    if c_pad > 0:
        written = _s32(incl[:, -1])
    else:
        written = torch.zeros(n, dtype=_I64, device=dev)
    overrun = (reached & (_u32(out_start + contrib) > out_len_u)).any(dim=1)
    bad_wrap = (reached & wrap_bad).any(dim=1)
    bad_offset = (reached & ~is_lit & ((offset == 0) | (offset > out_start))).any(dim=1)
    ok = done & ~err & ~overrun & ~bad_wrap & ~bad_offset & (written == ol)
    del incl, contrib, wrap_bad, outlen

    # Phase 2: each output byte's tag (its comp position and out start).
    out_start_i = _s32(out_start)
    scat_idx = torch.where(reached, out_start_i, u_pad)
    blank = torch.full((n, u_pad), -1, dtype=_I64, device=dev)
    seg_comp = _scatter_max(blank, scat_idx, torch.where(reached, idx, -1))
    seg_comp = torch.cummax(seg_comp, dim=1).values
    seg_out0 = _scatter_max(blank, scat_idx, torch.where(reached, out_start_i, -1))
    seg_out0 = torch.cummax(seg_out0, dim=1).values
    del blank, scat_idx, out_start_i, out_start, reached

    # in range: clipped into [0, c_pad) just here
    seg_comp_c = seg_comp.clamp(0, c_pad - 1)
    del seg_comp
    j = torch.arange(u_pad, dtype=_I64, device=dev).expand(n, u_pad)
    j_rel = _s32(j - seg_out0.clamp(min=0))
    del seg_out0
    tag_is_lit = torch.gather(is_lit, 1, seg_comp_c)
    tag_hdr = _s32(torch.gather(hdr, 1, seg_comp_c))
    tag_off = _s32(torch.gather(offset, 1, seg_comp_c))
    lit_src = _s32(seg_comp_c + tag_hdr + j_rel)
    del j_rel, tag_hdr, seg_comp_c
    ptr = torch.where(tag_is_lit, j, (j - tag_off.clamp(min=1)).clamp(0, u_pad - 1))
    del tag_is_lit, tag_off

    # Phase 3: copy chains by pointer doubling.  Every pointer is in
    # [0, u_pad): a literal byte points at itself, a copy byte is clipped.
    limit = max_iters(u_pad)
    it, changed = 0, True
    while changed and it < limit:
        nxt_ptr = torch.gather(ptr, 1, ptr)
        changed = bool((nxt_ptr != ptr).any())
        ptr = nxt_ptr
        it += 1

    # ptr in range (above); src clipped into comp_ext's [0, c_pad + 4)
    src = torch.gather(lit_src, 1, ptr).clamp(0, c_pad + 3)
    del lit_src, ptr
    out = (torch.gather(cx, 1, src) & 0xFF).to(torch.uint8)
    out = out.masked_fill_(j >= ol[:, None], 0)
    return out, ok, written.to(torch.int32)


def decode_raw(
    comp: torch.Tensor, comp_len, out_len, u_pad: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode one tag stream (no varint header): ``comp`` byte values
    [c_pad] zero-padded beyond ``comp_len``, ``out_len`` the declared size
    (decode_jax.decode_raw).  Returns (out uint8 [u_pad], ok bool, written
    int32) as 0-d tensors beside ``out``."""
    out, ok, written = decode_chunks(comp.reshape(1, -1), [comp_len], [out_len], u_pad)
    return out[0], ok[0], written[0]
