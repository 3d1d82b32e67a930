"""Array-parallel Snappy block encoder: the JAX package's second device
route, in PyTorch tensor operations on the device of its inputs.

JAX counterpart: snappy_tpu/ops/encode_jax.py (``_nearest_prev_candidate``,
``_lcp``, ``_reach_from_zero``, ``_encode_block_padded``,
``encode_blocks``), an XLA program that reaches no Pallas kernel.  It is
another matcher than the block encoder K3 (ops/encode_blocks.py) and the
host C encoder, and gives other bytes:

1. each position's candidate is the nearest earlier position with the same
   4-gram, from a stable sort of the 4-grams; a second candidate carries a
   capped match on at +64 with the same offset;
2. the match length against the candidate, capped at 68, from 17 word
   compares and the trailing zero bytes of the first unequal word;
3. the greedy parse (a copy where the match is long enough, else one
   literal byte) as the positions reachable from 0 by pointer doubling;
4. an exclusive prefix sum of the units' encoded sizes places each literal
   run and copy, and every output byte is computed where it lands.

Rows are independent blocks (JAX's ``vmap``), zero-padded beyond their
lengths: the bytes there enter the match lengths before they are cut to
the block, so they must be zero, as in the JAX engine.  The results equal
JAX's element for element; the uint32 and int32 arithmetic, the gathers
and the doubling loop follow the rules set out in ops/decode_array.py,
whose helpers this module shares.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .decode_array import _I64, _s32, _scatter_max, _u32, reach_by_doubling

_LCP_CAP = 68  # the reference's long-copy split (encoder.nim:96-111)
_NWORDS = _LCP_CAP // 4


def _nearest_prev_candidate(v4: torch.Tensor) -> torch.Tensor:
    """cand[i] = the nearest j < i with v4[j] == v4[i] in the same row,
    else -1.  ``v4``: int64 [N, b], non-negative."""
    sorted_v4, perm = torch.sort(v4, dim=1, stable=True)  # equal v4 grouped, ascending i inside
    n = v4.shape[0]
    prev_i = torch.cat([torch.full((n, 1), -1, dtype=_I64, device=v4.device), perm[:, :-1]], dim=1)
    same = torch.cat(
        [torch.zeros((n, 1), dtype=torch.bool, device=v4.device), sorted_v4[:, 1:] == sorted_v4[:, :-1]],
        dim=1,
    )
    cand_sorted = torch.where(same, prev_i, -1)
    return torch.zeros_like(v4).scatter_(1, perm, cand_sorted)


def _lcp(v4_ext: torch.Tensor, cand: torch.Tensor, b: int) -> torch.Tensor:
    """The match length, capped at 68, between each position i < b and
    cand[i] (-1: none).  ``v4_ext``: the little-endian 4-grams [N, b + 72]
    (uint32 values)."""
    j = cand.clamp(min=0)
    full_words = torch.zeros_like(cand)
    alive = cand >= 0
    xor_acc = torch.zeros_like(cand)
    have_neq = torch.zeros_like(alive)
    for t in range(_NWORDS):
        a_t = v4_ext[:, 4 * t : 4 * t + b]
        b_t = torch.gather(v4_ext, 1, j + 4 * t)  # j + 4 t <= b - 1 + 64 < b + 72
        eq = a_t == b_t
        adv = alive & eq
        full_words += adv
        first_neq = alive & ~eq & ~have_neq
        xor_acc = torch.where(first_neq, a_t ^ b_t, xor_acc)
        have_neq |= first_neq
        alive = adv
    # The bytes that match inside the first unequal word: the trailing zero
    # bytes of its XOR (little-endian loads: the lowest differing byte
    # first), which JAX counts as popcount(lowest set bit - 1) >> 3.
    tz_bytes = (
        ((xor_acc & 0xFF) == 0).to(_I64)
        + ((xor_acc & 0xFFFF) == 0).to(_I64)
        + ((xor_acc & 0xFFFFFF) == 0).to(_I64)
    )
    extra = torch.where(have_neq, tz_bytes, 0)
    return torch.clamp(full_words * 4 + extra, max=_LCP_CAP)


def _reach_from_zero(jump: torch.Tensor) -> torch.Tensor:
    """Positions reachable from 0 under ``jump`` (int64 [N, size], absorbing
    at size - 1): encode_jax._reach_from_zero over rows."""
    reach = torch.zeros(jump.shape, dtype=torch.int32, device=jump.device)
    reach[:, 0] = 1
    return reach_by_doubling(jump, reach) > 0


def encode_blocks(blocks: torch.Tensor, blens, max_comp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode the blocks in the rows of ``blocks`` (byte values [N, b], any
    integer dtype, b >= 64, zero-padded beyond ``blens``, int32 [N]) into raw
    tag streams of at most ``max_comp`` bytes (encode_jax.encode_blocks,
    ``_encode_block_padded`` over rows).  Returns (out uint8 [N, max_comp],
    totals int32 [N]) on ``blocks``' device."""
    dev = blocks.device
    n, b = blocks.shape
    pad = _LCP_CAP + 4
    blk = blocks.to(_I64)
    ub = _u32(torch.cat([blk, torch.zeros((n, pad), dtype=_I64, device=dev)], dim=1))
    v4 = _u32(ub[:, 0:b] | (ub[:, 1 : b + 1] << 8) | (ub[:, 2 : b + 2] << 16) | (ub[:, 3 : b + 3] << 24))
    del ub
    v4_ext = torch.cat([v4, torch.zeros((n, pad), dtype=_I64, device=dev)], dim=1)
    idx = torch.arange(b, dtype=_I64, device=dev).expand(n, b)
    bl = _s32(torch.as_tensor(blens, device=dev).to(_I64).reshape(n))[:, None]

    in_block = idx + 4 <= bl  # a match starts only where a whole 4-gram is data
    cand = torch.where(in_block, _nearest_prev_candidate(v4), -1)
    lcp = _lcp(v4_ext, cand, b)

    # The continuation candidate: whatever distance position i - 64 matched
    # at also matches at i (a capped match emits 64 bytes and re-matches).
    cand_prev = torch.cat([torch.full((n, 64), -1, dtype=_I64, device=dev), cand[:, :-64]], dim=1)
    cand2 = torch.where(cand_prev >= 0, cand_prev + 64, -1)
    del cand_prev
    # cand2 <= b - 1: cand_prev < i - 64 + 1
    same4 = torch.gather(v4_ext, 1, cand2.clamp(min=0)) == v4
    cand2 = torch.where(in_block & (cand2 >= 0) & same4, cand2, -1)
    del same4, in_block
    lcp2 = _lcp(v4_ext, cand2, b)
    del v4_ext, v4
    better = (lcp2 > lcp) | ((lcp2 == lcp) & (cand2 > cand) & (cand2 >= 0))
    cand = torch.where(better, cand2, cand)
    lcp = torch.where(better, lcp2, lcp)
    del cand2, lcp2, better

    # Matches end at the block's end; length-4 matches only as copy1.
    lcp = torch.minimum(lcp, (bl - idx).clamp(min=0))
    is_match = (lcp >= 4) & (cand >= 0) & ((lcp > 4) | (idx - cand < 2048))
    offset = _u32(torch.where(is_match, idx - cand, 0))
    del cand

    # Greedy parse: +64 for a capped match, +lcp for a match, +1 a literal.
    adv = torch.where(is_match, torch.where(lcp == _LCP_CAP, 64, lcp), 1)
    jump = torch.where(idx < bl, torch.clamp(idx + adv, max=b), b)
    del adv
    tail = torch.full((n, 1), b, dtype=_I64, device=dev)
    chosen = _reach_from_zero(torch.cat([jump, tail], dim=1))[:, :b] & (idx < bl)
    del jump
    copy_sel = chosen & is_match
    lit_sel = chosen & ~is_match
    del chosen, is_match

    # Literal runs: maximal runs of chosen literal positions.
    prev_lit = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=dev), lit_sel[:, :-1]], dim=1)
    run_start = lit_sel & ~prev_lit
    del prev_lit, lit_sel
    arr = torch.where(copy_sel, idx, b)
    ncp = torch.flip(torch.cummin(torch.flip(arr, [1]), dim=1).values, [1])
    run_len = _u32(torch.where(run_start, torch.minimum(ncp, bl) - idx, 0))
    del arr, ncp

    # Each unit's encoded size.
    n_lit = _u32(run_len - 1)
    lit_hdr = torch.where(n_lit < 60, 1, torch.where(n_lit < 256, 2, 3))
    lit_bytes = _u32(lit_hdr + run_len)
    is_cap = lcp == _LCP_CAP
    is_dbl = (lcp > 64) & (lcp < _LCP_CAP)  # 65..67: copy2(60) + a short tag
    short_len = torch.where(is_dbl, lcp - 60, lcp)
    short_is_c1 = (short_len < 12) & (offset < 2048)
    copy_bytes = torch.where(is_cap, 3, torch.where(is_dbl, 3, 0) + torch.where(short_is_c1, 2, 3))
    unit_mask = run_start | copy_sel
    unit_bytes = torch.where(run_start, lit_bytes, torch.where(copy_sel, copy_bytes, 0))
    del lit_bytes, copy_bytes, n_lit, lcp
    incl = _u32(torch.cumsum(unit_bytes, dim=1))
    out_off = _s32(incl - unit_bytes)
    if b > 0:
        total = _s32(incl[:, -1])
    else:
        total = torch.zeros(n, dtype=_I64, device=dev)
    del incl, unit_bytes

    # Every output byte from its unit: the units' starts, run forward.
    scat = torch.where(unit_mask, out_off, max_comp)
    seg = _scatter_max(
        torch.zeros((n, max_comp), dtype=_I64, device=dev), scat, torch.where(unit_mask, idx, 0)
    )
    seg = torch.cummax(seg, dim=1).values  # in [0, b): block positions
    del scat, unit_mask

    def at(x: torch.Tensor) -> torch.Tensor:
        return torch.gather(x, 1, seg)

    p = torch.arange(max_comp, dtype=_I64, device=dev).expand(n, max_comp)
    rel = _s32(p - at(out_off))
    u_is_copy = at(copy_sel)
    u_offv = at(offset)
    u_cap = at(is_cap)
    u_dbl = at(is_dbl)
    u_c1 = at(short_is_c1)
    u_slen = at(short_len)
    u_nlit = _u32(at(run_len) - 1)
    u_lhdr = at(lit_hdr)
    del out_off, copy_sel, offset, is_cap, is_dbl, short_is_c1, short_len, run_len, lit_hdr, run_start

    off_lo = u_offv & 0xFF
    off_hi = (u_offv >> 8) & 0xFF

    def copy2_tag(length):
        return _u32((_u32(length - 1) << 2) | 2)

    def copy1_tag(length):
        return _u32(((u_offv >> 8) << 5) | (_u32(length - 4) << 2) | 1)

    # A copy unit, at rel: cap [copy2(64), lo, hi]; dbl [copy2(60), lo, hi,
    # then the single tag]; else the single tag (copy1 or copy2 of short_len).
    single0 = torch.where(u_c1, copy1_tag(u_slen), copy2_tag(u_slen))
    first0 = torch.where(u_cap, (63 << 2) | 2, (59 << 2) | 2)
    head_is_c2 = u_cap | u_dbl
    rel2 = torch.where(u_dbl, rel - 3, rel)
    copy_byte = torch.where(
        head_is_c2 & (rel == 0), first0,
        torch.where(
            head_is_c2 & (rel == 1), off_lo,
            torch.where(
                head_is_c2 & (rel == 2), off_hi,
                torch.where(rel2 == 0, single0, torch.where(rel2 == 1, off_lo, off_hi)),
            ),
        ),
    )
    del single0, first0, head_is_c2, rel2, u_cap, u_dbl, u_c1, u_slen, off_lo, off_hi

    # A literal unit, at rel: its header, then its bytes.
    lit_b0 = torch.where(u_lhdr == 1, _u32(u_nlit << 2), torch.where(u_lhdr == 2, 60 << 2, 61 << 2))
    lit_byte_hdr = torch.where(rel == 0, lit_b0, torch.where(rel == 1, u_nlit & 0xFF, (u_nlit >> 8) & 0xFF))
    lit_src = _s32(seg + _s32(rel - u_lhdr)).clamp(0, b - 1)
    lit_byte = torch.where(rel < u_lhdr, lit_byte_hdr, _u32(torch.gather(blk, 1, lit_src)))
    del lit_b0, lit_byte_hdr, lit_src, u_nlit, seg

    out = (torch.where(u_is_copy, copy_byte, lit_byte) & 0xFF).to(torch.uint8)
    out.masked_fill_(p >= total[:, None], 0)
    return out, total.to(torch.int32)
