"""Streaming raw-format decoders: one raw stream of any size, in grid
mode (kernel K4) or scan mode (kernel K5).

JAX counterpart: snappy_tpu/ops/decode_stream.py.

* Grid mode, ``decode_stream``: the TPU kernel ``_kernel_grid``, launched
  by ``decode_raw_stream_grid``.  The CUDA kernel is
  ``csrc/decode_stream.cu``: one CTA walks the stream in 64 KiB output
  windows staged in shared memory, with 64-bit cursors, so any declared
  length up to ``MAX_UNCOMPRESSED_LEN`` is taken; every legal copy offset
  is served.  The verdict: ``ok`` = no malformed tag, ``consumed ==
  len(body)`` and ``written == declared``; ``written`` is the output
  produced before the first bad tag and ``consumed`` that tag's offset (or
  the body's end), as the sequential decoder reports them.
* Scan mode, ``decode_stream_scan``: the TPU kernel ``_kernel``, launched
  once per window by the ``lax.scan`` of ``decode_raw_stream``.  The CUDA
  kernel is ``csrc/decode_stream_scan.cu``: one launch per scan step, the
  scan state in a small int64 tensor on the card, each window written at
  its final offset of one flat output.  It keeps the TPU kernel's
  verdicts, ``unsupported`` included: a copy reaching more than 64 KiB
  behind its window's start.

``decode_raw_stream_bytes`` picks the mode from ``SNAPPY_TPU_STREAM_MODE``
(``grid`` by default), as the JAX function does.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import config
from . import _build
from .decode_chunks import decode_tags

LAUNCHES = 0  # kernel launches made by decode_stream
LAUNCHES_SCAN = 0  # kernel launches made by decode_stream_scan

SC_BYTES = 76800  # scan mode's comp window (4 * SC_WORDS)
WIN = 65536  # scan mode's output window (4 * OW_WORDS)
MARGIN = 8
STATE_WORDS = 16
# the scan state, int64 [STATE_WORDS] (decode_stream_scan.cu)
S_POS, S_WRITTEN, S_ERR, S_DONE, S_UNSUP, S_PK, S_PLEN, S_POFF = range(8)


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


# ---------------------------------------------------------------------------
# Scan mode (K5)
# ---------------------------------------------------------------------------


def n_steps(comp_len: int, declared: int) -> int:
    """The scan's step count (decode_stream.py:641-651): every step fills a
    64 KiB output window or drains a comp window, rounded up to 4, 16, 64,
    256 and then multiples of 256."""
    need = -(-declared // WIN) + -(-comp_len // (SC_BYTES - 256)) + 2
    for b in (4, 16, 64, 256):
        if need <= b:
            return b
    return -(-need // 256) * 256


def decode_stream_scan(
    comp_u8: torch.Tensor, declared: int, out: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode the raw tag stream ``comp_u8`` (no varint header) with
    declared length ``declared`` into ``out`` by ``n_steps`` scan steps.

    Returns (state int64 [16], writtens int64 [steps]) on out's device:
    the final scan state (see ``scan_status``) and each step's window
    length; step ``k``'s window is ``out[sum(writtens[:k]):][:writtens[k]]``."""
    _check(comp_u8, declared, out)
    dev = out.device
    steps = n_steps(comp_u8.shape[0], declared)
    state = torch.zeros(STATE_WORDS, dtype=torch.int64, device=dev)
    writtens = torch.zeros(steps, dtype=torch.int64, device=dev)
    if dev.type == "cpu":
        _scan_plain(comp_u8.numpy().tobytes(), declared, out.numpy(), state.numpy(), writtens.numpy())
        return state, writtens
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for k in range(steps):
        _launch_scan(comp_u8, declared, out, state, writtens, k)
    return state, writtens


def _launch_scan(comp_u8, declared: int, out, state, writtens, step: int) -> None:
    """Launch one scan step on checked CUDA tensors, no checks."""
    _build.launch(
        "decode_stream_scan", out.device,
        comp_u8.data_ptr(), comp_u8.shape[0], declared, out.data_ptr(),
        state.data_ptr(), writtens.data_ptr(), step,
    )
    global LAUNCHES_SCAN
    LAUNCHES_SCAN += 1


def scan_status(state, comp_len: int, declared: int) -> Tuple[int, int, int, int, int]:
    """(ok, err, unsupported, total_written, consumed) of a final scan
    state: the JAX function's status (decode_stream.py:622-637)."""
    st = [int(x) for x in state[:8]]
    ok = (st[S_DONE] and not st[S_ERR] and not st[S_UNSUP]
          and st[S_WRITTEN] == declared and st[S_POS] == comp_len)
    return int(ok), st[S_ERR], st[S_UNSUP], st[S_WRITTEN], st[S_POS]


def _tag(comp: bytes, q: int) -> Tuple[int, int, int, int]:
    """(kind, hdr, length, offset) of the tag at comp[q] (parse_tag of
    snappy_common.cuh): bytes past the stream read as zero."""
    b = comp[q]
    kind = b & 3
    if kind == 0:
        lc = b >> 2
        if lc < 60:
            return 0, 1, lc + 1, 0
        ex = lc - 59
        return 0, 1 + ex, int.from_bytes(comp[q + 1 : q + 1 + ex].ljust(ex, b"\0"), "little") + 1, 0
    if kind == 1:
        nxt = comp[q + 1] if q + 1 < len(comp) else 0
        return 1, 2, 4 + ((b >> 2) & 7), ((b & 0xE0) << 3) | nxt
    hdr = 3 if kind == 2 else 5
    return kind, hdr, 1 + (b >> 2), int.from_bytes(comp[q + 1 : q + hdr].ljust(hdr - 1, b"\0"), "little")


def _copy(out: np.ndarray, o: int, off: int, n: int) -> None:
    """out[o:o + n] = the n bytes that a copy at offset ``off`` emits."""
    if off >= n:
        out[o : o + n] = out[o - off : o - off + n]
    else:
        out[o : o + n] = np.resize(out[o - off : o].copy(), n)


def scan_step_plain(comp: bytes, declared: int, out: np.ndarray, state: np.ndarray) -> int:
    """One scan step (scan_step of decode_stream_scan.cu, line for line):
    updates ``state`` and ``out`` in place and returns the step's written
    length."""
    n = len(comp)
    pos_total, base_w, err, done, _unsup, pk, plen, poff = (int(x) for x in state[:8])
    m = min(WIN, declared - base_w)
    if done or err or (m <= 0 and pk <= 0):
        return 0
    m = max(m, 0)
    wb4 = pos_total & ~3
    start = pos_total - wb4
    navail = min(max(n - wb4, 0), SC_BYTES)
    more = wb4 + navail < n
    pos, w = start, 0
    err = unsup = False
    if pk == 1:
        eff = max(min(plen, m, navail - start), 0)
        out[base_w : base_w + eff] = np.frombuffer(comp, np.uint8, eff, wb4 + start)
        pos, w = start + eff, eff
        plen -= eff
        pk = 1 if plen > 0 else 0
    elif pk == 2:
        eff = max(min(plen, m), 0)
        _copy(out, base_w, poff, eff)
        w = eff
        plen -= eff
        pk = 2 if plen > 0 else 0
    else:
        pk = plen = 0
    stop = pk > 0
    while pos < navail and not err and not stop and w < m and not (more and pos > navail - MARGIN):
        kind, hdr, length, off = _tag(comp, wb4 + pos)
        lit = kind == 0
        bad = length > 0x7FFFFFFF if lit else off > 0x7FFFFFFF
        if lit:
            bad |= not more and pos + hdr + length > navail
        else:
            bad |= pos + hdr > navail
            bad |= off <= 0 or off > base_w + w
        far = not lit and not bad and off > WIN + w
        bad |= far
        unsup |= far
        eff = min(length, m - w)
        if lit and more:
            eff = min(eff, navail - (pos + hdr))
        eff = max(eff, 0)
        split = not bad and eff < length
        if not bad and eff > 0:
            if lit:
                q = wb4 + pos + hdr
                out[base_w + w : base_w + w + eff] = np.frombuffer(comp, np.uint8, eff, q)
            else:
                _copy(out, base_w + w, off, eff)
        if not bad:
            pos += hdr + (eff if lit else 0)
            w += eff
        pk = (1 if lit else 2) if split else 0
        plen = length - eff if split else 0
        if split and not lit:
            poff = off
        err |= bad
        unsup |= split and not lit and off > WIN
        stop |= split
    state[S_POS] = wb4 + pos
    state[S_WRITTEN] = base_w + w
    state[S_ERR] = int(err)
    state[S_DONE] = int(not err and pos == navail and not more and pk == 0)
    state[S_UNSUP] |= int(unsup)
    state[S_PK], state[S_PLEN], state[S_POFF] = pk, plen, poff
    return w


def _scan_plain(comp: bytes, declared: int, out: np.ndarray, state: np.ndarray,
                writtens: np.ndarray) -> None:
    """The plain version: the window loop over ``scan_step_plain``."""
    for k in range(len(writtens)):
        writtens[k] = scan_step_plain(comp, declared, out, state)


def decode_raw_stream_bytes(
    body: bytes, declared: int, mode: Optional[str] = None, device: config.DeviceLike = None
) -> Tuple[Optional[bytes], str]:
    """Decode a raw tag stream of any size: (payload, "ok") or (None,
    reason), reason in {"invalid", "unsupported"} (decode_stream.py:654-728).

    ``mode`` (default: ``SNAPPY_TPU_STREAM_MODE``, else ``"grid"``): "grid"
    runs K4, which serves every copy; "scan" runs K5, which reports a copy
    reaching more than 64 KiB behind its window's start as "unsupported".
    A zero declared length takes scan mode in either, as in the JAX
    function."""
    if mode is None:
        mode = os.environ.get("SNAPPY_TPU_STREAM_MODE", "grid")
    if mode not in ("grid", "scan"):
        raise ValueError(f"SNAPPY_TPU_STREAM_MODE must be grid|scan: {mode!r}")
    dev = config.resolve_device(device)
    comp = torch.empty(len(body), dtype=torch.uint8)
    comp.numpy()[:] = np.frombuffer(body, dtype=np.uint8)
    comp = comp.to(dev)
    out = torch.empty(max(declared, 1), dtype=torch.uint8, device=dev)
    if mode == "grid" and declared > 0:
        if not int(decode_stream(comp, declared, out)[0]):
            return None, "invalid"
    else:
        state, _ = decode_stream_scan(comp, declared, out)
        ok, _, unsup, _, _ = scan_status(state.cpu().tolist(), len(body), declared)
        if not ok:
            return None, "unsupported" if unsup else "invalid"
    return out[:declared].cpu().numpy().tobytes(), "ok"

