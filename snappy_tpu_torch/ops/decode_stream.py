"""Streaming raw-format decoders: one raw stream of any size, in grid
mode (kernel K4) or scan mode (kernel K5).

JAX counterpart: snappy_tpu/ops/decode_stream.py.

* Grid mode, ``decode_stream``: the TPU kernel ``_kernel_grid``, launched
  by ``decode_raw_stream_grid``.  The CUDA kernels are in
  ``csrc/decode_stream.cu``, with 64-bit cursors, so any declared length
  up to ``MAX_UNCOMPRESSED_LEN`` is taken; every legal copy offset is
  served.  Given ``in_offs``, the input offset of every 64 KiB output
  boundary (``window_index``: the host's block scan), the window route
  decodes one window per CTA and then, in one CTA, the windows whose
  copies reach an earlier window; without it, one CTA walks the whole
  stream.  The verdict: ``ok`` = no malformed tag, ``consumed ==
  len(body)`` and ``written == declared``; ``written`` is the output
  produced before the first bad tag and ``consumed`` that tag's offset (or
  the body's end), as the sequential decoder reports them.
* Scan mode, ``decode_stream_scan``: the TPU kernel ``_kernel``, launched
  once per window by the ``lax.scan`` of ``decode_raw_stream``.  The CUDA
  kernels compute the whole scan, each window written at its final offset
  of one flat output: given ``in_offs``, pass 1 is K2's kernel
  (``decode_chunks._launch``) over the index's windows and pass 2
  (``csrc/decode_stream_scan.cu``, one CTA) writes down the step of every
  window that K2 decoded cleanly and walks the other steps in order; with
  no index, pass 2 alone walks every step.  Two launches, or one, for any
  number of steps.  It keeps the TPU kernel's verdicts, ``unsupported``
  included: a copy reaching more than 64 KiB behind its window's start.

``decode_raw_stream_bytes`` picks the mode from ``SNAPPY_TPU_TORCH_STREAM_MODE``
(``grid`` by default), as the JAX function does.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import config, telemetry
from . import _build, decode_chunks, host_codec
from .decode_chunks import decode_tags

SC_BYTES = 76800  # scan mode's comp window (4 * SC_WORDS)
WIN = 65536  # the output window of scan mode (4 * OW_WORDS) and of K4's window route
MARGIN = 8
STATE_WORDS = 16
# the scan state, int64 [STATE_WORDS] (decode_stream_scan.cu)
S_POS, S_WRITTEN, S_ERR, S_DONE, S_UNSUP, S_PK, S_PLEN, S_POFF = range(8)
S_WALKED = STATE_WORDS  # the kernel's state buffer, int64 [17]: then the walked steps


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


def _check_index(in_offs: torch.Tensor, declared: int, out: torch.Tensor) -> int:
    """Type, device and length of a window index; returns its windows."""
    if in_offs.dtype != torch.int64 or in_offs.dim() != 1 or not in_offs.is_contiguous():
        raise TypeError("in_offs must be a contiguous 1-D int64 tensor")
    if in_offs.device != out.device:
        raise ValueError("in_offs and out must be on one device")
    if declared <= 0 or in_offs.shape[0] != window_count(declared) + 1:
        raise ValueError(
            f"in_offs must hold ceil(declared / {WIN}) + 1 offsets and declared be > 0"
        )
    return in_offs.shape[0] - 1


def window_count(declared: int) -> int:
    """The windows of the window route: one per 64 KiB of output."""
    return -(-declared // WIN)


def window_index(body, declared: int) -> Optional[torch.Tensor]:
    """The window route's ``in_offs`` for a raw tag stream: int64 [windows
    + 1] on the host, the body offset of every 64 KiB output boundary, from
    the native block scan (``host_codec.scan_raw_blocks``).  None where the
    scan finds none (a malformed stream, or a literal or copy straddling a
    boundary) or one too few (an op over the last boundary)."""
    offs = host_codec.scan_raw_blocks(body, declared)
    if offs is None or len(offs) != window_count(declared) + 1:
        return None
    return torch.from_numpy(offs)


def decode_stream(
    comp_u8: torch.Tensor,
    declared: int,
    out: torch.Tensor,
    in_offs: Optional[torch.Tensor] = None,
    status: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode the raw tag stream ``comp_u8`` (no varint header) with
    declared length ``declared`` into ``out[:declared]``.

    ``in_offs`` (int64 [windows + 1] on out's device, ``window_index``)
    takes the window route, none the whole-stream walk; the result is the
    same.  Returns int64 [3] = (ok, written, consumed) on out's device, the
    first three slots of ``status`` (int64 [4], made here unless given),
    whose slot 3 receives the number of windows that pass 2 decoded (0 on
    the walk and on the CPU).  The first ``written`` bytes of ``out`` are
    the output; bytes past them are not kept (windows after a failing one
    may have been written)."""
    _check(comp_u8, declared, out)
    dev = out.device
    if in_offs is not None:
        _check_index(in_offs, declared, out)
    if status is None:
        status = torch.zeros(4, dtype=torch.int64, device=dev)
    elif status.dtype != torch.int64 or status.shape != (4,) or status.device != dev:
        raise ValueError("status must be an int64 [4] tensor on out's device")
    if dev.type == "cpu":
        status[:3] = _decode_stream_plain(comp_u8, declared, out)
        status[3] = 0
        return status[:3]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if in_offs is None:
        status[3] = 0
        _launch(comp_u8, declared, out, status)
    else:
        _launch_windows(comp_u8, declared, out, in_offs, status)
    telemetry.count("k4.launches")  # a decode_stream call on the card, either route
    return status[:3]


def _launch(comp_u8, declared: int, out, status) -> None:
    """Launch the whole-stream walk on checked CUDA tensors, no checks."""
    _build.launch(
        "decode_stream", out.device,
        comp_u8.data_ptr(), comp_u8.shape[0], declared, out.data_ptr(), status.data_ptr(),
    )
    telemetry.count("k4.launches_walk")


def _launch_windows(comp_u8, declared: int, out, in_offs, status, rec=None, passes: int = 3) -> None:
    """Launch the window route on checked CUDA tensors, no checks: both
    passes, or one (``passes`` 1 or 2, for timing each alone; pass 2 reads
    the window records ``rec``, int64 [3 * windows], that pass 1 left)."""
    nwin = in_offs.shape[0] - 1
    if rec is None:
        rec = torch.empty(3 * nwin, dtype=torch.int64, device=out.device)
    _build.launch(
        "decode_stream_windows", out.device,
        comp_u8.data_ptr(), comp_u8.shape[0], declared, in_offs.data_ptr(), nwin,
        out.data_ptr(), status.data_ptr(), rec.data_ptr(), passes,
    )
    telemetry.count("k4.launches_windows")


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
    comp_u8: torch.Tensor,
    declared: int,
    out: torch.Tensor,
    in_offs: Optional[torch.Tensor] = None,
    state: Optional[torch.Tensor] = None,
    host_offs: Optional[np.ndarray] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode the raw tag stream ``comp_u8`` (no varint header) with
    declared length ``declared`` into ``out`` as the ``n_steps`` steps of
    the scan.

    ``in_offs`` (int64 [windows + 1] on out's device, ``window_index``)
    takes the window route: K2 over the windows (pass 1), then one launch
    that writes down the steps of the windows K2 decoded cleanly and walks
    the others (pass 2); ``out`` then needs ``windows * 65536`` bytes, as
    K2 fills every window's row.  Without it pass 2 alone walks every
    step.  The result is the same.  ``host_offs``: the host array that
    ``in_offs`` was uploaded from, for a caller that has it; its values
    are checked there instead of copying ``in_offs`` back from the card.

    Returns (state int64 [16], writtens int64 [steps]) on out's device:
    the final scan state (see ``scan_status``) and each step's window
    length; step ``k``'s window is ``out[sum(writtens[:k]):][:writtens[k]]``.
    The state is the first 16 words of ``state`` (int64 [17], made here
    unless given), whose word 16 receives the steps that pass 2 ran
    through ``scan_step`` (0 on the CPU).  Bytes of ``out`` past the
    state's ``written`` are not kept."""
    _check(comp_u8, declared, out)
    dev = out.device
    nwin = 0
    if in_offs is not None:
        nwin = _check_index(in_offs, declared, out)
        if out.shape[0] < nwin * WIN:
            raise ValueError(f"the window route needs out of windows * {WIN} bytes")
        offs_h = in_offs.cpu().numpy() if host_offs is None else host_offs
        decode_chunks.check_values(offs_h, window_lengths(declared), comp_u8.shape[0], WIN)
    steps = n_steps(comp_u8.shape[0], declared)
    if state is None:
        state = torch.empty(STATE_WORDS + 1, dtype=torch.int64, device=dev)
    elif state.dtype != torch.int64 or state.shape != (STATE_WORDS + 1,) or state.device != dev:
        raise ValueError(f"state must be an int64 [{STATE_WORDS + 1}] tensor on out's device")
    if dev.type == "cpu":
        writtens = torch.zeros(steps, dtype=torch.int64)
        state.zero_()
        _scan_plain(comp_u8.numpy().tobytes(), declared, out.numpy(), state[:STATE_WORDS].numpy(),
                    writtens.numpy())
        return state[:STATE_WORDS], writtens
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    writtens = torch.empty(steps, dtype=torch.int64, device=dev)
    win = None
    if nwin:
        decl = torch.from_numpy(window_lengths(declared)).to(dev)
        ok = torch.empty(nwin, dtype=torch.bool, device=dev)
        written = torch.empty(nwin, dtype=torch.int32, device=dev)
        win = (in_offs, decl, ok, written)
    _launch_scan(comp_u8, declared, out, state, writtens, win)
    return state[:STATE_WORDS], writtens


def window_lengths(declared: int) -> np.ndarray:
    """int32 [windows]: each window's output length, min(65536, declared -
    65536 k), the declared length K2 decodes it to."""
    lens = np.full(window_count(declared), WIN, dtype=np.int32)
    if len(lens):
        lens[-1] = declared - WIN * (len(lens) - 1)
    return lens


def _launch_scan(comp_u8, declared: int, out, state, writtens, win=None, passes: int = 3) -> None:
    """Launch K5 on checked CUDA tensors, no checks: with ``win`` = (in_offs,
    window lengths int32, K2's ok, K2's written), K2 over the windows (pass
    1, bit 0 of ``passes``) and then pass 2 (bit 1), one after the other on
    the current stream; one bit alone times one pass (pass 2 reads what an
    earlier pass 1 left in ok and written).  Without ``win``, pass 2
    alone."""
    dev = out.device
    in_offs = ok = written = None
    nwin = 0
    if win is not None:
        in_offs, decl, ok, written = win
        nwin = in_offs.shape[0] - 1
        if passes & 1:
            rows = out[: nwin * WIN].view(nwin, WIN)
            decode_chunks._launch(comp_u8, in_offs, decl, rows, ok, written)
            telemetry.count("k5.launches_windows")
    if passes & 2:
        _build.launch(
            "decode_stream_scan", dev,
            comp_u8.data_ptr(), comp_u8.shape[0], declared, out.data_ptr(), state.data_ptr(),
            writtens.data_ptr(), writtens.shape[0],
            None if in_offs is None else in_offs.data_ptr(), nwin,
            None if ok is None else ok.data_ptr(), None if written is None else written.data_ptr(),
        )
        telemetry.count("k5.launches")


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

    ``mode`` (default: ``SNAPPY_TPU_TORCH_STREAM_MODE``, else ``"grid"``): "grid"
    runs K4, which serves every copy, "scan" runs K5, which reports a copy
    reaching more than 64 KiB behind its window's start as "unsupported".
    Both take their window route where ``window_index`` finds the stream's
    windows (before the body goes to the card): K4's one CTA per window,
    K5's K2 over the windows and one launch for the steps the index cannot
    vouch for.  Elsewhere K4 walks the whole stream in one CTA and K5 walks
    every step in one launch.  A zero declared length takes scan mode in
    either, as in the JAX function."""
    if mode is None:
        mode = os.environ.get("SNAPPY_TPU_TORCH_STREAM_MODE", "grid")
    if mode not in ("grid", "scan"):
        raise ValueError(f"SNAPPY_TPU_TORCH_STREAM_MODE must be grid|scan: {mode!r}")
    dev = config.resolve_device(device)
    grid = mode == "grid" and declared > 0
    in_offs = window_index(body, declared) if declared > 0 else None
    comp = torch.empty(len(body), dtype=torch.uint8)
    comp.numpy()[:] = np.frombuffer(body, dtype=np.uint8)
    comp = comp.to(dev)
    offs_d = None if in_offs is None else in_offs.to(dev)
    if grid:
        out = torch.empty(max(declared, 1), dtype=torch.uint8, device=dev)
        status = torch.empty(4, dtype=torch.int64, device=dev)
        decode_stream(comp, declared, out, offs_d, status)
        ok, _, _, redecoded = status.tolist()
        telemetry.count("k4.redecoded", redecoded)
        if not ok:
            return None, "invalid"
    else:
        nwin = 0 if in_offs is None else in_offs.shape[0] - 1
        out = torch.empty(max(declared, nwin * WIN, 1), dtype=torch.uint8, device=dev)
        state = torch.empty(STATE_WORDS + 1, dtype=torch.int64, device=dev)
        decode_stream_scan(comp, declared, out, offs_d, state,
                           None if in_offs is None else in_offs.numpy())
        st = state.tolist()
        telemetry.count("k5.walked", st[S_WALKED])
        ok, _, unsup, _, _ = scan_status(st, len(body), declared)
        if not ok:
            return None, "unsupported" if unsup else "invalid"
    return out[:declared].cpu().numpy().tobytes(), "ok"
