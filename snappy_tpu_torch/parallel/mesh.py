"""Distribution layer: the 64 KiB frames of a payload, or the chunks of a
framed stream, split over the ranks of a process group.

JAX counterpart: snappy_tpu/parallel/mesh.py (``default_mesh``, ``AXIS``,
``_sharded_encode_scalar_step``, ``_sharded_decode_scalar_step``,
``_sharded_encode_step``, ``_sharded_decode_step``,
``sharded_raw_compress``, ``sharded_framed_compress``,
``sharded_framed_uncompress``).

A ``Mesh`` is one rank per device, in the usual PyTorch SPMD layout
(torchrun): every rank calls the same entry point with the same input.
Each rank runs the port's kernels on its own device over its contiguous
share of the rows (K1 and K3 to encode, K2 and K1 to decode; on the
engine's array route, config.device_kernel(), the array encoder and
decoder in place of K3 and K2, as the JAX mesh routes them), then the
ranks all-gather what the stream's layout needs: the int32 encoded lengths
(an exclusive scan of them places every frame, the counterpart of
``lax.all_gather`` plus ``cumsum``), the CRCs or ok flags, and each rank's
bytes packed end to end and padded to the largest rank's.  Every rank
returns the same result, byte for byte the single-device engine's.

Every rank reaches every collective: each return that skips one is
decided from the whole input, which every rank holds, or from gathered
values, which every rank holds alike; a rank with an empty share joins
each all-gather with a padded tensor.  Collective tensors live on the
card for an ``nccl`` group and on the CPU for a ``gloo`` group
(``dist.get_backend``); an ``nccl`` group on a CPU device raises.

Divergences from the JAX package on purpose (ROADMAP queue 3):
``n_devices`` other than the group's size raises (JAX slices its device
list, which one device per process has no counterpart for); the shares
differ by at most one row in ``np.array_split`` order, where JAX pads the
batch to a power of two per device to bound TPU compile shapes.
``sharded_framed_uncompress`` keeps the JAX mesh's error order,
which differs from the engine's (every verbatim CRC before any compressed
chunk).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import config, engine
from ..formats import constants as C
from ..formats import framing, varint

AXIS = "blocks"
_BLOCK = C.MAX_BLOCK_LEN  # 65536: a frame


@dataclass(frozen=True)
class Gather:
    """One all-gather of a sharded step, as ``Mesh.trace`` records it."""

    name: str  # "totals", "crcs", "bytes" (encode); "ok", "crcs", "verbatim_crcs", "bytes" (decode)
    rows: int  # frames or chunks of the whole stream that it carries
    sent: int  # bytes this rank sent: its share padded to the largest share
    ms: float  # host ms around it, the device synchronized before and after


class Mesh:
    """A 1-D mesh over a process group, axis ``"blocks"``: the group, this
    rank, the group's size and this rank's device.

    ``group`` None is a mesh of one rank that makes no collective.
    ``trace``: a list to which each all-gather appends a ``Gather`` (with a
    device synchronize on each side of it, for timing), or None."""

    axis_name = AXIS

    def __init__(self, group=None, device: config.DeviceLike = None, trace: Optional[list] = None):
        self.group = group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.size = 1 if group is None else dist.get_world_size(group)
        self.device = config.resolve_device(device)
        self.trace = trace
        backend = None if group is None else dist.get_backend(group)
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an nccl group needs a CUDA device; use a gloo group for the CPU")
        self.collective_device = self.device if backend == "nccl" else torch.device("cpu")


def default_mesh(n_devices: Optional[int] = None, device: config.DeviceLike = None) -> Mesh:
    """The mesh of the world group, or of one rank where no group is
    initialized.  ``device`` None is ``cuda:<LOCAL_RANK>`` (torchrun's
    variable; 0 where it is unset)."""
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    size = 1 if group is None else dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"n_devices={n_devices}, but the group has {size} ranks of one device each"
        )
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return Mesh(group, device)


def shard_bounds(rows: int, size: int) -> np.ndarray:
    """Row bounds of each rank's contiguous share, ``size + 1`` entries:
    rank r takes rows ``[b[r], b[r + 1])``.  Shares differ by at most one
    row, the larger ones first (``np.array_split``'s order)."""
    q, rem = divmod(rows, size)
    counts = np.full(size, q, dtype=np.int64)
    counts[:rem] += 1
    return np.concatenate([[0], np.cumsum(counts)])


def _all_gather(mesh: Mesh, name: str, local: torch.Tensor, width: int, rows: int) -> torch.Tensor:
    """Every rank's ``local`` (1-D, at most ``width`` elements), padded to
    ``width``: [size, width] on the collective device.  On a mesh without a
    group, ``local`` itself as one row."""
    if mesh.group is None:
        return local.view(1, -1)
    buf = torch.zeros(width, dtype=local.dtype, device=mesh.collective_device)
    buf[: local.numel()].copy_(local)
    out = torch.empty((mesh.size, width), dtype=local.dtype, device=mesh.collective_device)
    timed = mesh.trace is not None
    if timed:
        _sync(mesh)
        t = time.perf_counter()
    dist.all_gather(list(out.unbind(0)), buf, group=mesh.group)
    if timed:
        _sync(mesh)
        mesh.trace.append(Gather(name, rows, width * buf.element_size(),
                                 (time.perf_counter() - t) * 1e3))
    return out


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _gather_rows(mesh: Mesh, name: str, local: torch.Tensor, bounds: np.ndarray) -> np.ndarray:
    """One value per row: every rank's share, gathered, in row order."""
    width = int(bounds[1] - bounds[0])
    got = _all_gather(mesh, name, local, width, int(bounds[-1])).cpu().numpy()
    return np.concatenate([got[r, : bounds[r + 1] - bounds[r]] for r in range(len(got))])


def _gather_bytes(mesh: Mesh, packed: torch.Tensor, per_row: np.ndarray,
                  bounds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Every rank's rows packed end to end (``per_row`` bytes each, known to
    every rank), gathered: (buf, starts), row k's bytes being
    ``buf[starts[k] : starts[k] + per_row[k]]``."""
    cum = np.concatenate([[0], np.cumsum(per_row, dtype=np.int64)])
    rank_bytes = cum[bounds[1:]] - cum[bounds[:-1]]
    width = int(rank_bytes.max())
    if width == 0:  # nothing to send anywhere: every rank skips it alike
        return np.zeros(0, dtype=np.uint8), np.zeros(len(per_row), dtype=np.int64)
    buf = _all_gather(mesh, "bytes", packed, width, len(per_row)).cpu().numpy().reshape(-1)
    rank = np.repeat(np.arange(len(rank_bytes)), np.diff(bounds))
    return buf, rank * width + cum[:-1] - cum[bounds[rank]]


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _sharded_encode(mesh: Mesh, arr: np.ndarray, with_crc: bool):
    """This rank's frames through ``engine.encode_frames`` at level 1 (K1
    where ``with_crc``, then K3 or the array encoder), then the
    all-gathers.  Returns (buf, starts, totals, crcs), the same on every
    rank: frame k's encoded bytes are ``buf[starts[k] : starts[k] +
    totals[k]]``, its masked CRC ``crcs[k]`` (None without ``with_crc``)."""
    n = len(arr)
    nf = -(-n // _BLOCK)
    bounds = shard_bounds(nf, mesh.size)
    lo, hi = bounds[mesh.rank], bounds[mesh.rank + 1]
    if hi > lo:
        frames, flens = engine.split_frames(arr[lo * _BLOCK : min(n, hi * _BLOCK)], mesh.device)
    else:
        frames = torch.empty((0, _BLOCK), dtype=torch.uint8, device=mesh.device)
        flens = torch.empty(0, dtype=torch.int32, device=mesh.device)
    crcs, enc, totals = engine.encode_frames(frames, flens, 1, crc=with_crc)
    all_totals = _gather_rows(mesh, "totals", totals, bounds).astype(np.int64)
    all_crcs = None
    if with_crc:
        all_crcs = _gather_rows(mesh, "crcs", crcs.view(torch.int32), bounds).view(np.uint32)
    buf, starts = _gather_bytes(mesh, engine.pack_rows(enc, totals), all_totals, bounds)
    return buf, starts, all_totals, all_crcs


def sharded_raw_compress(data: bytes, mesh: Optional[Mesh] = None) -> bytes:
    """Raw-format compress with the 64 KiB blocks split over the mesh: the
    bytes of ``engine.raw_compress(data)`` at level 1."""
    mesh = mesh or default_mesh()
    n = len(data)
    if n == 0:
        return varint.encode_uint32(0)
    buf, starts, totals, _ = _sharded_encode(mesh, np.frombuffer(data, dtype=np.uint8), False)
    return b"".join([varint.encode_uint32(n)] + [buf[s : s + t] for s, t in zip(starts, totals)])


def sharded_framed_compress(data: bytes, mesh: Optional[Mesh] = None) -> bytes:
    """Framed-format compress with the frames split over the mesh: the
    bytes of ``engine.framed_compress(data)`` at level 1."""
    mesh = mesh or default_mesh()
    if not data:
        return C.FRAMING_HEADER
    buf, starts, totals, crcs = _sharded_encode(mesh, np.frombuffer(data, dtype=np.uint8), True)
    return framing.frame_stream(data, crcs, buf, starts, totals, True)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _first(bad: np.ndarray) -> Optional[int]:
    hit = np.flatnonzero(bad)
    return int(hit[0]) if len(hit) else None


def sharded_framed_uncompress(
    data: bytes, mesh: Optional[Mesh] = None, check_integrity: bool = True
) -> Tuple[Optional[bytes], str]:
    """Framed-format decompress with the compressed chunks (K2, or the
    array decoder, then K1 over the decoded rows) and the verbatim chunks' CRCs (K1) split over the
    mesh.  Returns (payload, "ok") or (None, reason), with the JAX mesh's
    error order: the walk over the chunk table (``invalid``,
    ``unknown_chunk``), then every verbatim chunk's CRC (``crc``), then the
    compressed chunks in order (``invalid`` before ``crc`` within one)."""
    mesh = mesh or default_mesh()
    if not framing.is_snappy_framed_stream(data):
        return None, "invalid"
    chunks = framing.scan_frames(data, len(C.FRAMING_HEADER))
    if chunks is None:
        return None, framing.scan_failure_reason(data, len(C.FRAMING_HEADER))
    arr = np.frombuffer(data, dtype=np.uint8)

    jobs = []  # (body lo, body hi, declared, stored crc) of each compressed chunk
    verbatim = []  # (payload lo, payload hi, stored crc) of each uncompressed chunk
    for ch in chunks:
        if ch.id in (C.CHUNK_COMPRESSED, C.CHUNK_UNCOMPRESSED):
            stored = int.from_bytes(data[ch.data_pos : ch.data_pos + 4], "little")
            lo, hi = ch.data_pos + 4, ch.data_pos + ch.data_len
            if ch.id == C.CHUNK_UNCOMPRESSED:
                verbatim.append((lo, hi, stored))
                continue
            declared, read = varint.decode_uint32(arr[lo : min(hi, lo + 5)])
            if declared is None or declared > C.MAX_UNCOMPRESSED_FRAME_DATA_LEN:
                return None, "invalid"
            jobs.append((lo + read, hi, declared, stored))
        elif ch.id < C.CHUNK_RESERVED_SKIPPABLE_LO and ch.id != C.CHUNK_STREAM_HEADER:
            return None, "unknown_chunk"

    # This rank's shares: K2 (and K1) over its compressed chunks, K1 over
    # its verbatim chunks.
    declared = np.array([j[2] for j in jobs], dtype=np.int32)
    bounds = shard_bounds(len(jobs), mesh.size)
    lo, hi = bounds[mesh.rank], bounds[mesh.rank + 1]
    ok, out, crcs, decl = engine._decode_bodies(
        arr, [(b_lo, b_hi) for b_lo, b_hi, _, _ in jobs[lo:hi]], declared[lo:hi],
        check_integrity, mesh.device,
    )
    if check_integrity:
        v_bounds = shard_bounds(len(verbatim), mesh.size)
        v_mine = verbatim[v_bounds[mesh.rank] : v_bounds[mesh.rank + 1]]
        v_crcs = engine._crc_payloads(arr, [(p_lo, p_hi) for p_lo, p_hi, _ in v_mine], mesh.device)

    # Gathered values are the same on every rank, so is every verdict below.
    if jobs:
        all_ok = _gather_rows(mesh, "ok", ok.to(torch.uint8), bounds)
    if check_integrity:
        if jobs:
            all_crcs = _gather_rows(mesh, "crcs", crcs.view(torch.int32), bounds).view(np.uint32)
        if verbatim:
            got = _gather_rows(mesh, "verbatim_crcs", v_crcs.view(torch.int32), v_bounds)
            stored = np.array([s for _, _, s in verbatim], dtype=np.uint32)
            if _first(got.view(np.uint32) != stored) is not None:
                return None, "crc"
    if jobs:
        bad_crc = np.zeros(len(jobs), dtype=bool)
        if check_integrity:
            bad_crc = all_crcs != np.array([j[3] for j in jobs], dtype=np.uint32)
        k = _first((all_ok == 0) | bad_crc)
        if k is not None:
            return None, "invalid" if all_ok[k] == 0 else "crc"

    buf, starts = _gather_bytes(mesh, engine.pack_rows(out, decl), declared.astype(np.int64), bounds)
    result = np.empty(sum(ch.uncompressed_len for ch in chunks), dtype=np.uint8)
    pos = j = v = 0
    for ch in chunks:
        if ch.id == C.CHUNK_COMPRESSED:
            m = int(declared[j])
            result[pos : pos + m] = buf[starts[j] : starts[j] + m]
            j += 1
        elif ch.id == C.CHUNK_UNCOMPRESSED:
            p_lo, p_hi, _ = verbatim[v]
            m = p_hi - p_lo
            result[pos : pos + m] = arr[p_lo:p_hi]
            v += 1
        else:
            continue
        pos += m
    return result[:pos].tobytes(), "ok"
