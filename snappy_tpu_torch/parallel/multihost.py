"""Multi-process distribution: each process codes its own span of a framed
stream, and only the span lengths cross processes.

JAX counterpart: snappy_tpu/parallel/multihost.py (``initialize``,
``_allgather_lengths``, ``compress_framed_span``,
``uncompress_framed_span``).  A framed stream is a concatenation of
self-delimiting chunks, so each process compresses or decompresses its
span on its own device, and one all-gather of int64 lengths places every
span at its offset.

Usage (the same program in every process, e.g. under torchrun):

    from snappy_tpu_torch.parallel import multihost
    multihost.initialize()                 # from torchrun's environment
    blob, off, total = multihost.compress_framed_span(local_bytes)
    # write `blob` at byte offset `off` of the shared output; process 0
    # (or the caller) writes the stream header at offset 0.

``backend`` here is the codec backend of ``config`` (None: the
configured one, ``device`` by default), not the process group's.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import config, engine
from ..formats import constants as C
from ..formats import framing

TIMEOUT = timedelta(minutes=10)  # of the group's collectives, unless given


def free_port() -> int:
    """A TCP port free on this host now, for a local group's coordinator
    (``initialize(f"127.0.0.1:{free_port()}", ...)``)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: Optional[timedelta] = None,
) -> None:
    """Initialize the default process group (nothing if one is up).

    ``coordinator_address`` ("host:port") is rank 0's TCP store; it needs
    ``num_processes`` and ``process_id``.  Without it the group comes from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  ``backend`` is ``nccl`` by default, which
    needs CUDA and makes ``cuda:<LOCAL_RANK>`` (0 where unset) the current
    device; ``gloo`` is for CPU tensors.  Nothing switches backend on its
    own: a missing NCCL raises."""
    if dist.is_initialized():
        return
    backend = backend or "nccl"
    if backend == "nccl":
        if not (dist.is_nccl_available() and torch.cuda.is_available()):
            raise RuntimeError("the nccl backend needs CUDA and NCCL; pass backend='gloo' for the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kwargs = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, timeout=timeout or TIMEOUT, **kwargs)


def _process() -> Tuple[int, int]:
    """(process index, process count); (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_lengths(local_len: int) -> np.ndarray:
    """All-gather one int64 per process; no collective for one process."""
    _, n_proc = _process()
    if n_proc == 1:
        return np.array([local_len], dtype=np.int64)
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" \
        else torch.device("cpu")
    mine = torch.tensor([local_len], dtype=torch.int64, device=dev)
    out = torch.empty((n_proc, 1), dtype=torch.int64, device=dev)
    dist.all_gather(list(out.unbind(0)), mine)
    return out.view(-1).cpu().numpy()


def compress_framed_span(
    local_data: bytes, backend: Optional[str] = None, with_header: bool = False,
    device: config.DeviceLike = None,
) -> Tuple[bytes, int, int]:
    """Compress this process's span of a payload that the processes hold in
    rank order (every span a multiple of 64 KiB but the last).  Returns
    ``(blob, global_offset, total_len)``: each process's ``blob`` written
    at its ``global_offset`` gives one framed stream equal to compressing
    the whole payload.  With ``with_header=True`` process 0's blob starts
    with the 10-byte stream header; with False every offset leaves room for
    the header, which the caller writes at offset 0."""
    blob = engine.framed_compress(local_data, with_header=False, device=device, backend=backend)
    lens = _allgather_lengths(len(blob))
    pid, _ = _process()
    offset = int(lens[:pid].sum()) + len(C.FRAMING_HEADER)
    total = int(lens.sum()) + len(C.FRAMING_HEADER)
    if with_header and pid == 0:
        blob = C.FRAMING_HEADER + blob
        offset = 0
    return blob, offset, total


def uncompress_framed_span(
    data: bytes, backend: Optional[str] = None, device: config.DeviceLike = None
) -> Tuple[Optional[bytes], int, int, str]:
    """Decode this process's share of a framed stream that every process
    holds.  Every process scans the chunk table; process ``p`` of ``n``
    decodes the contiguous chunks ``p*k .. (p+1)*k`` with ``k = ceil(chunks
    / n)`` and returns ``(payload, out_offset, total_out, reason)``: its
    bytes belong at ``out_offset`` of the decoded output."""
    if not framing.is_snappy_framed_stream(data):
        return None, 0, 0, "invalid"
    chunks = framing.scan_frames(data, len(C.FRAMING_HEADER))
    if chunks is None:
        return None, 0, 0, "invalid"
    pid, n_proc = _process()
    per = -(-len(chunks) // n_proc)
    mine = chunks[pid * per : (pid + 1) * per]
    out_offset = sum(c.uncompressed_len for c in chunks[: pid * per])
    total = sum(c.uncompressed_len for c in chunks)
    if not mine:
        return b"", out_offset, total, "ok"
    outs, reason = engine.framed_uncompress_chunks(data, mine, device=device, backend=backend)
    if outs is None:
        return None, 0, 0, reason
    return b"".join(outs), out_offset, total, "ok"
