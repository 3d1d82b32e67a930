"""``api_decode``: the public ``snappy_tpu_torch.api.decode_framed`` of each
message's framed stream, host bytes to host bytes, as a node calls it on a
state read from its database or an era file.

Set-up makes each message's framed stream with the port's host encoder at
the configuration's level and holds it as ``bytes`` on the host; nothing
is staged on the card.  A step hands every stream to the API, which
scans it, stages and uploads the compressed bodies and the stored chunks'
payloads, runs K2 and K1, reads the rows back and assembles the payload.

After the window the plain reference judges, each with the limit 0:

* ``rows_bad``: frames of the last step's output that differ from the
  untouched host payload (an output of the wrong length: all of its
  message's frames);
* ``stream_bad``: of a sample of chunks drawn from the seed and the
  longest, those that the reference does not decode to the payload's
  frame under their stored masked CRC32C, and any chunk missing or extra;
* ``integrity_bad``: of the broken streams, those that the API does not
  refuse with ``b""``: each its own copy of a message's stream, with the
  stored CRC changed of a compressed chunk, of a stored chunk (where
  there is one) and of the last chunk, and cut inside a chunk; the
  chunks drawn from the seed but the last.  So a decode that checks the
  CRC of one kind of chunk only, or of the first chunks only, fails on
  every seed.

``CONTROL`` breaks the configuration's integrity guarantee: the API
called with ``check_integrity=False``, which ``benchmark/control.py``
runs.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Tuple

import numpy as np
import torch

from benchmark.lib import frames, rng, steps
from benchmark.reference import crc32c as ref_crc
from benchmark.reference import snappy as ref_snappy

SAMPLE_CHUNKS = 64  # chunks decoded by the reference, besides the longest
SAMPLE_STREAM = 7_000_002  # rng stream of the checked sample
BREAK_STREAMS = (7_000_003, 7_000_004, 7_000_005)  # rng streams of the chunks broken: compressed, stored, cut


@contextlib.contextmanager
def no_integrity():
    from snappy_tpu_torch import api

    real = api.decode_framed
    api.decode_framed = functools.partial(real, check_integrity=False)
    try:
        yield
    finally:
        api.decode_framed = real


CONTROL = ("no_integrity", no_integrity)


class Step:
    entry = "api_decode"

    def __init__(self, traffic: dict, cfg: dict, data: torch.Tensor, sizes: List[int], host, device):
        from snappy_tpu_torch import api, config
        from snappy_tpu_torch.ops import host_codec

        if config.resolve_backend() != "device":
            raise RuntimeError(f"the API's backend is {config.resolve_backend()!r}, not the device")
        self._api = api  # looked up at each call, so that a control can stand in
        self.device = device
        self.frame = cfg["frame_bytes"]
        self.sample_size = traffic.get("sample_frames", SAMPLE_CHUNKS)
        self.sizes = [int(s) for s in sizes]
        self.payload_bytes = sum(self.sizes)
        self.table = frames.table(sizes, self.frame)
        self.streams: List[bytes] = []
        self.chunks: List[List[frames.Chunk]] = []
        declared, plain_lens = [], []
        self.comp_bytes = pos = 0
        for size in self.sizes:
            stream = host_codec.framed_compress(host[pos : pos + size].tobytes(), level=cfg["level"])
            pos += size
            chunks = frames.chunks(stream)
            for ch in chunks:
                if ch.kind == frames.COMPRESSED:
                    m_len, read = frames.varint(stream, ch.lo)
                    self.comp_bytes += ch.hi - ch.lo - read
                    declared.append(m_len)
                else:
                    plain_lens.append(ch.hi - ch.lo)
            self.streams.append(stream)
            self.chunks.append(chunks)
        # (message, chunk) of every chunk, in order
        self.flat = [(m, k) for m, chs in enumerate(self.chunks) for k in range(len(chs))]
        self.n_comp = len(declared)
        self.stream_bytes = sum(len(s) for s in self.streams)
        # what the staged decode's work() counts, under its names
        self.declared_h, self.plain_lens = np.asarray(declared, np.int64), np.asarray(plain_lens, np.int64)
        self.plain_f = self.plain_lens

    def __call__(self) -> List[bytes]:
        return [self._api.decode_framed(s, device=self.device) for s in self.streams]

    def describe(self) -> str:
        return (f"{len(self.streams)} framed streams of {self.stream_bytes} bytes: {self.n_comp} compressed "
                f"chunks, {len(self.flat) - self.n_comp} stored, {self.payload_bytes} payload bytes a step")

    def failed(self, out) -> bool:
        return any(size and not got for got, size in zip(out, self.sizes))

    def release(self) -> None:
        pass  # nothing is staged on the card

    work = steps.DecodeStep.work  # K2's and K1's bytes, counted as the staged decode counts them

    def check(self, out, host: np.ndarray, sizes: List[int], seed: int, device) -> List[Tuple[str, float, float]]:
        return [("rows_bad", self._rows_bad(out, host), 0),
                ("stream_bad", self._stream_bad(host, seed, device), 0),
                ("integrity_bad", self._integrity_bad(seed), 0)]

    def _rows_bad(self, out, host: np.ndarray) -> int:
        t, bad, pos = self.table, 0, 0
        for m, size in enumerate(self.sizes):
            lo, hi = int(t.first[m]), int(t.first[m + 1])
            got = out[m]
            if len(got) != size:
                bad += hi - lo
            elif size:
                diff = np.frombuffer(got, dtype=np.uint8) != host[pos : pos + size]
                bad += int(np.logical_or.reduceat(diff, t.start[lo:hi] - pos).sum())
            pos += size
        return bad

    def _stream_bad(self, host: np.ndarray, seed: int, device) -> int:
        t = self.table
        frames_of = np.diff(t.first)
        bad = sum(abs(len(chs) - int(frames_of[m])) for m, chs in enumerate(self.chunks))
        n = len(self.flat)
        if not n:
            return bad
        sample = set(rng.below(seed, SAMPLE_STREAM, self.sample_size, n, "cpu").tolist())
        sample.add(max(range(n), key=lambda j: self._chunk(j).hi - self._chunk(j).lo))
        sample = sorted(j for j in sample if self.flat[j][1] < frames_of[self.flat[j][0]])  # extra chunks: counted
        want = np.zeros((len(sample), self.frame), dtype=np.uint8)
        lens = np.zeros(len(sample), dtype=np.int64)
        for i, j in enumerate(sample):
            m, k = self.flat[j]
            f = int(t.first[m]) + k
            lens[i] = t.length[f]
            want[i, : lens[i]] = host[t.start[f] : t.start[f] + lens[i]]
        crcs = ref_crc.masked_crc32c_rows(torch.from_numpy(want).to(device), lens)
        for i, j in enumerate(sample):
            m, ch = self.flat[j][0], self._chunk(j)
            stream = self.streams[m]
            if ch.kind == frames.COMPRESSED:
                declared, read = frames.varint(stream, ch.lo)
                got = ref_snappy.decode(stream[ch.lo + read : ch.hi], declared)
            else:
                got = stream[ch.lo : ch.hi]
            bad += got != want[i, : lens[i]].tobytes() or ch.crc != int(crcs[i])
        return bad

    def _broken(self, seed: int) -> List[bytes]:
        """Each broken stream, its own copy of a message's stream: the stored
        CRC changed of a compressed chunk, of a stored one (where there is
        one) and of the last chunk, and the stream cut inside a chunk."""
        pick = lambda js, stream: js[int(rng.below(seed, stream, 1, len(js), "cpu")[0])]  # noqa: E731
        every = range(len(self.flat))
        comp = [j for j in every if self._chunk(j).kind == frames.COMPRESSED]
        stored = [j for j in every if self._chunk(j).kind != frames.COMPRESSED]
        flips = [pick(js, st) for js, st in zip((comp, stored), BREAK_STREAMS) if js] + [every[-1]]
        out = []
        for j in flips:
            m, ch = self.flat[j][0], self._chunk(j)
            changed = bytearray(self.streams[m])
            changed[ch.lo - 4] ^= 0x01  # the stored CRC's first byte
            out.append(bytes(changed))
        j = pick(every, BREAK_STREAMS[2])
        m, ch = self.flat[j][0], self._chunk(j)
        out.append(self.streams[m][: (ch.lo - 8 + ch.hi) // 2])  # inside the chunk, past its header
        return out

    def _integrity_bad(self, seed: int) -> int:
        """Broken streams that the API does not refuse with ``b""``."""
        if not self.flat:
            return 0
        return sum(self._api.decode_framed(s, device=self.device) != b"" for s in self._broken(seed))

    def _chunk(self, j: int) -> frames.Chunk:
        m, k = self.flat[j]
        return self.chunks[m][k]
