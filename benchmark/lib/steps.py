"""The timed steps: what a traffic mix's ``entry`` names, staged and checked.

``encode``: ``snappy_tpu_torch.entry.step`` on every frame of the step's
messages, staged on the device at set-up: K1's masked CRC32C of each
frame, then K3's level-1 tag stream of each, padded to
``max_comp(65536)``.

``decode``: the device stage of ``engine._framed_uncompress_device`` on
the framed streams of the step's messages, staged on the device at
set-up: K2 over the compressed chunks' tag streams into 64 KiB rows, K1
over those rows, K1 over the stored chunks' payloads, then each chunk's
verdict (decoded whole and CRC as stored) on the device, read back in one
copy, and each stream's earliest bad chunk.  The
streams are made at set-up by the port's host encoder at the cell's
level.

Each step kind stages its inputs, runs one step, and after the window
checks the last step's outputs against the plain reference, which works
every expected value out again from the payload alone.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.lib import frames, rng
from benchmark.reference import crc32c as ref_crc
from benchmark.reference import snappy as ref_snappy

SAMPLE_STREAM = 7_000_001  # rng stream of the checked sample


def max_comp(b: int) -> int:
    """The flagship step's encoded width for frames of b bytes."""
    return b + b // 6 + 64


def reference_rows(host: np.ndarray, sizes: List[int], frame: int, device):
    """The payload's frames (uint8 [F, frame], zeros past each frame) and
    lengths, cut again from the untouched host copy of the payload."""
    t = frames.table(sizes, frame)
    flat = torch.from_numpy(host).to(device)
    return frames.rows(flat, t, frame), t.length


class EncodeStep:
    entry = "encode"

    def __init__(self, traffic: dict, cfg: dict, data: torch.Tensor, sizes: List[int], host, device):
        from snappy_tpu_torch import entry

        self._step = entry.step
        self.frame = cfg["frame_bytes"]
        self.table = frames.table(sizes, self.frame)
        self.rows = frames.rows(data, self.table, self.frame)
        self.lens = torch.from_numpy(self.table.length.astype(np.int32)).to(device)
        self.sample_size = traffic["sample_frames"]
        self.payload_bytes = int(sum(sizes))

    def __call__(self):
        return self._step(self.rows, self.lens)

    def describe(self) -> str:
        return f"{len(self.table.length)} frames, {self.payload_bytes} payload bytes a step"

    def failed(self, out) -> bool:
        return False

    def release(self) -> None:
        del self.rows, self.lens

    def work(self, out) -> Dict[str, float]:
        frames_n = len(self.table.length)
        return {"k1": self.payload_bytes + 4 * frames_n,
                "k3": self.payload_bytes + float(out[2].sum())}

    def check(self, out, host: np.ndarray, sizes: List[int], seed: int, device) -> List[Tuple[str, float, float]]:
        crcs, enc, totals = out
        ref_rows, lens = reference_rows(host, sizes, self.frame, device)
        want = ref_crc.masked_crc32c_rows(ref_rows, lens)
        got = crcs.cpu().numpy().astype(np.uint32)
        crc_bad = int((got != want).sum()) + abs(len(got) - len(want))
        n = len(lens)
        width_ok = tuple(enc.shape) == (n, max_comp(self.frame)) and len(totals) == n
        # every frame's stream, decoded against its frame
        stream_bad = int(ref_snappy.bad_streams(enc, totals, ref_rows, lens).sum()) if width_ok else n
        # the level-1 encoder's bytes, on frames drawn from the seed and the longest stream
        totals = totals.cpu().numpy()
        sample = set(rng.below(seed, SAMPLE_STREAM, self.sample_size, n, "cpu").tolist())
        sample.add(int(np.argmax(totals)) if len(totals) == n else 0)
        level1_bad = 0
        for f in sorted(sample):
            if not width_ok or not 0 <= totals[f] <= enc.shape[1]:
                level1_bad += 1
                continue
            frame = ref_rows[f, : lens[f]].cpu().numpy().tobytes()
            level1_bad += enc[f, : totals[f]].cpu().numpy().tobytes() != ref_snappy.encode_block(frame)
        return [("crc_bad", crc_bad, 0), ("stream_bad", stream_bad, 0), ("level1_bad", level1_bad, 0)]


class DecodeStep:
    entry = "decode"

    def __init__(self, traffic: dict, cfg: dict, data: torch.Tensor, sizes: List[int], host, device):
        from snappy_tpu_torch.ops import crc32c, decode_chunks, host_codec

        self._k1, self._k2 = crc32c.masked_crc32c_chunks, decode_chunks.decode_chunks
        self.frame = cfg["frame_bytes"]
        self.device = device
        self.payload_bytes = int(sum(sizes))
        t = frames.table(sizes, self.frame)
        comp, comp_f, declared, stored_c = [], [], [], []
        plain_f, stored_u, plain = [], [], []
        sid_c, idx_c, sid_u, idx_u = [], [], [], []
        self.stage_bad = 0  # frames whose chunk is missing or not where it belongs
        pos = 0
        for m, size in enumerate(sizes):
            stream = host_codec.framed_compress(host[pos : pos + size].tobytes(), level=cfg["level"])
            pos += size
            chunks = frames.chunks(stream)
            nf = int(t.first[m + 1] - t.first[m])
            self.stage_bad += abs(len(chunks) - nf)
            for k, ch in enumerate(chunks[:nf]):
                f = int(t.first[m]) + k
                if ch.kind == frames.COMPRESSED:
                    m_len, read = frames.varint(stream, ch.lo)
                    comp.append(np.frombuffer(stream, np.uint8, ch.hi - ch.lo - read, ch.lo + read))
                    comp_f.append(f), declared.append(m_len), stored_c.append(ch.crc)
                    sid_c.append(m), idx_c.append(k)
                else:
                    plain_f.append(f), stored_u.append(ch.crc), sid_u.append(m), idx_u.append(k)
                    plain.append(np.frombuffer(stream, np.uint8, ch.hi - ch.lo, ch.lo))
        up = lambda a, dt: torch.from_numpy(np.asarray(a, dtype=dt)).to(device)  # noqa: E731
        self.comp_f, self.plain_f = np.asarray(comp_f, np.int64), np.asarray(plain_f, np.int64)
        self.offsets_h = np.zeros(len(comp) + 1, dtype=np.int64)
        self.offsets_h[1:] = np.cumsum([len(c) for c in comp])
        self.declared_h = np.asarray(declared, dtype=np.int32)
        self.comp = up(np.concatenate(comp + [np.zeros(0, np.uint8)]), np.uint8)
        self.offsets, self.declared = up(self.offsets_h, np.int64), up(self.declared_h, np.int32)
        self.stored_c = up(np.asarray(stored_c, np.uint32).view(np.int32), np.int32)
        self.stored_u = up(np.asarray(stored_u, np.uint32).view(np.int32), np.int32)
        # the stored chunks' payloads, each in a zero-padded row, as the
        # engine stages them (engine._crc_payloads)
        rows_h = np.zeros((len(plain), self.frame), dtype=np.uint8)
        for k, p in enumerate(plain):
            rows_h[k, : len(p)] = p
        self.plain_rows = up(rows_h, np.uint8)
        self.plain_lens = up([len(p) for p in plain], np.int32)
        self.stage_bad += int((self.plain_lens.cpu().numpy() != t.length[self.plain_f]).sum())
        # stream and chunk of each verdict, compressed chunks first
        self.chunk_stream = np.asarray(sid_c + sid_u, dtype=np.int64)
        self.chunk_index = np.asarray(idx_c + idx_u, dtype=np.int64)
        self.comp_bytes = int(self.offsets_h[-1])

    def __call__(self):
        out = ok = crc_c = crc_u = None
        bad = []
        if len(self.declared_h):
            out = torch.empty((len(self.declared_h), self.frame), dtype=torch.uint8, device=self.device)
            ok, _ = self._k2(self.comp, self.offsets, self.declared, out,
                             host_values=(self.offsets_h, self.declared_h))
            crc_c = self._k1(out, self.declared)
            bad.append(~ok | (crc_c.view(torch.int32) != self.stored_c))
        if len(self.plain_f):
            crc_u = self._k1(self.plain_rows, self.plain_lens)
            bad.append(crc_u.view(torch.int32) != self.stored_u)
        # each chunk's verdict, compared on the card, read back in one copy
        flags = torch.cat(bad).cpu().numpy() if bad else np.zeros(0, dtype=bool)
        return out, ok, crc_c, crc_u, self.verdicts(flags)

    def describe(self) -> str:
        return (f"{len(self.declared_h)} compressed chunks ({self.comp_bytes} bytes, decoding to "
                f"{int(self.declared_h.sum())}), {len(self.plain_f)} stored chunks, "
                f"{self.payload_bytes} payload bytes a step")

    def verdicts(self, flags: np.ndarray) -> Dict[int, int]:
        """{stream: its earliest bad chunk} for the streams with one."""
        first: Dict[int, int] = {}
        for j in np.flatnonzero(flags):
            s, k = self.chunk_stream[j], self.chunk_index[j]
            first[s] = min(k, first.get(s, k))
        return first

    def failed(self, out) -> bool:
        return bool(out[4])

    def release(self) -> None:
        del self.comp, self.plain_rows

    def work(self, out) -> Dict[str, float]:
        decoded = float(self.declared_h.sum())
        plain = float(self.plain_lens.sum())
        return {"k2": self.comp_bytes + decoded,
                "k1": decoded + plain + 4 * (len(self.declared_h) + len(self.plain_f))}

    def check(self, out, host: np.ndarray, sizes: List[int], seed: int, device) -> List[Tuple[str, float, float]]:
        rows, ok, crc_c, crc_u, _ = out
        ref_rows, lens = reference_rows(host, sizes, self.frame, device)
        want = ref_crc.masked_crc32c_rows(ref_rows, lens)
        rows_bad, crc_bad = self.stage_bad, 0
        if rows is not None:
            rows_bad += int((~ok).sum()) + int((self.declared_h != lens[self.comp_f]).sum())
            col = torch.arange(self.frame, device=device)
            for lo in range(0, len(self.comp_f), 1024):  # each row's first declared bytes
                f = self.comp_f[lo : lo + 1024]
                keep = col < torch.from_numpy(lens[f]).to(device)[:, None]
                diff = (rows[lo : lo + 1024] != ref_rows.index_select(0, torch.from_numpy(f).to(device))) & keep
                rows_bad += int(diff.any(1).sum())
            crc_bad += int((crc_c.cpu().numpy().astype(np.uint32) != want[self.comp_f]).sum())
        if crc_u is not None:
            crc_bad += int((crc_u.cpu().numpy().astype(np.uint32) != want[self.plain_f]).sum())
        return [("rows_bad", rows_bad, 0), ("crc_bad", crc_bad, 0)]


KINDS = {EncodeStep.entry: EncodeStep, DecodeStep.entry: DecodeStep}


def make(traffic: dict, cfg: dict, data, sizes, host, device, bench_dir: Path):
    """The step kind that ``traffic["entry"]`` names, staged: one of
    ``KINDS``, or the class ``Step`` of ``<bench_dir>/entries/<entry>.py``,
    which is how a later change adds a kind without editing this file."""
    entry = traffic["entry"]
    if entry in KINDS:
        kind = KINDS[entry]
    else:
        from benchmark.lib import cells

        kind = cells.load_module(bench_dir / "entries" / f"{entry}.py", f"bench_entry_{entry}").Step
    return kind(traffic, cfg, data, sizes, host, device)
