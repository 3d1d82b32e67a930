"""Guard bands around every kernel launch: on the card, the stand-in for
``compute-sanitizer``, which does not run on the card's machine.

Each case calls a wrapper's ``_launch`` with views into guarded buffers:

* **Writes out of bounds.**  Every buffer a kernel writes (outputs,
  ``ok`` / ``written`` / ``status`` / ``state`` / ``rec`` and K1's
  ``tile_regs``) is a view into an allocation with ``GUARD`` bytes before
  and after it, the whole allocation painted with a fixed pattern.  After
  the launch every guard byte must be unchanged.
* **Reads past the end that change a result.**  Every buffer a kernel
  reads (inputs, offsets, lengths, the window index, K1's tables and K6's
  constants) is followed by ``GUARD`` bytes of tail guard, filled with each
  of ``FILLS`` in turn (0x00, 0xFF, seeded random bytes), and the case runs
  once a fill.  What the kernel's contract keeps (the outputs, verdicts,
  ``written``, and the bytes up to it) must be the same for every fill.

A read out of bounds that changes no result is the twin's to catch, under
ASan (``testing/sanitize.py``).  ``Guard(dev)`` runs the cases, one
method a kernel, counts the guarded launches under the names of
chip_smoke.py's kernels line (``guarded``) and collects the failures;
``long_stream`` decodes one raw stream of any declared length (above
2^31 bytes on the card) on K4's and K5's window routes inside the guards
and holds the verdict and the SHA-256 of the output against the host C
decoder.  On the CPU (the tests) the launches go wherever
``_build.launch`` sends them.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import crc32c, crc32c_mma, decode_chunks, decode_stream, encode_blocks, host_codec
from . import payloads

GUARD = 4096  # bytes of each guard band; also the period of the painted pattern
FILLS = (0x00, 0xFF, "random")
WIN = decode_stream.WIN

Spec = Tuple[Tuple[int, ...], torch.dtype]


def _tensor(data) -> torch.Tensor:
    """A contiguous tensor of ``data`` (a tensor, a numpy array or bytes)."""
    if isinstance(data, torch.Tensor):
        return data.contiguous()
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(data, dtype=np.uint8)
    data = np.ascontiguousarray(data)
    return torch.from_numpy(data if data.flags.writeable else data.copy())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Guard:
    """Guarded launches on ``dev``: ``guarded`` counts them by kernel name,
    ``cases`` counts the cases, ``failures`` holds what went wrong."""

    def __init__(self, dev, fills: Sequence = FILLS):
        self.dev = torch.device(dev)
        self.fills = tuple(fills)
        self.pattern = torch.from_numpy(payloads.Rand(0x6A09E667).bytes(GUARD)).to(self.dev)
        self.tails = {
            0x00: torch.zeros(GUARD, dtype=torch.uint8, device=self.dev),
            0xFF: torch.full((GUARD,), 0xFF, dtype=torch.uint8, device=self.dev),
            "random": torch.from_numpy(payloads.Rand(0xBB67AE85).bytes(GUARD)).to(self.dev),
        }
        self.guarded: Dict[str, int] = collections.Counter()
        self.cases: Dict[str, int] = collections.Counter()
        self.failures: List[str] = []

    # -- buffers ------------------------------------------------------------

    def _paint(self, flat: torch.Tensor) -> None:
        """Fill a flat uint8 tensor with the pattern, period GUARD."""
        full = flat.numel() // GUARD
        if full:
            flat[: full * GUARD].view(full, GUARD).copy_(self.pattern.expand(full, GUARD))
        rest = flat.numel() - full * GUARD
        if rest:
            flat[full * GUARD :].copy_(self.pattern[:rest])

    def _output(self, bands: list, name: str, spec: Spec) -> torch.Tensor:
        shape, dtype = spec
        nb = int(np.prod(shape, dtype=np.int64)) * torch.empty(0, dtype=dtype).element_size()
        alloc = torch.empty(GUARD + nb + GUARD, dtype=torch.uint8, device=self.dev)
        self._paint(alloc)
        bands.append((name, alloc, nb))
        return alloc[GUARD : GUARD + nb].view(dtype).view(shape)

    def _input(self, data: torch.Tensor, fill) -> torch.Tensor:
        nb = _nbytes(data)
        alloc = torch.empty(nb + GUARD, dtype=torch.uint8, device=self.dev)
        if nb:
            alloc[:nb].copy_(data.reshape(-1).view(torch.uint8))
        alloc[nb:].copy_(self.tails[fill])
        return alloc[:nb].view(data.dtype).view(data.shape)

    def _changed(self, bands: list) -> List[str]:
        """The names of the bands whose guard bytes changed (one sync)."""
        if not bands:
            return []
        flags = []
        for _, alloc, nb in bands:
            tail = torch.roll(self.pattern, -(nb % GUARD))
            flags.append((alloc[:GUARD] != self.pattern).any() | (alloc[GUARD + nb :] != tail).any())
        hit = torch.stack(flags).cpu().tolist()
        return [name for (name, _, _), h in zip(bands, hit) if h]

    # -- the case loop ------------------------------------------------------

    def run(self, name: str, label: str, inputs: Dict[str, object], outputs: Dict[str, Spec],
            launch: Callable[[dict, dict], Sequence[str]],
            keep: Callable[[dict, dict], Dict[str, torch.Tensor]],
            fills: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
        """One case: for each fill, the inputs with that tail guard and the
        outputs in fresh guarded buffers, ``launch(ins, outs)`` (it returns
        the kernel names it launched), the guard check, and what ``keep``
        returns, which must be equal across the fills.  Returns the first
        fill's kept tensors."""
        host = {k: _tensor(v) for k, v in inputs.items()}
        ref = None
        for fill in fills or self.fills:
            bands = []
            ins = {k: self._input(v, fill) for k, v in host.items()}
            outs = {k: self._output(bands, k, spec) for k, spec in outputs.items()}
            for launched in launch(ins, outs):
                self.guarded[launched] += 1
            changed = self._changed(bands)
            if changed:
                self.failures.append(f"{name} {label}, input guard {fill!r}: the guard bands of "
                                     f"{changed} changed")
            kept = keep(ins, outs)
            if ref is None:
                ref = kept
            else:
                diff = [k for k in kept if not torch.equal(kept[k], ref[k])]
                if diff:
                    self.failures.append(f"{name} {label}: {diff} differ between the input guards "
                                         f"{self.fills[0]!r} and {fill!r}")
        self.cases[name] += 1
        return ref

    # -- the kernels --------------------------------------------------------

    def crc32c(self, flat, offset: int, stride: int, n: int, width: int, lengths,
               label: str = "") -> torch.Tensor:
        """K1 on the rows ``flat[offset + r * stride :][:width]``, r < n, of
        ``lengths``; ``crc32c_long`` where a row is longer than a tile."""
        lengths = _tensor(lengths).to(torch.int32)
        nt = crc32c.tiles_per_row(int(lengths.max()))
        name = "crc32c" if nt == 1 else "crc32c_long"
        outputs = {"out": ((n,), torch.int32)}
        if nt > 1:
            outputs["tile_regs"] = ((n * nt,), torch.int32)

        def launch(ins, outs):
            c = ins["chunks"]
            rows = c.as_strided((n, width), (stride, 1), c.storage_offset() + offset)
            with _swapped(crc32c._consts, self.dev, (ins["tables"], ins["adv"])):
                crc32c._launch(rows, ins["lengths"], outs["out"].view(torch.uint32), nt,
                               outs.get("tile_regs"))
            return [name]

        inputs = {"chunks": flat, "lengths": lengths, "tables": crc32c.tables(),
                  "adv": crc32c.adv_tables()}
        return self.run(name, label, inputs, outputs, launch, lambda i, o: {"out": o["out"]})["out"]

    def crc32c_mma(self, rows, lengths, label: str = "") -> torch.Tensor:
        """K6 on uint8 [N, 65536] rows, zero past ``lengths``."""
        lengths = _tensor(lengths).to(torch.int32)
        n = lengths.shape[0]

        def launch(ins, outs):
            with _swapped(crc32c_mma._consts, self.dev, ins["consts"]):
                crc32c_mma._launch(ins["chunks"], ins["lengths"], outs["out"].view(torch.uint32))
            return ["crc32c_mma"]

        inputs = {"chunks": rows, "lengths": lengths, "consts": crc32c_mma.consts()}
        return self.run("crc32c_mma", label, inputs, {"out": ((n,), torch.int32)}, launch,
                        lambda i, o: {"out": o["out"]})["out"]

    def encode_blocks(self, rows, lens, level: int = 1, label: str = "") -> Dict[str, torch.Tensor]:
        """K3 at ``level`` on uint8 [N, W] rows of ``lens``; kept: the
        lengths and each row's bytes up to its length."""
        lens = _tensor(lens).to(torch.int32)
        n, ways = lens.shape[0], 1 if level < 2 else 2
        name = "encode_blocks" if ways == 1 else "encode_blocks_l2"

        def launch(ins, outs):
            encode_blocks._launch(ins["blocks"], ins["lens"], outs["enc"], outs["enc_len"], ways)
            return [name]

        def keep(ins, outs):
            col = torch.arange(encode_blocks.ENC_CAP, device=self.dev)
            enc = outs["enc"].masked_fill(col >= outs["enc_len"][:, None], 0)
            return {"enc_len": outs["enc_len"], "enc": enc}

        outputs = {"enc": ((n, encode_blocks.ENC_CAP), torch.uint8), "enc_len": ((n,), torch.int32)}
        return self.run(name, label, {"blocks": rows, "lens": lens}, outputs, launch, keep)

    def decode_chunks(self, comp, offsets, declared, width: int,
                      label: str = "") -> Dict[str, torch.Tensor]:
        """K2 on the ragged tag streams ``comp[offsets[i]:offsets[i + 1]]``
        into rows of ``width``; kept: ok, written and the whole rows."""
        declared = _tensor(declared).to(torch.int32)
        n = declared.shape[0]
        name = "decode_chunks" if width <= decode_chunks.CHUNK else "decode_chunks_big"

        def launch(ins, outs):
            decode_chunks._launch(ins["comp"], ins["offsets"], ins["declared"], outs["out"],
                                  outs["ok"], outs["written"])
            return [name]

        inputs = {"comp": comp, "offsets": _tensor(offsets).to(torch.int64), "declared": declared}
        outputs = {"out": ((n, width), torch.uint8), "ok": ((n,), torch.bool),
                   "written": ((n,), torch.int32)}
        return self.run(name, label, inputs, outputs, launch, lambda i, o: dict(o))

    def decode_stream(self, body, declared: int, in_offs=None, label: str = "",
                      fills: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
        """K4 on one raw tag stream: the window route on ``in_offs``, else
        the whole-stream walk; kept: the status and ``out[:written]``."""
        nwin = 0 if in_offs is None else len(in_offs) - 1
        inputs = {"comp": body}
        outputs = {"out": ((max(declared, 1),), torch.uint8)}
        if nwin:
            inputs["in_offs"] = _tensor(in_offs).to(torch.int64)
            outputs.update(status=((4,), torch.int64), rec=((3 * nwin,), torch.int64))
        else:
            outputs["status"] = ((3,), torch.int64)

        def launch(ins, outs):
            if nwin:
                decode_stream._launch_windows(ins["comp"], declared, outs["out"], ins["in_offs"],
                                              outs["status"], outs["rec"])
            else:
                decode_stream._launch(ins["comp"], declared, outs["out"], outs["status"])
            return ["decode_stream"]

        def keep(ins, outs):
            written = int(outs["status"][1])
            return {"status": outs["status"], "out": outs["out"][:written]}

        return self.run("decode_stream", label, inputs, outputs, launch, keep, fills)

    def decode_stream_scan(self, body, declared: int, in_offs=None, label: str = "",
                           fills: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
        """K5 on one raw tag stream: K2 over the windows of ``in_offs`` and
        then pass 2, else pass 2 alone; kept: the state, every step's
        length, ``out[:written]`` and K2's verdicts on the windows."""
        nwin = 0 if in_offs is None else len(in_offs) - 1
        steps = decode_stream.n_steps(len(body), declared)
        inputs = {"comp": body}
        outputs = {"out": ((max(declared, nwin * WIN, 1),), torch.uint8),
                   "state": ((decode_stream.STATE_WORDS + 1,), torch.int64),
                   "writtens": ((steps,), torch.int64)}
        if nwin:
            inputs.update(in_offs=_tensor(in_offs).to(torch.int64),
                          lengths=decode_stream.window_lengths(declared))
            outputs.update(ok=((nwin,), torch.bool), written=((nwin,), torch.int32))

        def launch(ins, outs):
            win = (ins["in_offs"], ins["lengths"], outs["ok"], outs["written"]) if nwin else None
            decode_stream._launch_scan(ins["comp"], declared, outs["out"], outs["state"],
                                       outs["writtens"], win)
            return (["decode_chunks"] if nwin else []) + ["decode_stream_scan"]

        def keep(ins, outs):
            kept = {k: outs[k] for k in ("state", "writtens", "ok", "written") if k in outs}
            kept["out"] = outs["out"][: int(outs["state"][decode_stream.S_WRITTEN])]
            return kept

        return self.run("decode_stream_scan", label, inputs, outputs, launch, keep, fills)

    def stream_routes(self, body: bytes, declared: int, label: str = "",
                      in_offs: Optional[np.ndarray] = None) -> None:
        """K4 and K5 on both of their routes: without an index, and on
        ``in_offs`` (by default ``decode_stream.window_index``) where there
        is one."""
        if in_offs is None and declared > 0:
            index = decode_stream.window_index(body, declared)
            in_offs = None if index is None else index.numpy()
        for offs in (None, in_offs) if in_offs is not None else (None,):
            self.decode_stream(body, declared, offs, label)
            self.decode_stream_scan(body, declared, offs, label)

    def chunk_streams(self, streams: Sequence[bytes], label: str = "") -> int:
        """Raw streams (varint header and body), each alone: K2 at both
        shapes where its declared length fits, K4 and K5 on both routes.
        Skips a stream whose header does not parse or declares more than
        64 MiB; returns the number run."""
        from ..formats import varint

        ran = 0
        for k, stream in enumerate(streams):
            declared, read = varint.decode_uint32(stream)
            if declared is None or declared > 1 << 26:
                continue
            ran += 1
            body = stream[read:]
            for width in (decode_chunks.CHUNK, decode_chunks.MAX_OUT):
                if declared <= width:
                    self.decode_chunks(body, [0, len(body)], [declared], width, f"{label} {k}")
            self.stream_routes(body, declared, f"{label} {k}")
        return ran


@contextlib.contextmanager
def _swapped(cache: dict, dev, value):
    """A wrapper's constants on ``dev`` replaced by ``value`` for the
    launch (the guarded copies)."""
    had, old = dev in cache, cache.get(dev)
    cache[dev] = value
    try:
        yield
    finally:
        if had:
            cache[dev] = old
        else:
            del cache[dev]


def long_payload(n: int, seed: int = 97) -> np.ndarray:
    """``n`` bytes of runs and period-8 data, a 1 MiB unit repeated: about
    20 bytes of output for each byte of its level-1 stream."""
    rng = payloads.Rand(seed)
    unit = np.concatenate([payloads.KINDS["runs"](rng, 1 << 19), payloads.KINDS["period8"](rng, 1 << 19)])
    return np.resize(unit, n)


def long_stream(g: Guard, declared: int) -> Dict[str, object]:
    """A raw stream of ``declared`` bytes of ``long_payload`` on K4's and
    K5's window routes, inside the guards (input guards 0x00 and 0xFF): the
    verdict and the SHA-256 of the output equal the host C decoder's
    (``host_codec.decode_tags_into``).  Returns what it measured; a
    difference goes to ``g.failures``."""
    t0 = time.perf_counter()
    payload = long_payload(declared)
    stream = host_codec.raw_compress(payload)
    del payload
    from ..formats import varint

    m, read = varint.decode_uint32(stream)
    body = np.frombuffer(stream, dtype=np.uint8)[read:]
    host = np.empty(declared, dtype=np.uint8)
    host_ok = host_codec.decode_tags_into(body, declared, host)
    want = hashlib.sha256(host).hexdigest()
    del host
    index = decode_stream.window_index(body, declared)
    made_s = time.perf_counter() - t0
    info = {"declared": declared, "body": len(body), "host_ok": host_ok, "sha256": want,
            "windows": None if index is None else len(index) - 1, "made_s": made_s}
    if m != declared or not host_ok or index is None:
        g.failures.append(f"long stream of {declared} bytes: header {m}, host C ok {host_ok}, "
                          f"index {'none' if index is None else 'built'}")
        return info
    offs = index.numpy()
    fills = (0x00, 0xFF)
    t = time.perf_counter()
    k4 = g.decode_stream(body, declared, offs, f"long stream of {declared} bytes", fills)
    k4_ok = k4["status"][:3].tolist() == [1, declared, len(body)]
    k4_sha = hashlib.sha256(k4["out"].cpu().numpy()).hexdigest()
    del k4
    info["k4_s"] = time.perf_counter() - t
    t = time.perf_counter()
    k5 = g.decode_stream_scan(body, declared, offs, f"long stream of {declared} bytes", fills)
    k5_ok = decode_stream.scan_status(k5["state"].tolist(), len(body), declared)[0] == 1
    k5_sha = hashlib.sha256(k5["out"].cpu().numpy()).hexdigest()
    info.update(k5_s=time.perf_counter() - t, k4_ok=k4_ok, k5_ok=k5_ok,
                k4_sha_equal=k4_sha == want, k5_sha_equal=k5_sha == want,
                walked=int(k5["state"][decode_stream.S_WALKED]))
    del k5
    for route, ok, sha in (("K4 window route", k4_ok, k4_sha), ("K5 window route", k5_ok, k5_sha)):
        if not ok or sha != want:
            g.failures.append(f"long stream of {declared} bytes, {route}: ok {ok}, SHA-256 {sha} "
                              f"against the host C decoder's {want}")
    return info
