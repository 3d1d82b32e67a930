"""Plain Snappy: a raw tag-stream decoder and the level-1 block encoder.

``decode`` walks a tag stream tag after tag (format_description.txt) and
returns the bytes it describes, or None where a tag is malformed or the
length differs from the declared one.  ``encode_block`` is the greedy
encoder with one-entry hash buckets and the 1/32 skip heuristic of
google/snappy's ``CompressFragment`` as the host C encoder
(snappy_codec.c, ``encode_block_impl``) runs it at level 1, whose bytes
the port's encoders are held to: a frozen, line-for-line copy, with the
words and their hashes computed up front so that a 64 KiB block takes
milliseconds.  ``bad_streams`` holds many tag streams to their frames at
once, in NumPy and plain PyTorch on any device.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 65536
INPUT_MARGIN = 15
MIN_NON_LITERAL_BLOCK_SIZE = 17
MAX_TABLE_BITS = 14
K_HASH = 0x1E35A7BD


def decode(body: bytes, declared: int):
    """The ``declared`` bytes that ``body`` encodes, or None."""
    n = len(body)
    out = bytearray()
    i = 0
    while i < n:
        b = body[i]
        tag = b & 3
        if tag == 0:
            length = (b >> 2) + 1
            hdr = 1
            if length > 60:
                hdr = length - 59
                if i + hdr > n:
                    return None
                length = int.from_bytes(body[i + 1 : i + hdr], "little") + 1
            if i + hdr + length > n or len(out) + length > declared:
                return None
            out += body[i + hdr : i + hdr + length]
            i += hdr + length
            continue
        hdr = (0, 2, 3, 5)[tag]
        if i + hdr > n:
            return None
        if tag == 1:
            length = 4 + ((b >> 2) & 7)
            offset = ((b & 0xE0) << 3) | body[i + 1]
        else:
            length = (b >> 2) + 1
            offset = int.from_bytes(body[i + 1 : i + hdr], "little")
        o = len(out)
        if offset == 0 or offset > o or o + length > declared:
            return None
        if offset >= length:
            out += out[o - offset : o - offset + length]
        else:
            pattern = bytes(out[o - offset :])
            out += (pattern * (length // offset + 1))[:length]
        i += hdr
    return bytes(out) if len(out) == declared else None


def _literal(out: bytearray, lit: bytes) -> None:
    n = len(lit) - 1
    if n < 60:
        out.append(n << 2)
    elif n < 256:
        out += bytes((60 << 2, n))
    else:
        out += bytes((61 << 2, n & 0xFF, n >> 8))
    out += lit


def _copy(out: bytearray, offset: int, length: int) -> None:
    def copy2(ln):
        out.extend((((ln - 1) << 2) | 2, offset & 0xFF, offset >> 8))

    while length >= 68:
        copy2(64)
        length -= 64
    if length > 64:
        copy2(60)
        length -= 60
    if length >= 12 or offset >= 2048:
        copy2(length)
    else:
        out.extend((((offset >> 8) << 5) | (((length - 4) & 7) << 2) | 1, offset & 0xFF))


def _table_bits(n: int) -> int:
    """log2 of the hash table's entries: the least power of two >= n, from
    256 to 16 K."""
    size = 256
    while size < (1 << MAX_TABLE_BITS) and size < n:
        size <<= 1
    return size.bit_length() - 1


def _match_end(data: bytes, s1: int, s2: int, n: int) -> int:
    """The first s2' >= s2 with data[s2'] != data[s1 + s2' - s2], or n."""
    while s2 < n:
        w = min(64, n - s2)
        if data[s1 : s1 + w] == data[s2 : s2 + w]:
            s1 += w
            s2 += w
            continue
        while data[s1] == data[s2]:
            s1 += 1
            s2 += 1
        return s2
    return n


def encode_block(data: bytes) -> bytes:
    """The level-1 tag stream of one block of at most 64 KiB."""
    n = len(data)
    out = bytearray()
    if n < MIN_NON_LITERAL_BLOCK_SIZE:
        if n:
            _literal(out, data)
        return bytes(out)
    bits = _table_bits(n)
    arr = np.frombuffer(data + b"\0\0\0", dtype=np.uint8).astype(np.uint64)
    words_a = arr[:n] | (arr[1 : n + 1] << 8) | (arr[2 : n + 2] << 16) | (arr[3 : n + 3] << 24)
    hashes = (((words_a * K_HASH) & 0xFFFFFFFF) >> (32 - bits)).tolist()
    words = words_a.tolist()  # words[p]: the 4 bytes at p, little-endian (p <= n - 4 are read)
    table = [0] * (1 << bits)
    ip = 1
    ip_limit = n - INPUT_MARGIN
    next_emit = 0
    while True:
        skip = 32
        next_ip = ip
        while True:  # probe with the 1/32 skip heuristic
            ip = next_ip
            step = skip >> 5
            skip += step
            next_ip = ip + step
            if next_ip > ip_limit:
                if next_emit < n:
                    _literal(out, data[next_emit:])
                return bytes(out)
            h = hashes[ip]
            candidate = table[h]
            table[h] = ip
            if words[ip] == words[candidate]:
                break
        if next_emit < ip:
            _literal(out, data[next_emit:ip])
        while True:  # extend the match, then try the next position
            base = ip
            ip = _match_end(data, candidate + 4, ip + 4, n)
            _copy(out, base - candidate, ip - base)
            next_emit = ip
            if ip > ip_limit:
                if next_emit < n:
                    _literal(out, data[next_emit:])
                return bytes(out)
            table[hashes[ip - 1]] = ip - 1
            h = hashes[ip]
            candidate = table[h]
            table[h] = ip
            if words[ip] != words[candidate]:
                ip += 1
                break


_HDR = np.array((1, 2, 3, 5))  # header bytes of a tag by its low two bits (a literal's before its extra length bytes)


def bad_streams(enc: torch.Tensor, totals, rows: torch.Tensor, lens, flush_every: int = 256,
                piece_bytes: int = 1 << 25) -> torch.Tensor:
    """bool [F] (on the CPU): true where ``enc[f, :totals[f]]`` is not a tag
    stream that decodes to ``rows[f, :lens[f]]``.

    The streams are parsed tag by tag on the host, all rows in step; every
    tag found is then held to the frame it should describe, byte by byte,
    on the rows' device: a literal's bytes equal the frame's at its place,
    and a copy's bytes equal the frame's ``offset`` bytes back, which is
    what decoding it yields once the output so far is the frame.  A stream
    is good where every tag is whole and within it, no copy reaches before
    the start, and its tags cover the frame exactly."""
    dev = rows.device
    n, width = enc.shape
    row_w = rows.shape[1]
    totals = torch.as_tensor(totals).cpu().numpy().astype(np.int64)
    lens = torch.as_tensor(lens).cpu().numpy().astype(np.int64)
    bad = (totals < 0) | (totals > width) | (lens < 0) | (lens > row_w)
    totals, lens = totals.clip(0, width), lens.clip(0, row_w)
    e = np.concatenate((enc.cpu().numpy().reshape(-1), np.zeros(8, np.uint8)))  # a tag may read 4 bytes past
    base = np.arange(n, dtype=np.int64) * width
    pos = np.zeros(n, dtype=np.int64)  # next tag in the stream
    out = np.zeros(n, dtype=np.int64)  # bytes described so far
    live = np.flatnonzero(~bad & (pos < totals))
    enc_flat, rows_flat = enc.to(dev).reshape(-1), rows.reshape(-1)

    def check(tags):
        f, at, length, lit, arg = (torch.from_numpy(np.concatenate(x)).to(dev) for x in zip(*tags))
        ends = length.cumsum(0)
        lo = 0
        while lo < len(f):  # pieces of about piece_bytes described bytes
            start = int(ends[lo] - length[lo])
            hi = max(lo + 1, int(torch.searchsorted(ends, start + piece_bytes, right=True)))
            tag = torch.repeat_interleave(torch.arange(lo, hi, device=dev), length[lo:hi])
            within = torch.arange(len(tag), device=dev) - (ends[tag] - length[tag] - start)
            fr, dst = f[tag], at[tag] + within
            want = rows_flat[fr * row_w + dst]
            got = torch.where(lit[tag], enc_flat[fr * width + (arg[tag] + within).clamp(max=width - 1)],
                              rows_flat[fr * row_w + (dst - arg[tag]).clamp(min=0)])
            bad[fr[got != want].unique().cpu().numpy()] = True
            lo = hi

    tags = []
    while len(live):
        p, o = pos[live], out[live]
        at = base[live] + p
        b = e[at].astype(np.int64)
        word = e[at + 1].astype(np.int64) | e[at + 2].astype(np.int64) << 8 \
            | e[at + 3].astype(np.int64) << 16 | e[at + 4].astype(np.int64) << 24
        tag, n1 = b & 3, (b >> 2) + 1
        lit = tag == 0
        extra = np.where(lit & (n1 > 60), n1 - 60, 0)
        length = np.where(lit, np.where(extra > 0, (word & ((1 << 8 * extra) - 1)) + 1, n1),
                          np.where(tag == 1, 4 + ((b >> 2) & 7), n1))
        offset = np.where(tag == 1, ((b & 0xE0) << 3) | (word & 0xFF), np.where(tag == 2, word & 0xFFFF, word))
        hdr = _HDR[tag] + extra
        end = p + hdr + np.where(lit, length, 0)
        ok = (end <= totals[live]) & (o + length <= lens[live]) & (lit | ((offset > 0) & (offset <= o)))
        bad[live[~ok]] = True
        live, end, o, length = live[ok], end[ok], o[ok], length[ok]
        tags.append((live, o, length, lit[ok], np.where(lit, p + hdr, offset)[ok]))
        pos[live], out[live] = end, o + length
        live = live[end < totals[live]]
        if len(tags) == flush_every:
            check(tags)
            tags = []
    if tags:
        check(tags)
    return torch.from_numpy(bad | (pos != totals) | (out != lens))
