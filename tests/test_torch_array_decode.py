"""The port's array decoder (snappy_tpu_torch/ops/decode_array.py) against
the JAX package's (snappy_tpu/ops/decode_jax.py) on the CPU.

The same inputs go through both: ``(out, ok, written)`` equal element for
element (the whole ``out`` row, zeros and all), on valid and malformed
streams alike.  The chunk cases share one JAX shape ([N, 65536] at u_pad
65536) and the raw streams another (one stream of 256 KiB at u_pad 256
KiB), so that JAX compiles each once.
"""

from __future__ import annotations

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappy_tpu.ops import decode_jax
from snappy_tpu_torch.formats import varint
from snappy_tpu_torch.ops import decode_array, host_codec
from snappy_tpu_torch.testing import payloads

REPO = Path(__file__).resolve().parents[1]
C_PAD = 1 << 16  # the chunk cases' comp width
U_PAD = 1 << 16  # ... and output width: the framed route's
RAW_PAD = 1 << 18  # comp and output width of the raw streams: 256 KiB


def copy1(offset: int, length: int) -> bytes:
    """A copy tag with a 1-byte offset (length 4-11, offset < 2048)."""
    return bytes([1 | ((length - 4) << 2) | ((offset >> 8) << 5), offset & 0xFF])


def lit_ext(value: int, nbytes: int) -> bytes:
    """A literal tag whose length extension of ``nbytes`` bytes holds
    ``value`` (the length is value + 1)."""
    return bytes([(59 + nbytes) << 2]) + value.to_bytes(nbytes, "little")


def chunk_cases():
    """(group, body, declared) rows for the chunk shape."""
    rng = payloads.Rand(101)
    rows = []
    bodies = {}
    for kind, make in payloads.KINDS.items():
        data = make(rng, 40_000).tobytes()
        for level in (1, 2):
            body = host_codec.encode_block(data, level)
            rows.append((f"kind_{kind}", body, len(data)))
        bodies[kind] = (body, len(data))
    block = payloads.mixed_payload(65536, 7)
    rows.append(("kind_mixed_64k", host_codec.encode_block(block), 65536))
    rows += [("malformed", body, n) for body, n in payloads.malformed_chunks()]
    for kind in ("text", "ssz"):
        body, n = bodies[kind]
        rows += [("truncated", body[:cut], n) for cut in (1, len(body) // 3, len(body) // 2, len(body) - 1)]
    head = payloads.literal(b"abcdefgh")
    rows += [
        ("offset_0", head + copy1(0, 4), 12),
        ("offset_0", head + payloads.copy2(0, 9), 17),
        ("offset_beyond_written", head + payloads.copy2(9, 4), 12),
        ("offset_beyond_written", head + payloads.copy4(1 << 20, 8), 16),
        ("offset_beyond_written", payloads.copy2(1, 4) + head, 12),
    ]
    # literal length extensions at and near 0xFFFFFFFF: the +1 wraps to 0,
    # and the consumed count (header + length) wraps to 0-4
    for value in range(0xFFFFFFFF - 5, 0xFFFFFFFF + 1):
        rows.append(("literal_wrap", lit_ext(value, 4) + head, 8))
        rows.append(("literal_wrap", head + lit_ext(value, 4) + b"\x00" * 8, 8))
    rows.append(("literal_wrap", lit_ext(0xFFFFFF, 3) + head, 8))
    for off in range(1, 8):
        lead = payloads.literal(b"abcdefgh"[:off])
        for length in (4, 7, 11):
            rows.append(("short_offsets", lead + copy1(off, length), off + length))
        rows.append(("short_offsets", lead + payloads.copy2(off, 64), off + 64))
    body, n = bodies["text"]
    for declared in (n - 1, n + 1, 0, 2 * n, 1 << 30, -1):
        rows.append(("declared_differs", body, declared))
    return rows


def _jax_chunks(rows):
    comp = np.zeros((len(rows), C_PAD), dtype=np.int32)
    for k, (_, body, _) in enumerate(rows):
        comp[k, : len(body)] = np.frombuffer(body, dtype=np.uint8)
    lens = np.array([len(b) for _, b, _ in rows], dtype=np.int32)
    decl = np.array([d for _, _, d in rows], dtype=np.int64).astype(np.int32)
    return comp, lens, decl


@pytest.fixture(scope="module")
def chunks():
    rows = chunk_cases()
    comp, lens, decl = _jax_chunks(rows)
    want = decode_jax.decode_chunks(jnp.asarray(comp), jnp.asarray(lens), jnp.asarray(decl), U_PAD)
    want = [np.asarray(w) for w in want]
    got = [[], [], []]
    for lo in range(0, len(rows), 16):  # slabs of 16 rows spare the host's memory
        part = decode_array.decode_chunks(
            torch.from_numpy(comp[lo : lo + 16]), torch.from_numpy(lens[lo : lo + 16]),
            torch.from_numpy(decl[lo : lo + 16]), U_PAD)
        for acc, t in zip(got, part):
            acc.append(t.numpy())
    return rows, want, [np.concatenate(g) for g in got]


GROUPS = ("kind_text", "kind_ssz", "kind_runs", "kind_period8", "kind_random", "kind_mixed_64k",
          "malformed", "truncated", "offset_0", "offset_beyond_written", "literal_wrap",
          "short_offsets", "declared_differs")


@pytest.mark.parametrize("group", GROUPS)
def test_decode_chunks_equals_jax(chunks, group):
    rows, (w_out, w_ok, w_written), (out, ok, written) = chunks
    sel = [k for k, (g, _, _) in enumerate(rows) if g == group]
    assert sel, group
    assert out.dtype == np.uint8 and ok.dtype == np.bool_ and written.dtype == np.int32
    for k in sel:
        assert ok[k] == w_ok[k], (group, k)
        assert written[k] == w_written[k], (group, k, written[k], w_written[k])
        assert np.array_equal(out[k], w_out[k]), (group, k, int(np.flatnonzero(out[k] != w_out[k])[0]))


def test_chunk_verdicts_are_the_expected_ones(chunks):
    rows, (w_out, w_ok, _), _ = chunks
    for k, (group, body, n) in enumerate(rows):
        if group.startswith("kind_"):
            assert w_ok[k] and host_codec.decode_tags(body, n)[0] == w_out[k, :n].tobytes(), (group, k)
        elif group in ("malformed", "truncated", "offset_0", "offset_beyond_written", "literal_wrap",
                       "declared_differs"):
            assert not w_ok[k], (group, k)
        else:  # short overlapping copies are valid
            assert w_ok[k], (group, k)


def _raw_streams():
    """(name, body, declared) raw streams for decode_raw at RAW_PAD: a 256
    KiB stream, then 60 of the mutation streams."""
    data = payloads.mixed_payload(RAW_PAD, 11)
    out = [("raw_256k", payloads.body_of(host_codec.raw_compress(data, 1)), RAW_PAD)]
    for k, (s, kind) in enumerate(payloads.mutation_streams(60)):
        declared, read = varint.decode_uint32(s)
        if declared is None:
            declared, read = 0, 0
        out.append((f"mutation_{k}_{kind}", s[read:], declared))
    return out


@pytest.fixture(scope="module")
def raw_results():
    res = []
    for name, body, declared in _raw_streams():
        assert len(body) <= RAW_PAD, (name, len(body))
        comp = np.zeros(RAW_PAD, dtype=np.int32)
        comp[: len(body)] = np.frombuffer(body, dtype=np.uint8)
        d32 = np.int64(declared).astype(np.int32)  # JAX's int32 view of the declared length
        want = [np.asarray(w) for w in decode_jax.decode_raw(
            jnp.asarray(comp), jnp.int32(len(body)), jnp.asarray(d32), RAW_PAD)]
        got = [t.numpy() for t in decode_array.decode_raw(
            torch.from_numpy(comp), len(body), int(d32), RAW_PAD)]
        res.append((name, body, declared, want, got))
    return res


def test_decode_raw_256k_stream(raw_results):
    name, body, declared, want, got = raw_results[0]
    assert name == "raw_256k" and want[1] and want[2] == RAW_PAD
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] and got[2] == want[2]
    assert got[0].tobytes() == payloads.mixed_payload(RAW_PAD, 11)


@pytest.mark.parametrize("part", range(6))
def test_decode_raw_mutation_streams(raw_results, part):
    for name, body, declared, want, got in raw_results[1 + 10 * part : 11 + 10 * part]:
        assert got[1] == want[1] and got[2] == want[2], (name, got[1:], want[1:])
        assert np.array_equal(got[0], want[0]), name
        # the verdict is the host C decoder's too, as on the JAX array route
        host = payloads.host_raw_decode(varint.encode_uint32(declared) + body) if declared else None
        if declared and declared <= RAW_PAD:
            assert bool(want[1]) == (host is not None), name
            if host is not None:
                assert got[0][:declared].tobytes() == host, name


def test_parse_all_positions_equals_jax():
    rng = np.random.default_rng(5)
    c_pad = 4096
    comp = rng.integers(0, 256, (3, c_pad + 4)).astype(np.int32)
    comp[0, ::7] = 0xFC  # literal length extensions, and their wraps
    comp[1, 1::5] = 0xFF
    comp[2, ::3] = 0xF8
    for r in range(3):
        want = decode_jax._parse_all_positions(jnp.asarray(comp[r]), c_pad)
        got = decode_array._parse_all_positions(torch.from_numpy(comp[r : r + 1]).to(torch.int64), c_pad)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w).astype(np.int64), g[0].numpy().astype(np.int64))


def test_reachable_equals_jax():
    rng = np.random.default_rng(6)
    c_pad = 2048
    for trial in range(4):
        nxt = np.arange(c_pad) + rng.integers(1, 9, c_pad)
        nxt = np.where(nxt >= c_pad, c_pad, nxt)
        nxt[rng.integers(0, c_pad, 5)] = c_pad + 1  # a few errors
        if trial == 3:
            nxt[100] = 100  # a self-loop: a tag that consumes nothing
        jump = np.concatenate([nxt, [c_pad, c_pad + 1]]).astype(np.int32)
        for comp_len in (0, c_pad):
            want = decode_jax._reachable(jnp.asarray(jump), c_pad, jnp.int32(comp_len))
            got = decode_array._reachable(
                torch.from_numpy(jump).to(torch.int64)[None], c_pad, torch.tensor([comp_len]))
            for w, g in zip(want, got):
                assert np.array_equal(np.asarray(w), g[0].numpy())


def test_jax_index_rules():
    """_take and _scatter_max follow JAX's gather and scatter on indices
    out of range: negative ones counted from the end once, then clamped
    (gather) or dropped (scatter)."""
    x = np.arange(10, dtype=np.int32) * 10
    idx = np.array([-1, -3, 12, 15, -12, -25, 5, 0, 9], dtype=np.int32)
    want = np.asarray(jnp.asarray(x)[jnp.asarray(idx)])
    got = decode_array._take(torch.from_numpy(x).to(torch.int64)[None], torch.from_numpy(idx).to(torch.int64)[None])
    assert np.array_equal(want, got[0].numpy())
    base = np.full(10, -1, dtype=np.int32)
    val = np.arange(9, dtype=np.int32) + 100
    want = np.asarray(jnp.asarray(base).at[jnp.asarray(idx)].max(jnp.asarray(val), mode="drop"))
    got = decode_array._scatter_max(torch.from_numpy(base).to(torch.int64)[None],
                                    torch.from_numpy(idx).to(torch.int64)[None],
                                    torch.from_numpy(val).to(torch.int64)[None])
    assert np.array_equal(want, got[0].numpy())


def test_array_modules_import_neither_jax_nor_the_jax_package():
    for name in ("decode_array.py", "encode_array.py", "../engine.py", "../config.py"):
        f = REPO / "snappy_tpu_torch" / "ops" / name
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "snappy_tpu"), (name, n)
