"""The port's array encoder (snappy_tpu_torch/ops/encode_array.py) against
the JAX package's (snappy_tpu/ops/encode_jax.py) on the CPU.

The same blocks, zero-padded rows of 64 KiB as the engines give them, go
through both in slabs of 16 rows (one JAX shape): the output rows and the
totals are byte-equal, and every block's tag stream decodes back to the
block through the host C decoder.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappy_tpu.ops import encode_jax
from snappy_tpu_torch import engine
from snappy_tpu_torch.ops import encode_array, host_codec
from snappy_tpu_torch.testing import payloads

ROWS = 16
LENGTHS = [0, 1, 3, 4, 5] + list(range(63, 70)) + [65535, 65536]


def blocks():
    """(name, block) cases: payloads.encoder_cases(), then the edge lengths
    of a compressible kind and of runs."""
    cases = list(payloads.encoder_cases())
    text = payloads.mixed_payload(65536, 13)
    runs = payloads.KINDS["runs"](payloads.Rand(17), 65536).tobytes()
    for n in LENGTHS:
        cases.append((f"mixed_{n}", text[:n]))
        cases.append((f"runs_{n}", runs[:n]))
    # a long match whose +64 re-match has a short unrelated repeat nearby
    rnd = payloads.Rand(19).bytes(4000).tobytes()
    cont = rnd[:3000] + rnd[200:1400] + rnd[3000:]
    cases.append(("continuation", cont[:2000] + cont[2064:2068] + cont[2000:]))
    return cases


@pytest.fixture(scope="module")
def encoded():
    cases = blocks()
    n = -(-len(cases) // ROWS) * ROWS
    rows = np.zeros((n, 65536), dtype=np.int32)
    lens = np.zeros(n, dtype=np.int32)
    for k, (_, b) in enumerate(cases):
        rows[k, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[k] = len(b)
    want_out, want_tot, got_out, got_tot = [], [], [], []
    for lo in range(0, n, ROWS):
        w_out, w_tot = encode_jax.encode_blocks(
            jnp.asarray(rows[lo : lo + ROWS]), jnp.asarray(lens[lo : lo + ROWS]), engine._MAX_COMP_BLOCK)
        want_out.append(np.asarray(w_out))
        want_tot.append(np.asarray(w_tot))
        g_out, g_tot = encode_array.encode_blocks(
            torch.from_numpy(rows[lo : lo + ROWS]).to(torch.uint8), torch.from_numpy(lens[lo : lo + ROWS]),
            engine._MAX_COMP_BLOCK)
        got_out.append(g_out.numpy())
        got_tot.append(g_tot.numpy())
    k = len(cases)
    return (cases, np.concatenate(want_out)[:k], np.concatenate(want_tot)[:k],
            np.concatenate(got_out)[:k], np.concatenate(got_tot)[:k])


def test_max_comp_is_the_jax_engines():
    from snappy_tpu import engine as jax_engine

    assert engine._MAX_COMP_BLOCK == jax_engine._MAX_COMP_BLOCK == 76544


@pytest.mark.parametrize("part", range(6))
def test_encode_blocks_equals_jax(encoded, part):
    cases, w_out, w_tot, g_out, g_tot = encoded
    assert g_out.dtype == np.uint8 and g_tot.dtype == np.int32
    step = -(-len(cases) // 6)
    for k in range(part * step, min(len(cases), (part + 1) * step)):
        name = cases[k][0]
        assert g_tot[k] == w_tot[k], (name, g_tot[k], w_tot[k])
        assert np.array_equal(g_out[k], w_out[k]), (name, int(np.flatnonzero(g_out[k] != w_out[k])[0]))


def test_edge_lengths_covered(encoded):
    cases, _, w_tot, _, _ = encoded
    names = {name: k for k, (name, _) in enumerate(cases)}
    for n in LENGTHS:
        assert f"mixed_{n}" in names and f"runs_{n}" in names
    assert w_tot[names["mixed_0"]] == 0
    # a capped match: the runs block is long copies, each 3 bytes
    assert w_tot[names["runs_65536"]] < 65536 // 8


def test_round_trip_through_the_host_c_decoder(encoded):
    cases, _, _, g_out, g_tot = encoded
    for k, (name, b) in enumerate(cases):
        body = g_out[k, : g_tot[k]].tobytes()
        got, written = host_codec.decode_tags(body, len(b))
        assert got == b and written == len(b), name


def test_array_bytes_differ_from_k3s(encoded):
    """Another matcher: on compressible blocks the array encoder's streams
    are not the block encoder's, and here no larger."""
    cases, _, _, g_out, g_tot = encoded
    k = next(k for k, (name, _) in enumerate(cases) if name == "mixed_65536")
    k3 = host_codec.encode_block(cases[k][1], 1)
    assert g_out[k, : g_tot[k]].tobytes() != k3 and g_tot[k] <= len(k3)


def test_nearest_prev_candidate_equals_jax():
    rng = np.random.default_rng(3)
    v4 = rng.integers(0, 50, (2, 4096)).astype(np.uint32)
    v4[1, ::3] = 0xFFFFFFFF
    for r in range(2):
        want = np.asarray(encode_jax._nearest_prev_candidate(jnp.asarray(v4[r]), 4096))
        got = encode_array._nearest_prev_candidate(torch.from_numpy(v4[r : r + 1].astype(np.int64)))
        assert np.array_equal(want, got[0].numpy())


def test_lcp_equals_jax():
    rng = np.random.default_rng(4)
    b = 4096
    period = rng.integers(0, 256, 7)
    block = np.concatenate([np.tile(period, b // 7 + 1)[: b // 2], rng.integers(0, 4, b - b // 2)])
    block_ext = np.concatenate([block, np.zeros(72, dtype=np.int64)]).astype(np.int32)
    u = block_ext.astype(np.uint32)
    v4 = u[:b] | (u[1 : b + 1] << 8) | (u[2 : b + 2] << 16) | (u[3 : b + 3] << 24)
    v4_ext = np.concatenate([v4, np.zeros(72, dtype=np.uint32)])
    cand = np.where(rng.random(b) < 0.2, -1, rng.integers(0, b, b))
    cand = np.minimum(cand, np.arange(b) - 1).astype(np.int32)
    want = np.asarray(encode_jax._lcp(jnp.asarray(block_ext), jnp.asarray(v4_ext), jnp.asarray(cand), b))
    got = encode_array._lcp(torch.from_numpy(v4_ext.astype(np.int64))[None],
                            torch.from_numpy(cand.astype(np.int64))[None], b)
    assert np.array_equal(want.astype(np.int64), got[0].numpy())
    assert want.max() == 68 and (want == 0).any()


def test_reach_from_zero_equals_jax():
    rng = np.random.default_rng(8)
    size = 5001
    jump = np.minimum(np.arange(size) + rng.integers(1, 70, size), size - 1).astype(np.int32)
    want = np.asarray(encode_jax._reach_from_zero(jnp.asarray(jump), size))
    got = encode_array._reach_from_zero(torch.from_numpy(jump.astype(np.int64))[None])
    assert np.array_equal(want, got[0].numpy())
