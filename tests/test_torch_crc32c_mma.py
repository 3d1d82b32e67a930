"""The port's CRC32C by GF(2) products (kernel K6) against the JAX package.

The host matrices equal ``crc32c_mxu``'s bit for bit, and the CUDA
kernel's step matrices are theirs: ``A32`` is the last 256 rows of ``A``
and ``M32`` the advance over 32 zero bytes.  The plain version (stage 1
and 2 as int32 matmuls) equals ``crc32c_mxu.masked_crc32c_chunks`` and the
TPU kernel ``masked_crc32c_chunks_fused`` run through the Pallas
interpreter, and the port's K1, at N = 8, on random chunks and the ragged
lengths 0, 1, 7, 511, 512, 513, 65,535 and 65,536.

The card's tensor-core body cannot run here.  ``emulate_unit`` follows its
arithmetic in numpy with mma.sync's documented fragment layouts and the
packed constants it reads: u8 bit-plane operands against weights scaled by
2^(7 - kk), the parity in bit 7, and the register so far fed back from
byte 0 of the C fragment through the permuted slots of the 9th k-step; its
16 stripe registers equal the table CRC of each stripe.  The CUDA source
compiled by g++ (the twin, whose ``warp_mma`` computes mma.sync's product
from the same layouts) runs the kernel's operands, walk, persistent grid,
folds and finish, lanes in both orders, and is held against the plain
version on the length sets, on drawn batches, and with CTAs owning 1 to 5
chunks (the loads of a warp's next chunk requested from the one before).
The packed constants hold the advance tables, the inverse shift matrices
and the init term at the kernel's offsets.
"""

import ctypes
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from snappy_tpu.ops import crc32c_jax, crc32c_mxu  # noqa: E402

from snappy_tpu_torch.ops import _build, crc32c, crc32c_mma  # noqa: E402
from snappy_tpu_torch.testing import mma_layouts  # noqa: E402
from snappy_tpu_torch.testing.payloads import Rand  # noqa: E402

P = crc32c_mma.CHUNK
LENGTH_SETS = {
    "edges": [0, 1, 7, 511, 512, 513, 65535, 65536],
    "mixed": [P, P - 3, 40000, 1, P, 7, 123, 65535],
}
# steps, stripes and units: the kernel's own edges
KERNEL_EDGES = [0, 1, 31, 32, 33, 511, 512, 4095, 4096, 8191, 8192, 65535, 65536]


def chunks_of(lengths, seed):
    rows = Rand(seed).bytes(len(lengths) * P).reshape(len(lengths), P)
    for k, n in enumerate(lengths):
        rows[k, n:] = 0
    return rows, np.asarray(lengths, dtype=np.int32)


def plain(rows, lens):
    return crc32c_mma._crc32c_mma_plain(torch.from_numpy(rows), torch.from_numpy(lens)).numpy()


@pytest.fixture(scope="module", params=sorted(LENGTH_SETS))
def batch(request):
    rows, lens = chunks_of(LENGTH_SETS[request.param], seed=len(request.param))
    got = crc32c_mma.masked_crc32c_chunks_fused(torch.from_numpy(rows), torch.from_numpy(lens))
    return rows, lens, got.numpy()


def test_matrices_equal_jax():
    A, B = crc32c_mma.matrices()
    JA, JB = crc32c_mxu._matrices()
    assert np.array_equal(A, JA) and np.array_equal(B, JB)


def test_step_matrices_equal_jax():
    """The kernel's A32 is A's last 256 rows, its M32 the JAX advance over
    32 zero bytes."""
    assert np.array_equal(crc32c_mma.a32(), crc32c_mxu._matrices()[0][3840:])
    assert np.array_equal(crc32c_mma.m32(), np.asarray(crc32c_jax._shift_matrices()[0][5]))


def test_pad_matrices_equal_jax():
    _, inv = crc32c_jax._shift_matrices()
    assert np.array_equal(crc32c_mma.inverse_shift_matrices(), np.stack(inv[:17]).astype(np.uint32))
    assert crc32c_mma.init_term() == int(crc32c_jax._init_term(P))


def test_plain_matches_jax_mxu(batch):
    rows, lens, got = batch
    want = crc32c_mxu.masked_crc32c_chunks(jnp.asarray(rows.astype(np.int32)), jnp.asarray(lens), P)
    assert got.tolist() == np.asarray(want).tolist()


def test_plain_matches_tpu_fused_kernel_interpreted(batch):
    rows, lens, got = batch
    want = crc32c_mxu.masked_crc32c_chunks_fused(
        jnp.asarray(rows.astype(np.int32)), jnp.asarray(lens), P, True
    )
    assert got.tolist() == np.asarray(want).tolist()


def test_plain_matches_k1(batch):
    rows, lens, got = batch
    want = crc32c._crc32c_plain(torch.from_numpy(rows), torch.from_numpy(lens))
    assert got.tolist() == want.tolist()


def zero_init_crc(data: np.ndarray) -> int:
    """The table-driven register of `data` from 0."""
    tab = crc32c.tables()[0]
    c = 0
    for b in data.tolist():
        c = int(tab[(c ^ b) & 0xFF]) ^ (c >> 8)
    return c


def test_plain_registers_match_stage_one_by_bits():
    """The registers of the matmul formulation equal the zero-init CRC of
    the padded chunk computed a byte at a time."""
    rows, _ = chunks_of([300, 5000], seed=7)
    for k, reg in enumerate(crc32c_mma.registers_plain(torch.from_numpy(rows)).tolist()):
        assert reg == zero_init_crc(rows[k])


def test_wrapper_checks():
    rows, lens = chunks_of([10, 20], seed=3)
    t, lt = torch.from_numpy(rows), torch.from_numpy(lens)
    with pytest.raises(ValueError, match="zero past"):
        bad = t.clone()
        bad[0, 10] = 1
        crc32c_mma.masked_crc32c_chunks_fused(bad, lt)
    with pytest.raises(TypeError):
        crc32c_mma.masked_crc32c_chunks_fused(t[:, :4096].contiguous(), lt)
    with pytest.raises(TypeError):
        crc32c_mma.masked_crc32c_chunks_fused(t, lt.to(torch.int64))
    with pytest.raises(ValueError):
        crc32c_mma.masked_crc32c_chunks_fused(t, torch.tensor([10, P + 1], dtype=torch.int32))
    empty = crc32c_mma.masked_crc32c_chunks_fused(
        torch.zeros((0, P), dtype=torch.uint8), torch.zeros(0, dtype=torch.int32)
    )
    assert empty.shape == (0,)
    before = crc32c_mma.LAUNCHES
    crc32c_mma.masked_crc32c_chunks_fused(t, lt)
    assert crc32c_mma.LAUNCHES == before


LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
I4 = np.arange(4)


def _bytes_of(w):
    """The 4 u8 of each 32-bit register, [..., 4]."""
    return ((w[..., None] >> (8 * I4).astype(np.uint32)) & 0xFF).astype(np.int64)


def _word(b):
    """Little-endian words of [..., 4] bytes."""
    return (b.astype(np.uint32) << (8 * I4).astype(np.uint32)).sum(axis=-1, dtype=np.uint32)


def mma_u8(a, b, c):
    """mma.sync m16n8k32 .row.col u8.u8.s32 over the warp's fragments:
    a [32 lanes, 4] (thread (g, t) holds A[g][4t + i] in byte i of a0,
    A[g + 8][4t + i] in a1, A[g][16 + 4t + i] in a2, A[g + 8][16 + 4t + i]
    in a3), b [32, 2] (B[4t + i][g] in b0, B[16 + 4t + i][g] in b1), c
    [32, 4] (D[g][2t + j] in c0, c1, D[g + 8][2t + j] in c2, c3)."""
    A = np.zeros((16, 32), dtype=np.int64)
    B = np.zeros((32, 8), dtype=np.int64)
    for r, (row, col) in enumerate([(0, 0), (8, 0), (0, 16), (8, 16)]):
        A[G[:, None] + row, col + 4 * T[:, None] + I4] = _bytes_of(a[:, r])
    B[4 * T[:, None] + I4, G[:, None]] = _bytes_of(b[:, 0])
    B[16 + 4 * T[:, None] + I4, G[:, None]] = _bytes_of(b[:, 1])
    D = A @ B
    return c + np.stack([D[G, 2 * T], D[G, 2 * T + 1], D[G + 8, 2 * T], D[G + 8, 2 * T + 1]], axis=1)


def emulate_unit(unit: np.ndarray) -> np.ndarray:
    """The 16 stripe registers of one 8 KiB unit as crc32c_mma.cu computes
    them, from the packed constants: each step, thread (g, t) takes bytes 8t
    .. 8t + 7 of rows g and g + 8 (a0 / a2: row g's first / last four, a1 /
    a3: row g + 8's); k-step kk takes w & (0x01010101 << kk); after the
    first step a 9th k-step takes byte 0 of the step before's accumulators,
    a0 = (c0, c1 of n-tile 0, c0, c1 of n-tile 1), a2 the same of n-tiles 2
    and 3, a1 / a3 from c2, c3."""
    frag = crc32c_mma.consts()[: crc32c_mma.MMA_K_STEPS * 32 * 8].reshape(
        crc32c_mma.MMA_K_STEPS, 32, 4, 2)
    stripes = unit.reshape(16, crc32c_mma.STRIPE)
    acc = None
    for s in range(crc32c_mma.STEPS):
        blk = stripes[:, crc32c_mma.STEP * s : crc32c_mma.STEP * (s + 1)]
        w = np.stack([_word(blk[G + row][np.arange(32)[:, None], 8 * T[:, None] + half + I4])
                      for row, half in [(0, 0), (8, 0), (0, 4), (8, 4)]], axis=1)
        new = np.zeros((4, 32, 4), dtype=np.int64)
        for kk in range(8):
            a = w & np.uint32(0x01010101 << kk)
            for nt in range(4):
                new[nt] = mma_u8(a, frag[kk, :, nt], new[nt])
        if acc is not None:
            low = acc & 0xFF  # byte 0 of each accumulator
            state = np.stack([
                _word(np.stack([low[2 * h][:, r], low[2 * h][:, r + 1],
                                low[2 * h + 1][:, r], low[2 * h + 1][:, r + 1]], axis=1))
                for h, r in [(0, 0), (0, 2), (1, 0), (1, 2)]], axis=1)
            for nt in range(4):
                new[nt] = mma_u8(state, frag[8, :, nt], new[nt])
        # every product is 128 . bit . weight, 288 terms at most
        assert not (new & 0x7F).any() and int(new.max()) < 1 << 16
        acc = new
    regs = np.zeros(16, dtype=np.int64)
    for nt in range(4):
        for j in range(2):
            for half in range(2):
                on = (acc[nt][:, 2 * half + j] >> 7) & 1
                np.bitwise_or.at(regs, G + 8 * half, on << (8 * nt + 2 * T + j))
    return regs


def test_emulated_kernel_gives_stage_one_registers():
    """The fragment arithmetic on one unit (16 stripes of 512 bytes) gives
    each stripe's zero-init register."""
    rows, _ = chunks_of([P], seed=11)
    unit = rows[0][: crc32c_mma.UNIT]
    want = [zero_init_crc(unit[k * crc32c_mma.STRIPE : (k + 1) * crc32c_mma.STRIPE]) for k in range(16)]
    assert emulate_unit(unit).tolist() == want


def test_fragments_carry_the_step_matrices():
    """Unpacked, k-step kk < 8 of the B fragments is A32's rows 8 byte + kk
    scaled by 2^(7 - kk), and k-step 8 is M32 with its slots permuted to the
    lanes' C-fragment columns: every slot of it is one state bit, each once."""
    frag = crc32c_mma.fragments()
    A, M = crc32c_mma.a32().astype(np.int64), crc32c_mma.m32()
    slot_bits = set()
    for lane in range(32):
        g, t = divmod(lane, 4)
        for nt in range(4):
            for r in range(2):
                got = _bytes_of(frag[:, lane, nt, r])  # [9, 4]
                for i in range(4):
                    byte = 8 * t + 4 * r + i
                    assert got[:8, i].tolist() == [A[8 * byte + kk, 8 * nt + g] << (7 - kk) for kk in range(8)]
                    bit = 16 * r + 8 * (i // 2) + 2 * t + i % 2
                    assert got[8, i] == (int(M[bit]) >> (8 * nt + g)) & 1
                    slot_bits.add((4 * t + i + 16 * r, bit))
    assert sorted(b for _, b in slot_bits) == list(range(32))


@pytest.fixture(scope="module", params=["lanes_up", "lanes_down"])
def twin(request):
    """The twin, its lanes run 0 .. 31 (the package's build) or 31 .. 0."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the CPU twin")
    if request.param == "lanes_up":
        return _build.twin_lib()
    so = _build._build(
        "twin_mma_lanes_down",
        ["g++", "-std=c++17", "-O2", "-fPIC", "-x", "c++", "-DSTPU_TWIN_REVERSE_LANES"],
        ["g++", "-shared"], [_build.CSRC / "crc32c_mma.cu"], [_build.CSRC / "snappy_common.cuh"],
    )
    lib = ctypes.CDLL(str(so))
    lib.stpu_twin_crc32c_mma.argtypes = _build._ENTRY_POINTS["crc32c_mma"][:-1]
    return lib


def run_twin(lib, rows, lens):
    """The twin's CRCs of a batch, on its grid of 3 CTAs (at most one a
    chunk)."""
    out = np.zeros(len(lens), dtype=np.uint32)
    consts = crc32c_mma.consts()
    assert lib.stpu_twin_crc32c_mma(rows.ctypes.data, lens.ctypes.data, len(lens),
                                    consts.ctypes.data, out.ctypes.data) == 0
    return out


def test_twin_matches_plain(twin, batch):
    rows, lens, got = batch
    assert run_twin(twin, rows, lens).tolist() == got.tolist()


@pytest.fixture(scope="module")
def edge_batch():
    rows, lens = chunks_of(KERNEL_EDGES, seed=13)
    return rows, lens, plain(rows, lens)


@pytest.mark.parametrize("n", [1, 2, 5, len(KERNEL_EDGES)])
def test_twin_grids(twin, edge_batch, n):
    """The first n edge chunks on the twin's 3 CTAs: CTAs owning 1 .. 5
    chunks each, each warp's loads of its next chunk going out from the end
    of the one before."""
    rows, lens, want = edge_batch
    assert run_twin(twin, rows[:n], lens[:n]).tolist() == want[:n].tolist()


@settings(max_examples=12, deadline=None)
@given(n=st.integers(1, 20), seed=st.integers(0, 1 << 30), full=st.floats(0, 1))
def test_twin_matches_plain_property(n, seed, full):
    """Drawn batches: N in 1 .. 20, lengths in 0 .. 65,536 (a drawn share
    of them full chunks)."""
    rnd = Rand(seed)
    lens = rnd.ints(0, P + 1, n)
    lens[rnd.ints(0, 1 << 20, n) < int(full * (1 << 20))] = P
    rows, lens = chunks_of(lens.tolist(), seed)
    assert run_twin(_build.twin_lib(), rows, lens).tolist() == plain(rows, lens).tolist()


def test_kernel_params():
    """The geometry and the constants' size that the source defines are the
    wrapper's."""
    p = mma_layouts.kernel_params(_build.twin_lib())
    assert (p["chunk"], p["warps"], p["stripe"]) == (P, crc32c_mma.WARPS, crc32c_mma.STRIPE)
    assert p["const_words"] == len(crc32c_mma.consts())
    # the warps' registers by turns, and each warp's slots: the steps ahead
    # and the one being read
    ring = crc32c_mma.WARPS * (p["ring"] + 1) * 16 * crc32c_mma.STEP
    assert p["smem_bytes"] == 4 * 2 * crc32c_mma.WARPS + ring
    assert p["ctas_per_sm"] == 0 and p["ring"] >= 1


FRAG_WORDS = crc32c_mma.MMA_K_STEPS * 32 * 8  # the constants' first part


@pytest.mark.parametrize("level", crc32c_mma.ADV_LEVELS)
def test_consts_advance_tables(level):
    """The k-th advance table of the constants takes a register across
    2^level zero bytes: a lookup a byte equals the shift matrix's product."""
    k = crc32c_mma.ADV_LEVELS.index(level)
    a = crc32c_mma.consts()[FRAG_WORDS + 1024 * k : FRAG_WORDS + 1024 * (k + 1)].reshape(4, 256)
    values = [1 << i for i in range(32)] + Rand(level).ints(0, 1 << 32, 32).tolist()
    for v in values:
        got = int(a[0, v & 0xFF] ^ a[1, (v >> 8) & 0xFF] ^ a[2, (v >> 16) & 0xFF] ^ a[3, v >> 24])
        assert got == crc32c._gf2_apply(crc32c.shift_matrices()[level], v), (level, v)


def test_consts_tail_terms():
    """After the tables: the 17 inverse shift matrices, each undoing its
    advance, then the init term; nothing more."""
    tail = crc32c_mma.consts()[FRAG_WORDS + 1024 * len(crc32c_mma.ADV_LEVELS) :]
    inv = tail[: 17 * 32].reshape(17, 32)
    for j in range(17):
        for v in (1, 0x80000000, 0x12345678, 0xFFFFFFFF):
            assert crc32c._gf2_apply(inv[j], crc32c._gf2_apply(crc32c.shift_matrices()[j], v)) == v
    assert tail[17 * 32 :].tolist() == [crc32c_mma.init_term()]
