"""The port's CRC32C by GF(2) products (kernel K6) against the JAX package.

The host matrices equal ``crc32c_mxu``'s bit for bit; the plain version
(stage 1 and 2 as int32 matmuls) equals ``crc32c_mxu.masked_crc32c_chunks``
and the TPU kernel ``masked_crc32c_chunks_fused`` run through the Pallas
interpreter, and the port's K1, at N = 8, on random chunks and the ragged
lengths 0, 1, 7, 511, 512, 513, 65,535 and 65,536.  The CUDA source
compiled by g++ (the twin: stage 1 as a bit loop, the kernel's own fold
and pad cancellation) is held against the plain version.  The card's
tensor-core body cannot run here; ``emulate_kernel`` follows its index
arithmetic with mma.sync's documented fragment layouts, to check the
packed constants it reads.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from snappy_tpu.ops import crc32c_jax, crc32c_mxu  # noqa: E402

from snappy_tpu_torch.ops import _build, crc32c, crc32c_mma  # noqa: E402
from snappy_tpu_torch.testing.payloads import Rand  # noqa: E402

P = crc32c_mma.CHUNK
LENGTH_SETS = {
    "edges": [0, 1, 7, 511, 512, 513, 65535, 65536],
    "mixed": [P, P - 3, 40000, 1, P, 7, 123, 65535],
}


def chunks_of(lengths, seed):
    rows = Rand(seed).bytes(len(lengths) * P).reshape(len(lengths), P)
    for k, n in enumerate(lengths):
        rows[k, n:] = 0
    return rows, np.asarray(lengths, dtype=np.int32)


@pytest.fixture(scope="module", params=sorted(LENGTH_SETS))
def batch(request):
    rows, lens = chunks_of(LENGTH_SETS[request.param], seed=len(request.param))
    got = crc32c_mma.masked_crc32c_chunks_fused(torch.from_numpy(rows), torch.from_numpy(lens))
    return rows, lens, got.numpy()


def test_matrices_equal_jax():
    A, B = crc32c_mma.matrices()
    JA, JB = crc32c_mxu._matrices()
    assert np.array_equal(A, JA) and np.array_equal(B, JB)


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


def test_plain_registers_match_stage_one_by_bits():
    """The registers of the matmul formulation equal the zero-init CRC of
    the padded chunk computed a byte at a time."""
    rows, _ = chunks_of([300, 5000], seed=7)
    tab = crc32c.tables()[0]
    for k, reg in enumerate(crc32c_mma.registers_plain(torch.from_numpy(rows)).tolist()):
        c = 0
        for b in rows[k].tolist():
            c = int(tab[(c ^ b) & 0xFF]) ^ (c >> 8)
        assert reg == c


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


def emulate_kernel(row: np.ndarray) -> np.ndarray:
    """The 128 super-lane registers of one chunk as crc32c_mma.cu computes
    them, with mma.sync m16n8k32 (row.col, s8) defined by its fragment
    layouts: thread (g, t) = (lane / 4, lane % 4) holds A[g][4t + i]
    (a0), A[g + 8][4t + i] (a1), A[g][16 + 4t + i] (a2), A[g + 8][16 + 4t
    + i] (a3), B[4t + i][g] (b0), B[16 + 4t + i][g] (b1), and gets D[g][2t
    + j] (c0, c1) and D[g + 8][2t + j] (c2, c3), byte or element i, j."""
    consts = crc32c_mma.consts()
    frag = consts[: crc32c_mma.K_STEPS * 32 * 8].reshape(crc32c_mma.K_STEPS, 32, 8)
    words = row.view(np.uint32).reshape(crc32c_mma.N_SUPER, crc32c_mma.K_STEPS)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    i = np.arange(4)

    def spread(x):  # stpu::spread4, as int8 values [..., 4]
        return ((x & 0xF)[..., None] >> i) & 1

    def unpack(w):  # 4 int8 of a 32-bit register
        return ((w[..., None] >> (8 * i).astype(np.uint32)) & 0xFF).astype(np.int64)

    regs = np.zeros(crc32c_mma.N_SUPER, dtype=np.int64)
    for warp in range(8):
        lo, hi = words[16 * warp + g], words[16 * warp + g + 8]  # [32 lanes, 128]
        acc = np.zeros((4, 16, 8), dtype=np.int64)
        for kk in range(crc32c_mma.K_STEPS):
            a = np.zeros((16, 32), dtype=np.int64)
            a[g[:, None], 4 * t[:, None] + i] = spread(lo[:, kk] >> (4 * t))
            a[g[:, None] + 8, 4 * t[:, None] + i] = spread(hi[:, kk] >> (4 * t))
            a[g[:, None], 16 + 4 * t[:, None] + i] = spread(lo[:, kk] >> (16 + 4 * t))
            a[g[:, None] + 8, 16 + 4 * t[:, None] + i] = spread(hi[:, kk] >> (16 + 4 * t))
            for nt in range(4):
                b = np.zeros((32, 8), dtype=np.int64)
                b[4 * t[:, None] + i, g[:, None]] = unpack(frag[kk, :, 2 * nt])
                b[16 + 4 * t[:, None] + i, g[:, None]] = unpack(frag[kk, :, 2 * nt + 1])
                acc[nt] += a @ b
        for r in range(16):
            regs[16 * warp + r] = sum(
                int(acc[nt, r, c] & 1) << (8 * nt + c) for nt in range(4) for c in range(8)
            )
    return regs


def test_emulated_kernel_gives_stage_one_registers():
    rows, _ = chunks_of([P], seed=11)
    A, _ = crc32c_mma.matrices()
    bits = (rows[0][:, None] >> np.arange(8)) & 1
    want = (bits.reshape(crc32c_mma.N_SUPER, crc32c_mma.SBITS).astype(np.int64) @ A) & 1
    want = (want << np.arange(32)).sum(axis=1)
    assert emulate_kernel(rows[0]).tolist() == want.tolist()


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the CPU twin")
    return _build.twin_lib()


def test_twin_matches_plain(twin, batch):
    rows, lens, got = batch
    out = np.zeros(len(lens), dtype=np.uint32)
    consts = crc32c_mma.consts()
    assert twin.stpu_twin_crc32c_mma(
        rows.ctypes.data, lens.ctypes.data, len(lens), consts.ctypes.data, out.ctypes.data
    ) == 0
    assert out.tolist() == got.tolist()
