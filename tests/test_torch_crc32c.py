"""The port's masked CRC32C (kernel K1) against the JAX package (exact).

The plain version is held against crc32c_jax.masked_crc32c_chunks (the XLA
twin on the JAX main path), against the TPU kernel itself run through the
Pallas interpreter (crc32c_pallas._lane_fold_pallas with interpret=True and
its outer steps), and against the host C CRC.  The CUDA kernel's own
source, compiled for the CPU by g++ (the twin), is held against the plain
version on the same inputs.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from snappy_tpu.ops import crc32c_jax, crc32c_native, crc32c_pallas  # noqa: E402

import snappy_tpu_torch as port  # noqa: E402
from snappy_tpu_torch.ops import _build, crc32c  # noqa: E402


def _chunks(lengths, width, seed, garbage=False):
    """uint8 [N, width] rows of random bytes, zero (or garbage) past each
    length."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, size=(len(lengths), width), dtype=np.uint8)
    if not garbage:
        for k, n in enumerate(lengths):
            rows[k, n:] = 0
    return rows, np.array(lengths, dtype=np.int32)


def test_tables_match_jax():
    assert np.array_equal(crc32c.tables(), crc32c_jax._tables())


def test_shift_matrices_match_jax():
    fwd, _ = crc32c_jax._shift_matrices()
    assert np.array_equal(crc32c.shift_matrices()[: len(fwd)], np.stack(fwd))


def test_plain_matches_xla_twin():
    lengths = [0, 1, 3, 4, 5, 63, 64, 65, 255, 256, 700, 1023, 1024]
    rows, lens = _chunks(lengths, 1024, seed=1)
    want = np.asarray(
        crc32c_jax.masked_crc32c_chunks(jnp.asarray(rows.astype(np.int32)), jnp.asarray(lens), 1024)
    )
    got = crc32c.masked_crc32c_chunks(torch.from_numpy(rows), torch.from_numpy(lens))
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), want)


def test_plain_matches_pallas_kernel_interpreted():
    """The TPU kernel K1 itself: _pallas_path runs _lane_fold_pallas (the
    pallas_call) with interpret=True, then the pad cancellation and mask."""
    lengths = [0, 1, 7, 100, 512, 777, 1000, 1024]  # 8 rows: the kernel's block
    rows, lens = _chunks(lengths, 1024, seed=2)
    want = np.asarray(
        crc32c_pallas._pallas_path(jnp.asarray(rows), jnp.asarray(lens), 1024, True)
    )
    got = crc32c.masked_crc32c_chunks(torch.from_numpy(rows), torch.from_numpy(lens))
    assert np.array_equal(got.numpy(), want)


def test_plain_matches_host_c_on_64k_chunks():
    lengths = [65536, 65535, 40000, 1]
    rows, lens = _chunks(lengths, 65536, seed=3, garbage=True)
    got = crc32c.masked_crc32c_chunks(torch.from_numpy(rows), torch.from_numpy(lens))
    for k, n in enumerate(lengths):
        assert int(got[k]) == crc32c_native.masked_crc32c(rows[k, :n].tobytes())


@pytest.mark.parametrize("n", [0, 1, 9, 65536, 200_003])
def test_one_shot_masked_crc32c(n):
    payload = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert port.masked_crc32c(payload, device="cpu") == crc32c_native.masked_crc32c(payload)


def test_wrapper_rejects_bad_inputs():
    rows = torch.zeros((2, 64), dtype=torch.uint8)
    with pytest.raises(TypeError):
        crc32c.masked_crc32c_chunks(rows.to(torch.int32), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        crc32c.masked_crc32c_chunks(rows, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        crc32c.masked_crc32c_chunks(rows, torch.tensor([1, 65], dtype=torch.int32))


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the CPU twin")
    return _build.twin_lib()


@pytest.mark.parametrize("width,offset", [(65536, 0), (1024, 1), (300_000, 3)])
def test_twin_matches_plain(twin, width, offset):
    """The kernel source, compiled by g++: the tiles, the lanes' registers,
    the folds of lanes, warps and tiles, the head and tail bytes and the
    mask.  Rows start at unaligned addresses when offset > 0, and bytes past
    each length are garbage the kernel must not read into the CRC."""
    lengths = sorted({0, 1, 3, 4, 5, 255, 256, 257, 4097, width // 2 + 1, width - 1, width})
    lengths = [n for n in lengths if n <= width]
    rows, lens = _chunks(lengths, width + offset, seed=width, garbage=True)
    rows = rows[:, offset:]
    nt_max = crc32c.tiles_per_row(width)
    out = np.zeros(len(lengths), dtype=np.uint32)
    tile_regs = np.zeros(len(lengths) * nt_max, dtype=np.uint32)
    rc = twin.stpu_twin_crc32c_chunks(
        rows.ctypes.data, rows.strides[0], lens.ctypes.data, len(lengths), nt_max,
        crc32c.tables().ctypes.data, crc32c.adv_tables().ctypes.data, tile_regs.ctypes.data,
        out.ctypes.data,
    )
    assert rc == 0
    want = crc32c._crc32c_plain(torch.from_numpy(np.ascontiguousarray(rows)), torch.from_numpy(lens))
    assert np.array_equal(out, want.numpy())
