"""The tiled masked CRC32C (kernel K1) through its CPU twin, exact.

The CUDA source cuts every row into a head and a tail of whole bytes and a
body of 16-byte words placed at the end of a window of 64 KiB tiles; a CTA
of 16 warps takes a tile, each lane keeping one register over its 32-byte
pieces, 1 KiB apart, with per-bank table copies; the lanes, the warps
and the tiles of a long row are folded by trees of "advance by 2^j bytes"
tables.  Its source compiled by g++ (the twin) runs the same tiles, lanes
and folds with each lane's values in arrays, and these tests hold it
against the plain version (``crc32c._crc32c_plain``, itself held against
the TPU kernel in tests/test_torch_crc32c.py) and against the host C CRC
(``snappy_tpu.ops.crc32c_native``): at the edge lengths of a word, a stride
and a tile, at every start offset of a 16-byte word with garbage past each
length, on rows of several tiles (the fold kernel), and on drawn lengths
and offsets.  The twin runs its lanes in both orders.  The port's binding
of the host C CRC (``host_codec.masked_crc32c``), chip_smoke.py's oracle on
the card, is held against the JAX package's.
"""

import ctypes
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from snappy_tpu.ops import crc32c_native  # noqa: E402

from snappy_tpu_torch.ops import _build, crc32c, host_codec  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

if shutil.which("g++") is None:
    pytest.skip("g++ is not available to build the CPU twin", allow_module_level=True)

EDGES = [0, 1, 15, 16, 17, 511, 512, 513, 4095, 65535, 65536]
MULTI_TILE = [65537, 131075, (1 << 20) + 7, 3 * 65536 + 1]  # the last: a tail tile of 1 byte


@pytest.fixture(scope="module", params=["lanes_up", "lanes_down"])
def twin(request):
    """The twin, its lanes run 0 .. 31 (the package's build) or 31 .. 0."""
    if request.param == "lanes_up":
        return _build.twin_lib().stpu_twin_crc32c_chunks
    so = _build._build(
        "twin_crc_lanes_down",
        ["g++", "-std=c++17", "-O2", "-fPIC", "-x", "c++", "-DSTPU_TWIN_REVERSE_LANES"],
        ["g++", "-shared"], [_build.CSRC / "crc32c.cu"], [_build.CSRC / "snappy_common.cuh"],
    )
    fn = ctypes.CDLL(str(so)).stpu_twin_crc32c_chunks
    fn.argtypes = _build._ENTRY_POINTS["crc32c_chunks"][:-1]
    return fn


def rows_at(lengths, offset, seed):
    """uint8 [N, W] rows of seeded random bytes, row k at `offset` bytes
    past a 16-byte edge, garbage past each length; W = max(lengths)."""
    rnd = payloads.Rand(seed)
    width = max(max(lengths), 1)
    stride = (width + offset + 16 + 15) // 16 * 16
    buf = rnd.bytes(len(lengths) * stride + 16)
    base = (-buf.ctypes.data) % 16  # the first 16-byte edge of the buffer
    rows = np.lib.stride_tricks.as_strided(
        buf[base + offset :], shape=(len(lengths), width), strides=(stride, 1))
    return rows, np.array(lengths, dtype=np.int32)


def run_twin(fn, rows, lens):
    n = len(lens)
    nt_max = crc32c.tiles_per_row(int(lens.max()) if n else 0)
    out = np.zeros(n, dtype=np.uint32)
    tile_regs = np.zeros(max(1, n * nt_max), dtype=np.uint32)
    rc = fn(rows.ctypes.data, rows.strides[0], lens.ctypes.data, n, nt_max,
            crc32c.tables().ctypes.data, crc32c.adv_tables().ctypes.data,
            tile_regs.ctypes.data, out.ctypes.data)
    assert rc == 0
    return out


def assert_twin_right(fn, rows, lens, plain=True):
    got = run_twin(fn, rows, lens)
    want = [crc32c_native.masked_crc32c(rows[k, :n].tobytes()) for k, n in enumerate(lens)]
    assert got.tolist() == want, "host C"
    if plain:
        p = crc32c._crc32c_plain(torch.from_numpy(np.ascontiguousarray(rows)), torch.from_numpy(lens))
        assert got.tolist() == p.tolist(), "plain version"


@pytest.mark.parametrize("offset", range(16))
def test_edge_lengths_at_every_offset(twin, offset):
    """Heads and tails of 0-15 bytes, bodies of 0, 1 and many words, a
    stride and a tile, and the empty row."""
    rows, lens = rows_at(EDGES, offset, seed=offset)
    assert_twin_right(twin, rows, lens)


@pytest.mark.parametrize("length", MULTI_TILE)
@pytest.mark.parametrize("offset", [0, 5, 15])
def test_rows_of_several_tiles(twin, length, offset):
    """Rows longer than a tile go through the fold kernel, beside rows of
    one tile in the same call."""
    rows, lens = rows_at([length, 1, 65536, length - 3], offset, seed=length + offset)
    assert_twin_right(twin, rows, lens, plain=length < 200_000)


def test_row_of_more_than_1024_tiles(twin):
    """The fold kernel's groups of 1,024 tiles: 1,030 tiles and a tail."""
    rows, lens = rows_at([1030 * 65536 + 9], 3, seed=7)
    assert_twin_right(twin, rows, lens, plain=False)


@settings(max_examples=40, deadline=None)
@given(lengths=st.lists(st.integers(0, 140_000), min_size=1, max_size=6),
       offset=st.integers(0, 15), skew=st.integers(0, 15), seed=st.integers(0, 1 << 30))
def test_twin_matches_host_c_property(twin, lengths, offset, skew, seed):
    """Drawn lengths in one call; a row stride of `skew` bytes past a
    16-byte multiple puts each row at its own offset."""
    width = max(max(lengths), 1)
    stride = (width + 15) // 16 * 16 + skew
    buf = payloads.Rand(seed).bytes(len(lengths) * stride + 32)
    base = (-buf.ctypes.data) % 16
    rows = np.lib.stride_tricks.as_strided(
        buf[base + offset :], shape=(len(lengths), width), strides=(stride, 1))
    assert_twin_right(twin, rows, np.array(lengths, dtype=np.int32), plain=False)


def test_adv_tables_advance_across_zero_bytes():
    """adv_tables()[j] applied byte-wise equals the GF(2) matrix of 2^j
    zero bytes, and a register advanced by 2^j equals the table CRC of
    2^j zero bytes from it."""
    rnd = payloads.Rand(11)
    tab = crc32c.tables()[0].tolist()
    adv = crc32c.adv_tables()
    for j in (0, 1, 4, 9, 16):
        for _ in range(4):
            v = int.from_bytes(rnd.bytes(4).tobytes(), "little")
            got = 0
            for p in range(4):
                got ^= int(adv[j, p, (v >> 8 * p) & 0xFF])
            reg = v
            for _ in range(1 << j):
                reg = tab[reg & 0xFF] ^ (reg >> 8)
            assert got == reg == crc32c._gf2_apply(crc32c.shift_matrices()[j], v)


def test_host_masked_crc32c_matches_jax_binding():
    rnd = payloads.Rand(5)
    for n in (0, 1, 15, 16, 17, 4095, 65537, 200_001):
        data = rnd.bytes(n).tobytes()
        assert host_codec.masked_crc32c(data) == crc32c_native.masked_crc32c(data)


def test_tile_slots():
    assert [crc32c.tiles_per_row(n) for n in (0, 1, 65536, 65537, 48 << 20)] == [1, 1, 1, 2, 768]
