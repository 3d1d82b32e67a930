"""The port's sharded paths (snappy_tpu_torch.parallel.mesh) against the JAX
package, on gloo groups of CPU processes (exact).

One spawn per world size (1, 3 and 4 ranks, all started at once) runs
every case in every rank with ``device="cpu"`` (the kernels' plain
versions) and writes each rank's results to a file under the module's
temporary directory; the parametrized tests below assert on those files.
Encode: every rank's bytes equal the JAX package's raw and framed bytes
(host C, which equals its TPU kernels), and for one payload also the JAX
mesh's own TPU path (``pmesh.sharded_*_compress`` with the scalar kernels
in interpret mode).  Decode: every rank's (payload, reason) equals
``pmesh.sharded_framed_uncompress`` on the 8-device CPU mesh of
tests/conftest.py, including the cases where the JAX mesh's error order
differs from the JAX engine's.  The shard split and the bytes each
all-gather sends per chunk are pinned.
"""

import ast
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from snappy_tpu import engine as jax_engine  # noqa: E402
from snappy_tpu.parallel import mesh as pmesh  # noqa: E402

from snappy_tpu_torch.formats import constants as C  # noqa: E402
from snappy_tpu_torch.formats import framing, varint  # noqa: E402
from snappy_tpu_torch.parallel import mesh  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

from test_parallel import _payload  # noqa: E402
from test_torch_framed import CASES as FRAMED_CASES, _case as framed_case  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORLDS = (1, 3, 4)
WAIT_S = 240  # per spawn; each group's collectives time out after 120 s

WORKER = textwrap.dedent(
    """
    import pickle, sys
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    from snappy_tpu_torch.parallel import mesh, multihost

    port, rank, world, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                         timeout=timedelta(seconds=120))
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")  # a group is up: nothing
    with open(f"{out}/cases.pkl", "rb") as f:
        cases = pickle.load(f)
    results = {}
    for key, (fn, data, kwargs) in cases.items():
        trace = []
        got = getattr(mesh, fn)(data, mesh.Mesh(dist.group.WORLD, "cpu", trace), **kwargs)
        results[key] = (got, [(g.name, g.rows, g.sent) for g in trace])
    m = mesh.default_mesh(world, device="cpu")
    results["mesh"] = (m.rank, m.size, m.axis_name, str(m.device), str(m.collective_device))
    try:
        mesh.default_mesh(world + 1, device="cpu")
        results["n_devices_check"] = "accepted"
    except ValueError:
        results["n_devices_check"] = "raised"
    results["modules"] = sorted(
        n for n in sys.modules if n.split(".")[0] in ("jax", "snappy_tpu")
    )
    dist.barrier()
    dist.destroy_process_group()
    with open(f"{out}/rank_{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    """
)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_group(script: str, world: int, out: Path):
    """Start ``world`` ranks of ``script`` (argv: port, rank, world, out)
    from the root of the checkout, one thread each."""
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "HOME": str(out)}
    return [
        subprocess.Popen(
            [sys.executable, "-c", script, str(port), str(rank), str(world), str(out)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        )
        for rank in range(world)
    ]


def wait_group(procs, out: Path):
    """Each rank's pickled results; every rank is killed if one fails or
    outlives WAIT_S."""
    try:
        for rank, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=WAIT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} of {len(procs)} timed out")
            if p.returncode != 0:
                pytest.fail(f"rank {rank} of {len(procs)} failed:\n" + err.decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank in range(len(procs)):
        with open(out / f"rank_{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------

# (name, payload) for the encode cases: payloads.mixed_payload, and
# test_parallel._payload's half-repeated, half-random shape
ENCODE = [
    ("empty", 0, "mixed"), ("four", 4, "mixed"), ("one_frame", 65536, "mixed"),
    ("frame_plus_one", 65537, "mixed"), ("three_frames_tail", 3 * 65536 + 1000, "mixed"),
    ("half_random_500k", 500_000, "half"), ("half_random_700k", 700_000, "half"),
]
TPU_PATH = "three_frames_tail"  # the payload (at most 200 KB) also held against the JAX mesh's TPU path


def encode_payload(size: int, shape: str) -> bytes:
    return payloads.mixed_payload(size, seed=5) if shape == "mixed" else _payload(size, seed=5)


def _order_case() -> bytes:
    """Compressed, verbatim, compressed: chunk 0's body bytes 3-40 broken
    (K2 rejects it) and chunk 1's stored CRC flipped.  The JAX engine
    reports the earlier chunk (``invalid``); the JAX mesh checks every
    verbatim CRC first (``crc``)."""
    text = payloads.mixed_payload(3 * 65536, seed=11)
    rnd = payloads.Rand(12).bytes(65536).tobytes()
    s = bytearray(C.FRAMING_HEADER + payloads.data_chunk(text[:65536], True)
                  + payloads.data_chunk(rnd, False) + payloads.data_chunk(text[2 * 65536 :], True))
    ch = framing.scan_frames(bytes(s), len(C.FRAMING_HEADER))
    assert [c.id for c in ch] == [0, 1, 0]
    body = ch[0].data_pos + 4
    s[body + 3 : body + 41] = b"\xff" * 38
    s[ch[1].data_pos] ^= 0x55
    return bytes(s)


N_VECTORS = 22  # len(payloads.framed_vectors()), checked where they are built
DECODE = [
    "valid_1000", "valid_500000", "valid_700000", "bad_crc_byte14", "bad_crc_byte14_unchecked",
    "unknown_chunk", "truncated", "order_verbatim_crc_first", "order_verbatim_crc_first_unchecked",
] + [f"vector_{i}" for i in range(N_VECTORS)] + [f"framed_{name}" for name in FRAMED_CASES]
# where the JAX mesh's verdict differs from the JAX engine's
ORDER_CASES = ["order_verbatim_crc_first", "framed_invalid_then_ucrc"]


def decode_cases():
    """name -> (stream, check_integrity), in DECODE's order."""
    cases = {}
    for size, seed in ((1000, 1), (500_000, 2), (700_000, 3)):
        cases[f"valid_{size}"] = (jax_engine.framed_compress(_payload(size, seed), backend="host"), True)
    bad = bytearray(jax_engine.framed_compress(_payload(200_000, seed=3), backend="host"))
    bad[14] ^= 0xFF  # chunk 0's CRC (tests/test_parallel.py)
    cases["bad_crc_byte14"] = (bytes(bad), True)
    cases["bad_crc_byte14_unchecked"] = (bytes(bad), False)
    cases["unknown_chunk"] = (cases["valid_500000"][0] + payloads.frame(0x40, b"x"), True)
    cases["truncated"] = (cases["valid_700000"][0][:-7], True)
    cases["order_verbatim_crc_first"] = (_order_case(), True)
    cases["order_verbatim_crc_first_unchecked"] = (_order_case(), False)
    vectors = payloads.framed_vectors()
    assert len(vectors) == N_VECTORS
    for i, (_name, data, _budget, check_integrity, _expected) in enumerate(vectors):
        cases[f"vector_{i}"] = (data, check_integrity)
    for name in FRAMED_CASES:
        cases[f"framed_{name}"] = (framed_case(name)[1], True)
    assert list(cases) == DECODE
    return cases


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    assert len(devs) == 8, "tests/conftest.py sets up 8 CPU devices"
    return pmesh.default_mesh(len(devs))


@pytest.fixture(scope="module")
def decode_inputs():
    return decode_cases()


@pytest.fixture(scope="module")
def launched(tmp_path_factory, decode_inputs):
    """Every world's ranks started at once over the same cases."""
    cases = {}
    for name, size, shape in ENCODE:
        p = encode_payload(size, shape)
        cases["raw", name] = ("sharded_raw_compress", p, {})
        cases["framed", name] = ("sharded_framed_compress", p, {})
    for name, (stream, check_integrity) in decode_inputs.items():
        cases["decode", name] = ("sharded_framed_uncompress", stream, {"check_integrity": check_integrity})
    groups = {}
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"world{world}")
        with open(out / "cases.pkl", "wb") as f:
            pickle.dump(cases, f)
        groups[world] = (start_group(WORKER, world, out), out)
    return groups


@pytest.fixture(scope="module")
def expected(launched, decode_inputs, mesh8):
    """The JAX package's results, computed while the ranks run."""
    exp = {}
    for name, size, shape in ENCODE:
        p = encode_payload(size, shape)
        exp["raw", name] = jax_engine.raw_compress(p, backend="host")
        exp["framed", name] = jax_engine.framed_compress(p, backend="host")
        # each frame's encoded length, for the bytes the all-gathers send
        frames = [p[k : k + 65536] for k in range(0, len(p), 65536)]
        exp["totals", name] = [
            len(jax_engine.raw_compress(f, backend="host")) - len(varint.encode_uint32(len(f)))
            for f in frames
        ]
    for name, (stream, check_integrity) in decode_inputs.items():
        exp["decode", name] = pmesh.sharded_framed_uncompress(stream, mesh8, check_integrity)
    for name in ORDER_CASES:
        exp["engine", name] = jax_engine.framed_uncompress(decode_inputs[name][0], backend="device")
    p = encode_payload(*[(s, sh) for n, s, sh in ENCODE if n == TPU_PATH][0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SNAPPY_TPU_SCALAR_INTERPRET", "1")
        mp.setenv("SNAPPY_TPU_DEVICE_KERNEL", "scalar")
        assert jax_engine._use_scalar_kernels()
        exp["tpu_path", "raw"] = pmesh.sharded_raw_compress(p, mesh8)
        exp["tpu_path", "framed"] = pmesh.sharded_framed_compress(p, mesh8)
    return exp


@pytest.fixture(scope="module")
def results(launched, expected):
    """world -> each rank's results."""
    return {world: wait_group(procs, out) for world, (procs, out) in launched.items()}


# ---------------------------------------------------------------------------
# Against the JAX package, at world sizes 1, 3 and 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fmt", ["raw", "framed"])
@pytest.mark.parametrize("name", [n for n, _, _ in ENCODE])
def test_encode_bytes_equal_jax_package(results, expected, world, fmt, name):
    want = expected[fmt, name]
    for rank, res in enumerate(results[world]):
        assert res[fmt, name][0] == want, (world, rank)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fmt", ["raw", "framed"])
def test_encode_bytes_equal_jax_mesh_tpu_path(results, expected, world, fmt):
    assert expected["tpu_path", fmt] == expected[fmt, TPU_PATH]
    for res in results[world]:
        assert res[fmt, TPU_PATH][0] == expected["tpu_path", fmt]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", DECODE)
def test_decode_verdict_equals_jax_mesh(results, expected, world, name):
    want = expected["decode", name]
    for rank, res in enumerate(results[world]):
        assert res["decode", name][0] == want, (world, rank, res["decode", name][0][1], want[1])


@pytest.mark.parametrize("name", ORDER_CASES)
def test_error_order_follows_the_jax_mesh_not_the_engine(expected, name):
    # the JAX mesh checks every verbatim CRC before any compressed chunk;
    # the JAX engine reports the earliest bad chunk
    assert expected["decode", name] == (None, "crc")
    assert expected["engine", name] == (None, "invalid")


def test_ranks_see_one_mesh(results):
    for world in WORLDS:
        for rank, res in enumerate(results[world]):
            assert res["mesh"] == (rank, world, "blocks", "cpu", "cpu")
            assert res["n_devices_check"] == "raised"
            assert res["modules"] == [], "a rank imported jax or snappy_tpu"


# ---------------------------------------------------------------------------
# The shard split and the bytes each all-gather sends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "rows,size,shares",
    [(769, 4, [193, 192, 192, 192]), (3, 4, [1, 1, 1, 0]), (0, 3, [0, 0, 0]),
     (1, 1, [1]), (11, 3, [4, 4, 3]), (768, 8, [96] * 8)],
)
def test_shard_split_is_balanced(rows, size, shares):
    b = mesh.shard_bounds(rows, size)
    got = np.diff(b).tolist()
    assert got == shares and b[0] == 0 and b[-1] == rows
    assert got == [len(a) for a in np.array_split(np.arange(rows), size)]
    assert max(got) - min(got) <= 1


def _widths(per_row, world):
    """(rows of the largest share, bytes of the largest share's rows)."""
    b = mesh.shard_bounds(len(per_row), world)
    cum = np.concatenate([[0], np.cumsum(per_row)])
    return int(b[1] - b[0]), int((cum[b[1:]] - cum[b[:-1]]).max())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["four", "half_random_700k"])
def test_encode_gathers_send_per_chunk(results, expected, world, name):
    totals = expected["totals", name]
    rows, nbytes = _widths(totals, world)
    for fmt, names in (("raw", ["totals", "bytes"]), ("framed", ["totals", "crcs", "bytes"])):
        want = {"totals": 4 * rows, "crcs": 4 * rows, "bytes": nbytes}  # 4 B a frame
        for res in results[world]:
            assert res[fmt, name][1] == [(g, len(totals), want[g]) for g in names], fmt


@pytest.mark.parametrize("world", WORLDS)
def test_decode_gathers_send_per_chunk(results, decode_inputs, world):
    stream = decode_inputs["valid_700000"][0]
    chunks = framing.scan_frames(stream, len(C.FRAMING_HEADER))
    declared = [c.uncompressed_len for c in chunks if c.id == C.CHUNK_COMPRESSED]
    n_verbatim = sum(c.id == C.CHUNK_UNCOMPRESSED for c in chunks)
    assert declared and n_verbatim
    rows, nbytes = _widths(declared, world)
    v_rows = int(np.diff(mesh.shard_bounds(n_verbatim, world)).max())
    want = [("ok", len(declared), rows), ("crcs", len(declared), 4 * rows),
            ("verbatim_crcs", n_verbatim, 4 * v_rows), ("bytes", len(declared), nbytes)]
    for res in results[world]:
        assert res["decode", "valid_700000"][1] == want
    # a failed verdict is decided from the gathered flags: no bytes gathered
    for res in results[world]:
        assert [g[0] for g in res["decode", "bad_crc_byte14"][1]] == ["ok", "crcs", "verbatim_crcs"]


# ---------------------------------------------------------------------------
# In this process: one rank without a group, and the module's imports
# ---------------------------------------------------------------------------


def test_one_rank_without_a_group():
    m = mesh.default_mesh(device="cpu")
    assert (m.group, m.rank, m.size, m.axis_name) == (None, 0, 1, "blocks")
    trace = []
    m = mesh.Mesh(None, "cpu", trace)
    p = _payload(150_000, seed=7)
    framed = mesh.sharded_framed_compress(p, m)
    assert framed == jax_engine.framed_compress(p, backend="host")
    assert mesh.sharded_raw_compress(p, m) == jax_engine.raw_compress(p, backend="host")
    assert mesh.sharded_framed_uncompress(framed, m) == (p, "ok")
    assert trace == []  # no group, no collective


def test_default_mesh_checks_its_arguments(monkeypatch):
    with pytest.raises(ValueError):
        mesh.default_mesh(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        mesh.default_mesh()  # cuda:0 without a card: nothing falls back to the CPU


def test_parallel_modules_import_neither_jax_nor_the_jax_package():
    pkg = REPO / "snappy_tpu_torch" / "parallel"
    files = sorted(pkg.glob("*.py"))
    assert {f.name for f in files} == {"__init__.py", "mesh.py", "multihost.py"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "snappy_tpu"), (f.name, n)
