"""The flagship step and the dry run (snappy_tpu_torch/entry.py) against
__graft_entry__.py and the JAX package, on the CPU (exact).

The step on the array route (``SNAPPY_TPU_TORCH_DEVICE_KERNEL=xla``)
equals the JAX entry's step on its example arguments, element for
element; on the kernel route (the default) its CRCs equal the JAX ones
and each frame's bytes the JAX package's level-1 encode, at the example
shape, at 64 KiB frames and at 512-byte frames.  ``enc`` is the
encoder's own buffer, never a copy: K3's rows are ``max_comp(65536)``
bytes wide, so at 64 KiB frames the step returns all of them.
One spawn of 3
gloo ranks runs ``dryrun_multichip(3, device="cpu")``: its array-route
bytes equal the JAX mesh's on the 8-device CPU mesh of tests/conftest.py,
its kernel-route bytes the JAX package's.
"""

import ast
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import snappy_tpu  # noqa: E402
from snappy_tpu.formats import varint as jax_varint  # noqa: E402
from snappy_tpu.ops import crc32c_jax  # noqa: E402
from snappy_tpu.parallel import mesh as jax_mesh  # noqa: E402

from snappy_tpu_torch import engine, entry  # noqa: E402
from snappy_tpu_torch.formats import constants as C  # noqa: E402
from snappy_tpu_torch.ops import encode_blocks  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ROUTE = "SNAPPY_TPU_TORCH_DEVICE_KERNEL"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread here: the array route's many small tensor ops
    on a pool of threads per core crawl when other test workers hold the
    cores (as in tests/test_torch_cpp_differential.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_entry():
    """``__graft_entry__.entry()``'s step (jitted) and example arguments,
    with the JAX compile cache off."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SNAPPY_TPU_NO_COMPILE_CACHE", "1")
        sys.path.insert(0, str(REPO))
        try:
            import __graft_entry__
        finally:
            sys.path.remove(str(REPO))
        fn, args = __graft_entry__.entry()
    return jax.jit(fn), args


def full_width():
    """Three seeded 64 KiB frames and a 777-byte tail, zero-padded."""
    p = payloads.mixed_payload(3 * 65536 + 777, seed=5)
    return engine.split_frames(np.frombuffer(p, dtype=np.uint8), CPU)


def narrow():
    """Three seeded frames of 512, 512 and 300 bytes, zero-padded to 512."""
    p = payloads.mixed_payload(2 * 512 + 300, seed=6)
    rows = np.zeros((3, 512), dtype=np.uint8)
    for k in range(3):
        part = np.frombuffer(p[k * 512 : (k + 1) * 512], dtype=np.uint8)
        rows[k, : len(part)] = part
    return torch.from_numpy(rows), torch.tensor([512, 512, 300], dtype=torch.int32)


def run_step(route, monkeypatch, frames, flens):
    if route == "xla":
        monkeypatch.setenv(ROUTE, "xla")
    else:
        monkeypatch.delenv(ROUTE, raising=False)
    crcs, enc, totals = entry.step(frames, flens)
    b = frames.shape[1]
    width = b + b // 6 + 64
    assert crcs.dtype == torch.uint32 and totals.dtype == torch.int32 and enc.dtype == torch.uint8
    assert enc.shape == (len(flens), width) and crcs.device == enc.device == totals.device == CPU
    # the encoder's own buffer: K3's rows (the whole of them at B = 65536)
    # or the array encoder's of the step's width, and no copy
    base = width if route == "xla" else encode_blocks.ENC_CAP
    assert enc.untyped_storage().nbytes() == len(flens) * base
    assert enc.is_contiguous() == (base == width)
    return crcs.numpy(), enc.numpy(), totals.numpy()


def test_array_route_equals_the_jax_entry(jax_entry, monkeypatch):
    jfn, jargs = jax_entry
    fn, args = entry.entry("cpu")
    assert fn is entry.step
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))
    assert np.array_equal(args[1].numpy(), np.asarray(jargs[1]))
    want = [np.asarray(x) for x in jfn(*jargs)]
    got = run_step("xla", monkeypatch, *args)
    for g, w in zip(got, want):  # crcs, enc (the bytes past totals too), totals
        assert g.shape == w.shape and np.array_equal(g, w.astype(g.dtype))


@pytest.mark.parametrize("shape", ["example", "full_width", "narrow"])
def test_kernel_route_equals_the_jax_package(shape, jax_entry, monkeypatch):
    """K1's CRCs equal the JAX ones, and K3's bytes of each frame equal
    ``snappy_tpu.encode`` of it (host C, level 1) without its varint, at
    frames of 4096 (the example), 65536 and 512 bytes."""
    if shape == "example":
        jfn, jargs = jax_entry
        frames, flens = entry.entry("cpu")[1]
        want_crcs = np.asarray(jfn(*jargs)[0])
    else:
        frames, flens = full_width() if shape == "full_width" else narrow()
        f32 = jnp.asarray(frames.numpy().astype(np.int32))
        want_crcs = np.asarray(crc32c_jax.masked_crc32c_chunks(f32, jnp.asarray(flens.numpy()),
                                                               frames.shape[1]))
    crcs, enc, totals = run_step("scalar", monkeypatch, frames, flens)
    assert np.array_equal(crcs, want_crcs.astype(np.uint32))
    for i, n in enumerate(flens.tolist()):
        raw = snappy_tpu.encode(frames[i, :n].numpy().tobytes())
        _, skip = jax_varint.decode_uint32(raw)
        assert enc[i, : totals[i]].tobytes() == raw[skip:], (shape, i)


@pytest.mark.parametrize("b", [1, 512, 4096, 65535, 65536])
def test_k3_rows_hold_the_step_width(b):
    """K3's rows are the step's width at 64 KiB frames and wider below, and
    the step's width holds the format's worst case with 16 bytes to spare."""
    assert encode_blocks.ENC_CAP == entry.max_comp(65536)
    assert C.max_compressed_len(b) + 16 <= entry.max_comp(b) <= encode_blocks.ENC_CAP


def test_step_refuses_frames_over_64_kib():
    with pytest.raises(ValueError):
        entry.step(torch.zeros((1, 65537), dtype=torch.uint8), torch.ones(1, dtype=torch.int32))


def test_entry_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        entry.entry()  # cuda without a card: nothing falls back to the CPU
    with pytest.raises(RuntimeError):
        entry.dryrun_multichip(1)


def test_dry_run_on_one_rank_without_a_group(capsys, monkeypatch):
    monkeypatch.setenv(ROUTE, "scalar")
    res = entry.dryrun_multichip(1, device="cpu")
    assert os.environ[ROUTE] == "scalar"  # restored after the array leg
    payload = entry.dryrun_payload(1)
    assert capsys.readouterr().out.strip() == res["line"]
    assert res["first_leg"]["framed"] == snappy_tpu.encode_framed(payload)
    assert res["per_shard"] == [1] and res["array_leg"]["input"] == len(payload) == 21_000


@pytest.fixture(scope="module")
def dry_run():
    """``dryrun_multichip(3, device="cpu")``: one spawn of 3 gloo ranks,
    each on one thread."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return entry.dryrun_multichip(3, device="cpu")


def test_dry_run_numbers(dry_run):
    payload = entry.dryrun_payload(3)
    assert len(payload) == dry_run["payload"] == 3 * 21_000
    assert dry_run["n_devices"] == 3 and dry_run["device"] == "cpu"
    assert dry_run["framed"] == len(dry_run["first_leg"]["framed"])
    assert dry_run["raw"] == len(dry_run["first_leg"]["raw"])
    assert dry_run["per_shard"] == [1, 0, 0] and dry_run["balance"] == 1.0 and dry_run["calls"] == 1
    assert dry_run["line"].startswith("dryrun_multichip OK on 3 devices (63000 B -> framed ")
    assert dry_run["array_leg"]["input"] == len(payload)  # under 3 * 65536 + 1234


def test_dry_run_payload_is_the_jax_entrys():
    """The payload rebuilt as __graft_entry__.py:76-85 builds it."""
    rng = np.random.default_rng(1)
    parts = []
    for k in range(4):
        word = rng.integers(0, 256, 11 + k, dtype=np.uint8).tobytes()
        parts += [(word * 2000)[:20_000], rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()]
    assert entry.dryrun_payload(4) == b"".join(parts)


def test_dry_run_kernel_route_equals_the_jax_package(dry_run):
    payload = entry.dryrun_payload(3)
    assert dry_run["first_leg"]["route"] == "scalar"
    assert dry_run["first_leg"]["framed"] == snappy_tpu.encode_framed(payload)
    assert dry_run["first_leg"]["raw"] == snappy_tpu.encode(payload)
    assert dry_run["array_leg"]["framed"] != dry_run["first_leg"]["framed"]  # the array encoder's bytes differ


def test_dry_run_array_leg_equals_the_jax_mesh(dry_run, monkeypatch):
    """The JAX mesh on its default route off a TPU, the array route."""
    monkeypatch.delenv("SNAPPY_TPU_SCALAR_INTERPRET", raising=False)
    monkeypatch.delenv("SNAPPY_TPU_DEVICE_KERNEL", raising=False)
    small = entry.dryrun_payload(3)[: dry_run["array_leg"]["input"]]
    m = jax_mesh.default_mesh(3)
    assert dry_run["array_leg"]["framed"] == jax_mesh.sharded_framed_compress(small, m)
    assert dry_run["array_leg"]["raw"] == jax_mesh.sharded_raw_compress(small, m)


def test_entry_imports_neither_jax_nor_the_jax_package():
    src = REPO / "snappy_tpu_torch" / "entry.py"
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "snappy_tpu"), n
