"""The legs of tests/test_completeness.py and tests/test_fuzz.py that the
other port test files do not hold, each run on both packages on the same
input, the port on ``device="cpu"`` (the kernels' plain versions):
concatenated framed streams on both backends, the raw device round trip at
the JAX engine's bucket seams (both device routes), the CLI's exit code on
a malformed ``.sz``, ``compress_framed_into`` on the device backend, and
the hypothesis round trip and arbitrary-input decoder differential at the
JAX suite's budget.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st  # noqa: E402

import snappy_tpu  # noqa: E402
from snappy_tpu import engine as jax_engine  # noqa: E402
from snappy_tpu.testing import oracle  # noqa: E402

from snappy_tpu_torch import api, config, engine  # noqa: E402
from snappy_tpu_torch.formats import constants as C  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"

# tests/test_fuzz.py:28-32: the JAX suite's budget and its payloads
SETTINGS = dict(
    max_examples=int(os.environ.get("SNAPPY_TPU_FUZZ_EXAMPLES", "30")),
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large,
                           HealthCheck.function_scoped_fixture],
)
PAYLOADS = st.one_of(
    st.binary(min_size=0, max_size=4096),
    st.tuples(st.binary(min_size=1, max_size=24), st.integers(1, 400)).map(
        lambda t: (t[0] * t[1])[:8000]
    ),
)

CONCAT = {
    "two": [b"first stream " * 100, b"second stream " * 200],
    "three_empty_middle": [b"x" * 70000, b"", b"tail" * 10],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread here: the array route's many small tensor ops
    on a pool of threads per core crawl when other test workers hold the
    cores (as in tests/test_torch_cpp_differential.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def device_backend(monkeypatch):
    """The port on its device backend and kernel route, whatever the
    environment says; the JAX device route off a TPU (the array route)."""
    monkeypatch.setattr(config, "_backend", "device")
    monkeypatch.delenv("SNAPPY_TPU_TORCH_DEVICE_KERNEL", raising=False)
    monkeypatch.delenv("SNAPPY_TPU_SCALAR_INTERPRET", raising=False)
    monkeypatch.delenv("SNAPPY_TPU_DEVICE_KERNEL", raising=False)


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("case", sorted(CONCAT))
def test_framed_streams_concatenate(case, backend):
    """Framed streams concatenate: the extra stream identifiers are
    skippable chunks (framing_format.txt:74-78)."""
    parts = CONCAT[case]
    enc = b"".join(engine.framed_compress(p, device=CPU, backend=backend) for p in parts)
    assert enc == b"".join(snappy_tpu.encode_framed(p) for p in parts)
    want = jax_engine.framed_uncompress(enc, backend=backend)
    assert want == (b"".join(parts), "ok")
    assert engine.framed_uncompress(enc, device=CPU, backend=backend) == want
    assert api.uncompressed_len_framed(enc) == snappy_tpu.uncompressed_len_framed(enc) == len(want[0])


@pytest.mark.parametrize("route", ["scalar", "xla"])
@pytest.mark.parametrize("n", [4095, 4096, 4097, 8192, 12289])
def test_device_round_trip_at_the_bucket_seams(n, route, monkeypatch):
    """tests/test_completeness.py:33-42's payloads.  The kernel route's
    stream is the JAX host C's, the array route's the JAX device
    backend's; each package decodes the other's."""
    rng = random.Random(n)
    payload = bytes(rng.getrandbits(8) for _ in range(n // 2))
    payload += (b"seam " * n)[: n - len(payload)]
    if route == "xla":
        monkeypatch.setenv("SNAPPY_TPU_TORCH_DEVICE_KERNEL", "xla")
    ours = engine.raw_compress(payload, device=CPU, backend="device")
    theirs = jax_engine.raw_compress(payload, backend="device" if route == "xla" else "host")
    assert ours == theirs
    assert engine.raw_uncompress(ours, device=CPU, backend="device") == (payload, "ok")
    assert jax_engine.raw_uncompress(ours, backend="device") == (payload, "ok")


MALFORMED = {
    "truncated_chunk": C.FRAMING_HEADER + b"\x00\x10\x00\x00garbage!",  # test_completeness.py:127
    "unknown_chunk": C.FRAMING_HEADER + b"\x02\x04\x00\x00abcd",
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_cli_rejects_a_malformed_sz(name, tmp_path):
    """``-d`` on a malformed ``.sz`` exits 1 from both command lines."""
    bad = tmp_path / "bad.sz"
    bad.write_bytes(MALFORMED[name])
    env = {"JAX_PLATFORMS": "cpu", "PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": str(tmp_path)}
    rcs = []
    for cmd in (["-m", "snappy_tpu_torch.cli", "-d", "--device", "cpu"], ["-m", "snappy_tpu.cli", "-d"]):
        proc = subprocess.run([sys.executable] + cmd + [str(bad)], capture_output=True, cwd=REPO,
                              env=env, timeout=300)
        rcs.append(proc.returncode)
    assert rcs == [1, 1], rcs
    assert not (tmp_path / "bad").exists()


@pytest.mark.parametrize("n_frames", [1, 2, 3])
def test_compress_framed_into_equals_encode_framed(n_frames):
    n = n_frames * C.MAX_BLOCK_LEN - 11
    payload = (b"span boundary " * (n // 14 + 1))[:n]
    want = jax_engine.framed_compress(payload, backend="host")
    buf = bytearray(C.max_compressed_len_framed(n))
    res = api.compress_framed_into(payload, buf, device=CPU)
    assert res.is_ok()
    assert bytes(buf[: res.unwrap()]) == api.encode_framed(payload, device=CPU) == want


@given(PAYLOADS)
@settings(**SETTINGS)
def test_round_trip_fuzz(payload):
    """tests/test_fuzz.py:43-66 on the port: its raw and framed bytes equal
    the JAX package's (level 1), decode back, and the oracle decodes the
    raw stream."""
    enc = api.encode(payload, device=CPU)
    assert enc == snappy_tpu.encode(payload)
    assert api.decode(enc, device=CPU) == payload
    assert oracle.uncompress(enc) == (payload, None)
    framed = api.encode_framed(payload, device=CPU)
    assert framed == snappy_tpu.encode_framed(payload)
    once = api.decode_framed(framed, device=CPU)
    assert once == payload == api.decode_framed(api.encode_framed(once, device=CPU), device=CPU)


@given(st.binary(min_size=0, max_size=300))
@settings(**SETTINGS)
def test_arbitrary_input_differential(data):
    """tests/test_fuzz.py:69-78: the port, the JAX package and the oracle
    accept and reject alike, with the same bytes."""
    ref, ref_err = oracle.uncompress(data)
    got = api.decode(data, device=CPU)
    assert got == snappy_tpu.decode(data)
    assert got == (ref if ref_err is None else b"")
