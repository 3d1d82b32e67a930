"""The port's streaming raw decoder (kernel K4) against the JAX package.

The plain version is held against the TPU kernel in grid mode, run through
the Pallas interpreter (decode_stream.decode_raw_stream_bytes with
interpret=True, mode="grid"): the same verdict, and on a valid stream the
same bytes.  The CUDA kernel's source compiled by g++ (the twin) runs the
same window and pending-segment code as the card and is held against the
plain version: verdict, written, consumed and bytes, all exact.  The cases
are payloads.stream_cases (chip_smoke.py runs the same ones on the card).
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snappy_tpu.ops import decode_stream as jax_stream  # noqa: E402

from snappy_tpu_torch.ops import _build, decode_stream  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402
from snappy_tpu_torch.testing.payloads import copy2, literal  # noqa: E402


CASES = payloads.stream_cases()


def run_plain(body: bytes, m: int):
    comp = torch.from_numpy(np.frombuffer(body, dtype=np.uint8).copy())
    out = torch.zeros(m, dtype=torch.uint8)
    status = decode_stream.decode_stream(comp, m, out)
    ok, written, consumed = status.tolist()
    return (ok, written, consumed), out[:written].numpy().tobytes()


@pytest.mark.parametrize("k", range(len(CASES)))
def test_plain_matches_tpu_grid_kernel_interpreted(k):
    body, m, payload = CASES[k]
    want, reason = jax_stream.decode_raw_stream_bytes(body, m, interpret=True, mode="grid")
    (ok, written, consumed), got = run_plain(body, m)
    assert bool(ok) == (reason == "ok"), reason
    if ok:
        assert got == want and written == m and consumed == len(body)
    if payload is not None:
        assert ok and got == payload


def test_plain_reports_written_and_consumed_at_the_first_bad_tag():
    head = b"0123456789"
    body = literal(head) + copy2(4, 6) + copy2(20, 4) + literal(b"zz")
    (ok, written, consumed), got = run_plain(body, 30)
    assert (ok, written, consumed) == (0, 16, len(literal(head)) + 3)
    assert got == head + b"678967"


def test_wrapper_rejects_bad_inputs():
    comp = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(TypeError):
        decode_stream.decode_stream(comp.to(torch.int32), 4, torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(TypeError):
        decode_stream.decode_stream(comp, 4, torch.zeros((2, 2), dtype=torch.uint8))
    with pytest.raises(ValueError):
        decode_stream.decode_stream(comp, 5, torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        decode_stream.decode_stream(comp, -1, torch.zeros(4, dtype=torch.uint8))


def test_counts_no_launch_on_the_cpu():
    before = decode_stream.LAUNCHES
    run_plain(CASES[0][0], CASES[0][1])
    assert decode_stream.LAUNCHES == before


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the CPU twin")
    return _build.twin_lib()


def run_twin(twin, body: bytes, m: int):
    src = np.frombuffer(body, dtype=np.uint8).copy() if body else np.zeros(1, np.uint8)
    out = np.full(max(m, 1), 0xAA, dtype=np.uint8)
    status = np.zeros(3, dtype=np.int64)
    assert twin.stpu_twin_decode_stream(src.ctypes.data, len(body), m, out.ctypes.data, status.ctypes.data) == 0
    return tuple(int(x) for x in status), out[: status[1]].tobytes()


@pytest.mark.parametrize("k", range(len(CASES)))
def test_twin_matches_plain(twin, k):
    body, m, payload = CASES[k]
    status, got = run_twin(twin, body, m)
    assert (status, got) == run_plain(body, m)
    if payload is not None:
        assert status == (1, m, len(body)) and got == payload


def test_twin_matches_plain_on_edge_cases(twin):
    extra = [(b"", 0), (b"", 5), (literal(b"ab"), 0), (b"\x00", 1)]
    for body, m in extra + payloads.malformed_chunks():
        assert run_twin(twin, body, m) == run_plain(body, m), (body, m)
