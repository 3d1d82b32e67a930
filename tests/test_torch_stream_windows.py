"""The window route of the port's streaming raw decoder (kernel K4) against
the sequential walk and the JAX package.

The window route decodes one 64 KiB output window per CTA from the host's
block index (decode_stream.window_index, the native scan), then decodes in
order, in one CTA, every window whose copies reach an earlier window.  Its
CUDA source compiled by g++ (the twin, stpu_twin_decode_stream_windows)
runs both passes from the same window code as the card and is held against
the plain version (the sequential walk, _decode_stream_plain): status and
out[:written], exact.  The plain version is held against the TPU kernel in
grid mode, run through the Pallas interpreter at one padded shape.  The
cases are payloads.window_cases and payloads.stream_cases (chip_smoke.py
runs the same ones on the card).
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from snappy_tpu.ops import decode_stream as jax_stream  # noqa: E402

from snappy_tpu_torch import telemetry  # noqa: E402
from snappy_tpu_torch.ops import _build, decode_stream  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

WINDOW_CASES = payloads.window_cases()
STREAM_CASES = payloads.stream_cases()
# window_cases: 3 block-encoded streams, the deferred case, the chain, ten
# mutants and the straddling literal
BLOCK, DEFERRED, CHAIN, MUTANTS, STRADDLE = range(3), 3, 4, range(5, 15), 15


def tensor(body: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(body, dtype=np.uint8).copy())


def run_plain(body: bytes, m: int):
    out = torch.zeros(max(m, 1), dtype=torch.uint8)
    status = decode_stream._decode_stream_plain(tensor(body), m, out)
    ok, written, consumed = status.tolist()
    return (ok, written, consumed), out[:written].numpy().tobytes()


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the CPU twin")
    return _build.twin_lib()


def run_windows_twin(twin, body: bytes, m: int, in_offs: np.ndarray, passes: int = 3):
    """((ok, written, consumed), out[:written], windows pass 2 decoded), of
    both passes (or of pass 1 and then pass 2, ``passes=(1, 2)``)."""
    src = np.frombuffer(body, dtype=np.uint8).copy()
    offs = np.ascontiguousarray(in_offs, dtype=np.int64)
    nwin = len(offs) - 1
    out = np.full(m, 0xAA, dtype=np.uint8)
    status = np.zeros(4, dtype=np.int64)
    rec = np.zeros(3 * nwin, dtype=np.int64)
    for p in (passes if isinstance(passes, tuple) else (passes,)):
        assert twin.stpu_twin_decode_stream_windows(
            src.ctypes.data, len(body), m, offs.ctypes.data, nwin, out.ctypes.data,
            status.ctypes.data, rec.ctypes.data, p,
        ) == 0
    st = tuple(int(x) for x in status)
    return st[:3], out[: st[1]].tobytes(), st[3]


def run_route_twin(twin, body: bytes, m: int):
    """The route decode_raw_stream_bytes takes in grid mode, by the twin:
    the window route where the index builds, else the whole-stream walk.
    Returns (status, bytes, windows pass 2 decoded or None on the walk)."""
    offs = decode_stream.window_index(body, m) if m > 0 else None
    if offs is not None:
        return run_windows_twin(twin, body, m, offs.numpy())
    src = np.frombuffer(body, dtype=np.uint8).copy() if body else np.zeros(1, np.uint8)
    out = np.full(max(m, 1), 0xAA, dtype=np.uint8)
    status = np.zeros(3, dtype=np.int64)
    assert twin.stpu_twin_decode_stream(src.ctypes.data, len(body), m, out.ctypes.data,
                                        status.ctypes.data) == 0
    return tuple(int(x) for x in status), out[: status[1]].tobytes(), None


@pytest.mark.parametrize("k", range(len(WINDOW_CASES)))
def test_window_route_twin_matches_plain(twin, k):
    body, m, payload = WINDOW_CASES[k]
    status, got, _ = run_route_twin(twin, body, m)
    assert (status, got) == run_plain(body, m)
    if payload is not None:
        assert status == (1, m, len(body)) and got == payload


@pytest.mark.parametrize("k", range(len(STREAM_CASES)))
def test_route_twin_matches_plain_on_stream_cases(twin, k):
    body, m, payload = STREAM_CASES[k]
    status, got, _ = run_route_twin(twin, body, m)
    assert (status, got) == run_plain(body, m)
    if payload is not None:
        assert status == (1, m, len(body)) and got == payload


def test_routes_and_windows_decoded_again(twin):
    redecoded = {k: run_route_twin(twin, b, m)[2] for k, (b, m, _) in enumerate(WINDOW_CASES)}
    for k in BLOCK:
        assert redecoded[k] == 0, k
    assert redecoded[DEFERRED] == 1
    assert redecoded[CHAIN] == 3
    assert redecoded[STRADDLE] is None  # no index: the walk
    assert all(redecoded[k] is not None for k in MUTANTS)
    assert any(redecoded[k] for k in MUTANTS) and not all(redecoded[k] for k in MUTANTS)
    # the block-encoded stream cases take the window route with nothing deferred
    routed = [run_route_twin(twin, b, m)[2] for b, m, p in STREAM_CASES[:6]]
    assert routed[:2] == [0, 0], routed


@pytest.mark.parametrize("k", MUTANTS)
def test_mutants_fail_after_the_first_window_with_the_plain_verdict(twin, k):
    body, m, _ = WINDOW_CASES[k]
    (ok, written, consumed), _ = run_plain(body, m)
    assert decode_stream.window_index(body, m) is not None
    assert not ok and written >= payloads.FRAME and consumed < len(body)


def test_every_window_of_a_stream_on_one_index_is_decoded_in_pass_2(twin):
    """Pass 2 alone gives the result: each window made deferred by a copy
    at its start that reaches the window before."""
    w = payloads.Rand(59).bytes(4 * payloads.FRAME).tobytes()
    ops = [w[: payloads.FRAME]]
    for k in range(1, 4):
        ops += [(payloads.FRAME, 64), w[k * payloads.FRAME + 64 : (k + 1) * payloads.FRAME]]
    body, p = payloads.ops_stream(ops)
    status, got, redecoded = run_route_twin(twin, body, len(p))
    assert status == (1, len(p), len(body)) and got == p and redecoded == 3


@pytest.mark.parametrize("k", [DEFERRED, CHAIN, MUTANTS[0]])
def test_passes_one_at_a_time_give_both_passes(twin, k):
    body, m, _ = WINDOW_CASES[k]
    offs = decode_stream.window_index(body, m).numpy()
    assert run_windows_twin(twin, body, m, offs, (1, 2)) == run_windows_twin(twin, body, m, offs)


def test_wrong_index_is_memory_safe_and_not_ok(twin):
    body, m, _ = WINDOW_CASES[0]
    offs = decode_stream.window_index(body, m).numpy().copy()
    for bad in (offs + 1, np.full_like(offs, len(body) + 7), np.full_like(offs, -3), offs[::-1].copy()):
        status, _, _ = run_windows_twin(twin, body, m, bad)
        assert status[0] == 0, bad


@pytest.fixture(scope="module")
def jax_grid():
    """decode_raw_stream_grid at one padded shape for every window case, so
    the interpreter compiles once."""
    shapes = [jax_stream._grid_shapes(len(b), m) for b, m, _ in WINDOW_CASES]
    words, windows, steps = (max(s[i] for s in shapes) for i in range(3))

    def run(body: bytes, m: int):
        buf = np.zeros(words * 4, dtype=np.uint8)
        buf[: len(body)] = np.frombuffer(body, dtype=np.uint8)
        out, st = jax_stream.decode_raw_stream_grid(
            jnp.asarray(buf.view(np.int32)), jnp.int32(len(body)), jnp.int32(m), windows, steps, True
        )
        st = np.asarray(st).reshape(-1)
        return (int(st[0]), int(st[3]), int(st[4])), np.asarray(out).view(np.uint8)[: int(st[3])].tobytes()

    return run


@pytest.mark.parametrize("k", range(len(WINDOW_CASES)))
def test_plain_matches_tpu_grid_kernel_interpreted(jax_grid, k):
    body, m, payload = WINDOW_CASES[k]
    (ok, written, consumed), got = run_plain(body, m)
    (jok, jwritten, jconsumed), jgot = jax_grid(body, m)
    assert ok == jok
    assert (written, consumed) == (jwritten, jconsumed)
    if ok:
        assert got == jgot and got == payload


def test_wrapper_takes_in_offs_and_refuses_a_wrong_count():
    body, m, payload = WINDOW_CASES[DEFERRED]
    offs = decode_stream.window_index(body, m)
    assert offs is not None and offs.shape[0] == decode_stream.window_count(m) + 1
    out = torch.zeros(m, dtype=torch.uint8)
    status = torch.full((4,), 9, dtype=torch.int64)
    got = decode_stream.decode_stream(tensor(body), m, out, in_offs=offs, status=status)
    assert got.tolist() == [1, m, len(body)] and out.numpy().tobytes() == payload
    assert int(status[3]) == 0  # the plain version decodes nothing twice
    for wrong in (offs[:-1], torch.cat([offs, offs[-1:]])):
        with pytest.raises(ValueError):
            decode_stream.decode_stream(tensor(body), m, out, in_offs=wrong)
    with pytest.raises(TypeError):
        decode_stream.decode_stream(tensor(body), m, out, in_offs=offs.to(torch.int32))
    with pytest.raises(ValueError):
        decode_stream.decode_stream(tensor(b""), 0, torch.zeros(1, dtype=torch.uint8),
                                    in_offs=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError):
        decode_stream.decode_stream(tensor(body), m, out, in_offs=offs, status=torch.zeros(3, dtype=torch.int64))


def test_window_index_finds_the_route():
    for k, (body, m, _) in enumerate(WINDOW_CASES):
        offs = decode_stream.window_index(body, m)
        assert (offs is None) == (k == STRADDLE), k
        if offs is not None:
            assert offs[0] == 0 and offs[-1] == len(body) and bool((offs[1:] >= offs[:-1]).all())


@pytest.mark.parametrize("k", [*BLOCK, DEFERRED, CHAIN, MUTANTS[0], STRADDLE])
def test_decode_raw_stream_bytes_on_the_cpu(k):
    body, m, payload = WINDOW_CASES[k]
    counters = ("k4.launches", "k4.launches_windows", "k4.launches_walk", "k4.redecoded")
    before = [telemetry.counter(c) for c in counters]
    got, reason = decode_stream.decode_raw_stream_bytes(body, m, mode="grid", device="cpu")
    if payload is None:
        assert (got, reason) == (None, "invalid")
    else:
        assert (got, reason) == (payload, "ok")
    after = [telemetry.counter(c) for c in counters]
    assert after == before  # nothing launched, nothing decoded twice on the CPU
