"""The port's scan-mode streaming decoder (kernel K5) against the JAX package.

The plain version is held against the TPU kernel's scan
(``snappy_tpu.ops.decode_stream.decode_raw_stream`` with interpret=True,
what ``decode_raw_stream_bytes(mode="scan")`` runs): the same status
(ok, err, unsupported, written, consumed), the same window length at
every step and the same window bytes.  Each stream is zero-padded to one
buffer shape and run at its own step count (4 or 16 here), so the Pallas
interpreter compiles twice for the whole file.  The CUDA kernel's source
compiled by g++ (the twin) runs the route without a window index, pass 2
alone walking every step with the card's scan step, and is held against
the plain version, state and bytes, exactly (the window route:
test_torch_stream_scan_windows.py).  The engine's route
(scan mode, then K4 on ``unsupported``) is checked by which decoder each
call reaches.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snappy_tpu.ops import decode_stream as jax_stream  # noqa: E402

from snappy_tpu_torch import api, engine, telemetry  # noqa: E402
from snappy_tpu_torch.formats import varint  # noqa: E402
from snappy_tpu_torch.ops import _build, decode_stream  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402


CASES = (
    [(b, m, p) for b, m, p in payloads.stream_cases()]
    + payloads.scan_edge_cases()
    + payloads.scan_differential_cases()
)
PAD_WORDS = max(-(-len(b) // 4) for b, _, _ in CASES) + jax_stream.SC_WORDS + 1024 + 8


def scan_windows(out: bytes, writtens):
    """The JAX function's per-step windows (``windows[k, :writtens[k]]``)
    from the port's flat output and step lengths."""
    ends = np.cumsum(np.asarray(writtens, dtype=np.int64))
    return [out[int(e - w) : int(e)] for e, w in zip(ends, writtens)]


def run_plain(body: bytes, m: int):
    comp = torch.from_numpy(np.frombuffer(body, dtype=np.uint8).copy())
    out = torch.zeros(max(m, 1), dtype=torch.uint8)
    state, writtens = decode_stream.decode_stream_scan(comp, m, out)
    return state.numpy(), writtens.numpy(), out.numpy()


def run_jax(body: bytes, m: int):
    buf = np.zeros(PAD_WORDS * 4, dtype=np.uint8)
    buf[: len(body)] = np.frombuffer(body, dtype=np.uint8)
    steps = decode_stream.n_steps(len(body), m)
    assert steps == jax_stream._n_steps(len(body), m)
    windows, writtens, status = jax_stream.decode_raw_stream(
        buf.view(np.int32), np.int32(len(body)), np.int32(m), steps, True
    )
    win = np.ascontiguousarray(np.asarray(windows)).view(np.uint8)
    writtens = np.asarray(writtens)
    return [int(x) for x in np.asarray(status)], writtens, [win[k, : writtens[k]].tobytes() for k in range(steps)]


@pytest.mark.parametrize("k", range(len(CASES)))
def test_plain_matches_tpu_scan_kernel_interpreted(k):
    body, m, payload = CASES[k]
    want_status, want_writtens, want_windows = run_jax(body, m)
    state, writtens, out = run_plain(body, m)
    status = list(decode_stream.scan_status(state, len(body), m))
    assert status == want_status
    assert writtens.tolist() == want_writtens.tolist()
    windows = scan_windows(out.tobytes(), writtens)
    if not status[2]:  # an unsupported copy's bytes come from clipped TPU reads
        assert windows == want_windows
    if payload is not None and status[0]:
        assert out.tobytes()[:m] == payload


def test_cases_cover_every_verdict():
    verdicts = []
    for body, m, _ in CASES:
        state, _, _ = run_plain(body, m)
        ok, _, unsup, _, _ = decode_stream.scan_status(state, len(body), m)
        verdicts.append("ok" if ok else "unsupported" if unsup else "invalid")
    assert {"ok", "invalid", "unsupported"} <= set(verdicts)
    # the history limit: 64 KiB is in reach, one byte more is not
    edge = verdicts[len(payloads.stream_cases()) : len(payloads.stream_cases()) + 6]
    assert edge == ["ok", "unsupported"] * 3


def test_decode_raw_stream_bytes_matches_jax():
    """The JAX function itself, on the split copy beyond the history
    (test_scalar_kernels.py:136-176): scan says unsupported, grid serves it."""
    body, m, payload = payloads.scan_differential_cases()[-1]
    want = jax_stream.decode_raw_stream_bytes(body, m, interpret=True, mode="scan")
    assert want == (None, "unsupported")
    assert decode_stream.decode_raw_stream_bytes(body, m, mode="scan", device="cpu") == want
    assert decode_stream.decode_raw_stream_bytes(body, m, mode="grid", device="cpu") == (payload, "ok")


def test_mode_from_the_environment(monkeypatch):
    body, m, payload = payloads.scan_edge_cases()[1]
    monkeypatch.setenv("SNAPPY_TPU_TORCH_STREAM_MODE", "scan")
    assert decode_stream.decode_raw_stream_bytes(body, m, device="cpu") == (None, "unsupported")
    monkeypatch.setenv("SNAPPY_TPU_TORCH_STREAM_MODE", "grid")
    assert decode_stream.decode_raw_stream_bytes(body, m, device="cpu") == (payload, "ok")
    monkeypatch.delenv("SNAPPY_TPU_TORCH_STREAM_MODE")
    assert decode_stream.decode_raw_stream_bytes(body, m, device="cpu") == (payload, "ok")
    monkeypatch.setenv("SNAPPY_TPU_TORCH_STREAM_MODE", "warp")
    with pytest.raises(ValueError):
        decode_stream.decode_raw_stream_bytes(body, m, device="cpu")


def test_the_jax_variable_alone_leaves_grid_mode(monkeypatch, spies):
    """The JAX package's stream-mode variable names its own mode, not the
    port's: with it set to scan alone, the port decodes in grid mode (K4),
    where scan mode would say unsupported."""
    body, m, payload = payloads.scan_edge_cases()[1]
    monkeypatch.delenv("SNAPPY_TPU_TORCH_STREAM_MODE", raising=False)
    jax_variable = "SNAPPY_TPU_TORCH_STREAM_MODE".replace("TORCH_", "")  # the JAX package's name
    monkeypatch.setenv(jax_variable, "scan")
    assert decode_stream.decode_raw_stream_bytes(body, m, device="cpu") == (payload, "ok")
    assert engine.raw_uncompress(varint.encode_uint32(m) + body, device="cpu") == (payload, "ok")
    assert spies == ["decode_stream", "decode_stream"]


def test_zero_declared_takes_scan_mode_in_either():
    for mode in ("grid", "scan"):
        want = jax_stream.decode_raw_stream_bytes(b"", 0, interpret=True, mode=mode)
        assert decode_stream.decode_raw_stream_bytes(b"", 0, mode=mode, device="cpu") == want


@pytest.fixture
def spies(monkeypatch):
    """Calls that reach each streaming decoder's wrapper."""
    calls = []
    for name in ("decode_stream", "decode_stream_scan"):
        real = getattr(decode_stream, name)

        def spy(*args, _real=real, _name=name):
            calls.append(_name)
            return _real(*args)

        monkeypatch.setattr(decode_stream, name, spy)
    return calls


@pytest.mark.parametrize("mode, k, route, reason", [
    ("scan", 1, ["decode_stream_scan", "decode_stream"], "ok"),  # unsupported -> K4
    ("scan", 0, ["decode_stream_scan"], "ok"),
    ("grid", 1, ["decode_stream"], "ok"),
    ("scan", -1, ["decode_stream_scan"], "invalid"),
])
def test_engine_route(monkeypatch, spies, mode, k, route, reason):
    if k >= 0:
        body, m, payload = payloads.scan_edge_cases()[k]
    else:  # a truncated stream
        body, m, _ = payloads.scan_edge_cases()[0]
        body, payload = body[:-3], None
    monkeypatch.setenv("SNAPPY_TPU_TORCH_STREAM_MODE", mode)
    stream = varint.encode_uint32(m) + body
    assert engine.raw_uncompress(stream, device="cpu") == (payload, reason)
    assert spies == route
    assert api.decode(stream, device="cpu") == (payload or b"")


def test_counts_no_launch_on_the_cpu():
    before = telemetry.counter("k5.launches")
    run_plain(*CASES[0][:2])
    assert telemetry.counter("k5.launches") == before


def test_wrapper_rejects_bad_inputs():
    comp = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(TypeError):
        decode_stream.decode_stream_scan(comp.to(torch.int32), 4, torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        decode_stream.decode_stream_scan(comp, 5, torch.zeros(4, dtype=torch.uint8))


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the CPU twin")
    return _build.twin_lib()


def run_twin(twin, body: bytes, m: int):
    """Pass 2 alone (no window index): every step walked in one call."""
    src = np.frombuffer(body, dtype=np.uint8).copy() if body else np.zeros(1, np.uint8)
    out = np.zeros(max(m, 1), dtype=np.uint8)
    state = np.full(decode_stream.STATE_WORDS + 1, -7, dtype=np.int64)
    writtens = np.full(decode_stream.n_steps(len(body), m), -7, dtype=np.int64)
    assert twin.stpu_twin_decode_stream_scan(
        src.ctypes.data, len(body), m, out.ctypes.data, state.ctypes.data, writtens.ctypes.data,
        len(writtens), None, 0, None, None,
    ) == 0
    return state[: decode_stream.STATE_WORDS], writtens, out


@pytest.mark.parametrize("k", range(len(CASES)))
def test_twin_matches_plain(twin, k):
    body, m, _ = CASES[k]
    state, writtens, out = run_twin(twin, body, m)
    p_state, p_writtens, p_out = run_plain(body, m)
    assert state.tolist() == p_state.tolist() and writtens.tolist() == p_writtens.tolist()
    w = int(state[decode_stream.S_WRITTEN])
    assert out[:w].tobytes() == p_out[:w].tobytes()


def test_twin_matches_plain_on_edge_cases(twin):
    extra = [(b"", 0), (b"", 5), (payloads.literal(b"ab"), 0), (b"\x00", 1)]
    for body, m in extra + payloads.malformed_chunks():
        state, writtens, out = run_twin(twin, body, m)
        p_state, p_writtens, p_out = run_plain(body, m)
        assert state.tolist() == p_state.tolist() and writtens.tolist() == p_writtens.tolist(), (body, m)
