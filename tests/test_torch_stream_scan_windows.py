"""The window route of the port's scan-mode stream decoder (kernel K5)
against the plain scan and the JAX package.

Given the host's block index (decode_stream.window_index), K5 runs K2's
kernel over the index's 64 KiB windows (pass 1) and then one launch that
writes down the step of every window K2 decoded cleanly and walks every
other step with the scan step (pass 2); without an index, pass 2 alone
walks every step.  Their CUDA sources compiled by g++ (the twin: K2's
``stpu_twin_decode_chunks``, pass 2's ``stpu_twin_decode_stream_scan``),
K2's lanes run in both orders, are held against the plain scan
(``_scan_plain``) exactly: the 16 state words, every step's window length,
and the output up to ``written``.  The result must not depend on the
index: wrong indices give the same scan.  A few small cases are held
against the TPU kernel's scan through the Pallas interpreter, as
tests/test_torch_stream_scan.py does.
"""

import ctypes
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snappy_tpu.ops import decode_stream as jax_stream  # noqa: E402

from snappy_tpu_torch.ops import _build, decode_chunks, decode_stream  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

WIN = decode_stream.WIN
STREAM = payloads.stream_cases()
EDGE = payloads.scan_edge_cases()
WINDOW = payloads.window_cases()
DIFFERENTIAL = payloads.scan_differential_cases()
NEW = payloads.scan_window_cases()
FORCED = payloads.scan_forced_index_cases()
CASES = STREAM + EDGE + WINDOW + DIFFERENTIAL + NEW
# scan_window_cases, in order
RAGGED, RESYNC, SERVED, FAR, BAD, CHAIN, MARGIN, LONG, ZERO = range(len(STREAM + EDGE + WINDOW + DIFFERENTIAL), len(CASES))
# window_cases: 3 block-encoded streams, a window copying from an earlier
# one, a chain of three such windows
W_BLOCK = [len(STREAM + EDGE) + k for k in range(3)]
W_DEFERRED, W_CHAIN = len(STREAM + EDGE) + 3, len(STREAM + EDGE) + 4

if shutil.which("g++") is None:
    pytest.skip("g++ is not available to build the CPU twin", allow_module_level=True)


@pytest.fixture(scope="module", params=["lanes_up", "lanes_down"])
def twin(request):
    """The twin, K2's lanes run 0 .. 31 (the package's build) or 31 .. 0."""
    if request.param == "lanes_up":
        return _build.twin_lib()
    so = _build._build(
        "twin_scan_lanes_down",
        ["g++", "-std=c++17", "-O2", "-fPIC", "-x", "c++", "-DSTPU_TWIN_REVERSE_LANES"],
        ["g++", "-shared"],
        [_build.CSRC / "decode_chunks.cu", _build.CSRC / "decode_stream_scan.cu"],
        [_build.CSRC / "snappy_common.cuh"],
    )
    lib = ctypes.CDLL(str(so))
    for name in ("decode_chunks", "decode_stream_scan"):
        getattr(lib, "stpu_twin_" + name).argtypes = _build._ENTRY_POINTS[name][:-1]
    return lib


def route_index(body: bytes, m: int):
    """The index decode_raw_stream_bytes gives K5: window_index, or None."""
    offs = decode_stream.window_index(body, m) if m > 0 else None
    return None if offs is None else offs.numpy()


def run_twin(lib, body: bytes, m: int, in_offs=None):
    """(state [16], writtens, out, walked steps) of K5 by the twin: K2 over
    the windows of ``in_offs`` and pass 2, or pass 2 alone."""
    src = np.frombuffer(body, dtype=np.uint8).copy() if body else np.zeros(1, np.uint8)
    nwin = 0 if in_offs is None else len(in_offs) - 1
    out = np.full(max(m, nwin * WIN, 1), 0xAA, dtype=np.uint8)
    state = np.full(decode_stream.STATE_WORDS + 1, -7, dtype=np.int64)
    writtens = np.full(decode_stream.n_steps(len(body), m), -7, dtype=np.int64)
    offs = ok = written = None
    if nwin:
        offs = np.ascontiguousarray(in_offs, dtype=np.int64)
        decl = decode_stream.window_lengths(m)
        ok = np.zeros(nwin, dtype=np.uint8)
        written = np.zeros(nwin, dtype=np.int32)
        assert lib.stpu_twin_decode_chunks(
            src.ctypes.data, offs.ctypes.data, decl.ctypes.data, nwin, out.ctypes.data, WIN,
            ok.ctypes.data, written.ctypes.data,
        ) == 0
    assert lib.stpu_twin_decode_stream_scan(
        src.ctypes.data, len(body), m, out.ctypes.data, state.ctypes.data, writtens.ctypes.data,
        len(writtens), None if offs is None else offs.ctypes.data, nwin,
        None if ok is None else ok.ctypes.data, None if written is None else written.ctypes.data,
    ) == 0
    return state[: decode_stream.STATE_WORDS], writtens, out, int(state[decode_stream.S_WALKED])


_PLAIN = {}


def run_plain(body: bytes, m: int):
    """(state [16], writtens, out) of the plain scan, once per stream."""
    key = (body, m)
    if key not in _PLAIN:
        comp = torch.from_numpy(np.frombuffer(body, dtype=np.uint8).copy())
        out = torch.zeros(max(m, 1), dtype=torch.uint8)
        state, writtens = decode_stream.decode_stream_scan(comp, m, out)
        _PLAIN[key] = (state.numpy().copy(), writtens.numpy().copy(), out.numpy().copy())
    return _PLAIN[key]


def assert_equals_plain(got, body: bytes, m: int):
    state, writtens, out, _ = got
    p_state, p_writtens, p_out = run_plain(body, m)
    assert state.tolist() == p_state.tolist(), "state"
    assert writtens.tolist() == p_writtens.tolist(), "writtens"
    w = int(p_state[decode_stream.S_WRITTEN])
    assert out[:w].tobytes() == p_out[:w].tobytes(), "bytes"


@pytest.mark.parametrize("k", range(len(CASES)))
def test_route_twin_matches_plain(twin, k):
    """Each case on the route decode_raw_stream_bytes takes in scan mode."""
    body, m, _ = CASES[k]
    assert_equals_plain(run_twin(twin, body, m, route_index(body, m)), body, m)


ROUTE = object()


def walked(body: bytes, m: int, in_offs=ROUTE):
    """(walked steps, writtens, state) of the twin, held against the plain
    scan, on the route's index (or ``in_offs``)."""
    got = run_twin(_build.twin_lib(), body, m, route_index(body, m) if in_offs is ROUTE else in_offs)
    assert_equals_plain(got, body, m)
    return got[3], got[1], got[0]


def test_block_encoded_streams_walk_no_step():
    for k in W_BLOCK + list(range(len(STREAM + EDGE + WINDOW), RAGGED)):
        body, m, _ = CASES[k]
        if route_index(body, m) is not None:
            n, writtens, state = walked(body, m)
            assert n == 0, k
            assert writtens[: decode_stream.window_count(m)].tolist() == \
                decode_stream.window_lengths(m).tolist(), k
            assert decode_stream.scan_status(state, len(body), m)[0] == 1, k
    body, m, _ = STREAM[1]  # 140,000 bytes of text, level 1
    assert route_index(body, m) is not None and walked(body, m)[0] == 0


def test_ragged_steps_are_walked_off_the_grid():
    body, m, payload = CASES[RAGGED]
    assert route_index(body, m) is not None
    n, writtens, state = walked(body, m)
    steps = writtens[writtens > 0].tolist()
    assert n == len(steps) and len(steps) > decode_stream.window_count(m)
    assert any(w % WIN for w in steps[:-1]), steps  # the steps leave the 64 KiB grid
    assert decode_stream.scan_status(state, len(body), m)[0] == 1


@pytest.mark.parametrize("k, want_walked, verdict", [
    (RESYNC, 1, "ok"),  # the copy into window 0 is walked, then the windows resync
    (SERVED, 1, "ok"),  # the copy exactly 64 KiB behind window 2's start
    (FAR, 1, "unsupported"),  # one byte further
    (BAD, 2, "invalid"),  # window 1 walked, then window 2's bad tag
    (CHAIN, 3, "ok"),  # three walked windows, each followed by a resync
    (MARGIN, 3, "ok"),  # window 2 stops at the MARGIN: it and the two steps after it
    (W_DEFERRED, 1, "unsupported"),  # a copy reaching window 0 from window 2
    (W_CHAIN, 1, "unsupported"),
])
def test_walked_steps_and_verdicts(k, want_walked, verdict):
    body, m, _ = CASES[k]
    assert route_index(body, m) is not None
    n, _, state = walked(body, m)
    ok, _, unsup, _, _ = decode_stream.scan_status(state, len(body), m)
    assert n == want_walked
    assert ("ok" if ok else "unsupported" if unsup else "invalid") == verdict


@pytest.mark.parametrize("k", range(len(FORCED)))
def test_forced_index_twin_matches_plain(twin, k):
    body, m, offs = FORCED[k]
    assert route_index(body, m) is None
    assert_equals_plain(run_twin(twin, body, m, offs), body, m)


def test_done_comes_early_on_the_window_route():
    """Three windows declaring 5,000 bytes more: window 2's step sets done
    with written < declared, as the scan does, and nothing is walked."""
    body, m, offs = FORCED[0]
    n, writtens, state = walked(body, m, offs)
    assert n == 0 and writtens[:4].tolist() == [WIN, WIN, WIN, 0]
    assert state[decode_stream.S_DONE] == 1 and state[decode_stream.S_WRITTEN] == 3 * WIN


def test_pending_segment_at_a_window_start_is_walked():
    """The scan reaches window 1 on the grid and at its index offset, but
    with a copy's bytes pending: the step is walked, not taken from K2."""
    body, m, offs = FORCED[1]
    n, writtens, state = walked(body, m, offs)
    assert n == 3 and writtens[:3].tolist() == [WIN, WIN, 1004]


def test_zero_declared_walks_nothing():
    for body in (CASES[ZERO][0], b""):
        n, writtens, state = walked(body, 0)
        assert n == 0 and not writtens.any() and not state.any()


def perturbed(offs: np.ndarray, n: int):
    """Indices that K2 can read (inside the body, not decreasing) but that
    are not the stream's."""
    yield np.minimum(offs + 1, n)
    yield np.concatenate([[0], np.minimum(offs[1:] + 4, n)])
    yield np.full_like(offs, n)
    z = np.zeros_like(offs)
    z[-1] = n
    yield z
    if len(offs) > 3:
        moved = offs.copy()
        moved[2] = moved[1]
        yield moved


@pytest.mark.parametrize("k", [W_BLOCK[2], W_DEFERRED, W_CHAIN, RESYNC, SERVED, BAD, CHAIN, MARGIN])
def test_any_index_gives_the_scan(k):
    body, m, _ = CASES[k]
    for offs in perturbed(route_index(body, m), len(body)):
        walked(body, m, offs)


# the JAX package's scan on a few small cases, through the interpreter at
# one padded buffer shape (4 or 16 steps: two compiles)
SMALL = [RESYNC, SERVED, FAR, BAD, CHAIN, LONG, ZERO]
PAD_WORDS = max(-(-len(CASES[k][0]) // 4) for k in SMALL) + jax_stream.SC_WORDS + 1024 + 8


@pytest.mark.parametrize("k", SMALL)
def test_window_route_matches_tpu_scan_kernel_interpreted(k):
    body, m, payload = CASES[k]
    steps = decode_stream.n_steps(len(body), m)
    assert steps in (4, 16)
    buf = np.zeros(PAD_WORDS * 4, dtype=np.uint8)
    buf[: len(body)] = np.frombuffer(body, dtype=np.uint8)
    windows, want_writtens, status = jax_stream.decode_raw_stream(
        buf.view(np.int32), np.int32(len(body)), np.int32(m), steps, True
    )
    windows = np.ascontiguousarray(np.asarray(windows)).view(np.uint8)
    want_writtens = np.asarray(want_writtens).tolist()
    state, writtens, out, _ = run_twin(_build.twin_lib(), body, m, route_index(body, m))
    got_status = list(decode_stream.scan_status(state, len(body), m))
    assert got_status == [int(x) for x in np.asarray(status)]
    assert writtens.tolist() == want_writtens
    if not got_status[2]:  # an unsupported copy's bytes come from clipped TPU reads
        ends = np.cumsum(writtens)
        for s, w in enumerate(want_writtens):
            assert out[ends[s] - w : ends[s]].tobytes() == windows[s, :w].tobytes(), s
    if got_status[0]:
        assert out[:m].tobytes() == payload


def tensor(body: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(body, dtype=np.uint8).copy())


def test_wrapper_takes_in_offs_and_checks_it():
    body, m, payload = CASES[RESYNC]
    offs = decode_stream.window_index(body, m)
    nwin = offs.shape[0] - 1
    out = torch.zeros(nwin * WIN, dtype=torch.uint8)
    state = torch.full((decode_stream.STATE_WORDS + 1,), 9, dtype=torch.int64)
    got, writtens = decode_stream.decode_stream_scan(tensor(body), m, out, offs, state)
    assert decode_stream.scan_status(got.tolist(), len(body), m)[0] == 1
    assert out[:m].numpy().tobytes() == payload
    assert int(state[decode_stream.S_WALKED]) == 0  # the plain version walks nothing on the card
    assert got.tolist() == run_plain(body, m)[0].tolist()
    with pytest.raises(ValueError):  # K2 fills whole windows: out needs nwin * 64 KiB
        decode_stream.decode_stream_scan(tensor(body), m, torch.zeros(m - 1, dtype=torch.uint8), offs)
    for wrong in (offs[:-1], torch.cat([offs, offs[-1:]])):
        with pytest.raises(ValueError):
            decode_stream.decode_stream_scan(tensor(body), m, out, wrong)
    with pytest.raises(TypeError):
        decode_stream.decode_stream_scan(tensor(body), m, out, offs.to(torch.int32))
    for bad in (offs.flip(0), offs + len(body)):  # values K2 cannot read
        with pytest.raises(ValueError):
            decode_stream.decode_stream_scan(tensor(body), m, out, bad)
    with pytest.raises(ValueError):
        decode_stream.decode_stream_scan(tensor(body), m, out, state=torch.zeros(16, dtype=torch.int64))


@pytest.mark.parametrize("k", [RAGGED, RESYNC, SERVED, FAR, BAD, CHAIN, MARGIN, LONG, ZERO, W_DEFERRED])
def test_decode_raw_stream_bytes_on_the_cpu(k):
    body, m, payload = CASES[k]
    counters = ("LAUNCHES_SCAN", "LAUNCHES_SCAN_WINDOWS", "WALKED")
    before = [getattr(decode_stream, c) for c in counters] + [decode_chunks.LAUNCHES]
    got = decode_stream.decode_raw_stream_bytes(body, m, mode="scan", device="cpu")
    state = run_plain(body, m)[0]
    ok, _, unsup, _, _ = decode_stream.scan_status(state, len(body), m)
    want = (payload if m else b"", "ok") if ok else (None, "unsupported" if unsup else "invalid")
    assert got == want
    after = [getattr(decode_stream, c) for c in counters] + [decode_chunks.LAUNCHES]
    assert after == before  # nothing launched or walked on the CPU
