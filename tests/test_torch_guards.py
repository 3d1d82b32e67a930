"""The guard phase of chip_smoke.py (testing/guards.py) on the CPU.

On the card the guard phase calls each kernel's ``_launch`` with views into
guarded buffers; here ``_build.launch`` is sent to the CPU twin of the
same sources, so the phase's buffers, fills, comparisons and counts run
as they do there, on small cases of every kernel.  A planted launch that
writes one byte past its output, one that writes before it, and one whose
result depends on the bytes past its input are each reported; the long
stream (above 2^31 bytes on the card, 3 windows and 5 bytes here) equals
the host C decoder on K4's and K5's window routes.
"""

import ctypes
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snappy_tpu_torch import telemetry  # noqa: E402
from snappy_tpu_torch.ops import _build, crc32c, decode_chunks, encode_blocks  # noqa: E402
from snappy_tpu_torch.testing import guards, payloads  # noqa: E402

if shutil.which("g++") is None:
    pytest.skip("g++ is not available to build the CPU twin", allow_module_level=True)


@pytest.fixture
def to_twin(monkeypatch):
    """``_build.launch`` on the twin: the entry point's arguments without
    the stream; K3's launch shape from the H100's limits."""
    twin = _build.twin_lib()

    def launch(name, device, *args):
        assert getattr(twin, "stpu_twin_" + name)(*args) == 0, name

    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(encode_blocks, "card_limits", lambda dev: (232_448, 132))
    return launch


def blocks():
    named = payloads.smoke_blocks()
    rows = np.zeros((len(named), 65536), dtype=np.uint8)
    for k, (_, b) in enumerate(named):
        rows[k, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return rows, np.array([len(b) for _, b in named], dtype=np.int32)


def test_every_kernel_holds_its_guards(to_twin):
    g = guards.Guard("cpu")
    rows, lens = blocks()
    want = crc32c._crc32c_plain(torch.from_numpy(rows), torch.from_numpy(lens)).view(torch.int32)
    assert torch.equal(g.crc32c(rows.reshape(-1), 0, 65536, len(lens), 65536, lens, "blocks"), want)
    assert torch.equal(g.crc32c_mma(rows, lens, "blocks"), want)
    payload = np.frombuffer(payloads.mixed_payload(200_003, seed=5), dtype=np.uint8)
    g.crc32c(payload, 3, 200_000, 1, 200_000, [200_000], "one long row at offset 3")
    k3 = ("k3.launches", "k3.launches_l2", "k3.walkers")
    before = [telemetry.counter(c) for c in k3]
    for level in (1, 2):
        g.encode_blocks(rows, lens, level, "blocks")
    l1, l2, walkers = (telemetry.counter(c) - b for c, b in zip(k3, before))
    assert l1 == l2 >= len(guards.FILLS) and walkers == len(lens) * (l1 + l2)  # a walker a block
    big = payloads.big_window_cases()
    comp = b"".join(b for b, _ in big)
    offs = np.cumsum([0] + [len(b) for b, _ in big])
    got = g.decode_chunks(comp, offs, [m for _, m in big], decode_chunks.MAX_OUT, "big windows")
    assert bool(got["ok"][:3].all()) and not bool(got["ok"][3])
    for k in (0, 3, 4, 15):  # block-encoded, deferred, chain, no index
        body, m, _ = payloads.window_cases()[k]
        g.stream_routes(body, m, f"window case {k}")
    for k, (body, m, offs) in enumerate(payloads.scan_forced_index_cases()):
        g.decode_stream_scan(body, m, offs, f"forced index {k}")
    g.chunk_streams([s for s, _ in payloads.mutation_streams(12)], "mutation stream")
    assert g.failures == []
    names = ("crc32c", "crc32c_long", "crc32c_mma", "encode_blocks", "encode_blocks_l2",
             "decode_chunks", "decode_chunks_big", "decode_stream", "decode_stream_scan")
    assert all(g.guarded[n] >= len(guards.FILLS) for n in names), dict(g.guarded)
    assert g.guarded["crc32c_mma"] == len(guards.FILLS)


@pytest.mark.parametrize("level", [1, 2])
def test_k3_orders_the_rows_past_its_walkers(to_twin, monkeypatch, level):
    """On a card of 2 SMs with room for one or two tables a CTA, the 8
    blocks outnumber K3's walkers: a first launch estimates each row's
    cost and the walk takes the rows in that order, inside the guards and
    with the plain version's bytes."""
    monkeypatch.setattr(encode_blocks, "card_limits", lambda dev: (65_536, 2))
    rows, lens = blocks()
    k3 = ("k3.ordered", "k3.walkers")
    before = [telemetry.counter(c) for c in k3]
    g = guards.Guard("cpu")
    got = g.encode_blocks(rows, lens, level, "blocks")
    ordered, walkers = (telemetry.counter(c) - b for c, b in zip(k3, before))
    assert g.failures == [] and ordered == len(guards.FILLS)
    assert walkers == len(guards.FILLS) * (4 if level == 1 else 2)
    enc, enc_len = encode_blocks._encode_blocks_plain(torch.from_numpy(rows), torch.from_numpy(lens),
                                                      level)
    assert torch.equal(got["enc_len"], enc_len)
    for k, m in enumerate(enc_len.tolist()):
        assert torch.equal(got["enc"][k, :m], enc[k, :m]), k


def test_guarded_launches_go_through_the_counted_wrappers(to_twin):
    g = guards.Guard("cpu")
    counters = ("k2.launches", "k4.launches_windows", "k4.launches_walk", "k5.launches", "k1.launches")
    before = [telemetry.counter(c) for c in counters]
    body, m, _ = payloads.window_cases()[3]
    g.stream_routes(body, m, "deferred")
    rows, lens = blocks()
    g.crc32c(rows.reshape(-1), 0, 65536, len(lens), 65536, lens, "blocks")
    after = [telemetry.counter(c) for c in counters]
    fills = len(guards.FILLS)
    assert tuple(a - b for a, b in zip(after, before)) == (fills, fills, fills, 2 * fills, fills)
    assert dict(g.guarded) == {"decode_stream": 2 * fills, "decode_stream_scan": 2 * fills,
                               "decode_chunks": fills, "crc32c": fills}


@pytest.mark.parametrize("where", ["after", "before"])
def test_a_write_out_of_bounds_is_caught(to_twin, monkeypatch, where):
    """A K2 launch that writes one byte past its rows, or one before them."""
    def launch(name, device, comp, offsets, declared, n, out, cols, ok, written):
        to_twin(name, device, comp, offsets, declared, n, out, cols, ok, written)
        ctypes.c_uint8.from_address(out + n * cols if where == "after" else out - 1).value ^= 1

    monkeypatch.setattr(_build, "launch", launch)
    g = guards.Guard("cpu")
    g.decode_chunks(b"\x00a", [0, 2], [1], 65536, "one literal")
    assert len(g.failures) == len(guards.FILLS)
    assert all("the guard bands of ['out'] changed" in f for f in g.failures), g.failures


def test_a_read_past_the_input_that_changes_the_result_is_caught(to_twin, monkeypatch):
    """A K4 walk that takes two bytes more than its input holds: behind a
    literal of 3 bytes, with 4 declared, 0x00 0x00 is a literal of one
    byte that completes the stream and 0xFF 0xFF a truncated copy."""
    def launch(name, device, comp, n, m, out, status):
        to_twin(name, device, comp, n + 2, m, out, status)

    monkeypatch.setattr(_build, "launch", launch)
    g = guards.Guard("cpu")
    g.decode_stream(payloads.literal(b"abc"), 4, None, "a literal")
    assert any("input guards 0 and 255" in f for f in g.failures), g.failures
    assert all("differ between the input guards" in f and "status" in f for f in g.failures), g.failures


def test_long_stream_equals_the_host_decoder(to_twin):
    g = guards.Guard("cpu")
    info = guards.long_stream(g, 3 * 65536 + 5)
    assert g.failures == []
    assert info["windows"] == 4 and info["host_ok"] and info["walked"] == 0
    assert info["k4_ok"] and info["k5_ok"] and info["k4_sha_equal"] and info["k5_sha_equal"]
    assert info["body"] < info["declared"] // 10  # runs and period-8 data
