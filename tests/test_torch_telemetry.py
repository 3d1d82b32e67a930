"""Spans and counters inside the port (snappy_tpu_torch/telemetry.py), on
the CPU.

Off (no profiler, outside ``recording()``), a span is the one shared
no-op and a step leaves nothing behind.  Under ``torch.profiler`` the
flagship step and a K2 + K1 decode emit ``snappy.*`` ranges nested as
the layers are, and the store agrees with the exported trace; inside
``recording()`` the store fills with no profiler, and the framed round
trip records the engine's stages.
"""

import json
import os
import sys
import threading
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from snappy_tpu_torch import engine, entry, telemetry  # noqa: E402
from snappy_tpu_torch.ops import crc32c, decode_chunks, encode_blocks  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

STEP_SPANS = {  # span: its parent, in the flagship step
    "entry.step": None, "k1": "entry.step", "read.k1_lengths": "k1",
    "k3": "entry.step", "read.k3_lengths": "k3",
}
DECODE_SPANS = {"k2": None, "k1": None, "read.k1_lengths": "k1"}
READS = {"read.k1_lengths": 2, "read.k3_lengths": 2}


@pytest.fixture(autouse=True)
def empty_store():
    telemetry.reset()
    yield
    telemetry.reset()


def frames(n=3, width=512):
    p = payloads.mixed_payload(n * width - 100, seed=3)
    rows = np.zeros((n, width), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for k in range(n):
        part = np.frombuffer(p[k * width : (k + 1) * width], dtype=np.uint8)
        rows[k, : len(part)], lens[k] = part, len(part)
    return torch.from_numpy(rows), torch.from_numpy(lens)


def decode_call(host_values=True):
    """A call of K2 over the level-1 streams of ``frames()`` (given the
    host values of its offsets and lengths, or not), then K1 over the rows;
    the streams are made here, outside the call."""
    rows, lens = frames()
    enc, enc_len = encode_blocks.encode_blocks(rows, lens)
    bodies = [enc[k, : int(enc_len[k])].numpy() for k in range(len(lens))]
    offsets = np.zeros(len(bodies) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(b) for b in bodies])
    comp = torch.from_numpy(np.concatenate(bodies))
    want = crc32c.masked_crc32c_chunks(rows, lens)
    telemetry.reset()

    def call():
        out = torch.empty((len(bodies), 512), dtype=torch.uint8)
        ok, _ = decode_chunks.decode_chunks(comp, torch.from_numpy(offsets), lens, out,
                                            host_values=(offsets, lens.numpy()) if host_values else None)
        assert bool(ok.all()) and torch.equal(crc32c.masked_crc32c_chunks(out, lens), want)

    return call


def step_call():
    rows, lens = frames()
    return lambda: entry.step(rows, lens)


def traced(fn, tmp_path):
    """The ``snappy.*`` ranges of a profiled call of fn: [(name, start us,
    end us)] by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = [(e["name"].removeprefix(telemetry.PREFIX), e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith(telemetry.PREFIX)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def parents(ranges):
    """Each range's innermost enclosing range's name, or None."""
    found = []
    for i, (name, lo, hi) in enumerate(ranges):
        outer = [r for j, r in enumerate(ranges) if j != i and r[1] <= lo and hi <= r[2]]
        found.append((name, min(outer, key=lambda r: r[2] - r[1])[0] if outer else None))
    return found


def test_off_a_span_is_the_shared_no_op_and_a_step_records_nothing(monkeypatch):
    assert telemetry.span("k1") is telemetry.OFF
    assert telemetry.span("read.k1_lengths", reads=2) is telemetry.OFF

    def no_range(name):
        raise AssertionError(f"record_function({name!r}) with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    step_call()()
    decode_call()()
    assert telemetry.spans() == {}


@pytest.mark.parametrize("make, layout", [(step_call, STEP_SPANS), (decode_call, DECODE_SPANS)],
                         ids=["entry_step", "decode_k2_k1"])
def test_profiler_trace_nests_the_spans_and_the_store_agrees(make, layout, tmp_path):
    ranges = traced(make(), tmp_path)
    nesting = parents(ranges)
    assert set(nesting) == set(layout.items())
    stats = telemetry.spans()
    assert set(stats) == set(layout)
    calls = Counter(name for name, _, _ in ranges)
    for name, st in stats.items():
        assert st.count == calls[name], name
        assert st.reads == READS.get(name, 0) * st.count, name
        assert st.parent == layout[name], name
        assert 0 <= st.self_s <= st.total_s, name
        assert (st.outer_s > 0) == (layout[name] is None), name
        # a range's stamps fall between the span's clock reads inside it and
        # those outside its enter and exit: its trace time lies between the
        # store's host time and its ranged time, and its self time (less
        # its child ranges') between the bounds that gives, whatever the
        # thread did between a stamp and a read
        lo_hi = [(lo, hi) for n, lo, hi in ranges if n == name]
        kids = sum(hi - lo for (n, lo, hi), (_, p) in zip(ranges, nesting) if p == name)
        trace_total = sum(hi - lo for lo, hi in lo_hi) * 1e-6
        trace_self = trace_total - kids * 1e-6
        assert st.total_s <= trace_total <= st.ranged_s, name
        inner = [s for s in stats.values() if s.parent == name]
        low = st.total_s - sum(s.ranged_s for s in inner)
        high = st.ranged_s - sum(s.total_s for s in inner)
        assert low <= st.self_s <= high, name
        assert low <= trace_self <= high, name
    assert telemetry.span("k1") is telemetry.OFF  # off again once the profiler stops


def test_recording_fills_the_store_without_a_profiler():
    with telemetry.recording() as store:
        assert telemetry.span("k1") is not telemetry.OFF
        entry.step(*frames())
        entry.step(*frames())
    assert store is telemetry.spans()
    assert {n: s.count for n, s in store.items()} == {n: 2 for n in STEP_SPANS}
    assert store["read.k1_lengths"].reads == store["read.k3_lengths"].reads == 4
    step = store["entry.step"]
    kids = sum(s.total_s for n, s in store.items() if s.parent == "entry.step")
    assert step.self_s == pytest.approx(step.total_s - kids)
    assert step.outer_s == step.total_s
    assert all(s.ranged_s == 0 for s in store.values())  # no profiler, no range
    assert telemetry.span("k1") is telemetry.OFF


def test_k2_reads_its_values_back_only_without_host_values():
    for given, want in ((True, {}), (False, {"read.k2_values": (1, 2, "k2")})):
        call = decode_call(host_values=given)
        with telemetry.recording() as store:
            call()
        got = {n: (s.count, s.reads, s.parent) for n, s in store.items() if n.startswith("read.k2")}
        assert got == want, given
        telemetry.reset()


def test_the_engine_stages_appear_in_a_framed_round_trip():
    noise = np.random.default_rng(11).integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    data = payloads.mixed_payload(2 * 65536, seed=11) + noise  # compressed, then stored chunks
    with telemetry.recording() as store:
        stream = engine.framed_compress(data, device="cpu")
        compress = {n: (s.count, s.reads) for n, s in store.items()}
        telemetry.reset()
        assert engine.framed_uncompress(stream, device="cpu") == (data, "ok")
    assert compress == {
        "engine.stage": (1, 0), "engine.upload": (1, 0), "k1": (1, 0), "read.k1_lengths": (1, 2),
        "k3": (1, 0), "read.k3_lengths": (1, 2), "read.engine": (1, 3), "engine.assemble": (1, 0),
    }
    chunks = engine.framing.scan_frames(stream, len(engine.C.FRAMING_HEADER))
    stored = sum(ch.id == engine.C.CHUNK_UNCOMPRESSED for ch in chunks)
    assert 0 < stored < len(chunks)  # both kinds of chunk, so every stage runs
    got = {n: (s.count, s.reads, s.parent) for n, s in store.items()}
    assert got == {
        "engine.scan": (1, 0, None), "engine.decode": (1, 0, None), "engine.tobytes": (1, 0, None),
        "engine.stage": (3, 0, "engine.decode"), "engine.upload": (2, 0, "engine.decode"),
        "k2": (1, 0, "engine.decode"), "k1": (2, 0, "engine.decode"), "read.k1_lengths": (2, 4, "k1"),
        "read.engine": (2, 3 + 1, "engine.decode"), "engine.assemble": (2, 0, "engine.decode"),
    }


def test_counters_count_by_name():
    before = telemetry.counter("test.things")
    telemetry.count("test.things")
    telemetry.count("test.things", 4)
    assert telemetry.counter("test.things") == before + 5
    assert telemetry.counter("test.never") == 0


def test_threads_lose_no_count_and_no_span():
    """More threads than cores, a short switch interval: every count and
    every span of every thread lands in the store."""
    threads, calls = 3 * (os.cpu_count() or 1), 400
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    before = telemetry.counter("test.threads")

    def work():
        for _ in range(calls):
            telemetry.count("test.threads")
            with telemetry.span("test.outer"):
                with telemetry.span("read.test", reads=2):
                    pass

    try:
        with telemetry.recording():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    st = telemetry.spans()
    assert telemetry.counter("test.threads") - before == threads * calls
    assert st["test.outer"].count == st["read.test"].count == threads * calls
    assert st["read.test"].reads == 2 * threads * calls
    assert st["read.test"].parent == "test.outer" and st["test.outer"].parent is None
