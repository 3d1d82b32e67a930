"""The readers of the port's own spans (``host_reads``, ``read_wait_ms``,
``program_host_ms``), on a filled store, an empty one and a traced run of
each cell cut to a few frames; and the trace's gap naming under a port
span."""

import time

import pytest
import torch

from benchmark.lib import cells, harness, trace
from snappy_tpu_torch import telemetry

from .helpers import CELLS, tiny_cell

READERS = ("host_reads", "read_wait_ms", "program_host_ms")
READS_A_STEP = {  # of the cut cells: K1's lengths (2 a call) and K3's (2)
    "beacon_state.encode_step": 4, "blob_sidecars.encode_step": 4,
    "beacon_state.decode_step": 2,  # K1 on the decoded rows: no chunk is stored at this size
    "blob_sidecars.decode_step": 2,  # K1 on the stored chunks: none compresses
}


@pytest.fixture(autouse=True)
def empty_store():
    telemetry.reset()
    yield
    telemetry.reset()


def run_of(steps):
    tr = trace.Trace(steps=steps, window_s=1.0, busy_s=0.5, kernel_union_s=0.4)
    return harness.Run(cell="c", payload_bytes=1, steps=steps, trace=tr)


def reader(name):
    return cells.load("beacon_state.encode_step").reader(name + ".encode")


def test_readers_on_a_filled_store():
    with telemetry.recording():
        for _ in range(2):  # two steps of one outer span holding a read and a kernel span
            with telemetry.span("entry.step"):
                with telemetry.span("k1"):
                    with telemetry.span("read.k1_lengths", reads=2):
                        time.sleep(0.002)
                time.sleep(0.001)
    st = telemetry.spans()
    run = run_of(2)
    assert reader("host_reads")(run) == 2.0
    wait = st["read.k1_lengths"].total_s
    assert reader("read_wait_ms")(run) == pytest.approx(wait / 2 * 1e3)
    assert reader("read_wait_ms")(run) >= 2.0
    own = st["entry.step"].total_s - wait
    assert reader("program_host_ms")(run) == pytest.approx(own / 2 * 1e3)
    assert reader("program_host_ms")(run) >= 1.0


def test_readers_on_an_empty_store_or_without_a_trace():
    for name in READERS:
        assert reader(name)(run_of(3)) is None
    with telemetry.recording():
        with telemetry.span("k1"):
            pass
    for name in READERS:
        assert reader(name)(harness.Run(cell="c", payload_bytes=1)) is None
        assert reader(name)(run_of(0)) is None
    assert reader("host_reads")(run_of(1)) == 0.0


def test_a_gap_under_a_port_span_is_named_by_it():
    span = telemetry.PREFIX + "read.k1_lengths"
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.STEP, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": telemetry.PREFIX + "k1", "ts": 5, "dur": 80},
        {"ph": "X", "cat": "user_annotation", "name": span, "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "void crc32c_tiles_kernel(int)", "ts": 40, "dur": 20},
    ]
    gaps = dict(trace.summarize(ev, 1).idle_gaps)
    # (0, 40): its middle, 20, under the read span; (60, 100): its middle, 80, under K1's span
    assert gaps == pytest.approx({span: 40e-6, telemetry.PREFIX + "k1": 40e-6})


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_reads_the_step_makes(name):
    cell = tiny_cell(name)
    line, _ = harness.execute(cell, 2**31 + 9, 0.0, True, time.perf_counter(), torch.device("cpu"))
    got = {m.split(".")[0]: v for m, v in line["metrics"].items()}  # by reader
    st = telemetry.spans()
    reads = {k: s.reads for k, s in st.items() if k.startswith(telemetry.READ)}
    assert got["host_reads"]["value"] == sum(reads.values()) / line["attempted"]
    if name in READS_A_STEP:  # a cell added later is held to the rest
        assert got["host_reads"]["value"] == READS_A_STEP[name]
    calls = sum(st[k].count for k in ("k1", "k3") if k in st)
    assert 2 * calls == reads.get("read.k1_lengths", 0) + reads.get("read.k3_lengths", 0)
    assert got["host_reads"]["unit"] == "reads"
    assert got["read_wait_ms"]["value"] > 0 and got["program_host_ms"]["value"] > 0
