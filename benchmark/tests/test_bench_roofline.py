"""The yardstick: roofline byte counts on a small case, and the trace's arithmetic."""

import numpy as np
import pytest

from benchmark.lib import harness, roofline, steps, trace

from .helpers import tiny_cell


def _staged(name):
    cell = tiny_cell(name)
    data, sizes = cell.generator().make(cell.config, 11, "cpu")
    host = data.numpy().copy()
    return steps.make(cell.traffic, cell.config, data, sizes, host, "cpu", cell.bench_dir), sizes


def test_encode_bytes_count_payload_and_tag_streams():
    step, sizes = _staged("blob_sidecars.encode_step")
    out = step()
    n = sum(sizes)
    assert step.work(out) == {"k1": n + 4 * 3 * len(sizes), "k3": n + int(out[2].sum())}
    assert out[1].shape[1] == steps.max_comp(65536) == 76522


def test_decode_bytes_count_bodies_and_rows():
    step, sizes = _staged("beacon_state.decode_step")
    out = step()
    w = step.work(out)
    decoded = int(step.declared_h.sum())
    plain = int(step.plain_lens.sum())
    assert decoded + plain == sum(sizes)
    assert w["k2"] == step.comp_bytes + decoded
    assert w["k1"] == sum(sizes) + 4 * (len(step.declared_h) + len(step.plain_f))


def test_share_is_least_time_over_kernel_time():
    tr = trace.Trace(steps=10, window_s=1.0, busy_s=0.5, kernel_union_s=0.4,
                     kernel_s={"void (anonymous namespace)::encode_blocks_kernel<1>(x)": 0.2, "other": 1.0})
    run = harness.Run(cell="c", payload_bytes=1, work={"k3": 3.35e9}, trace=tr)
    # 10 steps of 3.35 GB at 3.35 TB/s take 10 ms; the kernel took 200 ms
    assert roofline.share(run, roofline.K3, "k3") == pytest.approx(5.0)
    assert roofline.share(run, roofline.K2, "k2") is None  # no K2 in the trace
    assert roofline.share(harness.Run(cell="c", payload_bytes=1), roofline.K3, "k3") is None


def test_trace_summary_unions_gaps_and_names():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.STEP, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": trace.STEP, "ts": 120, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::aminmax", "ts": 10, "dur": 20, "args": {"External id": 5}},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::encode_blocks_kernel<1>(int)",
         "ts": 30, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<128>(int)", "ts": 40, "dur": 50,
         "args": {"External id": 5}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 150, "dur": 10},
    ]
    t = trace.summarize(ev, 2)
    assert t.window_s == pytest.approx(220e-6)
    assert t.busy_s == pytest.approx(70e-6) and t.kernel_union_s == pytest.approx(60e-6)
    assert t.kernel_time(*roofline.K3) == pytest.approx(50e-6)
    assert dict(t.device_ops) == pytest.approx({"encode_blocks_kernel": 50e-6, "aten::aminmax/elementwise_kernel": 50e-6,
                                                "Memcpy DtoH": 10e-6})
    # (0, 30) under aminmax; (90, 150) and (160, 220) have their middles in steps, under no op
    assert dict(t.idle_gaps) == pytest.approx({"aten::aminmax": 30e-6, "python": 120e-6})
    ev[1].update(ts=125, dur=95)  # now (90, 150)'s middle, 120, falls between steps
    assert dict(trace.summarize(ev, 2).idle_gaps) == pytest.approx(
        {"aten::aminmax": 30e-6, "python": 60e-6, "between steps": 60e-6})


def test_union_merges_overlaps():
    iv = np.array([[5.0, 7.0], [0.0, 2.0], [1.0, 3.0], [6.0, 6.5]])
    assert trace._union(iv).tolist() == [[0.0, 3.0], [5.0, 7.0]]
    assert trace.short("void (anonymous namespace)::crc32c_tiles_kernel<stpu::Interleaved>(unsigned char const*)") \
        == "crc32c_tiles_kernel"


def test_end_to_end_readers():
    from benchmark.lib import cells

    cell = cells.load("beacon_state.encode_step")
    run = harness.Run(cell=cell.name, payload_bytes=2_000_000_000, setup_s=9.5, steps=5, window_s=2.0,
                      step_ms=[float(x) for x in range(1, 101)], memory_peak_bytes=3_000_000)
    got = {m["name"]: cell.reader(m["name"])(run) for m in cell.end_to_end}
    assert got == pytest.approx({"encode_gbps": 5.0, "step_p95_ms.encode": 95.05, "device_mem_mb": 3.0, "setup_s": 9.5})


def test_a_split_metric_is_read_by_its_prefix_reader():
    from benchmark.lib import cells

    cell = cells.load("beacon_state.decode_step")
    run = harness.Run(cell=cell.name, payload_bytes=2_000_000_000, setup_s=9.5, steps=5, window_s=2.0,
                      step_ms=[float(x) for x in range(1, 101)], memory_peak_bytes=3_000_000)
    got = {m["name"]: cell.reader(m["name"])(run) for m in cell.end_to_end}
    assert got == pytest.approx({"decode_gbps.beacon_state": 5.0, "step_p95_ms.decode.beacon_state": 95.05,
                                 "device_mem_mb": 3.0, "setup_s": 9.5})
    file_of = lambda name: cell.reader(name).__code__.co_filename  # noqa: E731
    assert file_of("glue_ms.decode.beacon_state") == file_of("glue_ms.encode")
    assert file_of("glue_ms.encode") == str(cells.HERE / "metrics" / "glue_ms.py")
    with pytest.raises(FileNotFoundError):
        cell.reader("no_such_metric.decode")
