"""The ``api_decode`` step kind (``entries/api_decode.py``) on the CPU at a
few frames: correct as the program is, not correct under its control and
under faults planted where the API produces its answer, its bytes counted
as the staged decode counts them, and its spans read in a traced run.

Its cell, ``beacon_state.api_decode``, is not in ``BENCHMARK.json``: on
the card its rate swings with the host's cost of fresh pages, which only
the program can stop paying.  The cell is built here from its files and
the metrics that it would report."""

import json

import pytest
import torch

from benchmark import control
from benchmark.lib import harness, spans, steps, trace
from snappy_tpu_torch import api, engine, telemetry
from snappy_tpu_torch.ops import host_codec

from .helpers import run_cell, tiny_cell
from .test_bench_faults import FAULTS

CELL = "beacon_state.api_decode"
SPAN_READERS = ("scan_ms", "stage_ms", "upload_ms", "assemble_ms", "tobytes_ms")
END_TO_END = {"decode_gbps": "GB/s", "step_p95_ms": "ms", "device_mem_mb": "MB", "setup_s": "s"}
PER_LAYER = dict({"k2_roofline": "%", "k1_roofline": "%", "glue_ms": "ms", "idle_pct": "%", "host_reads": "reads",
                  "read_wait_ms": "ms", "program_host_ms": "ms"}, **{name: "ms" for name in SPAN_READERS})


def _metrics(units):
    split = lambda m: m if m in ("device_mem_mb", "setup_s") else f"{m}.api_decode.beacon_state"  # noqa: E731
    return [{"name": split(m), "unit": u} for m, u in units.items()]


def api_cell(base: str = "beacon_state.decode_step", sample_frames: int = 4):
    """The cut cell ``base`` with the ``api_decode`` traffic and metrics."""
    cell = tiny_cell(base, sample_frames)
    traffic = json.loads((cell.bench_dir / "traffic" / "api_decode.json").read_text())
    cell.name, cell.traffic_name = CELL, "api_decode"
    cell.traffic = dict(traffic, warmup_steps=0, sample_frames=sample_frames)
    cell.end_to_end, cell.per_layer = _metrics(END_TO_END), _metrics(PER_LAYER)
    return cell


def run_api(seed: int = 2**31 + 5, sample_frames: int = 4):
    return run_cell(api_cell(sample_frames=sample_frames), seed)


@pytest.fixture(autouse=True)
def empty_store():
    telemetry.reset()
    yield
    telemetry.reset()


def _sidecars():
    """The kind on the cut sidecars: 4 messages, every chunk stored."""
    return api_cell("blob_sidecars.decode_step")


def test_the_kind_is_correct():
    line, checks = run_api()
    assert line["correct"] and not any(checks.values()), checks
    assert {"decode_gbps.api_decode.beacon_state", "setup_s"} <= set(line["metrics"])  # the rest read the card


def test_the_kind_is_correct_on_stored_chunks_and_many_messages():
    line, checks = run_cell(_sidecars())
    assert line["correct"] and not any(checks.values()), checks


def test_the_bytes_are_counted_as_the_staged_decode_counts_them():
    for cell in (api_cell(), _sidecars()):
        data, sizes = cell.generator().make(cell.config, 11, "cpu")
        host = data.numpy().copy()
        kind = steps.make(cell.traffic, cell.config, data, sizes, host, "cpu", cell.bench_dir)
        staged = steps.make(dict(cell.traffic, entry="decode"), cell.config, data, sizes, host, "cpu", cell.bench_dir)
        assert kind.work(kind()) == staged.work(staged())


def test_control_no_integrity_is_not_correct():
    with control.control_of(api_cell())[1]():
        line, checks = run_api()
    assert not line["correct"]
    # the cut cell's 2 chunks are compressed: its CRC changed, the last's
    # changed, both taken; the cut stream is still refused by the scan
    assert checks == {"rows_bad": 0, "stream_bad": 0, "integrity_bad": 2, "failed_steps": 0}


def _varint_len(n: int) -> int:
    return max(1, (int(n).bit_length() + 6) // 7)


def _stored_of_bodies(arr, bodies, declared_h):
    """The stored CRC of each compressed chunk, read before its body's varint."""
    return [int.from_bytes(arr[lo - _varint_len(d) - 4 : lo - _varint_len(d)].tobytes(), "little")
            for (lo, _), d in zip(bodies, declared_h)]


def _compressed_unchecked(real):
    def decode_bodies(arr, bodies, declared_h, check_integrity, dev):
        ok, out, crcs, declared = real(arr, bodies, declared_h, check_integrity, dev)
        return ok, out, torch.tensor(_stored_of_bodies(arr, bodies, declared_h), dtype=torch.int64), declared
    return decode_bodies


def _second_half_unchecked(real):
    def decode_bodies(arr, bodies, declared_h, check_integrity, dev):
        ok, out, crcs, declared = real(arr, bodies, declared_h, check_integrity, dev)
        crcs = crcs.to(torch.int64).cpu() & 0xFFFFFFFF
        half = len(bodies) // 2
        crcs[half:] = torch.tensor(_stored_of_bodies(arr, bodies[half:], declared_h[half:]), dtype=torch.int64)
        return ok, out, crcs, declared
    return decode_bodies


def _stored_unchecked(real):
    def crc_payloads(arr, spans, dev):
        return torch.tensor([int.from_bytes(arr[lo - 4 : lo].tobytes(), "little") for lo, _ in spans])
    return crc_payloads


PARTIAL_CRC = {  # a decode that checks the CRC of some chunks only, and a cell that has the others
    "compressed_unchecked": ("_decode_bodies", _compressed_unchecked, CELL),
    "second_half_unchecked": ("_decode_bodies", _second_half_unchecked, CELL),
    "stored_unchecked": ("_crc_payloads", _stored_unchecked, "sidecars"),
}


@pytest.mark.parametrize("seed", [2**31 + 5, 2**33 + 1, 12345])
@pytest.mark.parametrize("fault", sorted(PARTIAL_CRC))
def test_a_decode_that_checks_some_crcs_only_is_not_correct(fault, seed, monkeypatch):
    attr, wrap, name = PARTIAL_CRC[fault]
    monkeypatch.setattr(engine, attr, wrap(getattr(engine, attr)))
    line, checks = run_cell(_sidecars() if name == "sidecars" else api_cell(), seed)
    assert not line["correct"] and checks["integrity_bad"] >= 1, checks
    assert checks["rows_bad"] == checks["stream_bad"] == checks["failed_steps"] == 0, checks


def _flip_one(out):
    b = bytearray(out)
    b[len(b) // 2] ^= 0x10
    return bytes(b)


ANSWERS = {  # the API's answer altered where it is produced, and the frames then wrong
    "one_byte": (_flip_one, 1),
    "unchanged": (lambda out: bytes(len(out)), 2),  # zeros: the output left as allocated
    "half": (lambda out: out[: len(out) // 2], 2),  # a wrong length counts every frame
    "refused": (lambda out: None, 2),
}


@pytest.mark.parametrize("fault", sorted(ANSWERS))
def test_an_altered_answer_is_not_correct(fault, monkeypatch):
    alter, frames_bad = ANSWERS[fault]
    real = engine.framed_uncompress

    def altered(*args, **kw):
        out, reason = real(*args, **kw)
        if out is None:
            return out, reason
        out = alter(out)
        return (None, "crc") if out is None else (out, reason)

    monkeypatch.setattr(engine, "framed_uncompress", altered)
    line, checks = run_api()
    assert not line["correct"] and checks["rows_bad"] == frames_bad, checks
    assert checks["failed_steps"] == (fault == "refused")


def test_a_stream_that_the_reference_refuses_is_counted(monkeypatch):
    """The set-up stream with its first chunk's stored CRC changed: every
    chunk in the sample, so the reference meets it."""
    real = host_codec.framed_compress

    def changed(data, level=1):
        s = bytearray(real(data, level=level))
        s[14] ^= 0x01  # the first chunk's CRC, after the 10-byte identifier and its 4-byte header
        return bytes(s)

    monkeypatch.setattr(host_codec, "framed_compress", changed)
    line, checks = run_api(sample_frames=64)
    assert not line["correct"] and checks["stream_bad"] == 1 and checks["failed_steps"] == 1, checks


def test_a_traced_run_reads_every_span_of_the_api():
    line, checks = run_cell(api_cell(), seed=2**31 + 9, traced=True)
    assert line["correct"], checks
    got = {m.split(".")[0]: v["value"] for m, v in line["metrics"].items()}
    assert set(got) == set(PER_LAYER) - {"k1_roofline", "k2_roofline"}  # those read kernel time on the card
    assert all(got[name] > 0 for name in SPAN_READERS + ("read_wait_ms", "program_host_ms"))
    st = telemetry.spans()
    reads = {k: s.reads for k, s in st.items() if k.startswith(telemetry.READ)}
    assert got["host_reads"] == sum(reads.values()) / line["attempted"]
    # at this size K1 runs once, on the decoded rows (no chunk is stored):
    # its lengths (2 reads), and the engine's verdicts, CRCs and rows (3)
    assert got["host_reads"] == 5 and reads["read.engine"] == 3 * line["attempted"]


# the kernels' faults that the API's path can have: K2 and K1 run under it
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_kernel_fault_is_not_correct(fault, monkeypatch):
    for module, attr, wrap in FAULTS[fault]["decode"]:
        monkeypatch.setattr(module, attr, wrap(getattr(module, attr)))
    line, checks = run_api()
    assert not line["correct"], checks


def test_a_span_reader_reads_nothing_without_a_trace_or_a_span():
    tr = trace.Trace(steps=2, window_s=1.0, busy_s=0.5, kernel_union_s=0.4)
    assert spans.span_ms(harness.Run(cell="c", payload_bytes=1, steps=2, trace=tr), "engine.scan") is None
    with telemetry.recording():
        api.decode_framed(host_codec.framed_compress(bytes(1000)), device="cpu")
    assert spans.span_ms(harness.Run(cell="c", payload_bytes=1), "engine.scan") is None
    run = harness.Run(cell="c", payload_bytes=1, steps=2, trace=tr)
    assert spans.span_ms(run, "engine.scan") == pytest.approx(telemetry.spans()["engine.scan"].total_s / 2 * 1e3)
    assert spans.span_ms(run, "no.such_span") is None
