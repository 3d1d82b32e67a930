"""The port's span API (snappy_tpu_torch.parallel.multihost) against the
JAX package's span semantics (exact).

Two processes form a gloo group on the CPU; each compresses its span of a
payload and decodes its share of framed streams with ``device="cpu"`` (the
kernels' plain versions) and on the host backend, and writes its results
to a file.  Each blob, offset and total must equal what
snappy_tpu/parallel/multihost.py:83-92 gives from
``snappy_tpu.engine.framed_compress(span, with_header=False,
backend="host")``, and each decoded share what its contiguous chunk split
(multihost.py:112-123) gives from the JAX engine.
"""

import pickle
import textwrap

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from snappy_tpu import engine as jax_engine  # noqa: E402
from snappy_tpu.formats import framing as jax_framing  # noqa: E402

from snappy_tpu_torch import api  # noqa: E402
from snappy_tpu_torch.formats import constants as C  # noqa: E402
from snappy_tpu_torch.parallel import multihost  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

from test_torch_parallel import start_group, wait_group  # noqa: E402

WORLD = 2
BACKENDS = ("device", "host")

WORKER = textwrap.dedent(
    """
    import pickle, sys
    from datetime import timedelta
    import torch.distributed as dist
    from snappy_tpu_torch.parallel import multihost

    port, rank, world, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                         timeout=timedelta(seconds=120))
    with open(f"{out}/cases.pkl", "rb") as f:
        cases = pickle.load(f)
    results = {}
    for name, payload in cases["payloads"].items():
        span = len(payload) // (world * 65536) * 65536
        local = payload[:span] if rank == 0 else payload[span:]
        for backend in ("device", "host"):
            for with_header in (False, True):
                results["compress", name, backend, with_header] = multihost.compress_framed_span(
                    local, backend=backend, with_header=with_header, device="cpu")
    for name, stream in cases["streams"].items():
        for backend in ("device", "host"):
            results["uncompress", name, backend] = multihost.uncompress_framed_span(
                stream, backend=backend, device="cpu")
    results["lengths"] = multihost._allgather_lengths(1000 + rank).tolist()
    results["modules"] = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "snappy_tpu"))
    dist.barrier()
    dist.destroy_process_group()
    with open(f"{out}/rank_{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    """
)

PAYLOADS = ["runs", "mixed", "small"]
STREAMS = ["mixed", "one_chunk", "bad_crc_second_share", "truncated", "bad_magic"]


def _payloads():
    return {
        "runs": b"".join(bytes([i & 0xFF]) * 997 for i in range(300)),  # tests/test_multihost.py
        "mixed": payloads.mixed_payload(400_000, seed=9),
        "small": payloads.mixed_payload(1000, seed=9),  # rank 0's span is empty
    }


def _streams(ps):
    mixed = jax_engine.framed_compress(ps["mixed"], backend="host")
    chunks = jax_framing.scan_frames(mixed, len(C.FRAMING_HEADER))
    bad = bytearray(mixed)
    bad[chunks[-1].data_pos] ^= 0x55  # the last chunk's CRC: rank 1's share
    return {
        "mixed": mixed,
        "one_chunk": jax_engine.framed_compress(ps["small"], backend="host"),  # rank 1 takes none
        "bad_crc_second_share": bytes(bad),
        "truncated": mixed[:-3],
        "bad_magic": b"sNaPpY!!!!" + mixed[len(C.FRAMING_HEADER) :],
    }


@pytest.fixture(scope="module")
def cases():
    ps = _payloads()
    return {"payloads": ps, "streams": _streams(ps)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, cases):
    out = tmp_path_factory.mktemp("spans")
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    return wait_group(start_group(WORKER, WORLD, out), out)


def _jax_spans(payload):
    """What snappy_tpu/parallel/multihost.py:83-92 returns on each of two
    processes, without and with the header."""
    span = len(payload) // (WORLD * 65536) * 65536
    blobs = [jax_engine.framed_compress(p, with_header=False, backend="host")
             for p in (payload[:span], payload[span:])]
    lens = [len(b) for b in blobs]
    h = len(C.FRAMING_HEADER)
    plain = [(blobs[pid], sum(lens[:pid]) + h, sum(lens) + h) for pid in range(WORLD)]
    header = [(C.FRAMING_HEADER + blobs[0], 0, sum(lens) + h)] + plain[1:]
    return {False: plain, True: header}


def _jax_decode_span(stream, pid):
    """What snappy_tpu/parallel/multihost.py:105-123 returns on process pid."""
    if not jax_framing.is_snappy_framed_stream(stream):
        return None, 0, 0, "invalid"
    chunks = jax_framing.scan_frames(stream, len(C.FRAMING_HEADER))
    if chunks is None:
        return None, 0, 0, "invalid"
    per = -(-len(chunks) // WORLD)
    mine = chunks[pid * per : (pid + 1) * per]
    out_offset = sum(c.uncompressed_len for c in chunks[: pid * per])
    total = sum(c.uncompressed_len for c in chunks)
    if not mine:
        return b"", out_offset, total, "ok"
    outs, reason = jax_engine.framed_uncompress_chunks(stream, mine, backend="host")
    if outs is None:
        return None, 0, 0, reason
    return b"".join(outs), out_offset, total, "ok"


@pytest.mark.parametrize("with_header", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", PAYLOADS)
def test_compress_span_equals_jax_semantics(ranks, cases, name, backend, with_header):
    payload = cases["payloads"][name]
    want = _jax_spans(payload)[with_header]
    got = [r["compress", name, backend, with_header] for r in ranks]
    assert got == want
    # the blobs at their offsets are one stream: the whole payload's
    stream = bytearray(got[1][2])
    if not with_header:
        stream[: len(C.FRAMING_HEADER)] = C.FRAMING_HEADER
    for blob, off, _ in got:
        stream[off : off + len(blob)] = blob
    assert bytes(stream) == jax_engine.framed_compress(payload, backend="host")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", STREAMS)
def test_uncompress_span_equals_jax_split(ranks, cases, name, backend):
    stream = cases["streams"][name]
    got = [r["uncompress", name, backend] for r in ranks]
    assert got == [_jax_decode_span(stream, pid) for pid in range(WORLD)]
    if name in ("mixed", "one_chunk"):
        out = bytearray(got[0][2])
        for part, off, _, reason in got:
            assert reason == "ok"
            out[off : off + len(part)] = part
        assert bytes(out) == cases["payloads"]["small" if name == "one_chunk" else "mixed"]


def test_lengths_gather_in_rank_order(ranks):
    for r in ranks:
        assert r["lengths"] == [1000, 1001]
        assert r["modules"] == [], "a rank imported jax or snappy_tpu"


def test_single_process_span_api():
    """Without a group the span API is one process's (tests/test_multihost.py:91-104)."""
    assert not dist.is_initialized()
    payload = b"single process span " * 2000
    blob, off, total = multihost.compress_framed_span(payload, device="cpu")
    assert off == len(C.FRAMING_HEADER) and total == off + len(blob)
    stream = C.FRAMING_HEADER + blob
    assert api.decode_framed(stream, device="cpu") == payload
    assert stream == jax_engine.framed_compress(payload, backend="host")
    out, out_off, total_out, reason = multihost.uncompress_framed_span(stream, device="cpu")
    assert (out, out_off, total_out, reason) == (payload, 0, len(payload), "ok")
    assert multihost._allgather_lengths(7).tolist() == [7]


def test_initialize_refuses_a_missing_nccl(monkeypatch):
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    for backend in (None, "nccl"):  # nccl is the default: nothing switches to gloo
        with pytest.raises(RuntimeError):
            multihost.initialize("127.0.0.1:1", 1, 0, backend=backend)
    assert not dist.is_initialized()


def test_initialize_needs_size_and_rank_with_an_address():
    with pytest.raises(ValueError):
        multihost.initialize("127.0.0.1:1", backend="gloo")
    assert not dist.is_initialized()
