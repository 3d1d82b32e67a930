"""The port's third-party differential on the CPU: the real google/snappy
(the system's ``libsnappy.so.1``, through ``testing/cpp_snappy.py``)
against every decode and encode route of the port, beside its plain
oracle (``testing/oracle.py``) and the pins that chip_smoke.py's phase 13
holds the card to (``testing/cpp_pins.json``).

JAX counterpart: tests/test_cpp_differential.py.  Cross-decoding in both
directions on the host backend and on the device backend (``device="cpu"``:
the kernels' plain versions) on both device routes, in grid and scan
mode; accept/reject and bytes on google/snappy's verdicts over the 600
mutation streams, google/snappy's seed streams and their mutants, and the
far-copy battery, on every route of ``cpp_differential.ROUTES``, the host
C decoder and the oracle; ``decode_into``; the port's binding and oracle
against the JAX package's on seeded inputs; imports.  Skips only where
the library does not load.
"""

import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snappy_tpu.testing import corpus as jax_corpus  # noqa: E402
from snappy_tpu.testing import cpp_snappy as jax_cpp  # noqa: E402
from snappy_tpu.testing import oracle as jax_oracle  # noqa: E402

from snappy_tpu_torch import engine  # noqa: E402
from snappy_tpu_torch.formats import varint  # noqa: E402
from snappy_tpu_torch.ops import decode_stream  # noqa: E402
from snappy_tpu_torch.testing import corpus, cpp_snappy, oracle, payloads  # noqa: E402
from snappy_tpu_torch.testing import cpp_differential as cd  # noqa: E402

CROSS_ROUTES = ("host", "scalar grid", "scalar scan", "array")
FARCOPY_CPU = 6  # the far-copy battery's first streams, two of each kind
# the slower routes take every 4th mutation stream on the CPU
SPARSE = ("decode scan", "K5", "array")


@pytest.fixture(autouse=True)
def library():
    if not cpp_snappy.available():
        pytest.skip("google/snappy (libsnappy.so.1) does not load")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread here: the array route's many small tensor ops
    on a pool of threads per core crawl when other test workers hold the
    cores (a 3 KB encode took 6.8 s instead of 0.06 s on busy cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _payload(rng: random.Random, n: int) -> bytes:
    """Half a repeated word, then random bytes (the JAX differential's
    ``TestRandomCross._payload``)."""
    word = bytes(rng.getrandbits(8) for _ in range(rng.randrange(2, 17)))
    rep = (word * (n // len(word) + 1))[: n // 2]
    return rep + bytes(rng.getrandbits(8) for _ in range(n - len(rep)))


@pytest.fixture(scope="module")
def cross():
    """40 seeded payloads of 0-3,999 bytes, and two that decode above
    128 KiB (the streaming decoders): the mixed payload of 200 KB and the
    largest seed payload."""
    rng = random.Random(424242)
    small = [_payload(rng, rng.randrange(0, 4000)) for _ in range(40)]
    return small + [payloads.mixed_payload(200_000, 7), cd.seed_payloads()[-1]]


@pytest.fixture(scope="module")
def pins():
    return cd.load_pins()


@pytest.fixture(scope="module")
def sets(pins):
    sets = cd.battery(pins["seeds"])
    sets["farcopy"] = sets["farcopy"][:FARCOPY_CPU]
    return {name: [s for s, _ in streams] for name, streams in sets.items()}


def decode_on(route: str, stream: bytes):
    if route == "host":
        return engine.raw_uncompress(stream, backend="host")[0]
    name, value = (("SNAPPY_TPU_TORCH_DEVICE_KERNEL", "xla") if route == "array"
                   else ("SNAPPY_TPU_TORCH_STREAM_MODE", route.split()[1]))
    with cd.env(name, value):
        return engine.raw_uncompress(stream, device="cpu", backend="device")[0]


def encode_on(route: str, data: bytes, level: int) -> bytes:
    if route == "host":
        return engine.raw_compress(data, level, backend="host")
    with cd.env("SNAPPY_TPU_TORCH_DEVICE_KERNEL", "xla" if route == "array" else "scalar"):
        return engine.raw_compress(data, level, device="cpu", backend="device")


@pytest.mark.parametrize("route", CROSS_ROUTES)
def test_google_streams_decode_on_every_route(route, cross):
    for k, p in enumerate(cross):
        assert decode_on(route, cpp_snappy.encode(p)) == p, (route, k, len(p))


@pytest.mark.parametrize("route", ("host", "scalar", "array"))
def test_google_decodes_every_port_encoding(route, cross):
    """Levels 1 and 2 (the array route ignores the level), and
    ``encode_batch``'s bytes on the device routes: on the array route of a
    few payloads, since its CPU slabs are slow under a loaded machine."""
    for level in (1,) if route == "array" else (1, 2):
        for k, p in enumerate(cross):
            assert cpp_snappy.decode(encode_on(route, p, level)) == p, (route, level, k, len(p))
    if route != "host":
        batch_in = cross[::10] if route == "array" else cross
        with cd.env("SNAPPY_TPU_TORCH_DEVICE_KERNEL", "xla" if route == "array" else "scalar"):
            batch = engine.raw_compress_batch(batch_in, device="cpu", backend="device")
        assert [cpp_snappy.decode(s) for s in batch] == batch_in, route


def test_google_streams_keep_their_windows(cross):
    """google/snappy writes every 64 KiB block on its own, so the window
    index builds on its streams (both modes take their window route), and
    scan mode serves every copy of them."""
    for p in cross[-2:]:
        body = payloads.body_of(cpp_snappy.encode(p))
        offs = decode_stream.window_index(body, len(p))
        assert offs is not None and len(offs) == decode_stream.window_count(len(p)) + 1
        assert decode_stream.decode_raw_stream_bytes(body, len(p), mode="scan", device="cpu") == (p, "ok")


@pytest.mark.parametrize("route", cd.ROUTES + ("host C", "oracle"))
@pytest.mark.parametrize("name", cd.SETS)
def test_agrees_with_google(name, route, sets, pins):
    """Verdicts and bytes equal google/snappy's (pinned, and checked
    against the library by ``test_pins_equal_the_library``) on every
    stream: 0 disagreements."""
    streams, want = sets[name], pins["verdicts"][name]
    step = 4 if name == "mutation_streams" and route in SPARSE + ("oracle",) else 1
    idx = list(range(0, len(streams), step))
    if route == "host C":
        outs = [payloads.host_raw_decode(streams[i]) for i in idx]
    elif route == "oracle":
        outs = [oracle.uncompress(streams[i])[0] for i in idx]
    else:
        sub, outs, firsts = cd.run_route(route, [streams[i] for i in idx], "cpu")
        idx = [idx[i] for i in sub]
        if route in ("K4", "K5"):  # every stream of these sets declares 1 B to 64 MiB
            assert len(idx) == len(range(0, len(streams), step)), route
        if route == "K5" and name == "farcopy":  # the kinds of the battery, in turn
            assert firsts == ["ok", "unsupported", "unsupported"] * (FARCOPY_CPU // 3), firsts
    assert cd.disagreements(want, idx, outs) == []
    accepted = sum(o is not None for o in outs)
    assert accepted > 0 and (name == "farcopy" or accepted < len(outs)), (name, route, accepted)


def test_pins_equal_the_library(pins):
    seeds = cd.seed_payloads()
    assert [cpp_snappy.decode(s) for s in pins["seeds"]] == seeds
    if cpp_snappy.version().rsplit("/", 1)[-1] == pins["library"]:  # an encoder's bytes are its release's
        assert [cpp_snappy.encode(p) for p in seeds] == pins["seeds"]
    for name, streams in cd.battery(pins["seeds"]).items():
        assert [cd.digest(cpp_snappy.decode(s)) for s, _ in streams] == pins["verdicts"][name], name


def test_pinned_port_streams_equal_the_library(pins):
    """The pins of the port's 48 MiB streams (phase 13's pinned part (b)):
    the only input of this file above 1 MiB, on the host backend and
    google/snappy alone (about 4 s)."""
    payload = payloads.mixed_payload()
    port = pins["port_streams"]
    for name, level in (("raw_l1", 1), ("raw_l2", 2)):
        s = engine.raw_compress(payload, level, backend="host")
        assert (len(s), cd.digest(s)) == (port[name]["len"], port[name]["sha256"]), name
        assert port[name]["google_decodes"] and cpp_snappy.decode(s) == payload, name
    assert (port["array"]["len"], port["array"]["sha256"]) == (payloads.RAW_XLA_LEN, payloads.RAW_XLA_SHA256)
    assert port["array"]["google_decodes"]
    inputs = []

    def encode_inputs(ps):
        inputs.extend(ps)
        return [engine.raw_compress(p, backend="host") for p in ps]

    payloads.serving_batch(encode_inputs)
    batch = [engine.raw_compress(p, backend="host") for p in inputs]
    assert (sum(map(len, batch)), cd.list_digest(batch)) == \
        (port["encode_batch"]["len"], port["encode_batch"]["sha256"])
    assert port["encode_batch"]["google_decodes"]
    assert pins["google_sizes"] == {"payload": len(cpp_snappy.encode(payload)),
                                    "serving_inputs": sum(len(cpp_snappy.encode(p)) for p in inputs)}


def test_farcopy_battery_construction(pins):
    """The battery's first streams, two of each kind: each decodes to the
    payload it was built from with the oracle, the host C and
    google/snappy; kinds 0 and 1 keep the window index (K4's window
    route), kind 2 has none (the whole-stream walk)."""
    cases = payloads.farcopy_placement_cases(count=FARCOPY_CPU)
    for k, (s, p) in enumerate(cases):
        assert oracle.uncompress(s) == (p, None), k
        assert payloads.host_raw_decode(s) == p and cpp_snappy.decode(s) == p, k
        assert pins["verdicts"]["farcopy"][k] == cd.digest(p), k
        declared, read = varint.decode_uint32(s)
        assert declared > 128 << 10, k  # the raw decode takes the streaming decoders
        assert (decode_stream.window_index(s[read:], declared) is None) == (k % 3 == 2), k
    assert payloads.farcopy_placement_cases(count=48)[:FARCOPY_CPU] == cases


def test_decode_into():
    """The reused-buffer control: exact bytes into the caller's buffer,
    None on malformed input, a buffer too small refused, not overrun."""
    data = payloads.mixed_payload(100_000, 3)
    enc = cpp_snappy.encode(data)
    out = bytearray(len(data) + 7)
    for _ in range(2):  # the same buffer again
        assert cpp_snappy.decode_into(enc, out) == len(data) and bytes(out[: len(data)]) == data
    arr = np.zeros(len(data), dtype=np.uint8)
    assert cpp_snappy.decode_into(enc, arr) == len(data) and arr.tobytes() == data
    assert cpp_snappy.decode_into(b"\xff\xff\xff\xff\xff", out) is None
    small = bytearray(len(data) - 1)
    assert cpp_snappy.decode_into(enc, small) is None
    assert jax_cpp.decode_into(enc, bytearray(len(data) - 1)) is None


def test_binding_equals_the_jax_binding():
    rng = np.random.default_rng(5)
    streams = []
    for k in range(60):
        n = int(rng.integers(0, 70_000 if k % 10 else 300_000))
        word = rng.integers(0, 256, int(rng.integers(1, 9)), dtype=np.uint8).tobytes()
        data = (word * (n // len(word) + 1))[: n // 3] + rng.integers(0, 256, n - n // 3, dtype=np.uint8).tobytes()
        enc = cpp_snappy.encode(data)
        assert enc == jax_cpp.encode(data), k
        assert cpp_snappy.max_compressed_length(n) == jax_cpp.max_compressed_length(n)
        streams += [enc] + [payloads.mutate(enc, kind, payloads.Rand(k)) for kind in payloads.MUTATIONS
                            if len(enc) > 2]
    streams += payloads.MALFORMED_RAW
    for s in streams:
        assert cpp_snappy.uncompressed_length(s) == jax_cpp.uncompressed_length(s)
        assert cpp_snappy.decode(s) == jax_cpp.decode(s)
    assert cpp_snappy.available() == jax_cpp.available()


def test_oracle_equals_the_jax_oracle():
    rng = random.Random(77)
    streams = list(payloads.MALFORMED_RAW)
    for k in range(40):
        data = _payload(rng, rng.randrange(0, 9000 if k % 8 else 140_000))
        enc = oracle.compress(data)
        assert enc == jax_oracle.compress(data), k
        assert oracle.encode_block(data[:65536]) == jax_oracle.encode_block(data[:65536])
        streams += [enc] + [payloads.mutate(enc, kind, payloads.Rand(k)) for kind in payloads.MUTATIONS
                            if len(enc) > 2]
    for s in streams:
        out, err = oracle.uncompress(s)
        want, want_err = jax_oracle.uncompress(s)
        assert out == want and (err and err.name) == (want_err and want_err.name), s[:16]
        got = oracle.decode_all_tags(s, 70_000)
        ref = jax_oracle.decode_all_tags(s, 70_000)
        assert got[0] == ref[0] and (got[1] and got[1].name) == (ref[1] and ref[1].name)


def test_version_names_the_loaded_library():
    path = cpp_snappy.version()
    assert path is not None and path.rsplit("/", 1)[-1].startswith("libsnappy.so")


def test_corpus_locators(tmp_path, monkeypatch):
    for name in ("CORPUS_FILES", "BAD_FILES", "STREAM_FILES", "GOLDEN_RAWSNAPPY"):
        assert getattr(corpus, name) == getattr(jax_corpus, name), name
    monkeypatch.delenv("SNAPPY_TPU_TORCH_CORPUS", raising=False)
    assert corpus.corpus_root() is None and corpus.read_data("html") is None
    assert corpus.available_corpus() == []
    (tmp_path / "data").mkdir()
    (tmp_path / "stream_compressed").mkdir()
    (tmp_path / "data" / "html").write_bytes(b"<html>")
    (tmp_path / "stream_compressed" / "alice29.txt.sz-32k").write_bytes(b"\xff")
    monkeypatch.setenv("SNAPPY_TPU_TORCH_CORPUS", str(tmp_path))
    assert corpus.corpus_root() == tmp_path
    assert corpus.read_data("html") == b"<html>" and corpus.read_data("urls.10K") is None
    assert corpus.read_stream("alice29.txt.sz-32k") == b"\xff"
    assert corpus.available_corpus() == ["html"]


def test_imports_load_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "from snappy_tpu_torch.testing import cpp_snappy, oracle, corpus, cpp_differential\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'snappy_tpu')))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=str(cd.PINS.parents[2]))
    assert res.stdout.strip() == "[]", res.stdout
