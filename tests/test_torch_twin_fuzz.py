"""The coverage-guided fuzzer of the kernels' CPU twins (testing/twin_fuzz.cpp).

The twins of the six kernel sources, traced and under ASan and UBSan, run
clean against the host C decoder, encoder and CRC at a small fixed budget
with a fixed seed, lanes up and lanes down, from seeds that reach K4's
deferred windows and K5's ``unsupported``.  Two planted oracles show that
the fuzzer bites: one that flips a byte of the host decoder's output is
reported as a divergence, and one that writes a byte past it as an ASan
report; either way the fuzzer exits nonzero and leaves the input in its
crash file, on which the true oracle runs clean.  The fuzzer's first run
found one input where K5 and the host decoder part: the empty stream that
declares 0 bytes, which the scan never finishes; the JAX package's stream
decoder gives the same verdict, so the fuzzer holds K5 to it.
"""

import os
import re
import subprocess

import pytest

pytest.importorskip("torch")

from snappy_tpu import engine as jax_engine  # noqa: E402
from snappy_tpu.ops import decode_stream as jax_stream  # noqa: E402

from snappy_tpu_torch import engine  # noqa: E402
from snappy_tpu_torch.formats import varint  # noqa: E402
from snappy_tpu_torch.ops import decode_stream, host_codec  # noqa: E402
from snappy_tpu_torch.testing import fuzz_corpus, payloads, sanitize  # noqa: E402

ITERS = 120
ORACLES = {
    "flip": r"""
#include <stddef.h>
#include <stdint.h>
int stpu_decode_tags(const uint8_t* in, size_t n, uint8_t* out, size_t out_len, size_t* written);
int stpu_fuzz_oracle_decode(const uint8_t* in, size_t n, uint8_t* out, size_t out_len,
                            size_t* written) {
  int rc = stpu_decode_tags(in, n, out, out_len, written);
  if (rc == 0 && *written > 0) out[*written / 2] ^= 1;  /* one wrong byte */
  return rc;
}
""",
    "overflow": r"""
#include <stddef.h>
#include <stdint.h>
int stpu_decode_tags(const uint8_t* in, size_t n, uint8_t* out, size_t out_len, size_t* written);
int stpu_fuzz_oracle_decode(const uint8_t* in, size_t n, uint8_t* out, size_t out_len,
                            size_t* written) {
  int rc = stpu_decode_tags(in, n, out, out_len, written);
  ((volatile uint8_t*)out)[out_len] = 0;  /* one byte past the output */
  return rc;
}
""",
}


@pytest.fixture(scope="module")
def seeds(tmp_path_factory):
    """A few small seeds: text, malformed vectors, a deferred window, a
    far copy (K5's unsupported) and one mutation stream."""
    d = tmp_path_factory.mktemp("seeds")
    files = {"small.txt": fuzz_corpus.generated()["gen_small.txt"]}
    for k in (5, 10, 16, 17):
        files[f"malformed_{k}.snappy"] = payloads.MALFORMED_RAW[k]
    window = payloads.window_cases()
    files["deferred.snappy"] = varint.encode_uint32(window[3][1]) + window[3][0]
    for k, (body, m, _) in enumerate(payloads.scan_edge_cases()[:2]):
        files[f"scan_edge_{k}.snappy"] = varint.encode_uint32(m) + body
    files["mutation.snappy"] = payloads.mutation_streams(1)[0][0]
    paths = []
    for name, blob in files.items():
        (d / name).write_bytes(blob)
        paths.append(d / name)
    return paths


@pytest.fixture(scope="module")
def consts(tmp_path_factory):
    return sanitize.write_consts(tmp_path_factory.mktemp("consts") / "crc_consts.bin")


@pytest.mark.parametrize("order", ["lanes_up", "lanes_down"])
def test_twin_fuzz_runs_clean(seeds, consts, tmp_path, order):
    binary = sanitize.twin_fuzz(order == "lanes_down")
    proc = sanitize.run([binary, consts, *seeds], {"FUZZ_ITERS": str(ITERS), "FUZZ_SEED": "7",
                                                   "FUZZ_CRASH": str(tmp_path / "crash.bin")})
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith(f"twin fuzz OK: {ITERS} iters"), line
    got = {k: int(v) for k, v in re.findall(r"(K\d[\w ]*?|edges|host accepts) (\d+)", line)}
    assert got["host accepts"] > 0 and got["K2"] > 0 and got["K2 big"] > 0, line
    assert got["K4 walk"] > 0 and got["K4 window route"] > 0 and got["K5 window route"] > 0, line
    assert got["K5 unsupported"] > 0 and got["K3 blocks"] > 0 and got["K6 rows"] > 0, line
    assert int(re.search(r"deferred windows in (\d+)", line).group(1)) > 0, line
    assert int(re.search(r"(\d+) edges", line).group(1)) > 500, line
    assert not (tmp_path / "crash.bin").exists()


@pytest.mark.parametrize("oracle,report", [("flip", "twin fuzz: divergence: K4 walk bytes"),
                                           ("overflow", "AddressSanitizer: heap-buffer-overflow")])
def test_a_planted_oracle_fault_is_reported_with_its_input(consts, tmp_path, oracle, report):
    src = tmp_path / f"oracle_{oracle}.c"
    src.write_text(ORACLES[oracle])
    text = fuzz_corpus.generated()["gen_small.txt"]
    seed = tmp_path / "seed.snappy"
    seed.write_bytes(varint.encode_uint32(len(text)) + host_codec.encode_block(text))
    crash = tmp_path / "crash.bin"
    env = {**os.environ, **sanitize.RUN_ENV, "FUZZ_ITERS": "0", "FUZZ_CRASH": str(crash)}
    proc = subprocess.run([str(sanitize.twin_fuzz(oracle=src)), str(consts), str(seed)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and report in proc.stderr, proc.stderr[-3000:]
    assert crash.read_bytes() == seed.read_bytes()
    # the same input against the true oracle: clean
    sanitize.run([sanitize.twin_fuzz(), consts, crash], {"FUZZ_ITERS": "0"})


@pytest.mark.parametrize("mode", ["grid", "scan"])
def test_the_empty_stream_is_invalid_to_the_stream_decoders_as_in_the_reference(mode):
    """A scan step runs only while output remains, so a stream that
    declares 0 bytes is never done: both packages' stream decoders say
    "invalid" where the host decoder accepts it (and the engines, which
    never route it there, say ok)."""
    assert decode_stream.decode_raw_stream_bytes(b"", 0, mode=mode, device="cpu") == (None, "invalid")
    assert jax_stream.decode_raw_stream_bytes(b"", 0, interpret=True, mode=mode) == (None, "invalid")
    assert host_codec.decode_tags(b"", 0) == (b"", 0)
    assert engine.raw_uncompress(b"\x00", device="cpu") == jax_engine.raw_uncompress(b"\x00") == (b"", "ok")
