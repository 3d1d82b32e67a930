"""The port's sanitizer build and its native legs (testing/sanitize.py).

``SNAPPY_TPU_TORCH_SANITIZE`` adds ``-fsanitize=address,undefined`` to the
host library's and the CPU twin's compile and link commands, under names of
their own; a planted out-of-bounds write and a planted signed overflow,
built by the same path, abort with the sanitizers' reports (and pass
unseen without them).  The sanitized ``sanitize_driver.c`` runs clean over
the port's corpus, whose generated part is the bytes of
tools/gen_corpus.py, and the coverage-guided ``fuzz_driver.c`` at a small
budget.  A leg whose tools are missing fails.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from snappy_tpu_torch.ops import _build, host_codec  # noqa: E402
from snappy_tpu_torch.testing import fuzz_corpus, sanitize  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FLAGS = ["-fsanitize=address,undefined", "-fno-sanitize-recover=all", "-g"]

PLANTED = r"""
#include <limits.h>
#include <stdlib.h>
int stpu_planted_overflow(int n) {  /* one byte past a heap buffer */
  volatile char* p = malloc(n);
  p[n] = 1;
  int r = p[0];
  free((void*)p);
  return r;
}
int stpu_planted_signed(int x) { return x + INT_MAX; }
"""


@pytest.fixture
def sanitized(monkeypatch):
    monkeypatch.setenv("SNAPPY_TPU_TORCH_SANITIZE", "1")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return fuzz_corpus.write(tmp_path_factory.mktemp("corpus"), mutation_seeds=2)


def test_sanitize_flags_follow_the_variable(monkeypatch):
    monkeypatch.delenv("SNAPPY_TPU_TORCH_SANITIZE", raising=False)
    assert host_codec.sanitize_flags() == []
    monkeypatch.setenv("SNAPPY_TPU_TORCH_SANITIZE", "1")
    assert host_codec.sanitize_flags() == FLAGS
    # the reference's variable does not move the port
    monkeypatch.delenv("SNAPPY_TPU_TORCH_SANITIZE")
    monkeypatch.setenv("SNAPPY_TPU_SANITIZE", "1")
    assert host_codec.sanitize_flags() == []


def test_cflags_reach_both_commands(monkeypatch):
    monkeypatch.delenv("SNAPPY_TPU_TORCH_SANITIZE", raising=False)
    monkeypatch.setenv("SNAPPY_TPU_TORCH_CFLAGS", "-DSTPU_PROBE=1  -fno-inline")
    compile_cmd, link_cmd = host_codec.build_cmds()
    assert compile_cmd[-2:] == ["-DSTPU_PROBE=1", "-fno-inline"]
    assert link_cmd[-2:] == ["-DSTPU_PROBE=1", "-fno-inline"]


def test_flags_reach_the_build_commands_and_names(monkeypatch, sanitized):
    built = []
    monkeypatch.setattr(_build, "_build", lambda name, cmd, link, *a, **k: built.append((name, cmd, link)))
    host_codec.library_path()
    _build.twin_path()
    _build.twin_path(lanes_down=True)
    names = [name for name, _, _ in built]
    assert names == ["host_codec_san", "twin_cpu_san", "twin_cpu_lanes_down_san"]
    for _, cmd, link in built:
        assert all(f in cmd for f in FLAGS) and all(f in link for f in FLAGS)
    assert "-DSTPU_TWIN_REVERSE_LANES" in built[2][1] and "-DSTPU_TWIN_REVERSE_LANES" not in built[1][1]


def test_sanitized_host_library_is_a_build_of_its_own(monkeypatch):
    monkeypatch.delenv("SNAPPY_TPU_TORCH_SANITIZE", raising=False)
    plain = host_codec.library_path()
    monkeypatch.setenv("SNAPPY_TPU_TORCH_SANITIZE", "1")
    san = host_codec.library_path()
    assert san != plain and san.name.startswith("host_codec_san_") and san.exists()
    assert b"__asan_init" in san.read_bytes() and b"__asan_init" not in plain.read_bytes()


def planted_library(tmp_path) -> Path:
    src = tmp_path / "planted.c"
    src.write_text(PLANTED)
    return _build._build("planted", *host_codec.build_cmds(), [src])


def call(lib: Path, fn: str, arg: int, preload: bool) -> subprocess.CompletedProcess:
    env = {**os.environ, **sanitize.RUN_ENV}
    if preload:
        env["LD_PRELOAD"] = " ".join(sanitize.runtime_libs())
    code = f"import ctypes; print(ctypes.CDLL({str(lib)!r}).{fn}({arg}))"
    return subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("fn,arg,report", [
    ("stpu_planted_overflow", 16, "AddressSanitizer: heap-buffer-overflow"),
    ("stpu_planted_signed", 1, "runtime error: signed integer overflow"),
])
def test_planted_fault_aborts_through_the_build_path(tmp_path, monkeypatch, fn, arg, report):
    """The flags take effect: the fault, built with them by the library's
    own build path, aborts with the report; built without them it runs."""
    monkeypatch.setenv("SNAPPY_TPU_TORCH_SANITIZE", "1")
    proc = call(planted_library(tmp_path), fn, arg, preload=True)
    assert proc.returncode != 0 and report in proc.stderr, proc.stderr[-2000:]
    monkeypatch.delenv("SNAPPY_TPU_TORCH_SANITIZE")
    proc = call(planted_library(tmp_path), fn, arg, preload=False)
    assert proc.returncode == 0 and report not in proc.stderr, proc.stderr[-2000:]


def test_corpus_regimes_are_the_bytes_of_gen_corpus(tmp_path):
    subprocess.run([sys.executable, str(REPO / "tools" / "gen_corpus.py"), str(tmp_path)], check=True,
                   capture_output=True)
    files = fuzz_corpus.generated()
    assert sorted(files) == sorted(p.name for p in tmp_path.iterdir())
    for name, blob in files.items():
        assert (tmp_path / name).read_bytes() == blob, name


def test_sanitize_driver_runs_clean_over_the_corpus(corpus):
    got = sanitize.leg_sanitize_driver(corpus, jobs=2)
    assert got["files"] == len(corpus) >= 8 + 2
    assert "sanitize driver OK" in got["summary"]


def test_fuzz_driver_at_a_small_budget(corpus):
    got = sanitize.leg_fuzz(corpus, 3000)
    assert got["iters"] == 3000 and got["edges"] > 100, got


def test_a_leg_without_its_tools_fails(monkeypatch, capsys):
    monkeypatch.setenv("CC", "/bin/echo")  # a "compiler" that finds no libasan
    with pytest.raises(sanitize.LegFailed, match="libasan"):
        sanitize.runtime_libs()
    assert sanitize.main(["--legs", "2"]) == 1
    assert "leg 2 host_tests: FAILED" in capsys.readouterr().out
