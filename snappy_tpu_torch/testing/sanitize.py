"""The sanitizer and fuzz legs of the port's native code: the host C and the
kernels' CPU twins under ASan and UBSan, and coverage-guided fuzzing.

JAX counterpart: tools/sanitize_tests.sh and tools/fuzz_coverage.sh, which
exempt the device path ("no native code of ours").  In the port the device
path is native code: the six CUDA sources, whose per-chunk bodies g++
compiles into the CPU twin.  So the legs here take in the twin as well:

1. ``sanitize_driver``: ``ops/native/sanitize_driver.c`` with the host C, built
   with ``-fsanitize=address,undefined``, over the corpus (round trips and
   20,000 mutations of each file);
2. ``host_tests``: the port's host-path tests with the host library built
   sanitized (``SNAPPY_TPU_TORCH_SANITIZE=1``), on the host backend, with
   libasan and libubsan preloaded;
3. ``twin_tests``: the twin tests with the twin built sanitized, the same
   way;
4. ``fuzz``: ``ops/native/fuzz_driver.c``, coverage-guided: the host C
   built with ``-fsanitize-coverage=trace-pc`` besides the sanitizers,
   ``fuzz_driver.c`` itself without;
5. ``twin_fuzz``: ``testing/twin_fuzz.cpp`` the same way, the twins traced
   and the host C their oracle, with the warps' lanes run up and down.

    python -m snappy_tpu_torch.testing.sanitize [--iters N] [--legs 1,4,5] [--jobs N]

``--iters`` (or ``FUZZ_ITERS``) is the budget of legs 4 and 5, by default
``FUZZ_DEFAULT`` and ``TWIN_FUZZ_DEFAULT``.  Each leg prints its time and,
for the fuzzers, iterations and edges.  A leg whose tools are missing
fails (the JAX script exits 0 without libasan), and so does any sanitizer
report or divergence; the exit code is then 1.  Builds go to
``build/snappy_tpu_torch/`` through ``_build._build``; the corpus is
written by ``testing/fuzz_corpus.py`` into a temporary directory.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops import _build, crc32c, crc32c_mma, host_codec
from . import fuzz_corpus

HERE = Path(__file__).resolve().parent
TESTS = HERE.parents[1] / "tests"
SAN = ["-fsanitize=address,undefined", "-fno-sanitize-recover=all"]
RUN_ENV = {"ASAN_OPTIONS": "abort_on_error=1:detect_leaks=0",
           "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1"}
FUZZ_DEFAULT = 100_000  # fuzz_driver.c's iterations (tools/sanitize_tests.sh's)
TWIN_FUZZ_DEFAULT = 3_000  # twin_fuzz.cpp's iterations, per lane order
HOST_TESTS = ("test_torch_host_codec.py", "test_torch_host_codec_runtime.py",
              "test_torch_formats.py", "test_torch_framed.py", "test_torch_backends.py")
TWIN_TESTS = ("test_torch_decode_warp.py", "test_torch_encode_warp.py",
              "test_torch_crc32c_warp.py", "test_torch_crc32c_mma.py",
              "test_torch_stream_windows.py", "test_torch_stream_scan_windows.py",
              "test_torch_decode.py", "test_torch_stream.py", "test_torch_stream_scan.py")
# checks the device backend's refusal of "cuda" without a card, which the
# host backend that leg 2 sets never reaches
HOST_DESELECT = ("test_torch_framed.py::test_cuda_without_a_card_raises",)
LEGS = ("sanitize_driver", "host_tests", "twin_tests", "fuzz", "twin_fuzz")


class LegFailed(RuntimeError):
    pass


def _cc() -> str:
    return os.environ.get("CC", "cc")


def runtime_libs() -> List[str]:
    """libasan and libubsan of the C compiler, to preload into a Python
    process that loads a sanitized library; raises where one is missing."""
    libs = []
    for name in ("libasan.so", "libubsan.so"):
        found = subprocess.run([_cc(), f"-print-file-name={name}"], capture_output=True,
                               text=True).stdout.strip()
        if not found or not Path(found).exists():
            raise LegFailed(f"{name} not found by {_cc()}: the sanitizer legs need it")
        libs.append(found)
    return libs


def _native(*names: str) -> List[Path]:
    return [host_codec.NATIVE / n for n in names]


def sanitize_driver() -> Path:
    """``sanitize_driver.c`` and the host C, all sanitized (one binary)."""
    cmd = [_cc(), "-O1", "-g", *SAN]
    return _build._build("sanitize_driver", cmd, cmd, _native("sanitize_driver.c", *host_codec.SOURCES),
                         suffix="")


def fuzz_driver() -> Path:
    """``fuzz_driver.c`` with the host C traced (tools/fuzz_coverage.sh:24-31)."""
    cmd = [_cc(), "-O1", "-g", *SAN]
    traced = cmd + ["-fsanitize-coverage=trace-pc"]
    return _build._build("fuzz_driver", [cmd, traced, traced], cmd,
                         _native("fuzz_driver.c", *host_codec.SOURCES), suffix="")


def twin_fuzz(lanes_down: bool = False, oracle: Optional[Path] = None) -> Path:
    """``twin_fuzz.cpp`` with the kernels' twins traced and the host C as
    the oracle.  ``oracle``: a C file whose ``stpu_fuzz_oracle_decode``
    takes the place of ``stpu_decode_tags`` as the decoder held against
    the kernels (the tests plant a wrong one)."""
    cxx = ["g++", "-std=c++17", "-O1", "-g", *SAN]
    # -O2 for the twins: their 32-lane warps are most of the fuzzer's time
    twin = ["g++", "-std=c++17", "-O2", "-g", *SAN, "-fsanitize-coverage=trace-pc", "-x", "c++"]
    if lanes_down:
        twin.append("-DSTPU_TWIN_REVERSE_LANES")
    harness = cxx + (["-DSTPU_FUZZ_ORACLE_DECODE=stpu_fuzz_oracle_decode"] if oracle else [])
    host = [_cc(), "-O1", "-g", *SAN]
    sources = [_build.CSRC / f for f in _build.SOURCES] + _native(*host_codec.SOURCES)
    cmds = [twin] * len(_build.SOURCES) + [host] * len(host_codec.SOURCES) + [harness]
    sources.append(HERE / "twin_fuzz.cpp")
    if oracle is not None:
        sources.append(Path(oracle))
        cmds.append(host)
    name = "twin_fuzz" + ("_lanes_down" if lanes_down else "") + ("_oracle" if oracle else "")
    return _build._build(name, cmds, ["g++", *SAN], sources,
                         [_build.CSRC / f for f in _build.HEADERS], suffix="")


def write_consts(path) -> Path:
    """K1's slicing and advance tables, then K6's constants, as uint32
    little-endian: twin_fuzz.cpp's first argument."""
    words = np.concatenate([crc32c.tables().reshape(-1), crc32c.adv_tables().reshape(-1),
                            crc32c_mma.consts()]).astype("<u4")
    Path(path).write_bytes(words.tobytes())
    return Path(path)


def run(cmd: Sequence[str], env: Optional[Dict[str, str]] = None, timeout: float = 3600,
        cwd: Optional[Path] = None) -> subprocess.CompletedProcess:
    """Run a leg's command with the sanitizers' options; raise LegFailed,
    with the end of its output, unless it exits 0."""
    full = {**os.environ, **RUN_ENV, **(env or {})}
    proc = subprocess.run(list(map(str, cmd)), env=full, capture_output=True, text=True,
                          timeout=timeout, cwd=cwd)
    if proc.returncode != 0:
        raise LegFailed(f"{Path(str(cmd[0])).name} exited {proc.returncode}:\n"
                        + (proc.stdout + proc.stderr)[-6000:])
    return proc


def _fuzz_numbers(line: str) -> Dict[str, int]:
    iters = re.search(r"(\d+) iters", line)
    edges = re.search(r"(\d+) edges", line)
    return {"iters": int(iters.group(1)) if iters else -1,
            "edges": int(edges.group(1)) if edges else -1}


def leg_sanitize_driver(files: Sequence[Path], jobs: int = 1) -> Dict:
    """Leg 1: the sanitized sanitize_driver.c over ``files``, one process
    a file, ``jobs`` at a time."""
    binary = sanitize_driver()
    largest_first = sorted(files, key=lambda f: -Path(f).stat().st_size)
    with ThreadPoolExecutor(max(1, jobs)) as pool:
        procs = list(pool.map(lambda f: run([binary, f]), largest_first))
    return {"files": len(files), "summary": procs[0].stdout.strip().splitlines()[-1]}


def leg_fuzz(files: Sequence[Path], iters: int) -> Dict:
    """Leg 4: fuzz_driver.c at ``iters`` iterations."""
    proc = run([fuzz_driver(), *files], {"FUZZ_ITERS": str(iters)})
    line = proc.stdout.strip().splitlines()[-1]
    return {**_fuzz_numbers(line), "summary": line}


def leg_twin_fuzz(files: Sequence[Path], iters: int, consts: Path, seed: int = 1,
                  crash_dir: Optional[Path] = None) -> Dict:
    """Leg 5: twin_fuzz.cpp at ``iters`` iterations, lanes up and lanes
    down at once.  A crash input goes to ``crash_dir``, by default the
    build directory."""
    crash_dir = Path(crash_dir or _build.BUILD_DIR)
    binaries = {order: twin_fuzz(order == "lanes_down") for order in ("lanes_up", "lanes_down")}

    def one(order):
        env = {"FUZZ_ITERS": str(iters), "FUZZ_SEED": str(seed),
               "FUZZ_CRASH": str(crash_dir / f"twin_fuzz_crash_{order}.bin")}
        line = run([binaries[order], consts, *files], env).stdout.strip().splitlines()[-1]
        return order, {**_fuzz_numbers(line), "summary": line}

    with ThreadPoolExecutor(2) as pool:
        return dict(pool.map(one, binaries))


def leg_pytest(files: Sequence[str], env: Dict[str, str], jobs: int = 1,
               deselect: Sequence[str] = ()) -> Dict:
    """Legs 2 and 3: pytest on ``files`` of tests/ with the sanitized
    builds (``SNAPPY_TPU_TORCH_SANITIZE=1``) and libasan and libubsan
    preloaded, less the ``deselect`` test ids."""
    paths = [TESTS / f for f in files]
    missing = [str(p) for p in paths if not p.exists()]
    if missing:
        raise LegFailed(f"test files not found: {missing}")
    env = {"SNAPPY_TPU_TORCH_SANITIZE": "1", "LD_PRELOAD": " ".join(runtime_libs()), **env}
    cmd = [sys.executable, "-m", "pytest", *map(str, paths), "-q", "-p", "no:cacheprovider",
           "-m", "not slow", *[f"--deselect=tests/{t}" for t in deselect]]
    if jobs > 1:
        cmd += ["-p", "xdist", "-n", str(jobs), "--dist", "loadfile"]
    proc = run(cmd, env, cwd=TESTS.parent)
    return {"summary": proc.stdout.strip().splitlines()[-1:]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=None,
                    help="iterations of the fuzz legs (default: FUZZ_ITERS, else per leg)")
    ap.add_argument("--legs", default="1,2,3,4,5", help="legs to run, by number")
    ap.add_argument("--jobs", type=int, default=min(4, os.cpu_count() or 1),
                    help="processes of legs 1, 2 and 3")
    ap.add_argument("--seed", type=int, default=1, help="twin_fuzz.cpp's mutation seed")
    args = ap.parse_args(argv)
    env_iters = os.environ.get("FUZZ_ITERS")
    iters = args.iters if args.iters is not None else int(env_iters) if env_iters else None
    chosen = [LEGS[int(k) - 1] for k in args.legs.split(",")]
    # this process loads no sanitized library: the legs' processes do
    os.environ.pop("SNAPPY_TPU_TORCH_SANITIZE", None)
    failed = []
    with tempfile.TemporaryDirectory(prefix="stpu_sanitize_") as td:
        made = {}

        def corpus(kernel_seeds: bool = False) -> List[Path]:
            """The corpus, written at first use; with the twin fuzz's seeds."""
            if not made:
                made["corpus"] = fuzz_corpus.write(Path(td) / "corpus")
                made["seeds"] = made["corpus"] + fuzz_corpus.kernel_seeds(Path(td) / "kernel_seeds")
                print(f"sanitize: corpus of {len(made['corpus'])} files (twin fuzz: "
                      f"{len(made['seeds'])} seeds), {os.cpu_count()} CPUs", flush=True)
            return made["seeds" if kernel_seeds else "corpus"]

        legs = {
            "sanitize_driver": lambda: leg_sanitize_driver(corpus(), args.jobs),
            "host_tests": lambda: leg_pytest(HOST_TESTS, {"SNAPPY_TPU_TORCH_BACKEND": "host"}, args.jobs,
                                             HOST_DESELECT),
            "twin_tests": lambda: leg_pytest(TWIN_TESTS, {}, args.jobs),
            "fuzz": lambda: leg_fuzz(corpus(), iters or FUZZ_DEFAULT),
            "twin_fuzz": lambda: leg_twin_fuzz(corpus(True), iters or TWIN_FUZZ_DEFAULT,
                                               write_consts(Path(td) / "crc_consts.bin"), args.seed),
        }
        for name in chosen:
            t = time.perf_counter()
            try:
                result = legs[name]()
                status = "ok"
            except (LegFailed, subprocess.TimeoutExpired, OSError, RuntimeError) as e:
                result, status = {"error": str(e)}, "FAILED"
                failed.append(name)
            print(f"sanitize: leg {LEGS.index(name) + 1} {name}: {status} in "
                  f"{time.perf_counter() - t:.1f} s: {result}", flush=True)
    print("sanitize: " + (f"FAILED legs {failed}" if failed else f"legs {chosen} clean"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
