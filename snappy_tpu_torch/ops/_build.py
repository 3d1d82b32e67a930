"""Build and load the kernels' shared library at first use.

JAX counterpart: none; ``snappy_tpu/ops/host_codec._build`` is the model
(a content-hashed shared object loaded with ctypes).

``cuda_lib()`` compiles ``csrc/*.cu`` with nvcc for sm_90a, one nvcc
process per source, all at once, links them into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds) and
loads it with ctypes.  ``twin_lib()`` compiles the same
sources with g++ into the CPU twin that the tests load (with ASan and
UBSan where ``SNAPPY_TPU_TORCH_SANITIZE`` is set); the port's path
never uses it.  Both go to ``build/snappy_tpu_torch/`` at the root of the
checkout, named by a hash of the sources and the commands, under a file
lock so that concurrent test workers do not race the build.
``host_codec`` builds the native C runtime (``native/*.c``) with the same
``_build``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import torch

CSRC = Path(__file__).parent / "csrc"
SOURCES = (
    "crc32c.cu", "crc32c_mma.cu", "decode_chunks.cu", "decode_stream.cu",
    "decode_stream_scan.cu", "encode_blocks.cu",
)
HEADERS = ("snappy_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "snappy_tpu_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

# C entry points and their arguments (pointers and the stream as c_void_p).
# The twin takes the same arguments without the trailing stream.
_ENTRY_POINTS: Dict[str, List] = {
    "crc32c_chunks": [_P, _I64, _P, _I, _I64, _P, _P, _P, _P, _P],
    "crc32c_mma": [_P, _P, _I, _P, _P, _P],
    "decode_chunks": [_P, _P, _P, _I, _P, _I64, _P, _P, _P],
    "decode_stream": [_P, _I64, _I64, _P, _P, _P],
    "decode_stream_windows": [_P, _I64, _I64, _P, _I64, _P, _P, _P, _I, _P],
    "decode_stream_scan": [_P, _I64, _I64, _P, _P, _P, _I64, _P, _I64, _P, _P, _P],
    "encode_blocks": [_P, _I64, _P, _I, _P, _I64, _P, _I, _I, _I, _P, _P, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _build(
    name: str,
    compile_cmd: Union[List[str], List[List[str]]],
    link_cmd: List[str],
    sources: Sequence[Path],
    headers: Sequence[Path] = (),
    salt: str = "",
    suffix: str = ".so",
) -> Path:
    """Build ``sources`` into a shared library in BUILD_DIR, unless one of
    the same sources, headers, commands and ``salt`` (what else the build
    depends on, such as the CPU that ``-march=native`` reads) is there:
    each source compiles in its own process (``compile_cmd -c src -o
    obj``; ``compile_cmd`` may also be a list of commands, one a source),
    all started at once, then ``link_cmd objs -o lib`` joins them (an
    executable, with ``suffix`` "" and no ``-shared``).  The compilers'
    output goes to a ``.log`` beside the result."""
    digest = hashlib.sha256(repr((compile_cmd, link_cmd)).encode() + salt.encode())
    for f in list(sources) + list(headers):
        digest.update(f.read_bytes())
    so = BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}{suffix}"
    cmds = compile_cmd if compile_cmd and isinstance(compile_cmd[0], list) else [compile_cmd] * len(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
                objs = [str(Path(td) / f"{k}_{src.stem}.o") for k, src in enumerate(sources)]
                procs = [
                    subprocess.Popen(
                        cmd + ["-c", str(src), "-o", obj],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                    )
                    for cmd, src, obj in zip(cmds, sources, objs)
                ]
                log = "".join(p.communicate()[0] for p in procs)
                rc = max(p.returncode for p in procs)
                if rc == 0:
                    tmp = Path(td) / "lib.so"
                    link = subprocess.run(
                        link_cmd + objs + ["-o", str(tmp)], capture_output=True, text=True
                    )
                    log += link.stdout + link.stderr
                    rc = link.returncode
                so.with_name(so.name.removesuffix(suffix) + ".log").write_text(log)
                if rc != 0:
                    raise RuntimeError(f"building {name} failed ({rc}):\n" + log[-4000:])
                os.replace(tmp, so)
    return so


def _kernel_build(name: str, compile_cmd: List[str], link_cmd: List[str]) -> Path:
    return _build(
        name, compile_cmd, link_cmd, [CSRC / f for f in SOURCES], [CSRC / f for f in HEADERS]
    )


def _load(so: Path, prefix: str, with_stream: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name, args in _ENTRY_POINTS.items():
        fn = getattr(lib, prefix + name)
        fn.restype = ctypes.c_int
        fn.argtypes = args if with_stream else args[:-1]
    return lib


@functools.cache
def cuda_lib() -> ctypes.CDLL:
    """The kernels for the card (nvcc, sm_90a)."""
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    cmd = [_nvcc(), *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    so = _kernel_build("kernels_sm90a", cmd, [_nvcc(), *arch, "-shared"])
    return _load(so, "stpu_", with_stream=True)


def cuda_build_log() -> str:
    """What nvcc printed when it built ``cuda_lib`` (registers, spills)."""
    logs = sorted(BUILD_DIR.glob("kernels_sm90a_*.log"), key=os.path.getmtime)
    return logs[-1].read_text() if logs else ""


def launch(name: str, device: torch.device, *args) -> None:
    """Call the entry point ``stpu_<name>`` with ``args`` and the current
    stream of ``device``, with ``device`` made current where it is not;
    raise if it reports a CUDA error (a refused launch
    never runs, and a later synchronize would not say so)."""
    fn = getattr(cuda_lib(), "stpu_" + name)
    if device.index is None or device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel: CUDA error {rc} at launch")


def twin_cmds(*extra: str) -> Tuple[List[str], List[str]]:
    """The compile and link commands of a CPU twin build: g++ -O2, the
    sanitizer flags of ``host_codec.sanitize_flags()`` (set by
    ``SNAPPY_TPU_TORCH_SANITIZE``) and ``extra``."""
    from .host_codec import sanitize_flags

    san = sanitize_flags()
    return ["g++", "-std=c++17", "-O2", "-fPIC", *san, *extra], ["g++", "-shared", *san]


def twin_path(lanes_down: bool = False) -> Path:
    """Build the CPU twin of the kernel sources unless it is there; its
    path.  ``lanes_down`` runs each warp's lanes 31 .. 0
    (``-DSTPU_TWIN_REVERSE_LANES``); a sanitized build's name ends in
    ``_san``."""
    from .host_codec import sanitize_flags

    cmd, link = twin_cmds("-x", "c++", *(["-DSTPU_TWIN_REVERSE_LANES"] if lanes_down else []))
    name = "twin_cpu" + ("_lanes_down" if lanes_down else "") + ("_san" if sanitize_flags() else "")
    return _kernel_build(name, cmd, link)


@functools.cache
def twin_lib(lanes_down: bool = False) -> ctypes.CDLL:
    """The CPU twin of the same sources (g++), lanes up or down, for the
    tests only."""
    return _load(twin_path(lanes_down), "stpu_twin_", with_stream=False)
