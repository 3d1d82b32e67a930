"""ctypes binding to the real google/snappy: the third-party differential.

JAX counterpart: snappy_tpu/testing/cpp_snappy.py (the same four C
functions and ``decode_into``, with the same ``None`` rules).

The reference's C++ shim (nim-snappy tests/cpp_snappy.nim:6-45) links
libsnappy and imports its C API: ``snappy_compress``,
``snappy_uncompress``, ``snappy_max_compressed_length`` and
``snappy_uncompressed_length``.  Here they come from the system's
``libsnappy.so.1`` (google/snappy 1.1.x).  An encoder and a decoder written
apart from the port's host C and kernels check both directions: every
stream google/snappy writes must decode on every route of the port, every
stream the port writes must decode with google/snappy, and on any input
both must accept or reject together and agree on the bytes.

Test support only: no path of the codec imports it.  Raw format only:
google/snappy's C API has no framed format.  ``available()`` says whether
the library loads; the other calls raise ``RuntimeError`` where it does
not.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Optional

import numpy as np

_SNAPPY_OK = 0

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    candidates = []
    found = ctypes.util.find_library("snappy")
    if found:
        candidates.append(found)
    candidates += ["libsnappy.so.1", "libsnappy.so"]
    for name in candidates:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        try:
            for fn in (lib.snappy_compress, lib.snappy_uncompress):
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_size_t)]
            lib.snappy_max_compressed_length.restype = ctypes.c_size_t
            lib.snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
            lib.snappy_uncompressed_length.restype = ctypes.c_int
            lib.snappy_uncompressed_length.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
            ]
        except AttributeError:
            continue
        _lib = lib
        break
    return _lib


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError("the google/snappy shared library (libsnappy.so.1) does not load")
    return lib


def available() -> bool:
    """True when the google/snappy shared library loads."""
    return _load() is not None


class _DlInfo(ctypes.Structure):
    _fields_ = [("dli_fname", ctypes.c_char_p), ("dli_fbase", ctypes.c_void_p),
                ("dli_sname", ctypes.c_char_p), ("dli_saddr", ctypes.c_void_p)]


def version() -> Optional[str]:
    """The loaded library's file, its soname resolved (for example
    ``.../libsnappy.so.1.1.9``): google/snappy has no version call, and
    its release is the name's suffix.  None where the library does not
    load or the loader cannot say."""
    lib = _load()
    if lib is None:
        return None
    info = _DlInfo()
    for host in (None, "libdl.so.2"):  # dladdr: in libc from glibc 2.34, in libdl before
        try:
            dladdr = ctypes.CDLL(host).dladdr
        except (OSError, AttributeError):
            continue
        dladdr.restype = ctypes.c_int
        dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(_DlInfo)]
        if dladdr(ctypes.cast(lib.snappy_compress, ctypes.c_void_p), ctypes.byref(info)) and info.dli_fname:
            return os.path.realpath(info.dli_fname.decode())
    return None


def max_compressed_length(n: int) -> int:
    return int(_need().snappy_max_compressed_length(n))


def encode(data: bytes) -> bytes:
    """Compress with google/snappy (cpp_snappy.nim:13-27)."""
    lib = _need()
    out_len = ctypes.c_size_t(lib.snappy_max_compressed_length(len(data)))
    out = ctypes.create_string_buffer(out_len.value)
    rc = lib.snappy_compress(bytes(data), len(data), out, ctypes.byref(out_len))
    if rc != _SNAPPY_OK:
        raise RuntimeError(f"snappy_compress failed: {rc}")
    return out.raw[: out_len.value]


def uncompressed_length(data: bytes) -> Optional[int]:
    """The declared length of a raw stream, or None where google/snappy
    cannot read it."""
    n = ctypes.c_size_t(0)
    rc = _need().snappy_uncompressed_length(bytes(data), len(data), ctypes.byref(n))
    if rc != _SNAPPY_OK:
        return None
    return int(n.value)


def decode(data: bytes) -> Optional[bytes]:
    """Decompress with google/snappy; None when it rejects the input
    (cpp_snappy.nim:29-45, where the shim returns an empty seq).  The
    output buffer is the declared length, left unwritten until the library
    writes it, so a bad stream declaring gigabytes costs no memory it does
    not decode into."""
    lib = _need()
    data = bytes(data)
    declared = uncompressed_length(data)
    if declared is None:
        return None
    out = np.empty(max(1, declared), dtype=np.uint8)
    out_len = ctypes.c_size_t(declared)
    rc = lib.snappy_uncompress(data, len(data), out.ctypes.data, ctypes.byref(out_len))
    if rc != _SNAPPY_OK:
        return None
    return out[: out_len.value].tobytes()


def decode_into(data: bytes, out) -> Optional[int]:
    """Decompress with google/snappy into a writable buffer of the caller
    (bytearray, numpy array, writable memoryview); returns the written
    length, or None where the library rejects the input or the buffer is
    too small.  The reused-buffer form of ``decode``, for a benchmark's
    clock-for-clock control."""
    lib = _need()
    buf = (ctypes.c_char * len(out)).from_buffer(out)
    out_len = ctypes.c_size_t(len(out))
    rc = lib.snappy_uncompress(bytes(data), len(data), buf, ctypes.byref(out_len))
    if rc != _SNAPPY_OK:
        return None
    return out_len.value
