"""The port's wire-format layer against snappy_tpu.formats (exact).

snappy_tpu_torch.formats is a copy of snappy_tpu.formats (the JAX package's
formats import jax through snappy_tpu/__init__.py); these pin the copy to
the original on hypothesis-fuzzed inputs, and pin that the port imports
with jax unavailable.
"""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import snappy_tpu  # noqa: E402
from snappy_tpu.formats import constants as JC  # noqa: E402
from snappy_tpu.formats import errors as JE  # noqa: E402
from snappy_tpu.formats import framing as JF  # noqa: E402
from snappy_tpu.formats import varint as JV  # noqa: E402

import snappy_tpu_torch  # noqa: E402
from snappy_tpu_torch.formats import constants as C  # noqa: E402
from snappy_tpu_torch.formats import errors as E  # noqa: E402
from snappy_tpu_torch.formats import framing as F  # noqa: E402
from snappy_tpu_torch.formats import varint as V  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_constants_equal():
    names = [n for n in dir(JC) if n.isupper()]
    assert names and names == [n for n in dir(C) if n.isupper()]
    for n in names:
        assert getattr(C, n) == getattr(JC, n), n


def test_error_enums_equal():
    for enum_name in ("CodecError", "FrameError"):
        ours, theirs = getattr(E, enum_name), getattr(JE, enum_name)
        assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in theirs]


def test_version_matches_jax_package():
    assert snappy_tpu_torch.__version__ == snappy_tpu.__version__ == "0.6.0"


@settings(max_examples=300, deadline=None)
@given(st.integers(min_value=0, max_value=(1 << 34)))
def test_max_compressed_len(n):
    assert C.max_compressed_len(n) == JC.max_compressed_len(n)
    assert C.max_compressed_len_framed(n) == JC.max_compressed_len_framed(n)


@settings(max_examples=300, deadline=None)
@given(st.integers(min_value=0, max_value=0xFFFF_FFFF), st.binary(max_size=12))
def test_varint(value, raw):
    assert V.encode_uint32(value) == JV.encode_uint32(value)
    enc = V.encode_uint32(value)
    assert V.decode_uint32(enc) == JV.decode_uint32(enc) == (value, len(enc))
    assert V.decode_uint32(raw) == JV.decode_uint32(raw)
    assert V.decode_uint64(raw) == JV.decode_uint64(raw)
    assert F.uncompressed_len(raw) == JF.uncompressed_len(raw)


_chunk = st.tuples(
    st.sampled_from([0x00, 0x01, 0x02, 0x7F, 0x80, 0xFD, 0xFE, 0xFF]),
    st.binary(max_size=40),
)


@settings(max_examples=300, deadline=None)
@given(st.lists(_chunk, max_size=6), st.binary(max_size=6), st.booleans())
def test_frame_scanning(chunks, tail, header):
    data = JC.FRAMING_HEADER if header else b""
    for cid, payload in chunks:
        data += F.encode_frame_header(cid, len(payload)) + payload
    data += tail
    assert F.is_snappy_framed_stream(data) == JF.is_snappy_framed_stream(data)
    start = len(C.FRAMING_HEADER) if header else 0
    ours, theirs = F.scan_frames(data, start), JF.scan_frames(data, start)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert [tuple(vars(c).values()) for c in ours] == [
            tuple(vars(c).values()) for c in theirs
        ]
    assert F.uncompressed_len_framed(data) == JF.uncompressed_len_framed(data)
    if len(data) >= 4:
        assert F.decode_frame_header(data[:4]) == JF.decode_frame_header(data[:4])


@settings(max_examples=100, deadline=None)
@given(st.integers(min_value=0, max_value=255), st.integers(min_value=0, max_value=(1 << 24) - 1))
def test_frame_header_pack(cid, length):
    assert F.encode_frame_header(cid, length) == JF.encode_frame_header(cid, length)


def test_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import snappy_tpu_torch, snappy_tpu_torch.testing.payloads\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules if sys.modules[m]}\n"
        "assert not any(m.startswith('snappy_tpu.') or m == 'snappy_tpu' for m in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stderr
