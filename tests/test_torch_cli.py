"""The port's command line against the JAX package's.

``snappy_tpu_torch.cli.main`` with ``--device cpu`` (the kernels' plain
versions) and ``snappy_tpu.cli.main`` on its host backend (monkeypatched
``snappy_tpu.config``, restored after) write the same files and exit with
the same codes: framed and raw compress at levels 1 and 2, decompress
(framed, raw, raw detected without framing, with and without CRCs, the
raw streaming decoder in scan mode), standard output, and malformed
input.
"""

import pytest

torch = pytest.importorskip("torch")

from snappy_tpu import cli as jax_cli  # noqa: E402
from snappy_tpu import config as jax_config  # noqa: E402

import snappy_tpu_torch  # noqa: E402
from snappy_tpu_torch import cli  # noqa: E402
from snappy_tpu_torch.formats import constants as C  # noqa: E402
from snappy_tpu_torch.testing import payloads  # noqa: E402

PAYLOAD = payloads.mixed_payload(150_000, seed=8)


@pytest.fixture(autouse=True)
def jax_host(monkeypatch):
    monkeypatch.setattr(jax_config, "_backend", "host")


def both(tmp_path, name: str, data: bytes, args):
    """Run both CLIs on a file holding ``data``: (rc, output) of each."""
    results = []
    for tag, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jax_cli.main, [])):
        src = tmp_path / f"{tag}_{name}"
        src.write_bytes(data)
        dest = tmp_path / f"{tag}_{name}.result"
        rc = main(args + extra + ["-o", str(dest), str(src)])
        results.append((rc, dest.read_bytes() if dest.exists() else None))
    assert results[0] == results[1]
    return results[0]


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("raw", [False, True])
def test_roundtrip_equals_jax(tmp_path, level, raw):
    fmt = ["--raw"] if raw else []
    rc, enc = both(tmp_path, "plain", PAYLOAD, fmt + ["-l", str(level)])
    assert rc == 0 and enc.startswith(C.FRAMING_HEADER) != raw
    rc, dec = both(tmp_path, "enc", enc, fmt + ["-d"])
    assert rc == 0 and dec == PAYLOAD


def test_raw_detected_without_framing(tmp_path):
    rc, enc = both(tmp_path, "plain", PAYLOAD, ["--raw"])
    assert both(tmp_path, "enc", enc, ["-d"]) == (0, PAYLOAD)


def test_raw_decode_in_scan_mode(tmp_path, monkeypatch):
    """``-d --raw`` reaches the streaming decoder in scan mode: a far copy
    (unsupported there) still decodes, through the grid-mode decoder."""
    body, m, payload = payloads.scan_edge_cases()[1]
    from snappy_tpu_torch.formats import varint

    monkeypatch.setenv("SNAPPY_TPU_TORCH_STREAM_MODE", "scan")
    assert both(tmp_path, "far", varint.encode_uint32(m) + body, ["-d", "--raw"]) == (0, payload)


def test_bad_crc_and_no_crc(tmp_path):
    _, enc = both(tmp_path, "plain", PAYLOAD, [])
    bad = bytearray(enc)
    bad[len(C.FRAMING_HEADER) + 4] ^= 0x55
    assert both(tmp_path, "bad", bytes(bad), ["-d"]) == (1, None)
    assert both(tmp_path, "bad", bytes(bad), ["-d", "--no-crc"]) == (0, PAYLOAD)


def test_malformed_raw_input(tmp_path, capsys):
    assert both(tmp_path, "junk", b"\xff\xff\xff\xff\xff\xff", ["-d", "--raw"]) == (1, None)
    assert "malformed" in capsys.readouterr().err


def test_default_names_and_verbose(tmp_path, capsys):
    src = tmp_path / "data.bin"
    src.write_bytes(PAYLOAD)
    assert cli.main(["--device", "cpu", "-v", str(src)]) == 0
    sz = tmp_path / "data.bin.sz"
    assert sz.exists() and "bytes" in capsys.readouterr().err
    sz.rename(tmp_path / "copy.sz")
    assert cli.main(["--device", "cpu", "-d", str(tmp_path / "copy.sz")]) == 0
    assert (tmp_path / "copy").read_bytes() == PAYLOAD


def test_stdout(tmp_path, capsysbinary):
    src = tmp_path / "data.bin"
    src.write_bytes(PAYLOAD)
    assert cli.main(["--device", "cpu", "-o", "-", str(src)]) == 0
    enc = capsysbinary.readouterr().out
    (tmp_path / "data.sz").write_bytes(enc)
    assert cli.main(["--device", "cpu", "-d", "-o", "-", str(tmp_path / "data.sz")]) == 0
    assert capsysbinary.readouterr().out == PAYLOAD


def test_version(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--version"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip() == f"snappy_tpu_torch {snappy_tpu_torch.__version__}"
