"""``correct`` on the CPU at a few frames, through the whole run but the
look for a card: true for the program as it is, false for each control
and for each fault the cells can have, planted under the timed path."""

import pytest
import torch

from benchmark import control
from benchmark.lib import cells
from snappy_tpu_torch import entry
from snappy_tpu_torch.ops import crc32c, decode_chunks, encode_blocks

from .helpers import CELLS, run_cpu

KIND = {name: cells.load(name).traffic["entry"] for name in CELLS}  # each cell's step kind
ENCODE = [c for c in CELLS if KIND[c] == "encode"]
DECODE = [c for c in CELLS if KIND[c] == "decode"]


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(name):
    line, checks = run_cpu(name)
    assert line["correct"], checks
    assert not any(checks.values())


@pytest.mark.parametrize("name", ENCODE)
def test_control_array_route_is_not_correct(name):
    with control.array_route():
        line, checks = run_cpu(name)
    assert not line["correct"]
    assert checks["level1_bad"] > 0 and checks["stream_bad"] == 0 and checks["crc_bad"] == 0


@pytest.mark.parametrize("name", DECODE)
def test_control_crc_head_is_not_correct(name):
    with control.crc_head():
        line, checks = run_cpu(name)
    assert not line["correct"] and checks["crc_bad"] > 0


def _half(fn):
    """``fn`` run on the first half of the rows only; the rest of each
    output left as zeros (and K2's rows reported ok)."""

    def half(*args, **kw):
        full = fn(*args, **kw)
        outs = full if isinstance(full, tuple) else (full,)
        n = outs[0].shape[0]
        cut = []
        for t in outs:
            t = t.clone()
            t[n // 2 :] = True if t.dtype == torch.bool else 0
            cut.append(t)
        if fn is decode_chunks.decode_chunks:
            args[3][n // 2 :] = 0  # the rows written in place
        return tuple(cut) if isinstance(full, tuple) else cut[0]

    return half


def _altered_crc(fn):
    def altered(*args, **kw):
        out = fn(*args, **kw).clone()
        out.view(torch.int32)[0] ^= 1 << 7
        return out

    return altered


def _altered_row(fn):
    def altered(comp, offsets, declared, out, **kw):
        ok, written = fn(comp, offsets, declared, out, **kw)
        out[0, 0] ^= 0x40
        return ok, written

    return altered


def _altered_stream(fn):
    """K3's stream of a frame drawn at random, one byte in its middle
    changed: the level-1 sample need not hold that frame."""

    def altered(blocks, lens, level=1):
        enc, enc_len = fn(blocks, lens, level)
        k = int(torch.randint(len(enc_len), (1,), generator=torch.Generator().manual_seed(11)))
        enc[k, int(enc_len[k]) // 2] ^= 0x01
        return enc, enc_len

    return altered


def _unchanged_step(rows, lens):
    n = rows.shape[0]
    return (torch.zeros(n, dtype=torch.uint32), torch.zeros((n, entry.max_comp(rows.shape[1])), dtype=torch.uint8),
            torch.zeros(n, dtype=torch.int32))


def _unchanged_k2(comp, offsets, declared, out, host_values=None):
    n = declared.shape[0]
    return torch.ones(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32)


FAULTS = {
    "unchanged": {"encode": [(entry, "step", lambda f: _unchanged_step)],
                  "decode": [(decode_chunks, "decode_chunks", lambda f: _unchanged_k2),
                             (crc32c, "masked_crc32c_chunks", lambda f: lambda rows, lens: torch.zeros(
                                 rows.shape[0], dtype=torch.uint32))]},
    "half_batch": {"encode": [(encode_blocks, "encode_blocks", _half), (crc32c, "masked_crc32c_chunks", _half)],
                   "decode": [(decode_chunks, "decode_chunks", _half), (crc32c, "masked_crc32c_chunks", _half)]},
    "altered_crc": {"encode": [(crc32c, "masked_crc32c_chunks", _altered_crc)],
                    "decode": [(crc32c, "masked_crc32c_chunks", _altered_crc)]},
    "altered_output": {"encode": [(encode_blocks, "encode_blocks", _altered_stream)],
                       "decode": [(decode_chunks, "decode_chunks", _altered_row)]},
}


# full blobs leave every chunk of the sidecars stored: K2 produces nothing
# there, and the answer produced is K1's CRC, which altered_crc alters.  A
# step kind of its own (entries/<entry>.py) keeps its faults in its own tests
CAN_HAVE = [(name, fault) for name in ENCODE + DECODE for fault in sorted(FAULTS)
            if (name, fault) != ("blob_sidecars.decode_step", "altered_output")]


@pytest.mark.parametrize("name,fault", CAN_HAVE)
def test_a_planted_fault_is_not_correct(name, fault, monkeypatch):
    for module, attr, wrap in FAULTS[fault][KIND[name]]:
        monkeypatch.setattr(module, attr, wrap(getattr(module, attr)))
    line, checks = run_cpu(name)
    assert not line["correct"], checks


@pytest.mark.parametrize("name", ENCODE)
def test_an_altered_stream_fails_without_the_level1_sample(name, monkeypatch):
    """Every frame's stream is decoded against its frame, not a sample."""
    monkeypatch.setattr(encode_blocks, "encode_blocks", _altered_stream(encode_blocks.encode_blocks))
    line, checks = run_cpu(name, sample_frames=0)
    assert not line["correct"] and checks["stream_bad"] == 1, checks
