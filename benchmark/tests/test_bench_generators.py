"""The configurations' generators: the spec's widths, deterministic by seed."""

import json

import pytest
import torch

from benchmark.lib import cells, frames, rng

from .helpers import TINY


def _make(name, seed, **over):
    cell = cells.load(f"{name}.decode_step")
    return cell.generator().make(dict(cell.config, **{**TINY[name], **over}), seed, "cpu"), cell.config


def test_rng_is_splitmix64_and_takes_large_seeds():
    # splitmix64's first output for state 0 is 0xE220A8397B1DCDAF
    z = rng.words(0, 0, 1, "cpu")
    assert z.dtype == torch.int64
    k = rng.key(2**40 + 3, 9)
    assert 0 <= k < 2**64
    a = rng.random_bytes(2**31 + 17, 4, 1000, "cpu")
    assert torch.equal(a, rng.random_bytes(2**31 + 17, 4, 1000, "cpu"))
    assert not torch.equal(a, rng.random_bytes(2**31 + 18, 4, 1000, "cpu"))
    assert sorted(rng.permutation(5, 1, 50, "cpu").tolist()) == list(range(50))
    m = (1 << 64) - 1
    x = (0 + rng.GOLDEN) & m
    x = ((x ^ (x >> 30)) * rng._C1) & m
    x = ((x ^ (x >> 27)) * rng._C2) & m
    x ^= x >> 31
    assert rng._mix(rng.GOLDEN) == x == 0xE220A8397B1DCDAF


@pytest.mark.parametrize("name", ["beacon_state", "blob_sidecars"])
def test_generator_is_deterministic_by_seed(name):
    (a, sa), _ = _make(name, 2**31 + 9)
    (b, sb), _ = _make(name, 2**31 + 9)
    (c, _), _ = _make(name, 2**31 + 10)
    assert sa == sb and torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.uint8 and a.numel() == sum(sa)


def test_beacon_state_layout():
    (state, sizes), cfg = _make("beacon_state", 3)
    v = TINY["beacon_state"]["validators"]
    assert cfg["validator_bytes"] == 121 == 48 + 32 + 8 + 1 + 4 * 8
    b = state.numpy().tobytes()
    # the first list's offset follows the fixed part (27 fixed fields + 12 offsets)
    fixed_prefix = 8 + 32 + 8 + 16 + 112 + 2 * 64 * 32
    off = int.from_bytes(b[fixed_prefix : fixed_prefix + 4], "little")
    hist, votes = 8 * 32, 8 * 72
    registry = state[off + hist + votes : off + hist + votes + v * 121].view(v, 121)
    creds = registry[:, 48].tolist()
    assert set(creds) <= {0, 1, 2}
    assert creds.count(1) == round(v * 0.70) and creds.count(2) == v - round(v * 0.25) - round(v * 0.70)
    far = bytes([255] * 8)
    exits = [registry[i, 105:113].numpy().tobytes() for i in range(v)]
    assert sum(e != far for e in exits) == round(v * cfg["assumed"]["exited_pct"] / 100)


def test_beacon_state_full_size():
    """The mainnet size, from the layout: 225,470,684 bytes, 3,441 frames."""
    cfg = json.loads((cells.HERE / "configs" / "beacon_state" / "config.json").read_text())
    v = cfg["validators"]
    fixed = (8 + 32 + 8 + 16 + 112 + 2 * cfg["slots_per_historical_root"] * 32 + 72 + 8
             + cfg["epochs_per_historical_vector"] * 32 + cfg["epochs_per_slashings_vector"] * 8 + 1
             + 3 * 40 + 2 * (cfg["sync_committee_size"] + 1) * 48 + 2 * 8 + 6 * 8 + 12 * 4)
    lists = (cfg["historical_roots"] * 32 + cfg["eth1_data_votes"] * 72 + v * (121 + 8 + 1 + 1 + 8)
             + 584 + cfg["extra_data_bytes"] + cfg["historical_summaries"] * 64 + cfg["pending_deposits"] * 192
             + cfg["pending_partial_withdrawals"] * 24 + cfg["pending_consolidations"] * 16)
    assert fixed + lists == 225_470_684
    (small, _), _ = _make("beacon_state", 1)
    t = TINY["beacon_state"]
    shrink = ((v - t["validators"]) * 139 + (cfg["epochs_per_historical_vector"] - 64) * 32
              + 2 * (cfg["slots_per_historical_root"] - 64) * 32 + (cfg["epochs_per_slashings_vector"] - 64) * 8
              + (cfg["historical_roots"] - 8) * 32 + (cfg["eth1_data_votes"] - 8) * 72
              + (cfg["historical_summaries"] - 8) * 64 + (cfg["pending_deposits"] - 8) * 192)
    assert small.numel() == 225_470_684 - shrink
    assert len(frames.table([225_470_684], 65536).length) == 3441


def test_blob_sidecars_layout():
    (data, sizes), cfg = _make("blob_sidecars", 4, sidecars_per_response=12)
    assert sizes == [131_928] * 12 and cfg["sidecar_bytes"] == 8 + 131_072 + 48 + 48 + 208 + 17 * 32
    rows = data.view(12, -1)
    assert rows[:, :8].view(torch.int64).view(-1).tolist() == [i % 9 for i in range(12)]
    blob = rows[:, 8 : 8 + 131_072].view(12, 4096, 32)
    assert int(blob[:, :, 0].max()) == 0  # every field element below the modulus
    assert bool((blob[:, -1, 1:] != 0).any(-1).all())  # every blob full
    header = rows[:, 8 + 131_072 + 96 : 8 + 131_072 + 96 + 208]
    assert torch.equal(header[0], header[8]) and not torch.equal(header[0], header[9])
    t = frames.table(sizes, 65536)
    assert t.length.tolist() == [65536, 65536, 856] * 12
