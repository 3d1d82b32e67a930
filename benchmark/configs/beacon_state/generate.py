"""A mainnet BeaconState (Electra) as SSZ bytes, made on the device from the seed.

The fields follow consensus-specs' ``BeaconState`` in order: the fixed
fields inline, a 4-byte offset for each list, then the lists in order.
Widths and vector lengths are the spec's mainnet preset; counts and value
distributions are the configuration's (its ``assumed``).  ``make`` returns
one message: the serialized state.
"""

from __future__ import annotations

import torch

from benchmark.lib import rng

FAR_FUTURE = -1  # FAR_FUTURE_EPOCH, 2^64 - 1, as int64
GWEI = 10**9


class _Draw:
    """Seeded draws, one stream per call, on ``device``."""

    def __init__(self, seed: int, device):
        self.seed, self.device, self.stream = seed, device, 0

    def _next(self) -> int:
        self.stream += 1
        return self.stream

    def bytes(self, n: int) -> torch.Tensor:
        return rng.random_bytes(self.seed, self._next(), n, self.device)

    def uniform(self, n: int) -> torch.Tensor:
        return rng.uniform(self.seed, self._next(), n, self.device)

    def below(self, n: int, bound: int) -> torch.Tensor:
        return rng.below(self.seed, self._next(), n, bound, self.device)

    def exactly(self, among: torch.Tensor, pct: float) -> torch.Tensor:
        """bool like ``among``: true at exactly pct% of its true places."""
        at = among.nonzero().squeeze(1)
        out = torch.zeros_like(among)
        out[at[rng.permutation(self.seed, self._next(), len(at), self.device)[: round(len(at) * pct / 100)]]] = True
        return out


def _u64(v: torch.Tensor) -> torch.Tensor:
    """Little-endian bytes of int64 values, [n, 8]."""
    return v.to(torch.int64).contiguous().view(torch.uint8).view(-1, 8)


def _const(device, *values: int, width: int = 8) -> torch.Tensor:
    out = b"".join((v & ((1 << 8 * width) - 1)).to_bytes(width, "little") for v in values)
    return torch.frombuffer(bytearray(out), dtype=torch.uint8).to(device)


def _validators(cfg: dict, d: _Draw):
    """The registry [V, 121] and what the other per-validator lists need."""
    a = cfg["assumed"]
    v = cfg["validators"]
    dev = d.device
    idx = torch.arange(v, device=dev)
    shares = a["credential_shares_pct"]
    # exact shares, placed from the seed: every seed gives the same counts
    order = rng.permutation(d.seed, d._next(), v, dev)
    cred = torch.empty(v, dtype=torch.int64, device=dev)
    n0, n1 = round(v * shares["0x00"] / 100), round(v * shares["0x01"] / 100)
    cred[order[:n0]], cred[order[n0 : n0 + n1]], cred[order[n0 + n1 :]] = 0, 1, 2
    pool = d.bytes(4096 * 20).view(4096, 20)
    pick = (4096.0 ** d.uniform(v)).long().sub_(1).clamp_(0, 4095)
    address = torch.cat((torch.zeros(v, 11, dtype=torch.uint8, device=dev), pool[pick]), 1)
    wc = torch.cat((cred[:, None].to(torch.uint8),
                    torch.where((cred == 0)[:, None], d.bytes(v * 31).view(v, 31), address)), 1)
    exited = d.exactly(torch.ones(v, dtype=torch.bool, device=dev), a["exited_pct"])
    slashed = d.exactly(exited, a["slashed_pct_of_exited"])
    g, now = a["genesis_validators"], a["current_epoch"]
    late = (idx - g).clamp(min=0).double() / max(1, v - g)
    act = torch.where(idx < g, 0, (late * (now - 300)).long() + 1)
    elig = torch.where(idx < g, 0, act - 1 - d.below(v, 4))
    span = (now - act - 256).clamp(min=1).double()
    exit_ep = torch.where(exited, act + 256 + (d.uniform(v) * span).long(), FAR_FUTURE)
    withdrawable = torch.where(exited, exit_ep + 256, FAR_FUTURE)
    eff = torch.where(cred == 2, (32 + d.below(v, 2017)) * GWEI, 32 * GWEI)
    eff = torch.where(exited, 0, eff)
    rows = torch.cat((d.bytes(v * 48).view(v, 48), wc, _u64(eff), slashed[:, None].to(torch.uint8),
                      _u64(elig), _u64(act), _u64(exit_ep), _u64(withdrawable)), 1)
    if rows.shape[1] != cfg["validator_bytes"]:
        raise ValueError(f"a validator of {rows.shape[1]} bytes, not {cfg['validator_bytes']}")
    rewards = torch.where(cred == 0, d.below(v, 4 * GWEI),
                          torch.where(cred == 1, d.below(v, 7 * GWEI // 100), d.below(v, GWEI)))
    balances = torch.where(exited, 0, eff + rewards)
    return rows, balances, exited


def _participation(n: int, exited: torch.Tensor, d: _Draw) -> torch.Tensor:
    others = torch.tensor([0, 1, 3, 5, 6], device=d.device)
    flags = torch.where(d.uniform(n) < 0.95, 7, others[d.below(n, 5)])
    return torch.where(exited, 0, flags).to(torch.uint8)


def make(cfg: dict, seed: int, device):
    """(uint8 tensor of the state's SSZ bytes on ``device``, [its length])."""
    d = _Draw(seed, device)
    a = cfg["assumed"]
    v = cfg["validators"]
    now = a["current_epoch"]
    dev = device
    registry, balances, exited = _validators(cfg, d)
    u64 = lambda *vals: _const(dev, *vals)  # noqa: E731
    root = lambda n=1: d.bytes(32 * n)  # noqa: E731

    def checkpoint(epoch):
        return torch.cat((u64(epoch), root()))

    def sync_committee():
        return torch.cat((registry[d.below(cfg["sync_committee_size"], v), :48].reshape(-1), d.bytes(48)))

    eth1 = [torch.cat((root(), u64(1_900_000 + k), root())) for k in range(2)]
    votes = torch.stack(eth1)[(d.uniform(cfg["eth1_data_votes"]) >= 0.9).long()].reshape(-1)
    header = torch.cat((d.bytes(436), _const(dev, 584, width=4), d.bytes(144), d.bytes(cfg["extra_data_bytes"])))
    slashings = torch.where(d.uniform(cfg["epochs_per_slashings_vector"]) < 0.99, 0, d.below(
        cfg["epochs_per_slashings_vector"], 1 << 40))
    inactivity = torch.where(exited | (d.uniform(v) < 0.99), 0, 1 + d.below(v, 50))
    # (name, bytes) in the container's order; bytes None marks a list, whose
    # offset goes here and whose bytes follow in ``lists``
    fields = [
        ("genesis_time", u64(1_606_824_023)),
        ("genesis_validators_root", root()),
        ("slot", u64(now * 32 + 5)),
        ("fork", torch.cat((_const(dev, 0x04000000, 0x05000000, width=4), u64(364_032)))),
        ("latest_block_header", torch.cat((u64(now * 32 + 4, 812_345), root(3)))),
        ("block_roots", root(cfg["slots_per_historical_root"])),
        ("state_roots", root(cfg["slots_per_historical_root"])),
        ("historical_roots", None),
        ("eth1_data", eth1[0]),
        ("eth1_data_votes", None),
        ("eth1_deposit_index", u64(1_950_000)),
        ("validators", None),
        ("balances", None),
        ("randao_mixes", root(cfg["epochs_per_historical_vector"])),
        ("slashings", _u64(slashings).reshape(-1)),
        ("previous_epoch_participation", None),
        ("current_epoch_participation", None),
        ("justification_bits", _const(dev, 0x0F, width=1)),
        ("previous_justified_checkpoint", checkpoint(now - 2)),
        ("current_justified_checkpoint", checkpoint(now - 1)),
        ("finalized_checkpoint", checkpoint(now - 2)),
        ("inactivity_scores", None),
        ("current_sync_committee", sync_committee()),
        ("next_sync_committee", sync_committee()),
        ("latest_execution_payload_header", None),
        ("next_withdrawal_index", u64(90_000_000)),
        ("next_withdrawal_validator_index", u64(812_000)),
        ("historical_summaries", None),
        ("deposit_requests_start_index", u64(1_950_000)),
        ("deposit_balance_to_consume", u64(0)),
        ("exit_balance_to_consume", u64(128 * GWEI)),
        ("earliest_exit_epoch", u64(now + 5)),
        ("consolidation_balance_to_consume", u64(0)),
        ("earliest_consolidation_epoch", u64(now + 5)),
        ("pending_deposits", None),
        ("pending_partial_withdrawals", None),
        ("pending_consolidations", None),
    ]
    lists = [
        root(cfg["historical_roots"]),
        votes,
        registry.reshape(-1),
        _u64(balances).reshape(-1),
        _participation(v, exited, d),
        _participation(v, exited, d),
        _u64(inactivity).reshape(-1),
        header,
        d.bytes(64 * cfg["historical_summaries"]),
        d.bytes(192 * cfg["pending_deposits"]),
        d.bytes(24 * cfg["pending_partial_withdrawals"]),
        d.bytes(16 * cfg["pending_consolidations"]),
    ]
    fixed_len = sum(4 if b is None else b.numel() for _, b in fields)
    offset, parts, it = fixed_len, [], iter(lists)
    for _, b in fields:
        if b is None:
            parts.append(_const(dev, offset, width=4))
            offset += next(it).numel()
        else:
            parts.append(b)
    state = torch.cat(parts + lists)
    return state, [state.numel()]
