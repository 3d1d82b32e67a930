"""Full BlobSidecarsByRange responses as SSZ bytes, made on the device from the seed.

A ``BlobSidecar`` (deneb/p2p-interface.md) is index 8, blob 131,072
(4,096 field elements of 32 bytes), KZG commitment 48, KZG proof 48,
signed block header 208 and the commitment's inclusion proof 17 x 32:
131,928 bytes, all fixed.  ``make`` returns one message a sidecar,
``responses`` x ``sidecars_per_response`` of them, in the order a server
sends them: by block, then by blob index.
"""

from __future__ import annotations

import torch

from benchmark.lib import rng


def make(cfg: dict, seed: int, device):
    """(uint8 tensor of every sidecar's bytes end to end on ``device``,
    [each sidecar's length])."""
    m = cfg["responses"] * cfg["sidecars_per_response"]
    per_block = cfg["blobs_per_block"]
    blocks = -(-m // per_block)
    fe, fe_bytes = cfg["field_elements_per_blob"], cfg["bytes_per_field_element"]
    stream = iter(range(1, 1 << 20))

    def draw(n):
        return rng.random_bytes(seed, next(stream), n, device)

    blob = draw(m * fe * fe_bytes).view(m, fe, fe_bytes)
    blob[:, :, 0] = 0  # each field element below the BLS modulus: a zero top byte
    index = (torch.arange(m, device=device) % per_block).view(torch.uint8).view(m, 8)
    block = torch.arange(m, device=device) // per_block
    slot = (11_500_000 + torch.arange(blocks, device=device)).view(torch.uint8).view(blocks, 8)
    proposer = rng.below(seed, next(stream), blocks, 1 << 20, device).view(torch.uint8).view(blocks, 8)
    header = torch.cat((slot, proposer, draw(blocks * (3 * 32 + 96)).view(blocks, -1)), 1)[block]
    sidecars = torch.cat((
        index, blob.view(m, -1), draw(m * cfg["commitment_bytes"]).view(m, -1),
        draw(m * cfg["proof_bytes"]).view(m, -1), header,
        draw(m * 32 * cfg["inclusion_proof_depth"]).view(m, -1),
    ), 1)
    if sidecars.shape[1] != cfg["sidecar_bytes"] or header.shape[1] != cfg["signed_block_header_bytes"]:
        raise ValueError(f"a sidecar of {sidecars.shape[1]} bytes, not {cfg['sidecar_bytes']}")
    return sidecars.reshape(-1), [cfg["sidecar_bytes"]] * m
