"""Group placement and the exact partial-product combine.

Two functions of `dds_tpu/parallel/mesh.py`, the ones the resident plane
and Stratum call:

- `combine_partials` (`:152`): the host modular-product tail over
  already-reduced partials, verbatim;
- `group_sharding` (`:57`): where one shard group's resident pool lives.
  The port runs on one card, so every group's pool lives on the plane's
  device (the reference answers None, default placement, for a single
  device).

The sharded folds over several devices (`sharded_reduce_mul_fixed`,
`sharded_pow_mod`) come with the mesh plane.
"""

from __future__ import annotations

import torch


def group_sharding(device, index: int) -> torch.device:
    """The device that holds shard group `index`'s resident pool: on one
    card, the plane's device for every group, whatever its index."""
    return torch.device(device)


def combine_partials(partials, modulus: int) -> int:
    """Modular-product tail combine over already-reduced partials — the
    host-integer twin of the replicated log2(D) tree the sharded fold runs
    over gathered per-device partials. Every shard group shares one
    Paillier modulus, and the modular product is associative and
    commutative, so S per-shard partials combine bit-for-bit to the
    single-shard result regardless of how the keyspace was partitioned."""
    parts = [p % modulus for p in partials]
    if not parts:
        raise ValueError("combine_partials needs at least one partial")
    while len(parts) > 1:
        nxt = [
            (parts[i] * parts[i + 1]) % modulus
            for i in range(0, len(parts) - 1, 2)
        ]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]
