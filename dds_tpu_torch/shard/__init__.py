"""Constellation: the sharded keyspace plane.

Port of `dds_tpu/shard/`. Partitions the key->set keyspace across S
independent BFT-ABD quorum groups — each with its own replicas, spares,
supervisor and anti-entropy loop — behind a consistent-hash,
epoch-versioned, HMAC-signed `ShardMap` that every client->replica
message carries and every replica fences. Point ops route to exactly one
group; aggregates scatter per-group folds and gather the partials with
`parallel/mesh.combine_partials` (all groups share one Paillier modulus).
Live resharding (`rebalance.Rebalancer`: split, merge, abort, journaled
recovery; the Constellation's takeover) streams keys through verified
state-transfer frames under an epoch fence, so a reshape never loses or
misroutes a write.
"""

from dds_tpu_torch.shard.fabric import (
    Constellation,
    ShardGroup,
    build_constellation,
    build_group,
)
from dds_tpu_torch.shard.rebalance import Rebalancer, ReshardAborted
from dds_tpu_torch.shard.router import ShardRouter
from dds_tpu_torch.shard.shardmap import (
    ShardManager,
    ShardMap,
    ShardState,
    moved_keys,
)

__all__ = [
    "Constellation", "ShardGroup", "build_constellation", "build_group",
    "Rebalancer", "ReshardAborted", "ShardRouter",
    "ShardManager", "ShardMap", "ShardState", "moved_keys",
]
