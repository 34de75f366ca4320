"""Atlas: the geo-distributed constellation plane.

Copy of `dds_tpu/geo`: region-aware placement (signed region labels on
shard maps, per-replica region spread inside a group), WAN ChaosNet
profiles (named per-region link matrices with 100-300 ms RTT presets) and
TTL-leased read-local quorum geometry layered on BFT-ABD.

While a region holds a read lease on a group, EVERY write or read quorum
the group's coordinators close must also include the lease-holding
replicas. A leased replica therefore stores every acked write before its
ack exists, so a local read served under an active lease never returns a
value older than the last acked write. The price is availability, not
safety: a dead holder stalls quorums for at most one lease TTL, after
which expiry restores plain quorum geometry. The one residual window, a
lease granted while a round that already closed its quorum is still in
flight, is bounded by one round and audited by the Watchtower's
`lease_staleness` invariant.
"""

from dds_tpu_torch.geo.lease import LeaseTable, ReadLease
from dds_tpu_torch.geo.placement import group_regions, spread
from dds_tpu_torch.geo.wan import WAN_PRESETS, apply_profiles, faults_from_spec

__all__ = [
    "LeaseTable",
    "ReadLease",
    "WAN_PRESETS",
    "apply_profiles",
    "faults_from_spec",
    "group_regions",
    "spread",
]
