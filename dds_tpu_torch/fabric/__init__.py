"""Meridian: the multi-host shard fabric.

Port of `dds_tpu/fabric/`. It takes the Constellation
(`dds_tpu_torch/shard`) across process and host boundaries: a `TcpNet` deployment a `[fabric]` role at a time, the signed
shard map distributed by `GET /shards` bootstrap and epoch-gossip long-
polls (304 while fresh, a push the moment an epoch bumps), cross-host live
resharding through each group's control agent, and an open-loop load
generator (`fabric.loadgen`) that reports through the SLO engine. With
`[obs.fleet]` the roles wire Panopticon (`obs.panopticon`): a span
shipper in every group process, the collector in the proxy.
"""

from dds_tpu_torch.fabric.deploy import (
    FabricStatusServer,
    MeridianController,
    group_endpoints,
    initial_map,
    launch_meridian,
    parse_role,
)
from dds_tpu_torch.fabric.gossip import (
    EpochGossipHub,
    MapFollower,
    RemoteShardManager,
    bootstrap_map,
    fetch_shards,
)
from dds_tpu_torch.fabric.remote import (
    AgentClient,
    AgentError,
    MeridianAgent,
    RemoteShardGroup,
)

__all__ = [
    "FabricStatusServer", "MeridianController", "group_endpoints",
    "initial_map", "launch_meridian", "parse_role",
    "EpochGossipHub", "MapFollower", "RemoteShardManager",
    "bootstrap_map", "fetch_shards",
    "AgentClient", "AgentError", "MeridianAgent", "RemoteShardGroup",
]
