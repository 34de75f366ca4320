"""Constellation fabric: build S independent BFT-ABD quorum groups.

Copy of `dds_tpu/shard/fabric.py` on the in-memory transport (or a
ChaosNet over it), without Atlas (geo placement, leases, region labels:
the reference's `_register_net_regions` labels a ChaosNet's endpoints
for geo). One group is the single-group stack — replicas (+ sentinent
spares), a supervisor, per-replica Merkle anti-entropy, an `AbdClient`
and a Trudy (a Nemesis with `chaos`) — with namespaced
endpoints (`s0-replica-3`, `s1-supervisor`, ...) over ONE shared
transport. `build_constellation` assembles S groups with the
ShardManager/ShardRouter pair. Live split, merge and takeover (the
reference's Rebalancer and the Constellation's `split`/`merge`/`promote`)
are not ported, and no config `run.launch` accepts asks for them.
"""

from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass

from dds_tpu_torch.core.quorum_client import AbdClient, AbdClientConfig
from dds_tpu_torch.core.replica import BFTABDNode, ReplicaConfig
from dds_tpu_torch.core.supervisor import BFTSupervisor, SupervisorConfig
from dds_tpu_torch.malicious.trudy import Nemesis, Trudy
from dds_tpu_torch.shard.router import ShardRouter
from dds_tpu_torch.shard.shardmap import ShardManager, ShardMap, ShardState


@dataclass
class ShardGroup:
    """Handle to one quorum group of the constellation."""

    gid: str
    active: list[str]
    sentinent: list[str]
    replicas: dict[str, BFTABDNode]
    supervisor: BFTSupervisor
    client: AbdClient
    state: ShardState
    quorum_size: int
    trudy: object = None

    async def stop(self) -> None:
        await self.supervisor.stop()
        for n in self.replicas.values():
            await n.antientropy.stop()


@dataclass
class Constellation:
    manager: ShardManager
    router: ShardRouter
    groups: list[ShardGroup]
    net: object = None
    secret: bytes = b""

    @property
    def gids(self) -> list[str]:
        """Group ids in construction order (the resident plane's pool
        registration order; see ShardRouter.group_ids)."""
        return [g.gid for g in self.groups]

    def group(self, gid: str) -> ShardGroup:
        for g in self.groups:
            if g.gid == gid:
                return g
        raise ValueError(f"unknown group {gid!r}")

    async def stop(self) -> None:
        for g in self.groups:
            await g.stop()


def build_group(
    net,
    gid: str,
    state: ShardState,
    *,
    n_active: int = 4,
    n_sentinent: int = 1,
    quorum: int = 3,
    max_faults: int = 1,
    rcfg: ReplicaConfig | None = None,
    sup_cfg: SupervisorConfig | None = None,
    abd_cfg: AbdClientConfig | None = None,
    chaos: bool = False,
    rng: random.Random | None = None,
) -> ShardGroup:
    """One namespaced quorum group over `net`, fencing under `state`;
    with `chaos` its attacker is a Nemesis (network attacks on a
    ChaosNet `net`)."""
    rcfg = rcfg or ReplicaConfig(quorum_size=quorum)
    endpoints = [f"{gid}-replica-{i}" for i in range(n_active + n_sentinent)]
    active, sentinent = endpoints[:n_active], endpoints[n_active:]
    sup_addr = f"{gid}-supervisor"
    replicas = {
        e: BFTABDNode(e, endpoints, sup_addr, net, rcfg, shard=state)
        for e in endpoints
    }
    for e in sentinent:
        replicas[e].behavior = "sentinent"
    supervisor = BFTSupervisor(
        sup_addr, active, sentinent, net,
        sup_cfg or SupervisorConfig(quorum_size=quorum,
                                    proactive_recovery_enabled=False),
        rng=rng,
    )
    if abd_cfg is None:
        abd_cfg = AbdClientConfig(quorum_size=quorum)
    elif not abd_cfg.shard:
        abd_cfg = dataclasses.replace(abd_cfg)
    abd_cfg.shard = gid
    abd_cfg.supervisor = sup_addr
    client = AbdClient(f"{gid}-proxy", net, active, abd_cfg)
    attacker = Nemesis if chaos else Trudy
    trudy = attacker(net, active, max_faults, addr=f"{gid}-trudy", rng=rng)
    return ShardGroup(gid, active, sentinent, replicas, supervisor, client,
                      state, quorum, trudy)


def build_constellation(
    net,
    *,
    shard_count: int = 2,
    vnodes_per_group: int = 16,
    secret: bytes = b"intranet-abd-secret",
    seed: int | None = None,
    **group_kwargs,
) -> Constellation:
    """S homogeneous groups + manager/router over one fabric.
    `seed` seeds each group's supervisor and Trudy from one rng, in group
    order, as the reference does."""
    gids = [f"s{i}" for i in range(shard_count)]
    smap = ShardMap.build(gids, vnodes_per_group).sign(secret)
    manager = ShardManager(smap, secret)
    rng = random.Random(seed) if seed is not None else None
    groups = []
    for gid in gids:
        state = ShardState(gid, smap, secret)
        grp_rng = random.Random(rng.getrandbits(64)) if rng else None
        groups.append(build_group(net, gid, state, rng=grp_rng, **group_kwargs))
    router = ShardRouter(manager, {g.gid: g.client for g in groups})
    return Constellation(manager, router, groups, net=net, secret=secret)
