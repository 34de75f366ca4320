"""Constellation fabric: build S independent BFT-ABD quorum groups.

Copy of `dds_tpu/shard/fabric.py` on the in-memory transport (or a
ChaosNet over it, or, for the Meridian role "all", a TcpNet, every
endpoint then named "host:port/name" by `namer`), with Atlas: region-aware placement (`regions`, and
`placement` span, home or a per-gid dict), the home regions signed onto
the map, per-group read-lease tables (`lease_ttl`), proxy clients homed
in `client_region`, every endpoint labelled on a ChaosNet so
`[chaos.profiles]` matrices apply, and a takeover that prefers a standby
homed in the dead group's region. One group is the
single-group stack — replicas (+ sentinent spares), a supervisor,
per-replica Merkle anti-entropy, an `AbdClient` and a Trudy (a Nemesis
with `chaos`) — with namespaced endpoints (`s0-replica-3`,
`s1-supervisor`, ...) over ONE shared transport. `build_constellation`
assembles S groups with the ShardManager/ShardRouter pair and a
Rebalancer; the Constellation's `split`, `merge` and `promote` reshape
the fleet live (`shard/rebalance.py`), a merged-away group staying up as
a warm standby the next split or takeover reuses, and `build_group` is
the factory a split uses for a brand-new group.
"""

from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass, field

from dds_tpu_torch.core.quorum_client import AbdClient, AbdClientConfig
from dds_tpu_torch.core.replica import BFTABDNode, ReplicaConfig
from dds_tpu_torch.core.supervisor import BFTSupervisor, SupervisorConfig
from dds_tpu_torch.geo.lease import LeaseTable
from dds_tpu_torch.geo.placement import group_regions, spread
from dds_tpu_torch.malicious.trudy import Nemesis, Trudy
from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.shard.rebalance import Rebalancer, _maybe_await
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
    # Atlas: replica endpoint -> region, the group's home region label,
    # and the shared per-group read-lease table (None = leases off)
    replica_regions: dict = field(default_factory=dict)
    home_region: str = ""
    lease_table: object = None

    def all_replicas(self) -> list[str]:
        return self.active + self.sentinent

    def region_census(self) -> dict:
        """region -> replica count, for /health and placement checks."""
        out: dict = {}
        for region in self.replica_regions.values():
            out[region] = out.get(region, 0) + 1
        return dict(sorted(out.items()))

    def export_from(self, endpoint: str) -> dict:
        """Export one replica's repository (migration seed DATA — every
        receiver re-verifies entries against the manifest quorum)."""
        node = self.replicas.get(endpoint)
        return node.export_state() if node is not None else {}

    def prune_unowned(self) -> int:
        return sum(n.drop_unowned() for n in self.replicas.values())

    async def stop(self) -> None:
        await self.supervisor.stop()
        for n in self.replicas.values():
            await n.antientropy.stop()


@dataclass
class Constellation:
    manager: ShardManager
    router: ShardRouter
    groups: list[ShardGroup]
    rebalancer: Rebalancer
    net: object = None
    secret: bytes = b""
    _build_kwargs: dict = field(default_factory=dict)
    # warm standbys: groups a merge retired (still running, pruned empty)
    # — the next split or takeover reuses one instead of building fresh
    standbys: list = field(default_factory=list)
    # Atlas build parameters, kept so standby groups built later place
    # the way the original fleet did
    geo_regions: list = field(default_factory=list)
    geo_placement: object = "span"
    geo_lease_ttl: float = 0.0
    geo_client_region: str = ""

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

    def _fresh_gid(self) -> str:
        used = {g.gid for g in self.groups} | {g.gid for g in self.standbys}
        n = len(used)
        while f"s{n}" in used:
            n += 1
        return f"s{n}"

    def regions_of_endpoints(self) -> dict:
        """Every fabric endpoint's region label (replicas per their
        placement; supervisor and proxy client per the group home or the
        client region): what ChaosNet region matrices key off."""
        out: dict = {}
        for g in self.groups + self.standbys:
            out.update(g.replica_regions)
            if g.home_region:
                out[g.supervisor.addr] = g.home_region
            region = self.geo_client_region or g.home_region
            if region:
                out[g.client.addr] = region
        return out

    def _acquire_standby(self, gid: str | None = None,
                         prefer_region: str = "") -> ShardGroup:
        """A serving-capable group outside the active map: a warm standby
        a merge retired, else a freshly built one (fenced until a map
        gives it keys, so it can be brought up eagerly without traffic).
        A caller naming `gid` (an operator's replayable split target)
        gets that standby, or a fresh group under that name.
        `prefer_region` picks a standby homed there when one exists (the
        Atlas takeover preference); a fresh group is homed there too."""
        if gid is not None:
            for i, g in enumerate(self.standbys):
                if g.gid == gid:
                    return self.standbys.pop(i)
            if gid in {g.gid for g in self.groups}:
                raise ValueError(f"target group {gid!r} is already active")
        else:
            if self.standbys:
                if prefer_region:
                    for i, g in enumerate(self.standbys):
                        if g.home_region == prefer_region:
                            return self.standbys.pop(i)
                return self.standbys.pop(0)
            gid = self._fresh_gid()
        state = ShardState(gid, self.manager.current(), self.secret)
        kwargs = dict(self._build_kwargs)
        if self.geo_regions:
            mode = (self.geo_placement.get(gid, "span")
                    if isinstance(self.geo_placement, dict)
                    else self.geo_placement)
            home = prefer_region or self.geo_regions[0]
            kwargs["regions"] = ([home] if mode == "home"
                                 else list(self.geo_regions))
            kwargs["home_region"] = home
            kwargs["lease_ttl"] = self.geo_lease_ttl
        group = build_group(self.net, gid, state, **kwargs)
        if self.geo_regions and hasattr(self.net, "set_regions"):
            labels = dict(group.replica_regions)
            if group.home_region:
                labels[group.supervisor.addr] = group.home_region
                labels[group.client.addr] = (self.geo_client_region
                                             or group.home_region)
            self.net.set_regions(labels)
        return group

    def _adopt(self, group: ShardGroup) -> None:
        self.groups.append(group)
        self.router.clients[group.gid] = group.client
        group.client.shard_epoch = lambda m=self.manager: m.current().epoch
        if not group.client.cfg.shard:
            group.client.cfg.shard = group.gid

    async def split(self, victim_gid: str,
                    target_gid: str | None = None) -> ShardGroup:
        """Live split: bring up a group (warm standby preferred; an
        explicit `target_gid` makes the operation replayable by name),
        migrate ~half of the victim's keyspace into it (verified,
        epoch-fenced), activate."""
        group = self._acquire_standby(target_gid)
        victim = self.group(victim_gid)
        try:
            await self.rebalancer.split(victim, group)
        except BaseException:
            # an aborted plan rolled the map back: the group is still a
            # serving-capable standby — keep it warm instead of leaking it
            self.standbys.append(group)
            raise
        self._adopt(group)
        return group

    async def merge(self, victim_gid: str) -> list[str]:
        """Live merge: fold `victim_gid`'s keyspace back into its ring
        successors (split's freeze/attest/stream/activate machinery run in
        reverse). The retired group keeps running as a warm standby for
        the next split. Returns the receiver gids."""
        old_map = self.manager.current()
        receivers = [self.group(g) for g in old_map.absorbers(victim_gid)]
        victim = self.group(victim_gid)
        await self.rebalancer.merge(victim, receivers)
        self.groups.remove(victim)
        self.router.clients.pop(victim_gid, None)
        self.standbys.append(victim)
        return [r.gid for r in receivers]

    async def promote(self, dead_gid: str) -> ShardGroup:
        """Disaster takeover: `dead_gid`'s replicas are gone, so its slice
        of the keyspace is relabeled — same ring positions, epoch+1 — onto
        a standby group, which serves it at once. Availability over data:
        a whole-group loss is beyond the <= f fault model, so the slice
        restarts empty and refills from client writes. Announced like any
        activation (`on_activate`). A standby homed where the dead group
        lived is preferred, so the slice keeps its geography (and its WAN
        profile); the relabeled map carries the home region over."""
        dead = self.group(dead_gid)
        standby = self._acquire_standby(prefer_region=dead.home_region)
        new_map = (self.manager.current()
                   .relabel(dead_gid, standby.gid).sign(self.secret))
        self.groups.remove(dead)
        self.router.clients.pop(dead_gid, None)
        for g in self.groups:
            g.state.install(new_map)
        standby.state.install(new_map)
        self.manager.activate(new_map)
        self._adopt(standby)
        if self.rebalancer.on_activate is not None:
            await _maybe_await(self.rebalancer.on_activate(new_map))
        await flight.record_async("takeover", dead=dead_gid,
                                  standby=standby.gid, epoch=new_map.epoch)
        return standby

    async def stop(self) -> None:
        for g in self.groups + self.standbys:
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
    regions: list[str] | None = None,
    home_region: str = "",
    lease_ttl: float = 0.0,
    namer=None,
) -> ShardGroup:
    """One namespaced quorum group over `net`, fencing under `state`;
    with `chaos` its attacker is a Nemesis (network attacks on a
    ChaosNet `net`). `namer` maps a bare endpoint name to its transport
    address: the identity on the in-memory fabric, `TcpNet.local_addr`
    for a Meridian group process, so every endpoint is a routable
    "host:port/name".

    Atlas: `regions` spreads the group's replicas round-robin across the
    listed regions; `home_region` labels the group (default the first
    region). `lease_ttl > 0` installs the group's shared read-lease table
    on every replica, switching its coordinators to the holder-pinned
    quorum geometry (dds_tpu_torch/geo)."""
    namer = namer or (lambda name: name)
    rcfg = rcfg or ReplicaConfig(quorum_size=quorum)
    endpoints = [namer(f"{gid}-replica-{i}") for i in range(n_active + n_sentinent)]
    active, sentinent = endpoints[:n_active], endpoints[n_active:]
    sup_addr = namer(f"{gid}-supervisor")
    replica_regions = spread(endpoints, regions or [])
    if regions and not home_region:
        home_region = regions[0]
    replicas = {
        e: BFTABDNode(e, endpoints, sup_addr, net, rcfg, shard=state)
        for e in endpoints
    }
    lease_table = None
    if lease_ttl > 0 and regions:
        # one table per group, shared by its replicas (the in-process
        # config-push idiom of ShardState)
        lease_table = LeaseTable(gid, state.secret)
        for node in replicas.values():
            node.lease_table = lease_table
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
    if replica_regions:
        abd_cfg.replica_regions = dict(replica_regions)
        if lease_ttl > 0:
            abd_cfg.lease_ttl = lease_ttl
            if abd_cfg.region:
                # a client without a home region stays on the quorum path
                abd_cfg.lease_enabled = True
    client = AbdClient(namer(f"{gid}-proxy"), net, active, abd_cfg)
    attacker = Nemesis if chaos else Trudy
    trudy = attacker(net, active, max_faults, addr=namer(f"{gid}-trudy"), rng=rng)
    return ShardGroup(gid, active, sentinent, replicas, supervisor, client,
                      state, quorum, trudy, replica_regions=replica_regions,
                      home_region=home_region, lease_table=lease_table)


def build_constellation(
    net,
    *,
    shard_count: int = 2,
    vnodes_per_group: int = 16,
    secret: bytes = b"intranet-abd-secret",
    manifest_timeout: float = 2.0,
    ack_timeout: float = 5.0,
    chunk_keys: int = 256,
    prune: bool = True,
    fence_lease: float = 0.0,
    journal_dir: str | None = None,
    seed: int | None = None,
    regions: list[str] | None = None,
    placement="span",
    lease_ttl: float = 0.0,
    client_region: str = "",
    namer=None,
    **group_kwargs,
) -> Constellation:
    """S homogeneous groups + manager/router/rebalancer over one fabric.
    `seed` seeds each group's supervisor and Trudy from one rng, in group
    order, as the reference does; the reshard settings go to the
    Rebalancer (`journal_dir` its plan journal, None in memory only).

    Atlas: `regions` makes the constellation geo-aware. Group homes are
    assigned round-robin and signed onto the ShardMap, and each group's
    replicas are placed per `placement`: "span" spreads every group across
    all regions (the read-local lease shape), "home" packs a group into
    its home region, and a dict gid -> mode mixes both. `lease_ttl > 0`
    installs per-group read-lease tables; `client_region` homes every
    group's proxy client (enabling its lease fast path) in one region. On
    a ChaosNet every endpoint is labelled with its region, so
    `[chaos.profiles]` WAN matrices apply unchanged. `namer` names every
    endpoint as `build_group` says (the Meridian role "all" over TCP)."""
    gids = [f"s{i}" for i in range(shard_count)]
    homes = group_regions(gids, regions or [])
    smap = ShardMap.build(gids, vnodes_per_group,
                          regions=homes or None).sign(secret)
    manager = ShardManager(smap, secret)
    rng = random.Random(seed) if seed is not None else None
    groups = []
    for gid in gids:
        state = ShardState(gid, smap, secret)
        grp_rng = random.Random(rng.getrandbits(64)) if rng else None
        groups.append(build_group(
            net, gid, state, rng=grp_rng, namer=namer,
            **_geo_group_kwargs(group_kwargs, gid, regions, homes,
                                placement, lease_ttl, client_region),
        ))
    router = ShardRouter(manager, {g.gid: g.client for g in groups})
    rebalancer = Rebalancer(
        manager, net, secret, addr=(namer or (lambda n: n))("rebalancer"),
        manifest_timeout=manifest_timeout,
        ack_timeout=ack_timeout, chunk_keys=chunk_keys, prune=prune,
        fence_lease=fence_lease, journal_dir=journal_dir,
    )
    constellation = Constellation(
        manager, router, groups, rebalancer, net=net, secret=secret,
        _build_kwargs=dict(group_kwargs, namer=namer),
        geo_regions=list(regions or []), geo_placement=placement,
        geo_lease_ttl=lease_ttl, geo_client_region=client_region,
    )
    if regions:
        _register_net_regions(net, constellation)
    return constellation


def _geo_group_kwargs(group_kwargs: dict, gid: str, regions, homes: dict,
                      placement, lease_ttl: float,
                      client_region: str) -> dict:
    """Per-group build kwargs with the Atlas placement resolved."""
    kwargs = dict(group_kwargs)
    if not regions:
        return kwargs
    mode = placement.get(gid, "span") if isinstance(placement, dict) \
        else placement
    home = homes.get(gid, regions[0])
    kwargs["regions"] = [home] if mode == "home" else list(regions)
    kwargs["home_region"] = home
    kwargs["lease_ttl"] = lease_ttl
    if client_region and lease_ttl > 0:
        abd_cfg = kwargs.get("abd_cfg")
        abd_cfg = dataclasses.replace(abd_cfg) if abd_cfg is not None \
            else AbdClientConfig(quorum_size=kwargs.get("quorum", 3))
        abd_cfg.region = client_region
        kwargs["abd_cfg"] = abd_cfg
    return kwargs


def _register_net_regions(net, constellation: Constellation) -> None:
    """Label every fabric endpoint with its region on a ChaosNet, so
    `[chaos.profiles]` region-pair matrices and `region_partition` apply
    to the constellation."""
    if hasattr(net, "set_regions"):
        net.set_regions(constellation.regions_of_endpoints())
