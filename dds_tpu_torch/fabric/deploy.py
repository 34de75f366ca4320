"""Meridian role deployment: one TOML, N OS processes, one constellation.

Copy of `dds_tpu/fabric/deploy.py`. `run.launch` lands here when
`[shard] enabled` meets `[transport] kind = "tcp"`. `[fabric]` names every group's
transport address and this process's `role`; the three roles compose a
fleet:

- **all**: the whole constellation (S groups, the ShardRouter and the
  REST proxy) in this process over real sockets;
- **group:N**: quorum group sN only (replicas, spares, supervisor,
  anti-entropy, Trudy) over this process's `TcpNet`, a `MeridianAgent`
  at `<host:port>/sN-fabric` for cross-host freezes, activations,
  exports and prunes, and a status listener serving the signed map at
  `GET /shards` (304 and long-poll gossip), so proxies bootstrap from
  any surviving group;
- **proxy**: the REST proxy and a ShardRouter over the remote groups: it
  bootstraps the signed map from the `[fabric] bootstrap` peers, keeps it
  fresh with epoch-gossip long-polls, derives every group's replica
  addresses from the shared config and hosts the `MeridianController`
  that drives cross-host splits (`POST /_reshard` with `admin-routes`).

With `[obs.fleet] enabled` (Panopticon, `obs/panopticon.py`) each group
process ships its span trees, incidents and metrics to the collector that
`[obs.fleet] collector` names, the proxy's transport address; the proxy's
collector stitches them into its own traces and feeds the Watchtower,
with quorum checks on, and Chronoscope, serves `GET /fleet/*`, and gives
Helmsman the groups' heartbeat ages and home regions. `[attacks] type =
"stale_tag"` arms a group process's replicas as stale-tag forgers, which
only that audit catches.

Every process derives the same epoch-1 map (`ShardMap.build` is
deterministic over the group list) and verifies every later map against
the shared intranet secret, so the fleet has no start order: a proxy
started before its groups answers 503 until quorums appear, never a wrong
answer.

Divergences from the reference, kept on purpose: the process-wide
Watchtower is reset before each role configures it, as every `launch` of
the port does; a proxy with `[geo] enabled` and a `[fabric] region` gives
each group's client the read-local lease path (the groups' home regions
derived round-robin over `[geo] regions`, as the in-process Constellation
assigns them; the reference's proxy clients always read through a
quorum); the proxy's Watchtower follows each installed map's geometry
whether or not a collector exists; a stopping process releases the
`/shards` long-polls parked on it at once.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import types

from dds_tpu_torch.core.quorum_client import AbdClient
from dds_tpu_torch.fabric.gossip import (
    EpochGossipHub,
    MapFollower,
    RemoteShardManager,
    bootstrap_map,
)
from dds_tpu_torch.fabric.remote import AgentClient, MeridianAgent, RemoteShardGroup
from dds_tpu_torch.fleet import Helmsman
from dds_tpu_torch.geo.placement import group_regions
from dds_tpu_torch.http.miniserver import HttpServer, Request, Response
from dds_tpu_torch.http.server import DDSRestServer
from dds_tpu_torch.malicious.trudy import arm_stale_tag_forgers
from dds_tpu_torch.obs.chronoscope import chronoscope
from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.obs.panopticon import FleetCollector, NullWatchtower, SpanShipper
from dds_tpu_torch.obs.slo import SloEngine
from dds_tpu_torch.obs.watchtower import watchtower
from dds_tpu_torch.shard.fabric import build_constellation, build_group
from dds_tpu_torch.shard.rebalance import Rebalancer
from dds_tpu_torch.shard.router import ShardRouter
from dds_tpu_torch.shard.shardmap import ShardMap, ShardState
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.fabric")


def parse_role(role: str) -> tuple[str, str | None]:
    """("all" | "proxy" | "group", gid | None) from a `[fabric] role`;
    "group:2" and "group:s2" both name s2, an empty role is "all"."""
    role = (role or "all").strip()
    if role in ("all", "proxy"):
        return role, None
    kind, sep, which = role.partition(":")
    if kind == "group" and sep:
        which = which.strip()
        if which.isdigit():
            return "group", f"s{int(which)}"
        if which:
            return "group", which
    raise ValueError(f"unknown fabric role {role!r} (expected 'all', 'proxy', or "
                     f"'group:<N>')")


def initial_map(cfg) -> ShardMap:
    """The deterministic epoch-1 map every process derives from [shard]."""
    gids = [f"s{i}" for i in range(cfg.shard.count)]
    return ShardMap.build(gids, cfg.shard.vnodes_per_group).sign(
        cfg.security.abd_mac_secret.encode())


def group_endpoints(cfg, gid: str) -> tuple[list[str], list[str]]:
    """(active, sentinent) replica addresses of `gid`, from `[fabric.groups]`
    and the homogeneous `[shard]` geometry: the same in every process."""
    hostport = cfg.fabric.groups.get(gid)
    if not hostport:
        raise ValueError(f"group {gid!r} has no [fabric.groups] transport address")
    n_act, n_sen = cfg.shard.replicas_per_group, cfg.shard.sentinent_per_group
    active = [f"{hostport}/{gid}-replica-{i}" for i in range(n_act)]
    sentinent = [f"{hostport}/{gid}-replica-{i}" for i in range(n_act, n_act + n_sen)]
    return active, sentinent


def _groups_body(cfg, smap: ShardMap) -> dict:
    out = {}
    for gid in smap.groups:
        try:
            active, _ = group_endpoints(cfg, gid)
        except ValueError:
            log.warning("group %s missing from [fabric.groups]", gid)
            continue
        out[gid] = active
    return out


class _Stopper:
    """Any callable (sync or async) as a Deployment stoppable."""

    def __init__(self, fn):
        self._fn = fn

    async def stop(self):
        res = self._fn()
        if asyncio.iscoroutine(res):
            await res


class FabricStatusServer:
    """The group role's status listener: GET /shards (the signed map, ETag,
    304 and long-poll gossip), /health and /metrics, enough for proxies to
    bootstrap from and operators to watch, with no storage router in the
    process. `stop()` releases the parked long-polls first."""

    def __init__(self, host: str, port: int, view, groups_fn, hub, *, group=None,
                 gid: str = "", wait_cap: float = 60.0, ssl_context=None):
        self.view = view
        self.groups_fn = groups_fn
        self.hub = hub
        self.group = group
        self.gid = gid
        self.wait_cap = wait_cap
        self._http = HttpServer(host, port, self.handle, ssl_context)
        self.cfg = types.SimpleNamespace(host=host, port=port)

    async def start(self) -> None:
        await self._http.start()
        self.cfg.port = self._http.port

    async def stop(self) -> None:
        if self.hub is not None:
            self.hub.close()
        await self._http.stop()

    def status(self) -> dict:
        return {"state": self.view.state, "map": self.view.current().to_wire(),
                "groups": self.groups_fn()}

    async def handle(self, req: Request) -> Response:
        if req.method != "GET":
            return Response(405)
        route = req.path.strip("/")
        if route == "shards":
            etag = req.headers.get("if-none-match", "").strip().strip('"')
            if etag and etag == str(self.view.epoch):
                try:
                    wait = float(req.query.get("wait", 0) or 0)
                except ValueError:
                    wait = 0.0
                if wait > 0 and self.hub is not None:
                    await self.hub.wait_change(min(wait, self.wait_cap))
                if etag == str(self.view.epoch):
                    return Response(304, headers={"ETag": f'"{self.view.epoch}"'})
            resp = Response.json(self.status())
            resp.headers["ETag"] = f'"{self.view.epoch}"'
            return resp
        if route == "health":
            body = {"status": "ok", "role": "group", "group": self.gid,
                    "shard_epoch": self.view.epoch, "reshard_state": self.view.state}
            if self.group is not None:
                body["fence_epoch"] = self.group.state.epoch
                body["replicas"] = {n.name: len(n.repository)
                                    for n in self.group.replicas.values()}
            return Response.json(body)
        if route == "metrics":
            return Response(200, metrics.render().encode(),
                            content_type="text/plain; version=0.0.4; charset=utf-8")
        return Response(404)


class MeridianController:
    """The cross-host reshard driver, in a proxy process: the Rebalancer
    over `RemoteShardGroup` handles derived from the fabric config, every
    activation broadcast to the fleet's group agents so remote /shards
    views and long-pollers see the epoch bump at once."""

    def __init__(self, cfg, net, namer, manager, rpc: AgentClient):
        self.cfg = cfg
        self.fab = cfg.fabric
        self.sh = cfg.shard
        self.manager = manager
        self.rpc = rpc
        self.rebalancer = Rebalancer(
            manager, net, cfg.security.abd_mac_secret.encode(),
            addr=namer("rebalancer"),
            manifest_timeout=self.sh.manifest_timeout,
            ack_timeout=self.sh.ack_timeout,
            chunk_keys=self.sh.migrate_chunk_keys,
            fence_lease=self.sh.fence_lease,
            journal_dir=self.sh.plan_dir or None,
            on_activate=self.broadcast_activation,
        )

    @property
    def phase(self):
        return self.rebalancer.phase

    def retry_after(self) -> float:
        return self.rebalancer.retry_after()

    async def recover(self) -> str | None:
        """Resolve a plan a crashed controller left in the journal: once at
        proxy boot, before any traffic or new plan."""
        return await self.rebalancer.recover(self.handle_for)

    def handle_for(self, gid: str) -> RemoteShardGroup:
        hostport = self.fab.groups.get(gid)
        if not hostport:
            raise ValueError(f"group {gid!r} has no [fabric.groups] transport address")
        return RemoteShardGroup(gid, hostport, n_active=self.sh.replicas_per_group,
                                n_sentinent=self.sh.sentinent_per_group,
                                quorum=self.sh.quorum_size, rpc=self.rpc)

    def pick_target(self, smap: ShardMap) -> str:
        """The first configured standby group not yet in the map."""
        for gid in sorted(self.fab.groups):
            if gid not in smap.groups:
                return gid
        raise ValueError("no standby group in [fabric.groups] to split into")

    async def split(self, source: str, target: str | None = None) -> ShardMap:
        smap = self.manager.current()
        if source not in smap.groups:
            raise ValueError(f"unknown source group {source!r}")
        target = target or self.pick_target(smap)
        if target in smap.groups:
            raise ValueError(f"target group {target!r} already in the map")
        return await self.rebalancer.split(self.handle_for(source), self.handle_for(target))

    async def merge(self, source: str) -> ShardMap:
        """Fold `source`'s keyspace into its ring successors and retire it
        to standby (still launched and configured, for the next split)."""
        smap = self.manager.current()
        if source not in smap.groups:
            raise ValueError(f"unknown source group {source!r}")
        if len(smap.groups) < 2:
            raise ValueError("cannot merge the last group away")
        receivers = [self.handle_for(g) for g in smap.absorbers(source)]
        return await self.rebalancer.merge(self.handle_for(source), receivers)

    async def promote(self, dead: str) -> ShardMap:
        """Takeover of a dead group process: its ring arcs relabelled (same
        positions, epoch+1) onto a live configured standby, the map
        committed there, activated and broadcast. Availability over data:
        a whole-group loss is beyond the <= f fault model, so the slice
        restarts empty."""
        smap = self.manager.current()
        if dead not in smap.groups:
            raise ValueError(f"unknown group {dead!r}")
        standby = self.pick_target(smap)
        new_map = smap.relabel(dead, standby).sign(self.cfg.security.abd_mac_secret.encode())
        # the standby holds the takeover map before routing reaches it (an
        # acked install with no lease: a commit, not a plan)
        await self.handle_for(standby).state.install(new_map)
        self.manager.activate(new_map)
        await self.broadcast_activation(new_map)
        await flight.record_async("takeover", dead=dead, standby=standby,
                                  epoch=new_map.epoch)
        return new_map

    async def broadcast_activation(self, smap: ShardMap) -> None:
        """Push the activated map to every configured group agent (the
        participants already fence under it; the others adopt it epoch-
        forward and wake their long-pollers). Best effort: an unreachable
        agent catches up from gossip or its next bootstrap."""

        async def one(gid: str, hostport: str) -> None:
            try:
                await self.rpc.activate(f"{hostport}/{gid}-fabric", smap)
            except Exception as e:
                log.warning("activation push to %s failed: %s", gid, e)

        await asyncio.gather(*(one(g, hp) for g, hp in sorted(self.fab.groups.items())))


def _namer(net):
    """The full-address namer of a TcpNet (through a ChaosNet wrap)."""
    fn = getattr(net, "local_addr", None)
    if fn is None:
        raise ValueError("meridian roles need a TcpNet-backed transport")
    return fn


def _fleet_secret(cfg) -> bytes:
    """The telemetry batches' HMAC key: its own secret when configured,
    else the intranet secret every fleet process already shares."""
    return (cfg.obs.fleet.secret or cfg.security.abd_mac_secret).encode()


def _identify(cfg, namer, role: str, shard: str = "") -> None:
    """This process's identity on the flight recorder and the
    `dds_process_info` gauge, its host the advertised "host:port"."""
    from dds_tpu_torch.run import publish_identity

    publish_identity(cfg, role, host=namer("_id").rsplit("/", 1)[0], shard=shard)


def _start_shipper(cfg, net, namer, stoppables, *, role: str, shard: str = "",
                   slo=None):
    """This process's span shipper, aimed at the fleet's collector (none
    unless `[obs.fleet]` is enabled and names one)."""
    fl = cfg.obs.fleet
    if not (fl.enabled and fl.collector):
        return None
    shipper = SpanShipper(
        net,
        collector=fl.collector,
        secret=_fleet_secret(cfg),
        host=namer("_id").rsplit("/", 1)[0],
        role=role,
        shard=shard,
        region=cfg.fabric.region,
        spool_max=fl.spool_max,
        batch_max=fl.batch_max,
        flush_interval=fl.flush_interval,
        flight_dir=cfg.obs.flight_dir,
        slo=slo,
    )
    shipper.start()
    stoppables.append(_Stopper(shipper.stop))
    return shipper


def _attach_watchtower(cfg, *, check_quorum: bool, geometry: dict) -> None:
    if not cfg.obs.audit_enabled:
        return
    watchtower.reset()
    watchtower.configure(quorum_size=cfg.shard.quorum_size,
                         n_replicas=cfg.shard.replicas_per_group,
                         check_quorum=cfg.obs.audit_quorum_checks and check_quorum,
                         group_geometry=geometry)
    watchtower.attach(tracer)


def _wire_helmsman(cfg, server, stoppables, *, load_census, breaker_census, split,
                   merge, promote, rebalancer, source_ages=None, regions=None):
    """The Helmsman autoscaler on a proxy's server with `[helmsman]
    enabled`: SLO, admission and breaker signals from the server, load
    shares from the router, actions onto the reshard controller."""
    if not cfg.helmsman.enabled:
        return None
    admission = server.admission
    hm = Helmsman.from_config(
        cfg.helmsman,
        load_census=load_census,
        slo_alerts=server.slo.alerts,
        shed_level=(lambda a=admission: a.shed_level if a else 0),
        breaker_census=breaker_census,
        source_ages=source_ages,
        split=split,
        merge=merge,
        promote=promote,
        moved_bytes=lambda r=rebalancer: r.moved_bytes_total,
        reshard_busy=lambda r=rebalancer: r.lock.locked(),
        # sustained canary unreachability from a region is black-box
        # region-down evidence
        canary_unreachable=(lambda s=server: (
            s.heliograph.unreachable_regions()
            if s.heliograph is not None else set()
        )) if cfg.heliograph.enabled else None,
        regions=regions,
    )
    if admission is not None:
        admission.subscribe(hm.on_admission)
    server.helmsman = hm
    hm.start()
    stoppables.append(_Stopper(hm.stop))
    return hm


async def launch_meridian(cfg, net, stoppables, flight_dir, ssl_server, ssl_client):
    kind, gid = parse_role(cfg.fabric.role)
    if kind == "all":
        return await _launch_all(cfg, net, stoppables, flight_dir, ssl_server, ssl_client)
    if kind == "group":
        return await _launch_group(cfg, net, stoppables, flight_dir, ssl_server,
                                   ssl_client, gid)
    return await _launch_proxy(cfg, net, stoppables, flight_dir, ssl_server, ssl_client)


# --------------------------------------------------------------- role: all


async def _launch_all(cfg, net, stoppables, flight_dir, ssl_server, ssl_client):
    """The whole constellation in this process, over real sockets."""
    from dds_tpu_torch.run import (ConstellationReshard, Deployment, proxy_config,
                                   shard_configs, start_helmsman)

    sh = cfg.shard
    rcfg, sup_cfg, abd_cfg = shard_configs(cfg)
    namer = _namer(net)
    const = build_constellation(
        net,
        shard_count=sh.count,
        vnodes_per_group=sh.vnodes_per_group,
        secret=cfg.security.abd_mac_secret.encode(),
        manifest_timeout=sh.manifest_timeout,
        ack_timeout=sh.ack_timeout,
        chunk_keys=sh.migrate_chunk_keys,
        fence_lease=sh.fence_lease,
        journal_dir=sh.plan_dir or None,
        namer=namer,
        n_active=sh.replicas_per_group,
        n_sentinent=sh.sentinent_per_group,
        quorum=sh.quorum_size,
        max_faults=sh.max_faults,
        rcfg=rcfg,
        sup_cfg=sup_cfg,
        abd_cfg=abd_cfg,
        chaos=cfg.attacks.chaos_enabled,
    )
    replicas = {}
    for g in const.groups:
        replicas.update(g.replicas)
    if cfg.recovery.enabled:
        for g in const.groups:
            g.supervisor.start()
    if cfg.recovery.anti_entropy_enabled:
        for node in replicas.values():
            node.antientropy.configure(interval=cfg.recovery.anti_entropy_interval,
                                       jitter=cfg.recovery.anti_entropy_jitter)
            node.antientropy.start()
    # epoch gossip: remote proxies long-poll this process's /shards; every
    # activation here (a split, the admin route) wakes them
    hub = EpochGossipHub()
    const.rebalancer.on_activate = lambda smap: hub.notify()
    if sh.plan_dir:
        await const.rebalancer.recover(const.group)
    server = DDSRestServer(
        const.router,
        proxy_config(cfg, const.groups[0].supervisor.addr, ssl_server, ssl_client),
        local_replicas=replicas,
        slo=SloEngine.from_obs(cfg.obs),
        gossip=hub,
        reshard=ConstellationReshard(const),
    )
    try:
        await server.start()
    except BaseException:
        await const.stop()
        raise
    if cfg.helmsman.enabled:
        stoppables.append(start_helmsman(cfg, const, server))
    _identify(cfg, namer, "all")
    dep = Deployment(cfg, net, replicas, server, None, const.groups[0].trudy, stoppables,
                     flight_dir, constellation=const, ssl_client=ssl_client)
    # every replica's spans land in this process's tracer, so the quorum
    # audits stay sound over sockets
    _attach_watchtower(cfg, check_quorum=True,
                       geometry={g.gid: (g.quorum_size, len(g.active))
                                 for g in const.groups})
    chronoscope.attach(tracer)
    return dep


# ------------------------------------------------------------- role: group


async def _launch_group(cfg, net, stoppables, flight_dir, ssl_server, ssl_client,
                        gid: str):
    """One quorum group, its fabric agent and its status listener."""
    from dds_tpu_torch.run import Deployment, shard_configs

    sh, fab = cfg.shard, cfg.fabric
    secret = cfg.security.abd_mac_secret.encode()
    rcfg, sup_cfg, abd_cfg = shard_configs(cfg)
    namer = _namer(net)
    if gid not in fab.groups:
        raise ValueError(f"this process's group {gid!r} is missing from [fabric.groups]")

    # the freshest map available: the epoch-1 map from config, upgraded from
    # any reachable peer, so a restarted group process fences under the
    # fleet's current epoch
    smap = initial_map(cfg)
    own_status = f"{fab.status_host or cfg.transport.host}:{fab.status_port}"
    peers = [p for p in fab.bootstrap if p != own_status]
    newer, _ = await bootstrap_map(peers, secret, timeout=fab.bootstrap_timeout,
                                   ssl_context=ssl_client)
    if newer is not None and newer.epoch > smap.epoch:
        smap = newer

    state = ShardState(gid, smap, secret)
    geo_kw = {}
    if cfg.geo.enabled and fab.region:
        # Atlas on Meridian: a group process is homed in its [fabric]
        # region; its replicas are labelled with it and share a lease table,
        # so the region's proxies can hold read leases
        geo_kw = dict(regions=[fab.region], home_region=fab.region,
                      lease_ttl=cfg.geo.lease_ttl)
    group = build_group(net, gid, state,
                        n_active=sh.replicas_per_group,
                        n_sentinent=sh.sentinent_per_group,
                        quorum=sh.quorum_size,
                        max_faults=sh.max_faults,
                        rcfg=rcfg, sup_cfg=sup_cfg, abd_cfg=abd_cfg,
                        chaos=cfg.attacks.chaos_enabled,
                        namer=namer,
                        **geo_kw)
    if cfg.recovery.enabled:
        group.supervisor.start()
    if cfg.recovery.anti_entropy_enabled:
        for node in group.replicas.values():
            node.antientropy.configure(interval=cfg.recovery.anti_entropy_interval,
                                       jitter=cfg.recovery.anti_entropy_jitter)
            node.antientropy.start()
    stoppables.append(_Stopper(group.stop))
    if cfg.attacks.enabled and cfg.attacks.type == "stale_tag":
        # the cross-host audit's regression schedule: this group's replicas
        # answer reads with properly MAC'd forged stale tags, which only
        # the collector-fed Watchtower on the proxy can catch
        arm_stale_tag_forgers(group.replicas)

    hub = EpochGossipHub()
    view = RemoteShardManager(smap, secret, hub=hub)
    agent = MeridianAgent(net, namer(f"{gid}-fabric"), group, view, secret, hub=hub)
    stoppables.append(_Stopper(agent.stop))

    # stay fresh when an activation push misses this process (a partition
    # during a reshard it was not part of): long-poll the other peers
    follower = MapFollower(view, peers, secret, wait=fab.gossip_wait,
                           ssl_context=ssl_client, install_also=[state])
    follower.start()
    stoppables.append(_Stopper(follower.stop))

    server = FabricStatusServer(
        fab.status_host or cfg.transport.host, fab.status_port,
        view, lambda: _groups_body(cfg, view.current()), hub,
        group=group, gid=gid, ssl_context=ssl_server,
    )
    await server.start()
    _identify(cfg, namer, f"group:{gid}", shard=gid)
    _start_shipper(cfg, net, namer, stoppables, role=f"group:{gid}", shard=gid)

    # Heliograph on the group role: a standalone prober of the configured
    # [heliograph] targets (a group process has no REST edge of its own)
    if cfg.heliograph.enabled:
        from dds_tpu_torch.clt.canary import parse_canary_targets
        from dds_tpu_torch.obs.heliograph import Heliograph

        targets, bad = parse_canary_targets(cfg.heliograph.targets)
        for entry in bad:
            log.warning("heliograph: skipping malformed target %r", entry)
        if targets:
            helio = Heliograph(cfg.heliograph, targets,
                               watchtower=watchtower if cfg.obs.audit_enabled else None,
                               ssl_context=ssl_client)
            helio.start()
            stoppables.append(_Stopper(helio.stop))

    dep = Deployment(cfg, net, dict(group.replicas), server, None, group.trudy,
                     stoppables, flight_dir, ssl_client=ssl_client)
    # replica spans are local but the coordinators live elsewhere: the
    # quorum-intersection checks would see every commit as quorumless
    _attach_watchtower(cfg, check_quorum=False,
                       geometry={gid: (sh.quorum_size, sh.replicas_per_group)})
    chronoscope.attach(tracer)
    return dep


# ------------------------------------------------------------- role: proxy


async def _launch_proxy(cfg, net, stoppables, flight_dir, ssl_server, ssl_client):
    """The REST proxy and a ShardRouter over remote groups, with the map's
    bootstrap, epoch-gossip freshness and the cross-host reshard
    controller."""
    from dds_tpu_torch.run import Deployment, proxy_config, shard_configs

    sh, fab = cfg.shard, cfg.fabric
    secret = cfg.security.abd_mac_secret.encode()
    _, _, abd_cfg = shard_configs(cfg)
    namer = _namer(net)

    smap = initial_map(cfg)
    boot, body = await bootstrap_map(fab.bootstrap, secret, timeout=fab.bootstrap_timeout,
                                     ssl_context=ssl_client)
    state_flag = None
    if boot is not None and boot.epoch >= smap.epoch:
        smap = boot
        state_flag = (body or {}).get("state")

    hub = EpochGossipHub()
    slo_engine = SloEngine.from_obs(cfg.obs)
    # Panopticon: the fleet collector lives with the proxy role; the group
    # processes' shipped spans stitch onto this process's, and the
    # federated /fleet/* views serve from here
    collector = None
    if cfg.obs.fleet.enabled:
        collector = FleetCollector(
            net,
            secret=_fleet_secret(cfg),
            host=namer("_id").rsplit("/", 1)[0],
            role="proxy",
            region=fab.region,
            stitch_window=cfg.obs.fleet.stitch_window,
            staleness=cfg.obs.fleet.staleness,
            flush_interval=cfg.obs.fleet.flush_interval,
            slo=slo_engine,
            # audits off: stitched traces are sunk, not judged against an
            # unconfigured geometry
            watchtower=watchtower if cfg.obs.audit_enabled else NullWatchtower(),
        )
    # Atlas: a proxy homed in a region reads locally from the groups homed
    # there (placement "home": one group process, one region)
    homes = (group_regions(sorted(fab.groups), list(cfg.geo.regions))
             if cfg.geo.enabled and fab.region and cfg.geo.lease_ttl > 0 else {})

    def _audit_geometry(m: ShardMap) -> dict:
        return {g: (sh.quorum_size, sh.replicas_per_group) for g in m.groups}

    def make_client(cgid: str) -> AbdClient:
        active, _ = group_endpoints(cfg, cgid)
        hostport = fab.groups[cgid]
        ccfg = dataclasses.replace(abd_cfg, shard=cgid,
                                   supervisor=f"{hostport}/{cgid}-supervisor")
        if cgid in homes:
            ccfg.region = fab.region
            ccfg.replica_regions = {a: homes[cgid] for a in active}
            ccfg.lease_ttl = cfg.geo.lease_ttl
            ccfg.lease_enabled = True
        return AbdClient(namer(f"{cgid}-proxy"), net, active, ccfg)

    def on_install(new_map: ShardMap, old_map: ShardMap) -> None:
        # a split-born group enters the map: grow its client from the
        # fabric config
        for new_gid in new_map.groups:
            if new_gid in router.clients or new_gid not in fab.groups:
                continue
            c = make_client(new_gid)
            c.shard_epoch = lambda m=manager: m.current().epoch
            router.clients[new_gid] = c
            log.info("grew a client for new group %s", new_gid)
        if cfg.obs.audit_enabled:
            # a split-born group audits against its own geometry too
            watchtower.configure(group_geometry=_audit_geometry(new_map))

    manager = RemoteShardManager(smap, secret, hub=hub, on_install=on_install)
    if state_flag:
        manager.install(smap, state=state_flag)
    follower = MapFollower(manager, fab.bootstrap, secret, wait=fab.gossip_wait,
                           ssl_context=ssl_client)
    clients = {g: make_client(g) for g in smap.groups if g in fab.groups}
    if not clients:
        raise ValueError("no routable groups: [fabric.groups] must map every group id "
                         "in the shard map to its transport host:port")
    router = ShardRouter(manager, clients, refresh=follower.poke)
    follower.start()
    stoppables.append(_Stopper(follower.stop))

    rpc = AgentClient(net, namer("meridian-ctl"), timeout=fab.rpc_timeout,
                      budget=fab.rpc_budget or None)
    stoppables.append(_Stopper(rpc.stop))
    controller = MeridianController(cfg, net, namer, manager, rpc)
    if sh.plan_dir:
        # a crashed predecessor may have left a plan mid-flight: resolve it
        # (back before its commit, forward after) before any traffic
        await controller.recover()

    sup0 = next(iter(clients.values())).cfg.supervisor
    server = DDSRestServer(
        router,
        proxy_config(cfg, sup0, ssl_server, ssl_client),
        local_replicas={},
        slo=slo_engine,
        gossip=hub,
        reshard=controller,
        fleet=collector,
    )
    await server.start()
    _wire_helmsman(cfg, server, stoppables,
                   load_census=router.load_census,
                   breaker_census=router.breaker_census,
                   split=lambda gid, c=controller: c.split(gid),
                   merge=lambda gid, c=controller: c.merge(gid),
                   promote=lambda gid, c=controller: c.promote(gid),
                   rebalancer=controller.rebalancer,
                   source_ages=collector.source_ages if collector is not None else None,
                   regions=collector.source_regions if collector is not None else None)
    _identify(cfg, namer, "proxy")
    dep = Deployment(cfg, net, {}, server, None, None, stoppables, flight_dir,
                     ssl_client=ssl_client)
    if collector is None:
        # no replica handler spans in this process: the tag, repair and
        # state-machine audits stay on, the quorum-intersection ones cannot
        # be sound
        _attach_watchtower(cfg, check_quorum=False, geometry=_audit_geometry(smap))
        chronoscope.attach(tracer)
        return dep
    collector.start()
    stoppables.append(_Stopper(collector.stop))
    if cfg.obs.audit_enabled:
        # the collector replays stitched trace trees (the local proxy spans
        # and the shipped replica handler spans), so the quorum-
        # intersection audits are sound here again. The Watchtower is fed
        # only through the collector, never attached to the tracer: each
        # trace is audited once, complete
        watchtower.reset()
        watchtower.configure(quorum_size=sh.quorum_size,
                             n_replicas=sh.replicas_per_group,
                             check_quorum=cfg.obs.audit_quorum_checks,
                             group_geometry=_audit_geometry(manager.current()))
    # Chronoscope follows the same once-a-trace rule: fed only through the
    # collector's stitched replay, so its critical paths include the remote
    # replica-apply spans
    chronoscope.detach()
    collector.profiler = chronoscope
    return dep
