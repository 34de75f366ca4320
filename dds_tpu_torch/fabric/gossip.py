"""Meridian shard-map distribution: bootstrap and epoch-gossip freshness.

Copy of `dds_tpu/fabric/gossip.py`. A multi-host constellation shares one
piece of routing state, the signed, epoch-versioned `ShardMap`, and three
kinds of consumers keep it fresh without an operator:

- remote proxies bootstrap the map from any peer's signed `GET /shards`
  and then hold a long-poll (`If-None-Match: "<epoch>"` + `?wait=<s>`)
  that answers 304 when nothing changed and the full signed map the
  moment an epoch bump lands;
- group processes mirror the active map the same way, so any of them can
  serve `/shards` to a (re)starting proxy;
- the serving side parks those long-polls on an `EpochGossipHub` and
  wakes them from the reshard activation path.

Trust never rides the HTTP hop: every installed map re-verifies its HMAC
(the intranet secret) and epochs only move forward, so a malicious or
stale peer can stall freshness but never re-home the keyspace.
"""

from __future__ import annotations

import asyncio
import json
import logging

from dds_tpu_torch.http.miniserver import http_request_full
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.shard.shardmap import ShardMap
from dds_tpu_torch.utils.tasks import supervised_task

log = logging.getLogger("dds_torch.fabric.gossip")


class EpochGossipHub:
    """Server-side wake-up fan-out for `/shards` long-polls: a waiter
    takes the current event and sleeps on it; `notify()` swaps in a fresh
    event and fires the old one, waking every parked poller once per
    change. Callers re-check the epoch around the wait, so a notify racing
    a subscribe costs one spurious re-check, never a lost wake-up.
    `close()` releases every parked poller for good (a stopping process
    answers them at once instead of holding them to their wait)."""

    def __init__(self):
        self._event = asyncio.Event()
        self.closed = False

    def notify(self) -> None:
        event, self._event = self._event, asyncio.Event()
        event.set()

    def close(self) -> None:
        self.closed = True
        self._event.set()

    async def wait_change(self, timeout: float) -> bool:
        """True when a change (or the close) fired within `timeout` s."""
        if self.closed:
            return True
        event = self._event
        try:
            await asyncio.wait_for(event.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False


class RemoteShardManager:
    """A router-facing mirror of `shard.ShardManager` for processes that
    do not own the map (remote proxies, group-process status views): the
    same read surface (`current()`, `epoch`, `state`) plus a verified,
    forward-only `install()` fed by bootstrap and gossip, and the
    begin/end/activate hooks the Rebalancer drives when this process runs
    a split."""

    def __init__(self, smap: ShardMap, secret: bytes, hub=None, on_install=None):
        if not smap.verify(secret):
            raise ValueError("shard map signature invalid")
        self.secret = secret
        self._map = smap
        self.state = "stable"  # stable | resharding
        self.hub = hub
        # on_install(new_map, old_map) fires after every adopted map: the
        # proxy grows a client for a split-born group here
        self.on_install = on_install

    def current(self) -> ShardMap:
        return self._map

    @property
    def epoch(self) -> int:
        return self._map.epoch

    def install(self, smap: ShardMap, state: str | None = None) -> bool:
        """Adopt a newer signed map; True when the epoch moved. The same or
        an older epoch is ignored (gossip redelivers), a forged signature
        raises."""
        if not smap.verify(self.secret):
            raise ValueError("shard map signature invalid")
        if state in ("stable", "resharding"):
            self.state = state
        if smap.epoch <= self._map.epoch:
            return False
        old, self._map = self._map, smap
        metrics.set("dds_shard_epoch", smap.epoch, help="active shard-map epoch")
        if self.on_install is not None:
            try:
                self.on_install(smap, old)
            except Exception:
                log.exception("shard-map install hook failed")
        if self.hub is not None:
            self.hub.notify()
        return True

    def install_wire(self, wire: dict, state: str | None = None) -> bool:
        return self.install(ShardMap.from_wire(wire), state=state)

    # the Rebalancer's surface, when this process drives a split
    def begin_reshard(self) -> None:
        self.state = "resharding"

    def end_reshard(self) -> None:
        self.state = "stable"

    def activate(self, smap: ShardMap) -> None:
        if smap.epoch <= self._map.epoch:
            raise ValueError(f"activation requires a newer epoch "
                             f"({smap.epoch} <= {self._map.epoch})")
        self.install(smap)


async def fetch_shards(peer: str, *, etag: int | None = None, wait: float = 0.0,
                       timeout: float = 5.0, ssl_context=None):
    """One `GET /shards` against `peer` ("host:port"): the parsed body, or
    None on 304 (fresh). Transport trouble raises (OSError family), and
    the callers rotate peers."""
    host, _, port = peer.rpartition(":")
    target = "/shards"
    headers = {}
    if wait > 0:
        target += f"?wait={wait:g}"
    if etag is not None:
        headers["If-None-Match"] = f'"{etag}"'
    status, _, body = await http_request_full(
        host, int(port), "GET", target, headers=headers,
        ssl_context=ssl_context, timeout=timeout + wait,
    )
    if status == 304:
        return None
    if status != 200:
        raise ConnectionError(f"/shards on {peer} answered {status}")
    return json.loads(body)


async def bootstrap_map(peers: list[str], secret: bytes, *, timeout: float = 3.0,
                        ssl_context=None):
    """The first reachable peer's verified signed map: (ShardMap, status
    body), or (None, None) when nobody answered (the caller falls back to
    the deterministic epoch-1 map, and the follower keeps trying)."""
    for peer in peers:
        try:
            body = await fetch_shards(peer, timeout=timeout, ssl_context=ssl_context)
        except (OSError, ValueError, EOFError, asyncio.TimeoutError,
                ConnectionError) as e:
            log.debug("shard-map bootstrap from %s failed: %s", peer, e)
            continue
        try:
            smap = ShardMap.from_wire(body["map"])
        except (KeyError, TypeError, ValueError) as e:
            log.warning("malformed /shards body from %s: %s", peer, e)
            continue
        if not smap.verify(secret):
            log.warning("peer %s served a forged shard map; skipped", peer)
            continue
        log.info("bootstrapped shard map epoch %d from %s", smap.epoch, peer)
        return smap, body
    return None, None


class MapFollower:
    """The remote router's freshness loop: long-poll `/shards` across the
    configured peers with `If-None-Match`, so a fresh map costs one header
    exchange (304) per `wait` window and an epoch bump arrives the moment
    the serving side's hub fires. `poke()` (the router's WrongShard
    refresh hook) breaks the current wait and refetches at once."""

    def __init__(self, manager, peers: list[str], secret: bytes, *, wait: float = 25.0,
                 retry: float = 0.5, ssl_context=None, install_also=()):
        self.manager = manager
        self.peers = list(peers)
        self.secret = secret
        self.wait = wait
        self.retry = retry
        self.ssl_context = ssl_context
        # fencing states (shard.ShardState) that adopt every map the
        # follower installs: a group process keeps its replicas' shared
        # fence in step with its serving view
        self.install_also = list(install_also)
        self._task: asyncio.Task | None = None
        self._poke = asyncio.Event()

    def poke(self) -> None:
        self._poke.set()

    def start(self) -> None:
        if self.peers and (self._task is None or self._task.done()):
            self._task = supervised_task(self._loop(), name="gossip.map_follower")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def _install(self, body: dict) -> None:
        smap = ShardMap.from_wire(body["map"])
        if self.manager.install(smap, state=body.get("state")):
            metrics.inc("dds_fabric_gossip_updates_total",
                        help="shard-map epochs adopted via gossip")
        for state in self.install_also:
            try:
                if smap.epoch > state.epoch:
                    state.install(smap)
            except ValueError:
                log.exception("gossiped map refused by fencing state")

    async def sync_once(self) -> bool:
        """One immediate refresh across the peers (no long-poll): True when
        any peer answered (fresh or newer)."""
        for peer in self.peers:
            try:
                body = await fetch_shards(peer, etag=self.manager.epoch,
                                          timeout=self.retry + 2.0,
                                          ssl_context=self.ssl_context)
            except (OSError, ValueError, EOFError, asyncio.TimeoutError,
                    ConnectionError):
                continue
            if body is not None:
                self._install(body)
            return True
        return False

    async def _loop(self) -> None:
        i = 0
        loop = asyncio.get_running_loop()
        while True:
            peer = self.peers[i % len(self.peers)]
            poked = self._poke.is_set()
            self._poke.clear()
            t0 = loop.time()
            try:
                body = await fetch_shards(
                    peer, etag=self.manager.epoch,
                    # a poke wants the answer now, not after a parked poll
                    wait=0.0 if poked else self.wait,
                    timeout=self.retry + 5.0, ssl_context=self.ssl_context,
                )
                if body is not None:
                    self._install(body)
                elif not poked and loop.time() - t0 < min(0.05, self.wait):
                    # a peer that answers 304 without holding the poll must
                    # not become a hot polling loop
                    await asyncio.sleep(self.retry)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.debug("gossip poll of %s failed: %s", peer, e)
                i += 1  # the next peer
                try:  # back off, but wake at once on a poke
                    await asyncio.wait_for(self._poke.wait(), self.retry)
                except asyncio.TimeoutError:
                    pass
