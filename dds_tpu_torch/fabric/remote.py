"""Meridian cross-host reshard plumbing: agents and remote group handles.

Copy of `dds_tpu/fabric/remote.py`. `shard/rebalance.Rebalancer` drives
in-process `ShardGroup` handles: the freeze is a synchronous
`state.install`, the seed export a repository read, the post-activation
prune a method call. Across hosts those three become control-plane RPCs;
everything else the Rebalancer does (manifests, chunk streaming, ack
quorums) already rides transport messages.

- `MeridianAgent` runs in every group process at `<host:port>/<gid>-fabric`.
  It installs signed maps into the group's shared fencing state (freeze,
  rollback; a `lease` makes the install provisional), adopts activations
  into the process's serving view (waking `/shards` long-polls), exports a
  replica's repository as migration seed data and prunes after cut-over.
- `AgentClient` and `RemoteShardGroup` live in the controller (proxy)
  process and present the `ShardGroup` surface the Rebalancer expects,
  with `state.install`, `export_from` and `prune_unowned` returning
  awaitables (the Rebalancer awaits whatever it gets, `_maybe_await`).

Trust: the map is HMAC-signed and re-verified at the agent, so install
and activate frames only need delivery. An export is data (every
receiving replica re-verifies entries against the attested manifest
quorum), and a prune drops only keys the group's own fencing map
disowns. The frames ride the authenticated transport (frame MAC, node
identity, intranet TLS).
"""

from __future__ import annotations

import asyncio
import logging

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.shard.shardmap import ShardMap
from dds_tpu_torch.utils import sigs
from dds_tpu_torch.utils.retry import Deadline, RetryPolicy, retry_deadline

log = logging.getLogger("dds_torch.fabric.remote")


class MeridianAgent:
    """A group process's control endpoint for the fabric RPCs."""

    def __init__(self, net, addr: str, group, view, secret: bytes, hub=None):
        self.net = net
        self.addr = addr
        self.group = group  # the local shard.fabric.ShardGroup
        self.view = view    # the RemoteShardManager serving view
        self.secret = secret
        self.hub = hub
        net.register(addr, self.handle)

    def stop(self) -> None:
        self.net.unregister(self.addr)

    def _ack(self, dest: str, nonce: int, ok: bool, error: str = "") -> None:
        self.net.send(self.addr, dest,
                      M.ShardMapAck(nonce, self.group.state.epoch, ok, error))

    async def handle(self, sender: str, msg) -> None:
        if isinstance(msg, M.ShardMapInstall):
            try:
                smap = ShardMap.from_wire(msg.map)
                self.group.state.install(smap, force=msg.force, lease=msg.lease)
            except (ValueError, KeyError, TypeError) as e:
                log.warning("refused shard-map install from %s: %s", sender, e)
                self._ack(sender, msg.nonce, False, str(e))
                return
            self._ack(sender, msg.nonce, True)
        elif isinstance(msg, M.ShardMapActivate):
            try:
                smap = ShardMap.from_wire(msg.map)
                self.view.install(smap)  # verifies and wakes the hub
                # the fence follows the active map epoch-forward; >= so an
                # activation also commits the equal-epoch map the freeze
                # installed under a fence lease
                if smap.epoch >= self.group.state.epoch:
                    self.group.state.install(smap)
            except (ValueError, KeyError, TypeError) as e:
                log.warning("refused shard-map activate from %s: %s", sender, e)
                self._ack(sender, msg.nonce, False, str(e))
                return
            self._ack(sender, msg.nonce, True)
        elif isinstance(msg, M.ShardExportRequest):
            entries = self.group.export_from(msg.endpoint)
            self.net.send(self.addr, sender, M.ShardExport(msg.nonce, entries))
        elif isinstance(msg, M.ShardPruneRequest):
            dropped = self.group.prune_unowned()
            self.net.send(self.addr, sender, M.ShardPruned(msg.nonce, dropped))


class AgentError(RuntimeError):
    """An agent refused an RPC (bad map, backwards epoch): definitive,
    never retried; the Rebalancer's failure path aborts the plan."""


class AgentTimeout(AgentError):
    """An agent did not answer within one attempt's timeout: the only
    retryable agent failure. `AgentClient._call` retries it under the
    call's `Deadline`; a spent budget raises `DeadlineExceededError`,
    which the Rebalancer turns into a plan abort instead of a hang."""


class AgentClient:
    """The controller's RPC endpoint: correlates nonced requests with the
    agents' replies, one instance for every remote group.

    Every call runs under a `utils/retry.Deadline`: `timeout` is the wait
    of one attempt, `budget` the total a call may spend across attempts
    (jittered exponential backoff between them, default about 3.5 x the
    timeout). Lost frames and a restarting agent are retried away; a
    refusal is definitive."""

    def __init__(self, net, addr: str, timeout: float = 5.0,
                 budget: float | None = None):
        self.net = net
        self.addr = addr
        self.timeout = timeout
        self.budget = budget if budget is not None else 3.5 * timeout
        self.policy = RetryPolicy(base=0.05, multiplier=2.0, max_delay=1.0)
        self._pending: dict[int, asyncio.Future] = {}
        net.register(addr, self.handle)

    def stop(self) -> None:
        self.net.unregister(self.addr)

    async def handle(self, sender: str, msg) -> None:
        fut = self._pending.get(getattr(msg, "nonce", None))
        if fut is not None and not fut.done():
            fut.set_result(msg)

    async def _call_once(self, agent: str, make_msg, timeout: float):
        nonce = sigs.generate_nonce()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[nonce] = fut
        try:
            self.net.send(self.addr, agent, make_msg(nonce))
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise AgentTimeout(f"agent {agent} did not answer")
        finally:
            self._pending.pop(nonce, None)

    async def _call(self, agent: str, make_msg, *, timeout: float | None = None,
                    deadline: Deadline | None = None):
        per_attempt = timeout or self.timeout
        deadline = deadline or Deadline(max(self.budget, per_attempt))

        async def attempt():
            t = deadline.timeout(per_attempt)
            if t <= 0:
                raise AgentTimeout(f"agent {agent}: no budget left")
            return await self._call_once(agent, make_msg, t)

        # only AgentTimeout retries; a refusal propagates at once, a spent
        # deadline as DeadlineExceededError
        return await retry_deadline(attempt, deadline, self.policy,
                                    retry_on=(AgentTimeout,))

    async def install(self, agent: str, smap: ShardMap, force: bool = False,
                      lease: float = 0.0, deadline: Deadline | None = None) -> None:
        wire = smap.to_wire()
        reply = await self._call(agent, lambda n: M.ShardMapInstall(wire, force, n, lease),
                                 deadline=deadline)
        if not isinstance(reply, M.ShardMapAck) or not reply.ok:
            raise AgentError(f"agent {agent} refused map install: "
                             f"{getattr(reply, 'error', 'bad reply')!r}")

    async def activate(self, agent: str, smap: ShardMap,
                       deadline: Deadline | None = None) -> None:
        wire = smap.to_wire()
        reply = await self._call(agent, lambda n: M.ShardMapActivate(wire, n),
                                 deadline=deadline)
        if not isinstance(reply, M.ShardMapAck) or not reply.ok:
            raise AgentError(f"agent {agent} refused map activate: "
                             f"{getattr(reply, 'error', 'bad reply')!r}")

    async def export(self, agent: str, endpoint: str, timeout: float | None = None,
                     deadline: Deadline | None = None) -> dict:
        reply = await self._call(
            agent, lambda n: M.ShardExportRequest(endpoint, n), timeout=timeout,
            deadline=deadline or Deadline(max(self.budget, timeout or self.timeout)))
        if not isinstance(reply, M.ShardExport):
            raise AgentError(f"agent {agent} sent a bad export reply")
        return dict(reply.entries)

    async def prune(self, agent: str, deadline: Deadline | None = None) -> int:
        reply = await self._call(agent, lambda n: M.ShardPruneRequest(n),
                                 deadline=deadline)
        if not isinstance(reply, M.ShardPruned):
            raise AgentError(f"agent {agent} sent a bad prune reply")
        return int(reply.dropped)


class _RemoteGroupState:
    """A `ShardState`-shaped fencing handle whose `install` returns an
    awaitable that resolves when the remote agent acked."""

    def __init__(self, rpc: AgentClient, agent: str):
        self._rpc = rpc
        self._agent = agent

    def install(self, smap: ShardMap, force: bool = False, lease: float = 0.0):
        return self._rpc.install(self._agent, smap, force=force, lease=lease)


class RemoteShardGroup:
    """The Rebalancer's handle for a group hosted in another process: the
    attribute surface of `shard.fabric.ShardGroup`, with the three calls
    that touch state returning awaitables over the agent RPCs. Replica
    addresses derive from the group's "host:port" in `[fabric.groups]` and
    the homogeneous `[shard]` geometry, as in every process of the fleet."""

    def __init__(self, gid: str, hostport: str, *, n_active: int, n_sentinent: int,
                 quorum: int, rpc: AgentClient, export_timeout: float = 10.0):
        self.gid = gid
        self.hostport = hostport
        self.active = [f"{hostport}/{gid}-replica-{i}" for i in range(n_active)]
        self.sentinent = [f"{hostport}/{gid}-replica-{i}"
                          for i in range(n_active, n_active + n_sentinent)]
        self.quorum_size = quorum
        self.agent = f"{hostport}/{gid}-fabric"
        self.state = _RemoteGroupState(rpc, self.agent)
        self._rpc = rpc
        self._export_timeout = export_timeout

    def all_replicas(self) -> list[str]:
        return self.active + self.sentinent

    def export_from(self, endpoint: str):
        if endpoint is None:
            async def _empty():
                return {}
            return _empty()
        return self._rpc.export(self.agent, endpoint, timeout=self._export_timeout)

    def prune_unowned(self):
        return self._rpc.prune(self.agent)
