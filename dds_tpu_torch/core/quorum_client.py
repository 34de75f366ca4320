"""Proxy-side ABD access: nonce-challenged, HMAC-verified quorum reads/writes.

Trimmed copy of `dds_tpu/core/quorum_client.py`. A point op picks a
random trusted replica as coordinator (the supervisor's freshest half
first), sends a signed `Envelope(IRead/IWrite)`, awaits the enveloped
reply, and verifies (a) the challenge nonce is the request nonce +
increment, (b) the proxy HMAC over the reply, (c) the echoed key. Every
protocol violation adds a suspicion
strike on the coordinator (3 strikes exclude it) and raises a typed
Byzantine exception; mere timeouts trip a per-coordinator circuit breaker
that steers the next picks elsewhere and self-heals through half-open
probes. When every trusted coordinator's breaker is open past the
caller's budget, `AllBreakersOpenError` fails the request at once.
`ActiveReplicas` membership updates are accepted from the configured
supervisor only (`refresh_from` asks for them) and merged, never shrunk.
`read_tags` validates many cached keys with ONE tag-only round that the
proxy broadcasts itself. Callers pass a `Deadline` so each attempt's
timeout shrinks to the remaining request budget. A verified reply
annotates its `abd.fetch` / `abd.write` span with `ok`, `op`, `key`, `seq`
and `tag_id`, the record the Watchtower audits (`obs/watchtower.py`).

Atlas read-local leases (`lease_enabled`, set by the Constellation for a
client homed in a region): a read first asks the in-region replica for
the region's TTL read lease and then reads one hop from it (`LocalRead`),
its span tagged `lease=True` and `replica=<holder>`; any refusal, timeout
or invalid reply drops the lease session and the read takes the full
quorum path. Lease replies correlate by request nonce only, so a late one
never resolves an ABD round.

A junk reply from the asked coordinator resolves the outstanding request
and is then rejected by validation, rather than stalling until timeout.

In a Constellation (`shard/`) the router labels each group's client
(`cfg.shard`) and installs `shard_epoch`, the active map's epoch, which
stamps every Envelope and ReadTagBatch; a signed `WrongShard` fence from a
replica raises `WrongShardError` (no suspicion: the replica behaved
correctly), a forged one is a protocol violation like any other.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Optional

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.core.errors import (
    AllBreakersOpenError,
    ByzFailedNonceChallengeError,
    ByzInvalidKeyError,
    ByzInvalidSignatureError,
    ByzUnknownReplyError,
    WrongShardError,
)
from dds_tpu_torch.core.transport import Transport
from dds_tpu_torch.utils import sigs
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils.retry import CircuitBreaker, Deadline, DeadlineExceededError
from dds_tpu_torch.utils.trace import tracer
from dds_tpu_torch.utils.trust import TrustedNodesList

log = logging.getLogger("dds_torch.quorum_client")

# vote marker: "this replica's whole tag vector equals the caller's
# fingerprinted cached vector" (see read_tags)
_UNCHANGED = object()


@dataclass
class AbdClientConfig:
    proxy_mac_secret: bytes = b"rest2abd"
    nonce_increment: int = 1
    request_timeout: float = 5.0
    supervisor: str | None = None  # only accept ActiveReplicas from here
    # read_tags verifies each replica's intranet MAC itself, so it needs
    # the ABD secret and the quorum size
    abd_mac_secret: bytes = b"intranet-abd-secret"
    quorum_size: int = 3
    # per-coordinator circuit breaker: ask timeouts trip it, half-open
    # probes heal it; protocol violations also land on the permanent
    # 3-strike suspicion counter
    breaker_threshold: int = 3
    breaker_reset: float = 2.0
    # fail at once when EVERY trusted coordinator's breaker is open and
    # none will half-open within the caller's remaining budget
    fast_fail_all_open: bool = True
    # Constellation shard label for this client's metric series (empty =
    # unsharded, series keep their label sets)
    shard: str = ""
    # Atlas read-local leases (dds_tpu_torch/geo): when enabled and an
    # in-region replica is known, reads first try a single-hop LocalRead
    # against the TTL-leased holder; any refusal, timeout or validation
    # failure drops the lease session and the read falls back to the full
    # quorum path, so leases are a latency optimisation, never a
    # correctness dependency
    lease_enabled: bool = False
    region: str = ""  # this proxy's home region ("" = geo-unaware)
    # replica addr (or bare name) -> region label, as placed by shard.fabric
    replica_regions: Optional[dict] = None
    lease_ttl: float = 2.0
    lease_renew_margin: float = 0.5  # renew when lease remaining < margin
    local_read_timeout: float = 0.75  # LocalRead budget before fallback


class AbdClient:
    def __init__(self, addr: str, net: Transport, replicas: list[str],
                 config: AbdClientConfig | None = None):
        self.addr = addr
        self.net = net
        self.cfg = config or AbdClientConfig()
        self.replicas = TrustedNodesList(replicas)
        # coordinator addr -> CircuitBreaker (created on first use)
        self.breakers: dict[str, CircuitBreaker] = {}
        # challenge nonce -> (future, coordinator)
        self._pending: dict[int, tuple[asyncio.Future, str]] = {}
        self._preferred: list[str] = []  # supervisor's freshest-half view
        # tag-broadcast nonce -> (future, sender->tags votes, digest, keys,
        # request fingerprint | None)
        self._pending_tags: dict[int, tuple] = {}
        # Constellation: the router installs a supplier of the ACTIVE map
        # epoch, stamped on every Envelope/ReadTagBatch so replicas can
        # fence stale routes. None = -1 = unsharded
        self.shard_epoch = None
        # Atlas lease session: {"target", "replica", "token", "renew_at",
        # "expires"} while we hold an in-region read lease, else None.
        # Client-side expiry counts from SEND time, so it is always
        # conservative against the holder's table clock
        self._lease: Optional[dict] = None
        self._lease_retry_at = 0.0  # grant backoff after a refusal/timeout
        # lease/local-read request nonce -> future (replies echo it)
        self._pending_lease: dict[int, asyncio.Future] = {}
        self._lease_grant: Optional[asyncio.Task] = None  # the grant in flight
        self._now = time.monotonic  # test hook (fake-clock schedules)
        net.register(addr, self.handle)

    async def handle(self, sender: str, msg) -> None:
        if isinstance(msg, M.Envelope) and msg.nonce in self._pending:
            fut, _ = self._pending[msg.nonce]
            if not fut.done():
                fut.set_result(msg)
            return
        if isinstance(msg, M.TagBatchReply) and msg.nonce in self._pending_tags:
            self._on_tag_batch_reply(sender, msg)
            return
        if isinstance(msg, M.WrongShard):
            # shard fence rejection: resolve the matching outstanding request
            # (Envelope ops correlate by challenge nonce, tag batches by
            # request nonce) BEFORE the junk-reply fallthrough, so a fence
            # never resolves another op as junk and strikes an honest replica
            if msg.nonce in self._pending:
                fut, _ = self._pending[msg.nonce]
                if not fut.done():
                    fut.set_result(msg)
            elif msg.nonce in self._pending_tags:
                self._on_wrong_shard_batch(sender, msg)
            return
        if isinstance(msg, (M.LeaseGrant, M.LocalReadReply)):
            # correlate by REQUEST nonce; an unmatched (late) lease reply is
            # dropped HERE, never falling through to the junk-reply path,
            # where it would resolve an ABD round in flight and strike an
            # honest replica that also coordinates it
            entry = self._pending_lease.get(msg.nonce)
            if entry is not None and not entry.done():
                entry.set_result(msg)
            return
        if isinstance(msg, M.ActiveReplicas):
            if self.cfg.supervisor is not None and sender != self.cfg.supervisor:
                log.warning("ignoring ActiveReplicas from non-supervisor %s", sender)
                return
            if msg.replicas:
                # the supervisor serves only the freshest HALF of the active
                # list: merge, don't reset — broadcasts (read_tags) need the
                # whole quorum membership, which a partial view must not
                # shrink
                self.replicas.merge(msg.replicas)
                self._preferred = list(msg.replicas)
            return
        # junk from a coordinator we are waiting on resolves that request;
        # validation will reject it
        for fut, coord in list(self._pending.values()):
            if coord == sender and not fut.done():
                fut.set_result(msg)
                return
        log.debug("unmatched message from %s: %s", sender, type(msg).__name__)

    def _breaker(self, node: str) -> CircuitBreaker:
        b = self.breakers.get(node)
        if b is None:
            b = self.breakers[node] = CircuitBreaker(
                self.cfg.breaker_threshold, self.cfg.breaker_reset,
                name=node.rsplit("/", 1)[-1],
            )
        return b

    def breaker_states(self) -> dict[str, str]:
        """Current breaker state per coordinator (for the /health route)."""
        return {n: b.state for n, b in sorted(self.breakers.items())}

    def breaker_census(self) -> tuple[int, list[float]]:
        """(trusted coordinator count, half-open ETAs of the ones whose
        breaker currently refuses traffic): what the Retry-After
        derivation reads."""
        trusted = self.replicas.get_trusted()
        etas = []
        for n in trusted:
            b = self.breakers.get(n)
            if b is not None and not b.allow():
                etas.append(b.half_open_eta())
        return len(trusted), etas

    def _coord_failed(self, coord: str) -> None:
        """A coordinator answered with a PROTOCOL VIOLATION: permanent
        suspicion strike plus a breaker failure (steers the next pick away
        at once)."""
        self.replicas.increment_suspicion(coord)
        metrics.inc(
            "dds_coordinator_violations_total", node=coord.rsplit("/", 1)[-1],
            help="protocol violations observed per coordinator",
        )
        tracer.event("abd.coordinator_violation", node=coord)
        self._breaker(coord).record_failure()

    def _mlabels(self, **labels) -> dict:
        """Metric labels, plus the shard label when this client serves one
        group of a constellation (unsharded series stay label-stable)."""
        if self.cfg.shard:
            labels["shard"] = self.cfg.shard
        return labels

    def _epoch(self) -> int:
        return self.shard_epoch() if self.shard_epoch is not None else -1

    def _check_wrong_shard(self, reply, coord: str, key: str, challenge: int):
        """Validate a WrongShard fence reply for an Envelope op: a valid
        fence raises WrongShardError (no suspicion), a forged one is a
        protocol violation."""
        if not isinstance(reply, M.WrongShard):
            return
        cfg = self.cfg
        if (
            reply.nonce != challenge
            or reply.key != key
            or not sigs.validate_proxy_signature(
                cfg.proxy_mac_secret, reply.key, reply.nonce, reply.signature,
                ["wrong-shard", reply.epoch],
            )
        ):
            self._coord_failed(coord)
            raise ByzInvalidSignatureError(coord)
        self._breaker(coord).record_success()
        raise WrongShardError(key, replica_epoch=reply.epoch,
                              sent_epoch=self._epoch())

    def _attempt_timeout(self, deadline: Optional[Deadline]) -> float:
        """Per-attempt timeout, clipped to the caller's remaining budget."""
        if deadline is None:
            return self.cfg.request_timeout
        timeout = deadline.timeout(self.cfg.request_timeout)
        if timeout <= 0:
            raise DeadlineExceededError(
                f"no budget left for a quorum attempt ({deadline!r})",
                elapsed=deadline.elapsed(),
            )
        return timeout

    async def _ask(self, call, nonce: int, signature: bytes, exclude=(),
                   deadline: Optional[Deadline] = None, op: str = "ask"):
        # route around open breakers; defer_to falls back to the full
        # trusted set when everything is excluded (a degraded try beats
        # instant failure, and a success closes the breaker again)
        blocked = tuple(n for n, b in self.breakers.items() if not b.allow())
        self._maybe_fast_fail(blocked, deadline, op)
        timeout = self._attempt_timeout(deadline)
        coordinator = self.replicas.defer_to(
            tuple(exclude) + blocked, prefer=self._preferred
        )
        challenge = nonce + self.cfg.nonce_increment
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[challenge] = (fut, coordinator)
        try:
            self.net.send(self.addr, coordinator,
                          M.Envelope(call, nonce, signature, epoch=self._epoch()))
            try:
                reply = await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                metrics.inc(
                    "dds_quorum_timeouts_total", **self._mlabels(
                        op=op, node=coordinator.rsplit("/", 1)[-1],
                    ),
                    help="quorum rounds that timed out per coordinator",
                )
                # transient unreachability: breaker only, the permanent
                # suspicion counter is for protocol violations
                self._breaker(coordinator).record_failure()
                raise
            return reply, coordinator, challenge
        finally:
            self._pending.pop(challenge, None)

    def _maybe_fast_fail(self, blocked: tuple, deadline: Optional[Deadline],
                         op: str) -> None:
        """When EVERY trusted coordinator's breaker refuses traffic and the
        nearest half-open probe lies beyond the caller's remaining budget,
        no attempt of this request can succeed: raise the typed error now
        instead of burning the Deadline. While any probe still fits the
        budget the degraded try proceeds."""
        if not self.cfg.fast_fail_all_open or deadline is None:
            return
        trusted = self.replicas.get_trusted()
        if not trusted or any(n not in blocked for n in trusted):
            return
        eta = min(self.breakers[n].half_open_eta() for n in trusted)
        if eta < deadline.remaining():
            return
        metrics.inc(
            "dds_fast_fail_total", **self._mlabels(op=op),
            help="requests degraded instantly: all coordinator breakers "
                 "open past the remaining budget",
        )
        tracer.event("abd.fast_fail", op=op, eta=round(eta, 4),
                     targets=len(trusted))
        raise AllBreakersOpenError(eta, len(trusted))

    async def fetch_set(self, key: str, deadline: Optional[Deadline] = None):
        """Quorum read; returns the stored set (list) or None."""
        return (await self.fetch_set_tagged(key, deadline=deadline))[0]

    async def fetch_set_tagged(self, key: str, deadline: Optional[Deadline] = None):
        """Quorum read; returns (set|None, tag) — the tag of the value the
        coordinator returned, for tag-validated caching."""
        value, tag, _ = await self.fetch_set_attributed(key, deadline=deadline)
        return value, tag

    async def fetch_set_attributed(self, key: str, exclude=(),
                                   deadline: Optional[Deadline] = None):
        """Quorum read; returns (set|None, tag, coordinator). `exclude`
        steers coordinator choice away from given nodes (an audit's
        corroborating re-read goes through a different coordinator)."""
        nonce = sigs.generate_nonce()
        sig = sigs.proxy_signature(self.cfg.proxy_mac_secret, key, nonce)
        cfg = self.cfg
        with tracer.span("abd.fetch") as span_meta:
            # Atlas fast path: one hop to the in-region lease holder. Not
            # when the caller steers coordinators (`exclude`: an audit wants
            # an INDEPENDENT quorum read, not a lease echo); any miss falls
            # through to the quorum round
            if cfg.lease_enabled and not exclude:
                local = await self._local_fetch(key, span_meta, deadline)
                if local is not None:
                    return local
            reply, coord, challenge = await self._ask(
                M.IRead(key), nonce, sig, exclude, deadline, op="fetch"
            )
            span_meta["coordinator"] = coord
            self._check_wrong_shard(reply, coord, key, challenge)
            match reply:
                case M.Envelope(M.IReadReply(k, value, tag), rnonce, rsig):
                    if rnonce != challenge:
                        self._coord_failed(coord)
                        raise ByzFailedNonceChallengeError(coord)
                    if not sigs.validate_proxy_signature(
                        cfg.proxy_mac_secret, k, rnonce, rsig,
                        [value, sigs.tag_payload(tag)],
                    ):
                        self._coord_failed(coord)
                        raise ByzInvalidSignatureError(coord)
                    if k != key:
                        self._coord_failed(coord)
                        raise ByzInvalidKeyError(coord)
                    self._breaker(coord).record_success()
                    # the commit's audit record (obs/watchtower): a failed
                    # attempt records the span without `ok` and is never
                    # audited as a commit
                    span_meta["ok"] = True
                    span_meta["op"] = "read"
                    span_meta["key"] = key
                    if tag is not None:
                        span_meta["seq"] = tag.seq
                        span_meta["tag_id"] = tag.id
                    return value, tag, coord
                case _:
                    self._coord_failed(coord)
                    raise ByzUnknownReplyError(coord)

    async def write_set(self, key: str, value,
                        deadline: Optional[Deadline] = None) -> str:
        """Quorum write (value=None removes); returns the key on success."""
        return (await self.write_set_tagged(key, value, deadline=deadline))[0]

    async def write_set_tagged(self, key: str, value,
                               deadline: Optional[Deadline] = None):
        """Quorum write; returns (key, tag) where tag is the tag written."""
        nonce = sigs.generate_nonce()
        sig = sigs.proxy_signature(self.cfg.proxy_mac_secret, key, nonce, value)
        cfg = self.cfg
        with tracer.span("abd.write") as span_meta:
            reply, coord, challenge = await self._ask(
                M.IWrite(key, value), nonce, sig, (), deadline, op="write"
            )
            span_meta["coordinator"] = coord
            self._check_wrong_shard(reply, coord, key, challenge)
            match reply:
                case M.Envelope(M.IWriteReply(k, tag), rnonce, rsig):
                    if rnonce != challenge:
                        self._coord_failed(coord)
                        raise ByzFailedNonceChallengeError(coord)
                    if not sigs.validate_proxy_signature(
                        cfg.proxy_mac_secret, k, rnonce, rsig,
                        sigs.tag_payload(tag),
                    ):
                        self._coord_failed(coord)
                        raise ByzInvalidSignatureError(coord)
                    if k != key:
                        self._coord_failed(coord)
                        raise ByzInvalidKeyError(coord)
                    self._breaker(coord).record_success()
                    span_meta["ok"] = True
                    span_meta["op"] = "write"
                    span_meta["key"] = key
                    if tag is not None:
                        span_meta["seq"] = tag.seq
                        span_meta["tag_id"] = tag.id
                    return k, tag
                case _:
                    self._coord_failed(coord)
                    raise ByzUnknownReplyError(coord)

    def _on_wrong_shard_batch(self, sender: str, msg: M.WrongShard) -> None:
        """A replica fenced a ReadTagBatch: the whole round fails with
        WrongShardError (the router re-partitions against a fresh map). A
        forged fence earns the sender a suspicion strike instead."""
        fut, _, _, keys, _ = self._pending_tags[msg.nonce]
        if fut.done():
            return
        if (
            msg.key not in keys
            or not sigs.validate_proxy_signature(
                self.cfg.proxy_mac_secret, msg.key, msg.nonce, msg.signature,
                ["wrong-shard", msg.epoch],
            )
        ):
            self.replicas.increment_suspicion(sender)
            return
        fut.set_exception(WrongShardError(
            msg.key, replica_epoch=msg.epoch, sent_epoch=self._epoch()
        ))

    def _on_tag_batch_reply(self, sender: str, msg: M.TagBatchReply) -> None:
        fut, votes, digest, keys, fp = self._pending_tags[msg.nonce]
        if fut.done() or sender in votes:
            return
        if msg.unchanged:
            # "my vector equals the fingerprint you sent": only meaningful
            # when we sent one and it matches; the MAC covers (fp, digest,
            # nonce)
            if (
                fp is None
                or msg.fingerprint != fp
                or msg.digest != digest
                or not sigs.validate_abd_batch_unchanged_signature(
                    self.cfg.abd_mac_secret, fp, msg.digest, msg.nonce,
                    msg.signature,
                )
            ):
                self.replicas.increment_suspicion(sender)
                return
            votes[sender] = _UNCHANGED
        else:
            if (
                msg.digest != digest
                or len(msg.tags) != len(keys)
                or not sigs.validate_abd_batch_signature(
                    self.cfg.abd_mac_secret, msg.tags, msg.digest, msg.nonce,
                    msg.signature,
                )
            ):
                self.replicas.increment_suspicion(sender)
                return
            votes[sender] = tuple(msg.tags)
        if len(votes) >= self.cfg.quorum_size:
            fut.set_result(list(votes.values()))

    # ------------------------------------------------- Atlas read-local leases

    def _local_replica(self) -> Optional[str]:
        """The trusted in-region replica eligible to hold our read lease:
        the first in trusted order (so seeded fleets pick the same one)
        whose breaker lets traffic through. A lease-plane timeout counts
        against the target's breaker, so once a dead holder's breaker
        opens the lease moves to the region's next replica; the reference
        takes the first in-region replica whatever its breaker says, and
        keeps asking a dead holder (ROADMAP §C 18). None when no in-region
        replica is eligible: the read takes the quorum path."""
        cfg = self.cfg
        if not cfg.lease_enabled or not cfg.region or not cfg.replica_regions:
            return None
        for addr in self.replicas.get_trusted():
            name = addr.rsplit("/", 1)[-1]
            region = cfg.replica_regions.get(
                addr, cfg.replica_regions.get(name, ""))
            if region == cfg.region:
                b = self.breakers.get(addr)
                if b is None or b.allow():
                    return addr
        return None

    def lease_state(self) -> Optional[dict]:
        """Current lease session for /health: {replica, region, remaining}
        or None."""
        lease = self._lease
        if lease is None:
            return None
        remaining = lease["expires"] - self._now()
        if remaining <= 0:
            return None
        return {"replica": lease["replica"], "region": self.cfg.region,
                "remaining": round(remaining, 3)}

    def invalidate_lease(self) -> None:
        """Drop the lease session; the next read goes full-quorum (and may
        re-acquire after the grant backoff)."""
        self._lease = None

    async def _ask_lease(self, target: str, msg, nonce: int, timeout: float):
        """One lease-plane round trip, correlated by request nonce."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending_lease[nonce] = fut
        try:
            self.net.send(self.addr, target, msg)
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending_lease.pop(nonce, None)

    async def _ensure_lease(self) -> Optional[dict]:
        """Grant-or-renew the region read lease. None = no lease available
        right now (no in-region replica, a refusal, or inside the
        backoff). Concurrent reads share one grant round: every grant
        mints a new token and kills the last, so the reference's one
        round per read leaves all but the last reader's token refused and
        those reads falling back to a full quorum (ROADMAP §C 19)."""
        lease, now = self._lease, self._now()
        if lease is not None and now < lease["renew_at"]:
            return lease
        if lease is None and now < self._lease_retry_at:
            return None
        if self._lease_grant is None or self._lease_grant.done():
            self._lease_grant = asyncio.ensure_future(self._grant_lease(now))
        return await asyncio.shield(self._lease_grant)

    async def _grant_lease(self, sent_at: float) -> Optional[dict]:
        """One grant round with the in-region replica: the new session, or
        None after a refusal, a timeout or an invalid grant (the backoff
        set and the failure counted)."""
        cfg = self.cfg
        target = self._local_replica()
        if target is None:
            self._lease = None
            return None
        nonce = sigs.generate_nonce()
        sig = sigs.manifest_signature(
            cfg.abd_mac_secret, "lease-request",
            {"region": cfg.region, "ttl": cfg.lease_ttl}, nonce)
        try:
            grant = await self._ask_lease(
                target, M.LeaseRequest(cfg.region, cfg.lease_ttl, nonce, sig),
                nonce, cfg.local_read_timeout)
        except asyncio.TimeoutError:
            grant = None
            self._breaker(target).record_failure()
        if (
            not isinstance(grant, M.LeaseGrant)
            or not grant.ok
            or grant.region != cfg.region
            or not sigs.validate_manifest_signature(
                cfg.abd_mac_secret, "lease-grant",
                {"region": grant.region, "replica": grant.replica,
                 "token": grant.token, "expires": grant.expires,
                 "ok": grant.ok}, nonce, grant.signature)
        ):
            self._lease = None
            self._lease_retry_at = self._now() + cfg.lease_renew_margin
            metrics.inc(
                "dds_geo_lease_failures_total", **self._mlabels(),
                help="lease grant/renew attempts that were refused, "
                     "timed out, or failed validation",
            )
            return None
        self._breaker(target).record_success()
        # expiry from SEND time: we stop using the token strictly before
        # the holder stops honouring it
        self._lease = {
            "target": target,
            "replica": grant.replica,
            "token": grant.token,
            "renew_at": sent_at + cfg.lease_ttl - cfg.lease_renew_margin,
            "expires": sent_at + cfg.lease_ttl,
        }
        return self._lease

    def _lease_fallback(self, reason: str, backoff: bool = True) -> None:
        """Drop the lease session after a failed local read (with the grant
        backoff unless `backoff` is False) and count the fallback."""
        self._lease = None
        if backoff:
            self._lease_retry_at = self._now() + self.cfg.lease_renew_margin
        metrics.inc(
            "dds_geo_local_read_fallbacks_total", **self._mlabels(reason=reason),
            help="lease reads that fell back to a full quorum round",
        )

    async def _local_fetch(self, key: str, span_meta: dict,
                           deadline: Optional[Deadline]):
        """Lease fast path for one read: a single hop to the in-region
        holder. Returns (value, tag, holder) or None, which means "take
        the full quorum path", never an error."""
        cfg = self.cfg
        lease = await self._ensure_lease()
        if lease is None:
            return None
        timeout = cfg.local_read_timeout
        if deadline is not None:
            timeout = min(timeout, deadline.remaining())
            if timeout <= 0:
                return None
        nonce = sigs.generate_nonce()
        sig = sigs.proxy_signature(cfg.proxy_mac_secret, key, nonce,
                                   ["local-read", cfg.region])
        try:
            reply = await self._ask_lease(
                lease["target"],
                M.LocalRead(key, cfg.region, lease["token"], nonce, sig,
                            epoch=self._epoch()),
                nonce, timeout)
        except asyncio.TimeoutError:
            # holder unreachable: the table-side TTL unpins the group's
            # quorums on its own, and its breaker steers the next grant
            self._breaker(lease["target"]).record_failure()
            self._lease_fallback("timeout")
            return None
        if (
            not isinstance(reply, M.LocalReadReply)
            or reply.key != key
            or not sigs.validate_proxy_signature(
                cfg.proxy_mac_secret, reply.key, reply.nonce, reply.signature,
                [reply.ok, reply.value,
                 sigs.tag_payload(reply.tag) if reply.tag is not None
                 else None])
        ):
            # a garbled or forged local reply is cryptographic evidence
            # like any other protocol violation
            self.replicas.increment_suspicion(lease["target"])
            self._lease_fallback("invalid", backoff=False)
            return None
        if not reply.ok:
            # typed refusal: the lease was revoked or expired table-side
            # (or the key is fenced)
            self._lease_fallback("refused")
            return None
        span_meta["ok"] = True
        span_meta["op"] = "read"
        span_meta["key"] = key
        # the Watchtower reads these two: `lease` switches the span from
        # the quorum-intersection bound to the lease-window invariant, and
        # `replica` is what its lease_lookup checks
        span_meta["lease"] = True
        span_meta["replica"] = lease["replica"]
        if reply.tag is not None:
            span_meta["seq"] = reply.tag.seq
            span_meta["tag_id"] = reply.tag.id
        return reply.value, reply.tag, lease["target"]

    async def read_tags(self, keys: list[str], digest: str | None = None,
                        fingerprint: bytes | None = None,
                        cached_tags: list | None = None,
                        deadline: Optional[Deadline] = None) -> list[M.ABDTag]:
        """Batched freshness probe: the quorum-max tag per key via ONE
        tag-only round broadcast by the proxy itself. Every reply's
        intranet MAC is verified here and the per-key max is taken over
        the first `quorum_size` valid vectors, so no single coordinator is
        trusted: any quorum intersects a completed write's quorum in an
        honest replica, so the max can never be deflated below the newest
        completed write's tag.

        Steady-state fast path: pass `fingerprint` (of `cached_tags`) and
        replicas whose vector matches answer `unchanged`; when every vote
        is unchanged the caller's own `cached_tags` list is returned BY
        IDENTITY (callers use `result is cached_tags` as the all-fresh
        signal)."""
        trusted = self.replicas.get_trusted()
        if len(trusted) < self.cfg.quorum_size:
            raise ByzUnknownReplyError(
                f"only {len(trusted)} trusted replicas < quorum {self.cfg.quorum_size}"
            )
        if fingerprint is not None and cached_tags is None:
            raise ValueError("fingerprint requires cached_tags")
        # the broadcast needs quorum_size replies, so a fabric whose every
        # coordinator breaker is open past the budget is as futile here as
        # for a point op
        self._maybe_fast_fail(
            tuple(n for n, b in self.breakers.items() if not b.allow()),
            deadline, "read_tags",
        )
        timeout = self._attempt_timeout(deadline)
        nonce = sigs.generate_nonce()
        if digest is None:
            digest = sigs.key_from_set(list(keys))
        sig = sigs.proxy_signature(self.cfg.proxy_mac_secret, digest, nonce)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending_tags[nonce] = (fut, {}, digest, tuple(keys), fingerprint)
        try:
            with tracer.span("abd.read_tags", k=len(keys)):
                req = M.ReadTagBatch(tuple(keys), nonce, sig, fingerprint,
                                     epoch=self._epoch())
                for replica in trusted:
                    self.net.send(self.addr, replica, req)
                vectors = await asyncio.wait_for(fut, timeout)
            if not keys:
                return []
            if all(v is _UNCHANGED for v in vectors):
                return cached_tags
            expanded = [cached_tags if v is _UNCHANGED else v for v in vectors]
            return [max(col) for col in zip(*expanded)]
        finally:
            self._pending_tags.pop(nonce, None)

    def refresh_from(self, supervisor: str) -> None:
        """Ask the supervisor for the freshest active replicas (fire and
        forget; the `ActiveReplicas` reply lands in `handle`)."""
        self.net.send(self.addr, supervisor, M.RequestReplicas())
