"""BFT-ABD replica: quorum-replicated register with HMAC auth + anti-replay.

Trimmed copy of `dds_tpu/core/replica.py`: the three behaviours
(healthy, sentinent spare, byzantine), the supervisor's recovery protocol
(the legacy `Sleep` reseed and the verified `SleepBegin`/`StateChunk`
reseed, `StateDigestRequest`, `Kill`), the Merkle index and anti-entropy
agent, the fault-injection gate, the Constellation's shard fence and its
migration ingest (`ShardMigrateBegin` + `StateChunk(kind="migrate")`,
merged store-if-newer, and `drop_unowned` after a reshape activates),
and the Atlas read-lease gate (`lease_table`, the holder-pinned
`_quorum_met`, `LeaseRequest`/`LeaseRevoke`/`LocalRead`).

Protocol summary:
- proxy `Envelope(IWrite)` -> broadcast `ReadTag`; on a quorum of
  `TagReply` take the max tag, bump seq, broadcast `Write`; on a quorum of
  `WriteAck` answer the proxy with `IWriteReply` under challenge nonce =
  client nonce + increment.
- proxy `Envelope(IRead)` -> broadcast `Read`; on a quorum of `ReadReply`
  take the max (tag, value, signature); if the whole quorum agreed answer
  directly, else broadcast a write-back `Write` with the original
  signature and answer `IReadReply` on a quorum of `WriteAck`.
- while the group's `lease_table` holds an active read lease, every write
  and read quorum this coordinator closes must also contain the holders
  (`_quorum_met`); the holder answers `LocalRead` from its own state under
  the lease token, one hop for a proxy in its region.
- proxy `ReadTagBatch` -> answer the tag vector (or "unchanged" when the
  proxy's fingerprint matches), MACed with the intranet secret.
- a replica of a shard group (`shard`, the group's shared
  `shard.ShardState`) fences every key its group does not own under the
  group's current map: an authenticated `IRead`/`IWrite` or
  `ReadTagBatch` answers a signed `WrongShard` (the proxy refreshes its map
  and retries), and a `Write` minted under a stale epoch is neither stored
  nor acked. An unsharded replica (`shard is None`) never fences.
- every inbound protocol message is HMAC-verified and nonce-replay-checked;
  violations raise `Suspect` votes to the supervisor.
- `Crash` and `Compromise` (Trudy's backdoors) are honoured only with
  `allow_fault_injection`, which `run.launch` sets from `[attacks]
  enabled`: without it no peer can silence or compromise a replica.
- a sentinent spare stores quorum Writes silently and answers `Awake`
  with its state; a byzantine node answers with garbage, replays, forged
  writes and omissions (its forged tags come from the node's own `_rng`).

Two divergences from the reference, both in the verified reseed (ROADMAP
§C 23, 24, where the reference loses acknowledged writes to proactive
recovery): the reseed keeps what the replica stored since its Kill
instead of replacing it, and pulls from the peers at once, in the exact
version f + 1 of its manifest signers attest at the manifests' time or a
moment later, every key it did not install (`reseed_holes`,
`AntiEntropy.fill_holes`, `fill_from_listings`).
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass, field

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.core.antientropy import AntiEntropy, MerkleIndex
from dds_tpu_torch.core.transport import Transport
from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils import sigs
from dds_tpu_torch.utils.tasks import supervised_task
from dds_tpu_torch.utils.trace import tracer
from dds_tpu_torch.utils.trust import TrustedNodesList

log = logging.getLogger("dds_torch.replica")


@dataclass
class ReplicaConfig:
    quorum_size: int = 3
    nonce_increment: int = 1
    abd_mac_secret: bytes = b"intranet-abd-secret"
    proxy_mac_secret: bytes = b"rest2abd"
    debug: bool = False
    # honour the Crash/Compromise fault-injection backdoors. True is the
    # harness default (tests drive faults directly); run.launch sets it
    # from `[attacks] enabled`, so a deployment without attack simulation
    # ignores injected faults from any peer
    allow_fault_injection: bool = True


@dataclass
class _Outgoing:
    client: str
    call: object
    client_nonce: int
    expired: bool = False
    # sender -> (tag, value, signature): keyed by sender so a replayed
    # reply can never count twice toward a quorum
    read_quorum: dict = field(default_factory=dict)
    write_quorum: set = field(default_factory=set)
    set_to_read: object = None
    set_to_write: object = None
    tag_to_reply: object = None  # tag returned to the proxy (read max / written)


class BFTABDNode:
    """One replica endpoint. `addr` must appear in `replicas`."""

    def __init__(self, addr: str, replicas: list[str], supervisor: str,
                 net: Transport, config: ReplicaConfig | None = None,
                 shard=None):
        self.addr = addr
        self.name = addr.rsplit("/", 1)[-1]
        self.all_replicas = list(replicas)
        self.supervisor = supervisor
        self.net = net
        self.cfg = config or ReplicaConfig()
        self.behavior = "healthy"
        # the byzantine behaviour's forged tags
        self._rng = random.Random()
        # monotonic floor for tags this coordinator mints: two concurrent
        # writes coordinated here must never mint the same (seq+1, self) tag
        self._seq_floor = 0
        self.repository: dict[str, tuple[M.ABDTag, object]] = {}
        self.outgoing: dict[int, _Outgoing] = {}
        self.incoming: dict[int, bool] = {}  # nonce -> expired
        self.siblings = TrustedNodesList(replicas)
        # bumped on every observable repository change (stored Write,
        # reseed, Kill wipe, snapshot restore); versions the tag-batch cache
        self.repo_version = 0
        # keys-tuple -> (repo_version, digest, tags, fingerprint)
        self._tagbatch_cache: dict[tuple, tuple] = {}
        # incremental (key -> tag, value-digest) hash index: the source of
        # StateDigest manifests and the anti-entropy tree
        self.merkle = MerkleIndex()
        # per-replica sync agent; run.launch (or a test) starts its loop
        self.antientropy = AntiEntropy(self)
        # verified-reseed sessions in flight: session -> {begin, chunks}
        # (SleepBegin and StateChunks may arrive in any order)
        self._recovery_sessions: dict[int, dict] = {}
        # set by a Kill's wipe, cleared by the reseed that follows it: the
        # repository meanwhile holds only what arrived since (ROADMAP §C 23)
        self._wiped = False
        # live-resharding migration sessions in flight (same shape; they
        # merge into the repository instead of replacing it)
        self._migrate_sessions: dict[int, dict] = {}
        # Constellation: the group's shared fencing state (shard.ShardState
        # duck-type: group_id / epoch / owns(key)). None = unsharded, no
        # fencing
        self.shard = shard
        # last snapshot save/load bookkeeping (core/snapshot fills it;
        # /health and the scrape-time gauges read it)
        self.snapshot_meta: dict = {}
        # Atlas read-lease geometry: the group's shared geo.LeaseTable
        # (None = leases off). While any lease is active every quorum this
        # coordinator closes must include the holders (dds_tpu_torch/geo)
        self.lease_table = None
        net.register(addr, self.handle)

    # ------------------------------------------------------------------ util

    def _state(self, key: str) -> tuple[M.ABDTag, object]:
        if key not in self.repository:
            self.repository[key] = (M.ABDTag(0, self.name), None)
        return self.repository[key]

    def _send(self, dest: str, msg) -> None:
        self.net.send(self.addr, dest, msg)

    def _suspect(self, endpoint: str) -> None:
        tracer.event("replica.suspect", by=self.name, suspect=endpoint)
        metrics.inc(
            "dds_suspect_votes_total", suspect=endpoint.rsplit("/", 1)[-1],
            help="Suspect votes raised toward the supervisor",
        )
        self._send(self.supervisor, M.Suspect(endpoint, sigs.generate_nonce()))

    def _debug(self, text: str) -> None:
        if self.cfg.debug:
            log.info("%s: %s", self.name, text)

    def _broadcast(self, msg) -> None:
        for sibling in self.siblings.get_trusted():
            self._send(sibling, msg)

    def _store(self, key: str, tag: M.ABDTag, value) -> None:
        """The ONLY place stored tags change: bump the version so cached
        tag-batch vectors invalidate."""
        self.repository[key] = (tag, value)
        self.repo_version += 1
        self.merkle.update(key, tag, value)

    def _install_repository(self, repository: dict) -> None:
        """Replace the whole repository (reseed / snapshot restore): bump
        the version, drop memo caches, rebuild the Merkle index."""
        self.repository = repository
        self.repo_version += 1
        self._tagbatch_cache.clear()
        self.merkle.rebuild(repository)

    def _wipe(self) -> None:
        self.repository = {}
        self.outgoing = {}
        self.incoming = {}
        self.repo_version += 1
        self._tagbatch_cache.clear()
        self.merkle.rebuild({})
        self._recovery_sessions.clear()
        self._wiped = True

    def _quorum_met(self, responders) -> bool:
        """Quorum gate for the write and read rounds this coordinator
        closes: plain `>= quorum_size`, except while read leases are out,
        when the quorum must ALSO contain every active holder. A leased
        replica then stores each acked write (and each value a read
        returns) before the round completes, so its local reads never
        trail an acked write. A dead holder stalls rounds at most one
        lease TTL (expiry drops it from `holders()`)."""
        if len(responders) < self.cfg.quorum_size:
            return False
        if self.lease_table is None:
            return True
        holders = self.lease_table.holders()
        if not holders:
            return True
        names = {s.rsplit("/", 1)[-1] for s in responders}
        return holders <= names

    def _shard_fenced(self, key: str) -> bool:
        """True when this group must NOT serve `key` under its current
        shard map (Constellation epoch fencing). Unsharded nodes never
        fence."""
        return self.shard is not None and not self.shard.owns(key)

    def _reply_wrong_shard(self, dest: str, key: str, nonce: int,
                           sent_epoch: int, what: str) -> None:
        """Typed, signed fence rejection: tells the proxy its map is stale
        (or a reshard is in flight) so it refreshes and re-routes under its
        existing Deadline budget."""
        epoch = self.shard.epoch
        sig = sigs.proxy_signature(
            self.cfg.proxy_mac_secret, key, nonce, ["wrong-shard", epoch]
        )
        metrics.inc(
            "dds_shard_fenced_total", shard=str(self.shard.group_id),
            msg=what,
            help="requests fenced for keys outside the group's shard map",
        )
        tracer.event("shard.fence", replica=self.name, key=key,
                     epoch=epoch, sent_epoch=sent_epoch, msg=what)
        self._send(dest, M.WrongShard(key, epoch, nonce, sig))

    def _tag_batch_fill(self, keys: tuple, digest: str) -> tuple[tuple, bytes]:
        """(tag vector, fingerprint) for an AUTHENTICATED ReadTagBatch,
        memoized per keys-tuple until the repository changes."""
        blank = (M.ABDTag(0, self.name), None)
        tags = tuple(self.repository.get(k, blank)[0] for k in keys)
        fp = sigs.tags_fingerprint(tags)
        if len(self._tagbatch_cache) > 8:  # distinct key-sets stay bounded
            self._tagbatch_cache.clear()
        self._tagbatch_cache[keys] = (self.repo_version, digest, tags, fp)
        return tags, fp

    # ------------------------------------------------------------- dispatch

    async def handle(self, sender: str, msg) -> None:
        meta = {"replica": self.name, "msg": type(msg).__name__}
        key = getattr(msg, "key", None)
        if isinstance(key, str):
            meta["key"] = key
        meta["behavior"] = self.behavior
        with tracer.span("replica.handle", **meta):
            self._dispatch(sender, msg)

    def _dispatch(self, sender: str, msg) -> None:
        if isinstance(msg, (M.Crash, M.Compromise)):
            # fault-injection backdoors (Trudy): honoured only when the
            # deployment enables attack simulation
            if not self.cfg.allow_fault_injection:
                self._debug(f"ignoring injected {type(msg).__name__}")
                return
            if isinstance(msg, M.Crash):
                self.net.unregister(self.addr)  # go silent, any behavior
                return
        if self.behavior == "healthy":
            self._healthy(sender, msg)
        elif self.behavior == "sentinent":
            self._sentinent(sender, msg)
        else:
            self._byzantine(sender, msg)

    def _reply_to_proxy(self, req: _Outgoing, reply, payload) -> None:
        """Answer the proxy under challenge nonce = its nonce + increment,
        MACing the reply's key and `payload` (which covers the tag)."""
        req.expired = True
        challenge = req.client_nonce + self.cfg.nonce_increment
        sig = sigs.proxy_signature(self.cfg.proxy_mac_secret, reply.key,
                                   challenge, payload)
        self._send(req.client, M.Envelope(reply, challenge, sig))

    def _healthy(self, sender: str, msg) -> None:
        cfg = self.cfg
        match msg:
            case M.Envelope(call, nonce, signature):
                if nonce in self.outgoing:
                    self._debug("invalid nonce from proxy - repeated")
                    return
                req = _Outgoing(sender, call, nonce)
                match call:
                    case M.IRead(key):
                        if not sigs.validate_proxy_signature(
                            cfg.proxy_mac_secret, key, nonce, signature
                        ):
                            self._debug("invalid proxy signature")
                        elif self._shard_fenced(key):
                            # fence AFTER authentication (an unauthenticated
                            # probe must not learn the keyspace layout) and
                            # burn the request so a replay cannot re-ask
                            req.expired = True
                            self._reply_wrong_shard(
                                sender, key, nonce + cfg.nonce_increment,
                                msg.epoch, "IRead",
                            )
                        else:
                            self._broadcast(M.Read(key, nonce))
                    case M.IWrite(key, value):
                        if not sigs.validate_proxy_signature(
                            cfg.proxy_mac_secret, key, nonce, signature, value
                        ):
                            self._debug("invalid proxy signature")
                        elif self._shard_fenced(key):
                            req.expired = True
                            self._reply_wrong_shard(
                                sender, key, nonce + cfg.nonce_increment,
                                msg.epoch, "IWrite",
                            )
                        else:
                            req.set_to_write = value
                            self._broadcast(M.ReadTag(key, nonce))
                    case _:
                        log.error("unexpected API call from proxy: %r", call)
                self.outgoing[nonce] = req

            case M.ReadTag(key, nonce):
                if nonce in self.incoming:
                    self._debug("invalid nonce - repeated")
                    self._suspect(sender)
                    return
                self.incoming[nonce] = False
                tag, contents = self._state(key)
                sig = sigs.abd_signature(cfg.abd_mac_secret, contents, tag, nonce)
                self._send(sender, M.TagReply(tag, key, contents, sig, nonce))

            case M.ReadTagBatch(keys, nonce, psig, pfp):
                # sent straight by the proxy: authenticate BEFORE burning an
                # anti-replay nonce; the memo cache is probed read-only here
                # and only filled after the MAC verifies
                hit = self._tagbatch_cache.get(keys)
                if hit is not None and hit[0] == self.repo_version:
                    digest = hit[1]
                else:
                    hit = None
                    digest = sigs.key_from_set(list(keys))
                if not sigs.validate_proxy_signature(
                    cfg.proxy_mac_secret, digest, nonce, psig
                ):
                    self._debug("invalid proxy signature (tag batch)")
                    return
                if nonce in self.incoming:
                    self._debug("invalid nonce - repeated (tag batch)")
                    self._suspect(sender)
                    return
                if self.shard is not None:
                    bad = next((k for k in keys if self._shard_fenced(k)), None)
                    if bad is not None:
                        # batch replies correlate by the REQUEST nonce
                        self.incoming[nonce] = True
                        self._reply_wrong_shard(
                            sender, bad, nonce, msg.epoch, "ReadTagBatch"
                        )
                        return
                if hit is not None:
                    tags, fp = hit[2], hit[3]
                else:
                    tags, fp = self._tag_batch_fill(keys, digest)
                # tag-only phase: no Write follows, so the nonce is spent now
                self.incoming[nonce] = True
                if pfp is not None and pfp == fp:
                    sig = sigs.abd_batch_unchanged_signature(
                        cfg.abd_mac_secret, fp, digest, nonce
                    )
                    self._send(sender, M.TagBatchReply(
                        (), digest, sig, nonce, unchanged=True, fingerprint=fp))
                else:
                    sig = sigs.abd_batch_signature(
                        cfg.abd_mac_secret, tags, digest, nonce
                    )
                    self._send(sender, M.TagBatchReply(
                        tags, digest, sig, nonce, fingerprint=fp))

            case M.TagReply(tag, key, value, signature, nonce):
                if not sigs.validate_abd_signature(
                    cfg.abd_mac_secret, value, tag, nonce, signature
                ):
                    self._debug("invalid ABD signature")
                    self._suspect(sender)
                    return
                req = self.outgoing.get(nonce)
                if req is None:
                    self._debug("invalid nonce - unknown")
                    self._suspect(sender)
                    return
                if req.expired:
                    return  # late quorum reply
                if not isinstance(req.call, M.IWrite):
                    # a reply type must match its request's phase
                    self._debug("TagReply for a non-write request")
                    self._suspect(sender)
                    return
                if key != req.call.key:
                    # the ABD signature does not cover the key: a reply for
                    # another key (a corrupted frame) never joins the
                    # quorum, so the Write goes to the key the proxy signed
                    self._debug("TagReply for another key")
                    return
                req.read_quorum[sender] = (tag, value, signature)
                if len(req.read_quorum) >= cfg.quorum_size:
                    max_tag = max(t for t, _, _ in req.read_quorum.values())
                    req.read_quorum = {}
                    self._seq_floor = max(self._seq_floor, max_tag.seq) + 1
                    new_tag = M.ABDTag(self._seq_floor, self.name)
                    req.tag_to_reply = new_tag
                    sig = sigs.abd_signature(
                        cfg.abd_mac_secret, req.set_to_write, new_tag, nonce
                    )
                    self._broadcast(M.Write(new_tag, key, req.set_to_write, sig, nonce))

            case M.Write(tag, key, value, signature, nonce):
                if not sigs.validate_abd_signature(
                    cfg.abd_mac_secret, value, tag, nonce, signature
                ):
                    self._debug("invalid ABD signature")
                    self._suspect(sender)
                    return
                if nonce not in self.incoming:
                    self._debug("invalid nonce - unknown")
                    self._suspect(sender)
                    return
                if self.incoming[nonce]:
                    return  # late quorum reply
                self.incoming[nonce] = True
                if self._shard_fenced(key):
                    # storage-layer fence: a Write minted under a stale
                    # epoch (its coordinator raced the map install) is
                    # neither stored nor acked, so the op cannot reach a
                    # quorum and its retry fences at the coordinator
                    metrics.inc(
                        "dds_shard_fenced_total",
                        shard=str(self.shard.group_id), msg="Write",
                        help="requests fenced for keys outside the group's "
                             "shard map",
                    )
                    tracer.event("shard.fence", replica=self.name, key=key,
                                 epoch=self.shard.epoch, msg="Write")
                    return
                cur_tag, _ = self._state(key)
                if cur_tag < tag:
                    self._store(key, tag, value)
                self._send(sender, M.WriteAck(key, nonce))

            case M.WriteAck(key, nonce):
                req = self.outgoing.get(nonce)
                if req is None:
                    self._debug("invalid nonce - unknown")
                    self._suspect(sender)
                    return
                if req.expired:
                    return  # late reply
                if not isinstance(req.call, (M.IRead, M.IWrite)):
                    self._debug("WriteAck for a request with no write phase")
                    self._suspect(sender)
                    return
                req.write_quorum.add(sender)
                if self._quorum_met(req.write_quorum):
                    req.write_quorum = set()
                    match req.call:
                        case M.IRead(k):
                            self._reply_to_proxy(
                                req, M.IReadReply(k, req.set_to_read, tag=req.tag_to_reply),
                                [req.set_to_read, sigs.tag_payload(req.tag_to_reply)],
                            )
                        case M.IWrite(k, _):
                            self._reply_to_proxy(
                                req, M.IWriteReply(k, tag=req.tag_to_reply),
                                sigs.tag_payload(req.tag_to_reply),
                            )

            case M.Read(key, nonce):
                if nonce in self.incoming:
                    self._debug("invalid nonce - repeated")
                    self._suspect(sender)
                    return
                self.incoming[nonce] = False
                tag, contents = self._state(key)
                sig = sigs.abd_signature(cfg.abd_mac_secret, contents, tag, nonce)
                self._send(sender, M.ReadReply(tag, key, contents, sig, nonce))

            case M.ReadReply(tag, key, value, signature, nonce):
                if not sigs.validate_abd_signature(
                    cfg.abd_mac_secret, value, tag, nonce, signature
                ):
                    self._debug("invalid ABD signature")
                    self._suspect(sender)
                    return
                req = self.outgoing.get(nonce)
                if req is None:
                    self._debug("invalid nonce - unknown")
                    self._suspect(sender)
                    return
                if req.expired:
                    return  # late reply
                if not isinstance(req.call, M.IRead):
                    self._debug("ReadReply for a non-read request")
                    self._suspect(sender)
                    return
                if key != req.call.key:
                    # as for TagReply: the write-back goes to the key read
                    self._debug("ReadReply for another key")
                    return
                req.read_quorum[sender] = (tag, value, signature)
                if self._quorum_met(req.read_quorum):
                    entries = list(req.read_quorum.values())
                    max_tag, max_val, max_sig = max(entries, key=lambda e: e[0])
                    req.read_quorum = {}
                    req.set_to_read = max_val
                    req.tag_to_reply = max_tag
                    if all(t == max_tag for t, _, _ in entries):
                        # the whole quorum already stores (max_tag, value):
                        # the write-back phase adds nothing, answer directly
                        k = req.call.key
                        self._reply_to_proxy(
                            req, M.IReadReply(k, max_val, tag=max_tag),
                            [max_val, sigs.tag_payload(max_tag)],
                        )
                        return
                    # ABD write-back phase, re-using the original signature
                    self._broadcast(M.Write(max_tag, key, max_val, max_sig, nonce))

            case M.LeaseRequest(region, ttl, nonce, signature):
                if not sigs.validate_manifest_signature(
                    cfg.abd_mac_secret, "lease-request",
                    {"region": region, "ttl": ttl}, nonce, signature,
                ):
                    self._debug("invalid lease-request signature")
                    return
                if nonce in self.incoming:
                    self._debug("invalid nonce - repeated (lease request)")
                    self._suspect(sender)
                    return
                self.incoming[nonce] = True
                ok = self.lease_table is not None
                token, expires = "", 0.0
                if ok:
                    lease = self.lease_table.grant(region, self.name, float(ttl))
                    token, expires = lease.token, lease.expires
                    tracer.event("geo.lease_grant", replica=self.name,
                                 region=region, ttl=float(ttl))
                rsig = sigs.manifest_signature(
                    cfg.abd_mac_secret, "lease-grant",
                    {"region": region, "replica": self.name, "token": token,
                     "expires": expires, "ok": ok}, nonce,
                )
                self._send(sender, M.LeaseGrant(region, self.name, token,
                                                expires, ok, nonce, rsig))

            case M.LeaseRevoke(region, nonce, signature):
                if not sigs.validate_manifest_signature(
                    cfg.abd_mac_secret, "lease-revoke",
                    {"region": region}, nonce, signature,
                ):
                    self._debug("invalid lease-revoke signature")
                    return
                if nonce in self.incoming:
                    self._debug("invalid nonce - repeated (lease revoke)")
                    self._suspect(sender)
                    return
                self.incoming[nonce] = True
                if self.lease_table is not None:
                    self.lease_table.revoke(region)
                    tracer.event("geo.lease_revoke", replica=self.name,
                                 region=region)

            case M.LocalRead(key, region, token, nonce, signature):
                if not sigs.validate_proxy_signature(
                    cfg.proxy_mac_secret, key, nonce, signature,
                    ["local-read", region],
                ):
                    self._debug("invalid proxy signature (local read)")
                    return
                if nonce in self.incoming:
                    self._debug("invalid nonce - repeated (local read)")
                    self._suspect(sender)
                    return
                self.incoming[nonce] = True
                served = (
                    self.lease_table is not None
                    and self.lease_table.valid(region, self.name, token)
                    and not self._shard_fenced(key)
                )
                # a refusal (bad, expired or revoked lease, or a fence) is
                # typed: the proxy falls back to a full quorum read at once
                # instead of timing out a WAN round trip first
                tag, value = self._state(key) if served else (None, None)
                metrics.inc(
                    "dds_geo_local_reads_total",
                    result="served" if served else "refused",
                    replica=self.name,
                    help="lease-backed region-local reads by outcome",
                )
                rsig = sigs.proxy_signature(
                    cfg.proxy_mac_secret, key, nonce,
                    [served, value,
                     sigs.tag_payload(tag) if tag is not None else None],
                )
                self._send(sender, M.LocalReadReply(tag, key, value, served,
                                                    nonce, rsig))

            case M.Sleep(data, nonces):
                # legacy unverified reseed (deployments that turn
                # verified_transfer off): the seeding state is trusted
                # verbatim, the blind spot the SleepBegin path closes
                self._install_repository({
                    k: (M.ABDTag(v["tag"][0], v["tag"][1]), v["value"])
                    for k, v in data.items()
                })
                for n in nonces:
                    self.incoming[int(n)] = True
                self._debug("going to sleep")
                self._send(sender, M.Complying())
                self.behavior = "sentinent"

            case M.SleepBegin():
                self._recovery_ingest(sender, msg)

            case M.ShardMigrateBegin():
                self._migrate_ingest(sender, msg)

            case M.StateChunk():
                # one frame type, two sessions: `kind` says which owns it
                if msg.kind == "migrate":
                    self._migrate_ingest(sender, msg)
                else:
                    self._recovery_ingest(sender, msg)

            case M.StateDigestRequest(nonce):
                self._send_manifest(sender, nonce)

            case (M.MerkleRootRequest() | M.MerkleBucketRequest()
                  | M.MerkleKeysRequest() | M.RepairRequest() | M.MerkleRoot()
                  | M.MerkleBuckets() | M.MerkleKeys() | M.RepairReply()):
                self.antientropy.handle(sender, msg)

            case M.Kill():
                # guardian-restart semantics: fresh empty state, healthy
                self._wipe()
                self.behavior = "healthy"
                self._debug("killed and restarted")

            case M.Compromise():
                self.behavior = "byzantine"

            case _:
                self._debug(f"unhandled {type(msg).__name__}")

    def _send_manifest(self, dest: str, nonce: int) -> None:
        manifest = self.merkle.manifest()
        sig = sigs.manifest_signature(self.cfg.abd_mac_secret, self.addr,
                                      manifest, nonce)
        self._send(dest, M.StateDigest(manifest, nonce, sig))

    # ------------------------------------------------------------ sentinent

    def _sentinent(self, sender: str, msg) -> None:
        cfg = self.cfg
        match msg:
            case M.Write(tag, key, value, signature, nonce):
                if not sigs.validate_abd_signature(
                    cfg.abd_mac_secret, value, tag, nonce, signature
                ):
                    self._debug("invalid ABD signature (sentinent)")
                    return
                if nonce in self.incoming:
                    self._debug("invalid nonce - repeated (sentinent)")
                    return
                self.incoming[nonce] = True
                if self._shard_fenced(key):
                    return  # same storage fence as the healthy path
                cur_tag, _ = self._state(key)
                if cur_tag < tag:
                    self._store(key, tag, value)

            case M.Awake():
                self._debug("waking up")
                self._send(sender, M.State(self.export_state(),
                                           list(self.incoming.keys())))
                self.behavior = "healthy"

            case M.StateDigestRequest(nonce):
                # the supervisor's spare-freshness probe and the verified-
                # transfer quorum both reach spares too
                self._send_manifest(sender, nonce)

            case (M.MerkleRootRequest() | M.MerkleBucketRequest()
                  | M.MerkleKeysRequest() | M.RepairRequest() | M.MerkleRoot()
                  | M.MerkleBuckets() | M.MerkleKeys() | M.RepairReply()):
                # spares sync too: a snapshot-restored sentinent converges
                # before it is ever promoted
                self.antientropy.handle(sender, msg)

            case M.ShardMigrateBegin():
                # spares of a receiving group ingest the migration too, so
                # a later promotion starts warm instead of divergent
                self._migrate_ingest(sender, msg)

            case M.StateChunk() if msg.kind == "migrate":
                self._migrate_ingest(sender, msg)

            case M.Kill():
                self._wipe()
                self.behavior = "healthy"

    # ------------------------------------------------------------ byzantine

    def _byzantine(self, sender: str, msg) -> None:
        """Simulated compromise: garbage replies, replays, forged writes,
        omissions. The attacker holds the real MAC key (the reference's
        threat model)."""
        cfg = self.cfg
        match msg:
            case M.Envelope(_, _, _):
                # protocol violation: bare reply, not an Envelope
                self._send(sender, M.IReadReply("2eikd094akldslcnu94342", None))

            case M.ReadTag(key, nonce):
                garbage = [1, "i am ", "trudy", None]
                for _ in range(4):  # replay x4 with empty signature
                    self._send(
                        sender,
                        M.TagReply(M.ABDTag(0, self.name), key, garbage, b"", nonce),
                    )

            case M.ReadTagBatch(keys, nonce, _):
                # inflated tags under an empty signature, replayed x2: the
                # proxy drops these on MAC failure
                fake = tuple(M.ABDTag(1 << 30, self.name) for _ in keys)
                for _ in range(2):
                    self._send(sender, M.TagBatchReply(fake, "forged", b"", nonce))

            case M.TagReply(_, key, _, _, nonce) | M.ReadReply(_, key, _, _, nonce):
                # forge a write to every replica under a random tag
                tag = M.ABDTag(self._rng.getrandbits(31), sender.rsplit("/", 1)[-1])
                sig = sigs.abd_signature(cfg.abd_mac_secret, None, tag, nonce + 1)
                for replica in self.all_replicas:
                    self._send(replica, M.Write(tag, key, None, sig, nonce + 1))

            case M.Write(_, key, _, _, nonce):
                self._send(sender, M.WriteAck(key, nonce))

            case M.WriteAck(_, _):
                pass  # omission

            case M.Read(key, nonce):
                tag = M.ABDTag(self._rng.getrandbits(31), sender.rsplit("/", 1)[-1])
                self._send(
                    sender,
                    M.ReadReply(tag, key, [",test,", 31, True], b"10010100110010", nonce),
                )

            case M.Kill():
                self._wipe()
                self.behavior = "healthy"

    # ------------------------------------------------- verified state seed

    MAX_RECOVERY_SESSIONS = 4

    def _recovery_ingest(self, sender: str, msg) -> None:
        """Buffer one frame of a verified reseed (SleepBegin header or a
        StateChunk); transports reorder, so completion is by count, not
        order. Sessions are bounded: a flood of bogus session ids evicts
        oldest-first instead of growing without bound."""
        sess = self._recovery_sessions.get(msg.session)
        if sess is None:
            while len(self._recovery_sessions) >= self.MAX_RECOVERY_SESSIONS:
                self._recovery_sessions.pop(next(iter(self._recovery_sessions)))
            sess = self._recovery_sessions[msg.session] = {
                "begin": None, "sender": None, "chunks": {},
            }
        if isinstance(msg, M.SleepBegin):
            sess["begin"] = msg
            sess["sender"] = sender
        else:
            sess["chunks"][int(msg.seq)] = msg.entries
        self._try_complete_recovery(msg.session)

    def _try_complete_recovery(self, session: int) -> None:
        sess = self._recovery_sessions.get(session)
        begin = sess["begin"]
        if begin is None:
            return
        chunks = sess["chunks"]
        if sum(1 for s in chunks if 0 <= s < begin.total) < begin.total:
            return
        verified = verified_manifest(begin.digests, begin.support,
                                     self.cfg.abd_mac_secret)
        repository: dict[str, tuple] = {}
        rejected: list[str] = []
        for seq in range(begin.total):
            for key, e in chunks[seq].items():
                try:
                    tag = M.ABDTag(int(e["tag"][0]), str(e["tag"][1]))
                    value = e["value"]
                except (KeyError, TypeError, ValueError, IndexError):
                    rejected.append(key)
                    continue
                want = verified.get(key)
                if want == (tag.seq, tag.id, sigs.value_digest(value)):
                    repository[key] = (tag, value)
                else:
                    rejected.append(key)
        self._recovery_sessions.pop(session, None)
        # keep what this replica stored since its Kill wiped it: quorum
        # Writes it acknowledged and migration entries it verified while
        # the seed was in flight. Replaced by the seed, each acknowledged
        # write it held loses a copy (ROADMAP §C 23)
        for key, (tag, value) in (self.repository.items() if self._wiped else ()):
            cur = repository.get(key)
            if MerkleIndex._tracked(tag, value) and (cur is None or cur[0] < tag):
                repository[key] = (tag, value)
        self._wiped = False
        self._install_repository(repository)
        for n in begin.nonces:
            self.incoming[int(n)] = True
        if rejected:
            log.warning(
                "%s: verified reseed rejected %d/%d entries (digest quorum "
                "mismatch); anti-entropy will repair the holes",
                self.name, len(rejected), len(rejected) + len(repository),
            )
            tracer.event("recovery.rejected_entries", replica=self.name,
                         rejected=len(rejected), accepted=len(repository))
            metrics.inc(
                "dds_recovery_rejected_entries_total", len(rejected),
                replica=self.name,
                help="seeded entries rejected by the digest quorum",
            )
            flight.record(
                "recovery_digest_mismatch", replica=self.name,
                rejected=sorted(rejected)[:32], accepted=len(repository),
            )
        self._debug(
            f"reseeded with {len(repository)} verified entries "
            f"({len(rejected)} rejected); going to sleep"
        )
        self._send(sess["sender"], M.Complying())
        self.behavior = "sentinent"
        # pull what the seed lacked now: left to the periodic loop, a hole
        # outlives the next recovery, in which this replica, a spare by
        # then, seeds the next victim without the key, until no read quorum
        # holds a copy (ROADMAP §C 23, 24)
        signers = sorted({str(d[0]) for d in begin.digests} - {self.addr})
        supervised_task(
            self._fill_after_reseed(reseed_holes(verified, repository), signers,
                                    begin.support),
            name="replica.fill_holes")

    async def _fill_after_reseed(self, holes: dict, signers: list[str], support: int) -> None:
        """The keys the manifests attested that the seed lacked, then the
        ones the signers hold by now (`AntiEntropy.fill_from_listings`)."""
        if holes:
            await self.antientropy.fill_holes(holes)
        await self.antientropy.fill_from_listings(signers, support)

    # -------------------------------------------------- shard migration

    MAX_MIGRATE_SESSIONS = 4

    def _migrate_ingest(self, sender: str, msg) -> None:
        """Buffer one frame of a Constellation key migration (the header
        or a kind="migrate" StateChunk): the recovery path's
        reorder-tolerant, bounded session buffering, but completion
        MERGES, never replaces."""
        sess = self._migrate_sessions.get(msg.session)
        if sess is None:
            while len(self._migrate_sessions) >= self.MAX_MIGRATE_SESSIONS:
                self._migrate_sessions.pop(next(iter(self._migrate_sessions)))
            sess = self._migrate_sessions[msg.session] = {
                "begin": None, "sender": None, "chunks": {},
            }
        if isinstance(msg, M.ShardMigrateBegin):
            sess["begin"] = msg
            sess["sender"] = sender
        else:
            sess["chunks"][int(msg.seq)] = msg.entries
        self._try_complete_migration(msg.session)

    def _try_complete_migration(self, session: int) -> None:
        sess = self._migrate_sessions.get(session)
        begin = sess["begin"]
        if begin is None:
            return
        chunks = sess["chunks"]
        if sum(1 for s in chunks if 0 <= s < begin.total) < begin.total:
            return
        verified = verified_manifest(begin.digests, begin.support,
                                     self.cfg.abd_mac_secret)
        accepted = rejected = 0
        for seq in range(begin.total):
            for key, e in chunks[seq].items():
                try:
                    tag = M.ABDTag(int(e["tag"][0]), str(e["tag"][1]))
                    value = e["value"]
                except (KeyError, TypeError, ValueError, IndexError):
                    rejected += 1
                    continue
                # the receiving group takes only keys its OWN map assigns
                # it: a Byzantine rebalancer cannot park foreign keys here
                if self.shard is not None and not self.shard.owns(key):
                    rejected += 1
                    continue
                if verified.get(key) != (tag.seq, tag.id, sigs.value_digest(value)):
                    rejected += 1
                    continue
                cur_tag = self.repository.get(key, (M.ABDTag(0, self.name), None))[0]
                if cur_tag < tag:
                    self._store(key, tag, value)
                accepted += 1  # installed, or already at/above the attested tag
        self._migrate_sessions.pop(session, None)
        metrics.inc(
            "dds_shard_migrated_keys_total", accepted, replica=self.name,
            help="verified keys accepted during shard migrations",
        )
        if rejected:
            tracer.event("shard.migrate_rejected", replica=self.name,
                         rejected=rejected, accepted=accepted)
            flight.record(
                "shard_migrate_rejected", replica=self.name,
                rejected=rejected, accepted=accepted, session=session,
            )
        self._debug(f"shard migration {session}: {accepted} accepted, "
                    f"{rejected} rejected")
        self._send(sess["sender"], M.ShardMigrateAck(session, accepted, rejected))

    def drop_unowned(self) -> int:
        """Prune repository entries outside this group's shard map (after
        a migration activates). Returns the number of keys dropped."""
        if self.shard is None:
            return 0
        doomed = [k for k in self.repository if not self.shard.owns(k)]
        for k in doomed:
            del self.repository[k]
        if doomed:
            self.repo_version += 1
            self._tagbatch_cache.clear()
            self.merkle.rebuild(self.repository)
        return len(doomed)

    # ---------------------------------------------------------------- admin

    def export_state(self) -> dict:
        return {
            k: {"tag": [t.seq, t.id], "value": v} for k, (t, v) in self.repository.items()
        }


def verified_manifest(digests: list, support: int, secret: bytes) -> dict:
    """Cross-check a relayed manifest quorum: verify every HMAC (the
    signer address is bound into it, so a relay cannot re-attribute) and
    keep only entries attested identically by >= `support` (= f+1)
    distinct signers, at least one of which is then honest, so no single
    Byzantine spare or relay can smuggle a forged entry."""
    votes: dict[tuple, set] = {}
    for item in digests:
        try:
            signer, manifest, nonce, sighex = item
            if not sigs.validate_manifest_signature(
                secret, str(signer), manifest,
                int(nonce), bytes.fromhex(sighex),
            ):
                continue
        except (TypeError, ValueError):
            continue
        for key, ent in manifest.items():
            try:
                attested = (str(key), int(ent[0]), str(ent[1]), str(ent[2]))
            except (TypeError, ValueError, IndexError):
                continue
            votes.setdefault(attested, set()).add(str(signer))
    return _verified(votes, support)


def _verified(votes: dict, support: int) -> dict:
    """key -> (seq, id, value digest), the newest version that >=
    `support` distinct signers attest identically in `votes`
    ((key, seq, id, value digest) -> signers)."""
    verified: dict[str, tuple] = {}
    for (key, seq, tid, vd), signers in votes.items():
        if len(signers) < support:
            continue
        cur = verified.get(key)
        if cur is None or (seq, tid) > (cur[0], cur[1]):
            verified[key] = (seq, tid, vd)
    return verified


def reseed_holes(verified: dict, repository: dict) -> dict:
    """The `verified` entries (`_verified`) that `repository` lacks or
    holds only older: key -> the exact (seq, id, value digest) to pull. A
    key no version of which f + 1 signers attest is never asked for; the
    periodic anti-entropy loop repairs it (ROADMAP §C 23)."""
    holes = {}
    for key, want in verified.items():
        cur = repository.get(key)
        if cur is None or (cur[0].seq, cur[0].id) < want[:2]:
            holes[key] = want
    return holes
