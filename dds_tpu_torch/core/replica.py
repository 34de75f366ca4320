"""BFT-ABD replica: quorum-replicated register with HMAC auth + anti-replay.

Trimmed copy of `dds_tpu/core/replica.py` (the healthy node's protocol:
coordinator rounds, tag reads, tag batches, HMAC and nonce checks). The
sentinent/byzantine behaviours, verified reseeds, anti-entropy, leases and
shard fencing wait for later slices; no supervisor runs in this slice's
topology, so Suspect votes are sent and dropped.

Protocol summary:
- proxy `Envelope(IWrite)` -> broadcast `ReadTag`; on a quorum of
  `TagReply` take the max tag, bump seq, broadcast `Write`; on a quorum of
  `WriteAck` answer the proxy with `IWriteReply` under challenge nonce =
  client nonce + increment.
- proxy `Envelope(IRead)` -> broadcast `Read`; on a quorum of `ReadReply`
  take the max (tag, value, signature); if the whole quorum agreed answer
  directly, else broadcast a write-back `Write` with the original
  signature and answer `IReadReply` on a quorum of `WriteAck`.
- proxy `ReadTagBatch` -> answer the tag vector (or "unchanged" when the
  proxy's fingerprint matches), MACed with the intranet secret.
- every inbound protocol message is HMAC-verified and nonce-replay-checked;
  violations raise `Suspect` votes.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.core.transport import Transport
from dds_tpu_torch.utils import sigs
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
                 net: Transport, config: ReplicaConfig | None = None):
        self.addr = addr
        self.name = addr.rsplit("/", 1)[-1]
        self.supervisor = supervisor
        self.net = net
        self.cfg = config or ReplicaConfig()
        # monotonic floor for tags this coordinator mints: two concurrent
        # writes coordinated here must never mint the same (seq+1, self) tag
        self._seq_floor = 0
        self.repository: dict[str, tuple[M.ABDTag, object]] = {}
        self.outgoing: dict[int, _Outgoing] = {}
        self.incoming: dict[int, bool] = {}  # nonce -> expired
        self.siblings = TrustedNodesList(replicas)
        # bumped on every stored Write; versions the tag-batch cache
        self.repo_version = 0
        # keys-tuple -> (repo_version, digest, tags, fingerprint)
        self._tagbatch_cache: dict[tuple, tuple] = {}
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
        with tracer.span("replica.handle", **meta):
            self._healthy(sender, msg)

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
                        else:
                            self._broadcast(M.Read(key, nonce))
                    case M.IWrite(key, value):
                        if not sigs.validate_proxy_signature(
                            cfg.proxy_mac_secret, key, nonce, signature, value
                        ):
                            self._debug("invalid proxy signature")
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
                if len(req.write_quorum) >= cfg.quorum_size:
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
                req.read_quorum[sender] = (tag, value, signature)
                if len(req.read_quorum) >= cfg.quorum_size:
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

            case _:
                self._debug(f"unhandled {type(msg).__name__}")
