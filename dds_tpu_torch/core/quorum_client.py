"""Proxy-side ABD access: nonce-challenged, HMAC-verified quorum reads/writes.

Trimmed copy of `dds_tpu/core/quorum_client.py` (circuit breakers, read
leases and shard fencing wait for later slices). A point op picks a random
trusted replica as coordinator, sends a signed `Envelope(IRead/IWrite)`,
awaits the enveloped reply, and verifies (a) the challenge nonce is the
request nonce + increment, (b) the proxy HMAC over the reply, (c) the
echoed key. Every protocol violation adds a suspicion strike on the
coordinator (3 strikes exclude it) and raises a typed Byzantine exception.
`read_tags` validates many cached keys with ONE tag-only round that the
proxy broadcasts itself. Callers pass a `Deadline` so each attempt's
timeout shrinks to the remaining request budget.

A junk reply from the asked coordinator resolves the outstanding request
and is then rejected by validation, rather than stalling until timeout.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Optional

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.core.errors import (
    ByzFailedNonceChallengeError,
    ByzInvalidKeyError,
    ByzInvalidSignatureError,
    ByzUnknownReplyError,
)
from dds_tpu_torch.core.transport import Transport
from dds_tpu_torch.utils import sigs
from dds_tpu_torch.utils.retry import Deadline, DeadlineExceededError
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
    # read_tags verifies each replica's intranet MAC itself, so it needs
    # the ABD secret and the quorum size
    abd_mac_secret: bytes = b"intranet-abd-secret"
    quorum_size: int = 3


class AbdClient:
    def __init__(self, addr: str, net: Transport, replicas: list[str],
                 config: AbdClientConfig | None = None):
        self.addr = addr
        self.net = net
        self.cfg = config or AbdClientConfig()
        self.replicas = TrustedNodesList(replicas)
        # challenge nonce -> (future, coordinator)
        self._pending: dict[int, tuple[asyncio.Future, str]] = {}
        # tag-broadcast nonce -> (future, sender->tags votes, digest, keys,
        # request fingerprint | None)
        self._pending_tags: dict[int, tuple] = {}
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
        # junk from a coordinator we are waiting on resolves that request;
        # validation will reject it
        for fut, coord in list(self._pending.values()):
            if coord == sender and not fut.done():
                fut.set_result(msg)
                return
        log.debug("unmatched message from %s: %s", sender, type(msg).__name__)

    def _coord_failed(self, coord: str) -> None:
        """A coordinator answered with a PROTOCOL VIOLATION: permanent
        suspicion strike."""
        self.replicas.increment_suspicion(coord)
        tracer.event("abd.coordinator_violation", node=coord)

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
                   deadline: Optional[Deadline] = None):
        timeout = self._attempt_timeout(deadline)
        coordinator = self.replicas.defer_to(tuple(exclude))
        challenge = nonce + self.cfg.nonce_increment
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[challenge] = (fut, coordinator)
        try:
            self.net.send(self.addr, coordinator, M.Envelope(call, nonce, signature))
            reply = await asyncio.wait_for(fut, timeout)
            return reply, coordinator, challenge
        finally:
            self._pending.pop(challenge, None)

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
            reply, coord, challenge = await self._ask(
                M.IRead(key), nonce, sig, exclude, deadline
            )
            span_meta["coordinator"] = coord
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
                    span_meta["ok"] = True
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
                M.IWrite(key, value), nonce, sig, (), deadline
            )
            span_meta["coordinator"] = coord
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
                    span_meta["ok"] = True
                    return k, tag
                case _:
                    self._coord_failed(coord)
                    raise ByzUnknownReplyError(coord)

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
        timeout = self._attempt_timeout(deadline)
        nonce = sigs.generate_nonce()
        if digest is None:
            digest = sigs.key_from_set(list(keys))
        sig = sigs.proxy_signature(self.cfg.proxy_mac_secret, digest, nonce)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending_tags[nonce] = (fut, {}, digest, tuple(keys), fingerprint)
        try:
            with tracer.span("abd.read_tags", k=len(keys)):
                req = M.ReadTagBatch(tuple(keys), nonce, sig, fingerprint)
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
