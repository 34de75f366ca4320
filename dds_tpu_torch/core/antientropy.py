"""Merkle anti-entropy: background convergence without client reads.

Copy of `dds_tpu/core/antientropy.py`, with the Atlas geo plane's seeded
cross-region peer pairing: a geo-aware agent (`regions` configured) pulls
across regions with probability `cross_region_bias`, after an extra
`cross_jitter` sleep, every draw from its one rng.

The ABD protocol repairs stale replicas lazily — a read's write-back phase
touches exactly the keys clients happen to read. A healed partition, a
snapshot-restored rejoiner, or a replica whose verified reseed rejected
forged entries (core/replica._try_complete_recovery) therefore stays
divergent for every key no client asks about. This module closes that gap:

- `MerkleIndex`: an incremental two-level hash tree over the repository's
  tracked entries (key -> tag, value-digest). Leaf buckets are XOR
  accumulators of per-entry digests (order-independent, O(1) update per
  store); the root hashes the bucket vector. Implicit defaults minted by
  `_state()` (tag seq 0, value None) are excluded — they differ per
  replica by tag id and would read as fake divergence.

- `AntiEntropy`: one instance per replica (created in BFTABDNode.__init__)
  that both ANSWERS peers' sync phases (root -> buckets -> keys -> repair,
  delegated from the replica's behavior handlers) and, when started, runs
  a jittered background loop pulling from one random peer per round:
  compare roots; on divergence fetch bucket vectors, walk divergent
  buckets' key listings, and repair stale keys via per-key signed value
  transfer — each repaired entry carries the standard ABD HMAC over
  (value, tag, nonce) and is installed store-if-newer, the same
  authenticity and monotonicity bar as a protocol `Write` write-back.

Sync is pull-based and one-directional per round: keys where the PEER is
stale are left for the peer's own loop (every replica runs one), keeping
rounds idempotent and free of write amplification. Replies are HMAC-signed
(utils/sigs.antientropy_signature); a tag-equal-but-digest-divergent entry
is cryptographic evidence of a forged or corrupted value under a real tag
and is flight-recorded, never auto-overwritten (the tag order cannot say
which side is right — the audit/repair story for that class lives in the
proxy's cache audit and operator hands).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import random
import time
from typing import Optional

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils import sigs
from dds_tpu_torch.utils.tasks import supervised_task
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.antientropy")


class MerkleIndex:
    """Incremental hash index over (key -> tag, value-digest).

    Two levels: BUCKETS XOR-accumulator leaves (bucket = first byte of
    sha256(key) mod BUCKETS) and a root hash over the bucket vector.
    XOR makes updates O(1) and order-independent; forged-vector attacks
    on XOR malleability are out of scope because bucket vectors only
    travel inside HMAC-signed replies from peers that hold the intranet
    secret anyway (the ABD threat model, SURVEY.md §7).
    """

    BUCKETS = 64

    def __init__(self):
        self._acc = [0] * self.BUCKETS
        # key -> (tag, value-digest hex, contribution int)
        self._entries: dict[str, tuple] = {}

    @staticmethod
    def _tracked(tag, value) -> bool:
        # the `_state()` implicit default is (seq 0, None) with a per-
        # replica tag id; deletes are None under seq > 0 and ARE tracked
        return not (tag.seq == 0 and value is None)

    @classmethod
    def bucket_of(cls, key: str) -> int:
        return hashlib.sha256(key.encode()).digest()[0] % cls.BUCKETS

    @staticmethod
    def _contribution(key: str, tag, vd: str) -> int:
        blob = f"{key}|{tag.seq}|{tag.id}|{vd}".encode()
        return int.from_bytes(hashlib.sha256(blob).digest(), "big")

    def update(self, key: str, tag, value) -> None:
        old = self._entries.get(key)
        b = self.bucket_of(key)
        if old is not None:
            self._acc[b] ^= old[2]
            del self._entries[key]
        if self._tracked(tag, value):
            vd = sigs.value_digest(value)
            contrib = self._contribution(key, tag, vd)
            self._acc[b] ^= contrib
            self._entries[key] = (tag, vd, contrib)

    def rebuild(self, repository: dict) -> None:
        self._acc = [0] * self.BUCKETS
        self._entries = {}
        for key, (tag, value) in repository.items():
            self.update(key, tag, value)

    def root(self) -> str:
        return hashlib.sha256(
            b"".join(a.to_bytes(32, "big") for a in self._acc)
        ).hexdigest()

    def bucket_digests(self) -> list[str]:
        return [format(a, "064x") for a in self._acc]

    def entries_in(self, buckets) -> dict:
        """{key: [seq, id, value-digest]} for the given bucket ids."""
        wanted = {int(b) for b in buckets}
        return {
            k: [t.seq, t.id, vd]
            for k, (t, vd, _) in self._entries.items()
            if self.bucket_of(k) in wanted
        }

    def manifest(self) -> dict:
        """The full {key: [seq, id, value-digest]} attestation — what a
        replica signs into a StateDigest for verified state transfer."""
        return {k: [t.seq, t.id, vd] for k, (t, vd, _) in self._entries.items()}

    def get(self, key: str):
        """(tag, value-digest) for a tracked key, else None."""
        e = self._entries.get(key)
        return None if e is None else (e[0], e[1])

    def __len__(self) -> int:
        return len(self._entries)


class AntiEntropy:
    """Per-replica sync agent: answers peers' phases, runs the pull loop."""

    REPAIR_BATCH = 256  # keys per RepairRequest, bounding reply frames

    def __init__(self, node):
        self.node = node
        self.interval = 5.0
        self.jitter = 2.0
        self.sync_timeout = 2.0
        self._rng = random.Random()
        self._task: Optional[asyncio.Task] = None
        self._pending: dict[int, asyncio.Future] = {}
        # Atlas cross-region pairing: endpoint -> region labels, a bias
        # toward cross-region pulls (the links where divergence builds up
        # after a WAN partition), and extra de-synchronising jitter ahead
        # of a cross-region round so a region's loops never dogpile one
        # WAN link at once
        self.regions: dict = {}
        self.cross_region_bias = 0.5
        self.cross_jitter = 0.0
        # observability surface, exported via /health + scrape-time gauges
        self.rounds = 0
        self.cross_rounds = 0
        self.repaired_total = 0
        self.last_divergence = 0   # divergent buckets seen in the last round
        self.last_sync: float | None = None  # monotonic ts of last completed round

    def configure(self, interval: float | None = None,
                  jitter: float | None = None,
                  sync_timeout: float | None = None,
                  rng: random.Random | None = None,
                  regions: dict | None = None,
                  cross_region_bias: float | None = None,
                  cross_jitter: float | None = None) -> None:
        if interval is not None:
            self.interval = interval
        if jitter is not None:
            self.jitter = jitter
        if sync_timeout is not None:
            self.sync_timeout = sync_timeout
        if rng is not None:
            self._rng = rng
        if regions is not None:
            self.regions = dict(regions)
        if cross_region_bias is not None:
            self.cross_region_bias = cross_region_bias
        if cross_jitter is not None:
            self.cross_jitter = cross_jitter

    # -------------------------------------------------------- peer selection

    def _region_of(self, endpoint: str) -> str:
        return self.regions.get(
            endpoint, self.regions.get(endpoint.rsplit("/", 1)[-1], ""))

    def _pick_peer(self, peers: list[str]) -> tuple[str, bool]:
        """(peer, is_cross_region). Geo-unaware agents draw uniformly;
        geo-aware ones split peers by region and pull cross-region with
        probability `cross_region_bias`, every draw from the one seeded
        rng, so a seeded fleet pairs the same way every run."""
        my_region = self._region_of(self.node.addr)
        if not self.regions or not my_region:
            return self._rng.choice(peers), False
        local = [p for p in peers if self._region_of(p) == my_region]
        remote = [p for p in peers if self._region_of(p) != my_region]
        if remote and (not local
                       or self._rng.random() < self.cross_region_bias):
            return self._rng.choice(remote), True
        return self._rng.choice(local or peers), False

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._task is None:
            self._task = supervised_task(self._loop(),
                                         name="antientropy.loop")

    def cancel(self) -> None:
        """Synchronous teardown for replaced nodes (redeploy rebuilds)."""
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def stop(self) -> None:
        if self._task is not None:
            task, self._task = self._task, None
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval + self._rng.uniform(0, self.jitter))
            peers = [p for p in self.node.all_replicas if p != self.node.addr]
            if not peers:
                continue
            peer, cross = self._pick_peer(peers)
            if cross:
                self.cross_rounds += 1
                if self.cross_jitter > 0:
                    await asyncio.sleep(self._rng.uniform(0, self.cross_jitter))
            try:
                await self.sync_once(peer)
            except asyncio.TimeoutError:
                metrics.inc(
                    "dds_antientropy_timeouts_total",
                    replica=self.node.name,
                    help="anti-entropy rounds abandoned on a silent peer",
                )
            except Exception:
                log.exception("anti-entropy round failed at %s", self.node.name)

    # ----------------------------------------------------------- initiator

    async def _ask(self, peer: str, msg) -> object:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[msg.nonce] = fut
        try:
            self.node.net.send(self.node.addr, peer, msg)
            return await asyncio.wait_for(fut, self.sync_timeout)
        finally:
            self._pending.pop(msg.nonce, None)

    async def sync_once(self, peer: str) -> int:
        """One pull round against `peer`; returns the number of repaired
        keys. Raises asyncio.TimeoutError if the peer stays silent."""
        node = self.node
        secret = node.cfg.abd_mac_secret
        repaired = 0
        with tracer.span("antientropy.sync", replica=node.name,
                         peer=peer.rsplit("/", 1)[-1]) as meta:
            root_reply = await self._ask(
                peer, M.MerkleRootRequest(sigs.generate_nonce()))
            if not (isinstance(root_reply, M.MerkleRoot)
                    and sigs.validate_antientropy_signature(
                        secret, "root", [root_reply.root, root_reply.count],
                        root_reply.nonce, root_reply.signature)):
                meta["outcome"] = "bad_root_reply"
                return 0
            if root_reply.root == node.merkle.root():
                self.last_divergence = 0
                self._mark_round(meta, "in_sync", 0)
                return 0

            buckets_reply = await self._ask(
                peer, M.MerkleBucketRequest(sigs.generate_nonce()))
            if not (isinstance(buckets_reply, M.MerkleBuckets)
                    and sigs.validate_antientropy_signature(
                        secret, "buckets", list(buckets_reply.digests),
                        buckets_reply.nonce, buckets_reply.signature)):
                meta["outcome"] = "bad_buckets_reply"
                return 0
            mine = node.merkle.bucket_digests()
            divergent = [
                i for i, (a, b) in enumerate(zip(mine, buckets_reply.digests))
                if a != b
            ]
            self.last_divergence = len(divergent)
            if not divergent:
                self._mark_round(meta, "in_sync", 0)
                return 0

            keys_reply = await self._ask(
                peer, M.MerkleKeysRequest(list(divergent), sigs.generate_nonce()))
            if not (isinstance(keys_reply, M.MerkleKeys)
                    and sigs.validate_antientropy_signature(
                        secret, "keys", keys_reply.entries,
                        keys_reply.nonce, keys_reply.signature)):
                meta["outcome"] = "bad_keys_reply"
                return 0

            # key -> the peer's ADVERTISED (seq, id): kept so each repaired
            # entry can be audited against what the peer claimed to hold
            # (Watchtower's repair_convergence invariant — a peer that
            # advertises fresh but serves stale never converges)
            stale: dict[str, tuple] = {}
            for key, ent in keys_reply.entries.items():
                seq, tid, vd = int(ent[0]), str(ent[1]), str(ent[2])
                local = node.merkle.get(key)
                if local is None or (local[0].seq, local[0].id) < (seq, tid):
                    stale[key] = (seq, tid)
                elif (local[0].seq, local[0].id) == (seq, tid) and local[1] != vd:
                    # same tag, different value: one side holds a forged or
                    # corrupted value under a real tag — evidence, not a
                    # repair candidate (tag order cannot arbitrate it)
                    tracer.event("antientropy.digest_mismatch",
                                 replica=node.name, peer=peer, key=key)
                    metrics.inc(
                        "dds_antientropy_digest_mismatches_total",
                        replica=node.name,
                        help="tag-equal value-digest conflicts seen in sync",
                    )
                    await flight.record_async(
                        "antientropy_digest_mismatch",
                        replica=node.name, peer=peer, key=key,
                        local=[local[0].seq, local[0].id, local[1]],
                        remote=[seq, tid, vd],
                    )

            repaired = await self._pull(peer, stale)
            if repaired:
                metrics.inc(
                    "dds_antientropy_repaired_keys_total", repaired,
                    replica=node.name,
                    help="stale keys repaired by anti-entropy",
                )
            self._mark_round(meta, "repaired", repaired)
            return repaired

    async def _pull(self, peer: str, wanted: dict, *, exact: bool = False) -> int:
        """Ask `peer` for the keys of `wanted` (key -> the (seq, id, value
        digest) the peer advertised or the manifests attested),
        RepairRequest by RepairRequest, and store each entry under a valid
        ABD HMAC that is newer than the local copy; with `exact`, only the
        wanted version with its digest. A key taken (stored, or held newer
        already) leaves `wanted`. Returns the stored count; a silent
        peer's timeout propagates."""
        node = self.node
        secret = node.cfg.abd_mac_secret
        repaired = 0
        keys = list(wanted)
        for i in range(0, len(keys), self.REPAIR_BATCH):
            batch = keys[i:i + self.REPAIR_BATCH]
            nonce = sigs.generate_nonce()
            repair = await self._ask(peer, M.RepairRequest(batch, nonce))
            if not isinstance(repair, M.RepairReply):
                continue
            asked = set(batch)
            for key, e in repair.entries.items():
                if key not in asked or key not in wanted:
                    continue
                try:
                    tag = M.ABDTag(int(e["tag"][0]), str(e["tag"][1]))
                    value = e["value"]
                    sig = bytes.fromhex(e["sig"])
                except (KeyError, TypeError, ValueError, IndexError):
                    continue
                if not sigs.validate_abd_signature(
                        secret, value, tag, nonce, sig):
                    metrics.inc(
                        "dds_antientropy_rejected_repairs_total",
                        replica=node.name,
                        help="repair entries failing the ABD HMAC",
                    )
                    continue
                src = wanted[key]
                if exact and ((tag.seq, tag.id) != src[:2]
                              or sigs.value_digest(value) != src[2]):
                    continue
                del wanted[key]
                cur = node.repository.get(key)
                if cur is None or cur[0] < tag:
                    node._store(key, tag, value)
                    repaired += 1
                    # audit feed: installed vs advertised tag, checked
                    # by Watchtower's repair_convergence invariant
                    tracer.event(
                        "audit.repair", replica=node.name,
                        peer=peer.rsplit("/", 1)[-1], key=key,
                        src_seq=src[0], src_id=src[1],
                        seq=tag.seq, tag_id=tag.id,
                    )
        return repaired

    async def fill_holes(self, wanted: dict, via: str = "manifest") -> int:
        """Pull the keys a verified reseed should hold but lacks
        (`wanted`: key -> (seq, id, value digest), from
        `replica.reseed_holes`) from each peer in turn until every one is
        in, each only in the exact version f + 1 signers attested, and
        return how many were taken (counted by `via`, the seed's
        manifests or `fill_from_listings`). A newer version is left to the
        periodic loop: one Byzantine peer holds the ABD secret and could
        sign a forged one (ROADMAP §C 23; the reference leaves every hole
        to the periodic loop)."""
        node = self.node
        left = dict(wanted)
        for peer in [p for p in node.all_replicas if p != node.addr]:
            try:
                await self._pull(peer, left, exact=True)
            except asyncio.TimeoutError:
                pass
            if not left:
                break
        filled = len(wanted) - len(left)
        tracer.event("recovery.holes_filled", replica=node.name, filled=filled,
                     left=len(left), via=via)
        metrics.inc("dds_recovery_holes_filled_total", filled, replica=node.name, via=via,
                    help="keys a verified reseed missed, pulled from peers at once, "
                         "by the seed's manifests or the signers' later listings")
        return filled

    async def fill_from_listings(self, peers: list[str], support: int) -> int:
        """After a reseed, ask `peers` (its manifest signers) for their
        whole key listings now and fill every entry that >= `support` of
        them attest identically and this replica lacks or holds older, as
        `fill_holes` does. A reseed whose manifests were taken while a
        migration was landing rejects the migrated keys, which one signer
        held then and every one holds a moment later (ROADMAP §C 24).
        Returns the keys filled."""
        from dds_tpu_torch.core.replica import _verified, reseed_holes

        node = self.node
        secret = node.cfg.abd_mac_secret
        buckets = list(range(MerkleIndex.BUCKETS))
        votes: dict[tuple, set] = {}
        for peer in peers:
            nonce = sigs.generate_nonce()
            try:
                reply = await self._ask(peer, M.MerkleKeysRequest(buckets, nonce))
            except asyncio.TimeoutError:
                continue
            if not (isinstance(reply, M.MerkleKeys)
                    and sigs.validate_antientropy_signature(
                        secret, "keys", reply.entries, reply.nonce, reply.signature)):
                continue
            for key, ent in reply.entries.items():
                try:
                    attested = (str(key), int(ent[0]), str(ent[1]), str(ent[2]))
                except (TypeError, ValueError, IndexError):
                    continue
                votes.setdefault(attested, set()).add(peer)
        holes = reseed_holes(_verified(votes, support), node.repository)
        return await self.fill_holes(holes, via="listing") if holes else 0

    def _mark_round(self, meta: dict, outcome: str, repaired: int) -> None:
        self.rounds += 1
        self.repaired_total += repaired
        self.last_sync = time.monotonic()
        meta["outcome"] = outcome
        meta["repaired"] = repaired
        meta["divergent_buckets"] = self.last_divergence
        metrics.inc(
            "dds_antientropy_rounds_total", replica=self.node.name,
            help="completed anti-entropy rounds",
        )

    # ------------------------------------------------------------ responder

    def handle(self, sender: str, msg) -> bool:
        """Dispatch one anti-entropy message (both roles); True = consumed.
        Called from the replica's behavior handlers, so a byzantine node
        simply never reaches here (omission, like the reference's)."""
        node = self.node
        secret = node.cfg.abd_mac_secret
        match msg:
            case M.MerkleRootRequest(nonce):
                root = node.merkle.root()
                count = len(node.merkle)
                sig = sigs.antientropy_signature(
                    secret, "root", [root, count], nonce)
                node._send(sender, M.MerkleRoot(root, count, nonce, sig))
            case M.MerkleBucketRequest(nonce):
                digests = node.merkle.bucket_digests()
                sig = sigs.antientropy_signature(
                    secret, "buckets", digests, nonce)
                node._send(sender, M.MerkleBuckets(digests, nonce, sig))
            case M.MerkleKeysRequest(buckets, nonce):
                entries = node.merkle.entries_in(buckets)
                sig = sigs.antientropy_signature(secret, "keys", entries, nonce)
                node._send(sender, M.MerkleKeys(entries, nonce, sig))
            case M.RepairRequest(keys, nonce):
                entries = {}
                for key in list(keys)[: self.REPAIR_BATCH]:
                    stored = node.repository.get(key)
                    if stored is None or not MerkleIndex._tracked(*stored):
                        continue
                    tag, value = stored
                    entries[key] = {
                        "tag": [tag.seq, tag.id],
                        "value": value,
                        "sig": sigs.abd_signature(
                            secret, value, tag, nonce).hex(),
                    }
                node._send(sender, M.RepairReply(entries, nonce))
            case (M.MerkleRoot() | M.MerkleBuckets() | M.MerkleKeys()
                  | M.RepairReply()):
                fut = self._pending.get(msg.nonce)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
            case _:
                return False
        return True

    def stats(self) -> dict:
        """Health/scrape surface (http/server._sample_state_gauges)."""
        age = (
            None if self.last_sync is None
            else max(0.0, time.monotonic() - self.last_sync)
        )
        return {
            "rounds": self.rounds,
            "cross_region_rounds": self.cross_rounds,
            "repaired_keys": self.repaired_total,
            "divergent_buckets": self.last_divergence,
            "last_sync_age": age,
            "running": self._task is not None,
        }
