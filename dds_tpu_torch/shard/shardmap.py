"""Constellation shard maps: epoch-versioned, HMAC-signed keyspace partitions.

Copy of `dds_tpu/shard/shardmap.py` without the Atlas region labels
(`[geo]` is not ported, so every map here is geo-unaware and signs the
payload the reference signs for a map without regions): the same ring
positions, owners, signatures, split/merge/relabel arithmetic, fencing
state (with its fence lease) and routing authority, so one map resolves
the same owner for the same key in both packages.

The ROADMAP's first scale lever. A `ShardMap` deterministically partitions
the key->set keyspace across S independent BFT-ABD quorum groups with a
consistent-hash ring of virtual nodes: every group contributes
`vnodes_per_group` ring positions derived from sha256(group_id # index),
and a key belongs to the group owning the first vnode clockwise of
sha256(key). Properties the rest of the plane leans on:

- **deterministic**: any party holding the map resolves the same owner for
  the same key — routers, replicas, and the rebalancer never negotiate.
- **epoch-versioned**: maps only ever move forward; every client->replica
  message carries the sender's epoch and replicas fence requests for keys
  their group no longer owns (core/replica), so a stale map can stall a
  request (retry under its Deadline budget) but never misroute it.
- **HMAC-signed**: the map is operator state distributed to every fencing
  party and served at GET /shards; the signature (intranet secret) stops a
  credentialed-but-keyless peer from installing a forged map that silently
  re-homes the keyspace.
- **split-local**: `split()` places the new group's vnodes at the ring
  midpoint of each victim vnode's arc, so a split moves (about half of)
  the VICTIM's keys and nothing else — every other group's ownership is
  bit-identical across the epoch bump, which is what keeps a live reshard
  a single-group migration instead of a cluster-wide reshuffle.

All groups share one Paillier modulus (the clients' key pair): sharding
partitions *storage and quorum fan-out*, not the ciphertext algebra, so
scatter-gathered aggregate partials combine with a plain modular-product
tail reduction (parallel/mesh.combine_partials).
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import logging
from dataclasses import dataclass

from dds_tpu_torch.utils import sigs

log = logging.getLogger("dds_torch.shard.map")

_RING = 1 << 64  # ring positions are the first 8 bytes of sha256


def _position(label: str) -> int:
    return int.from_bytes(hashlib.sha256(label.encode()).digest()[:8], "big")


@dataclass(frozen=True)
class ShardMap:
    epoch: int
    # sorted (ring position, group id) pairs; positions are unique
    vnodes: tuple
    groups: tuple
    signature: bytes = b""

    # ------------------------------------------------------------ building

    @staticmethod
    def build(groups: list[str], vnodes_per_group: int = 16,
              epoch: int = 1) -> "ShardMap":
        """Fresh map over `groups`; deterministic for a given group list."""
        if not groups:
            raise ValueError("a shard map needs at least one group")
        vnodes = []
        seen = set()
        for gid in sorted(groups):
            for i in range(vnodes_per_group):
                pos = _position(f"{gid}#{i}")
                while pos in seen:  # astronomically rare; keep positions unique
                    pos = (pos + 1) % _RING
                seen.add(pos)
                vnodes.append((pos, gid))
        vnodes.sort()
        return ShardMap(epoch, tuple(vnodes), tuple(sorted(groups)))

    def split(self, victim: str, new_gid: str) -> "ShardMap":
        """Epoch+1 map where `new_gid` takes ~half of `victim`'s keyspace:
        one new vnode at the ring midpoint of each victim vnode's arc.
        Ownership outside the victim's arcs is untouched (unsigned —
        callers sign the result before distributing it)."""
        if victim not in self.groups:
            raise ValueError(f"unknown victim group {victim!r}")
        if new_gid in self.groups:
            raise ValueError(f"group {new_gid!r} already in the map")
        positions = [p for p, _ in self.vnodes]
        added = []
        taken = set(positions)
        for i, (pos, gid) in enumerate(self.vnodes):
            if gid != victim:
                continue
            pred = self.vnodes[i - 1][0]  # ring predecessor (wraps at i=0)
            arc = (pos - pred) % _RING
            if arc < 2:
                continue
            mid = (pred + arc // 2) % _RING
            if mid in taken:
                continue
            taken.add(mid)
            added.append((mid, new_gid))
        if not added:
            raise ValueError(f"victim {victim!r} has no splittable arc")
        vnodes = tuple(sorted(self.vnodes + tuple(added)))
        return ShardMap(self.epoch + 1, vnodes,
                        tuple(sorted(self.groups + (new_gid,))))

    def merge(self, victim: str) -> "ShardMap":
        """Epoch+1 map with `victim`'s vnodes RETIRED: every key the
        victim owned falls to the first surviving vnode clockwise of its
        position. The exact inverse of `split` — `m.split(v, g).merge(g)`
        owns every key identically to `m` (epoch aside) — and merge-local
        the same way split is split-local: only keys the victim owned
        move; every other group's ownership is bit-identical across the
        epoch bump. Unsigned — callers sign before distributing."""
        if victim not in self.groups:
            raise ValueError(f"unknown victim group {victim!r}")
        if len(self.groups) < 2:
            raise ValueError("cannot merge the last group away")
        vnodes = tuple((p, g) for p, g in self.vnodes if g != victim)
        groups = tuple(g for g in self.groups if g != victim)
        return ShardMap(self.epoch + 1, vnodes, groups)

    def relabel(self, old_gid: str, new_gid: str) -> "ShardMap":
        """Epoch+1 map where `new_gid` takes over `old_gid`'s ring
        positions VERBATIM — the disaster-takeover move when a whole
        group process dies: ownership arcs are bit-identical, only the
        serving group changes, so no key moves between surviving groups.
        Unsigned — callers sign before distributing."""
        if old_gid not in self.groups:
            raise ValueError(f"unknown group {old_gid!r}")
        if new_gid in self.groups:
            raise ValueError(f"group {new_gid!r} already in the map")
        vnodes = tuple(
            (p, new_gid if g == old_gid else g) for p, g in self.vnodes
        )
        groups = tuple(sorted(
            new_gid if g == old_gid else g for g in self.groups
        ))
        return ShardMap(self.epoch + 1, vnodes, groups)

    def absorbers(self, victim: str) -> list[str]:
        """Groups that would receive keys if `victim` merged away: for
        each victim vnode, the owner of the first surviving vnode
        clockwise (the group absorbing that arc). Construction order is
        ring order, deduplicated — deterministic for a given map, so the
        rebalancer and any observer derive the same receiver set."""
        if victim not in self.groups:
            raise ValueError(f"unknown victim group {victim!r}")
        out: list[str] = []
        n = len(self.vnodes)
        for i, (_, gid) in enumerate(self.vnodes):
            if gid != victim:
                continue
            for j in range(1, n):
                succ = self.vnodes[(i + j) % n][1]
                if succ != victim:
                    if succ not in out:
                        out.append(succ)
                    break
        return out

    # ------------------------------------------------------------- routing

    @staticmethod
    def key_position(key: str) -> int:
        return _position(key)

    def owner(self, key: str) -> str:
        """Group owning `key`: first vnode clockwise of the key's position."""
        positions = [p for p, _ in self.vnodes]
        idx = bisect.bisect_left(positions, self.key_position(key))
        return self.vnodes[idx % len(self.vnodes)][1]

    # ---------------------------------------------------------- signatures

    def _payload(self) -> dict:
        return {"epoch": self.epoch,
                "vnodes": [[p, g] for p, g in self.vnodes]}

    def sign(self, secret: bytes) -> "ShardMap":
        sig = sigs.manifest_signature(secret, "shard-map", self._payload(),
                                      self.epoch)
        return dataclasses.replace(self, signature=sig)

    def verify(self, secret: bytes) -> bool:
        return sigs.validate_manifest_signature(
            secret, "shard-map", self._payload(), self.epoch, self.signature
        )

    # ---------------------------------------------------------------- wire

    def to_wire(self) -> dict:
        return {
            "epoch": self.epoch,
            "groups": list(self.groups),
            "vnodes": [[p, g] for p, g in self.vnodes],
            "signature": self.signature.hex(),
        }

    @staticmethod
    def from_wire(d: dict) -> "ShardMap":
        return ShardMap(
            int(d["epoch"]),
            tuple((int(p), str(g)) for p, g in d["vnodes"]),
            tuple(str(g) for g in d["groups"]),
            bytes.fromhex(d.get("signature", "")),
        )


def moved_keys(old: ShardMap, new: ShardMap, keys) -> list[str]:
    """Keys in `keys` whose owner changes between the two maps."""
    return [k for k in keys if old.owner(k) != new.owner(k)]


class ShardState:
    """One replica group's live fencing state: the group id plus the
    newest verified map the group has been handed. Every replica of a
    group shares ONE instance (installed in a single step per group —
    the in-process analogue of a config push), so `owns()` answers the
    fence question consistently across the group.

    **Fence lease**: a reshard's freeze step installs the new map with a
    TTL (`lease` seconds). If the plan's controller dies before committing
    (activation or rollback), the lease expires and the state reverts to
    the last COMMITTED map on its own — a crashed controller can stall a
    group for one TTL, never fence it forever. The rebalancer renews the
    lease while it streams and commits it (re-install, no lease) right
    after activation or abort."""

    def __init__(self, group_id: str, smap: ShardMap, secret: bytes,
                 clock=None):
        import time as _time

        self.group_id = group_id
        self.secret = secret
        self._clock = clock or _time.monotonic
        self._map = None
        self._lease_at = 0.0        # monotonic expiry; 0 = committed
        self._fallback = None       # last committed map, restored on expiry
        self.install(smap)

    def _lease_check(self) -> None:
        if self._fallback is not None and self._clock() >= self._lease_at:
            # the controller never came back: heal to the committed map
            expired, self._map = self._map, self._fallback
            self._fallback, self._lease_at = None, 0.0
            from dds_tpu_torch.obs.metrics import metrics

            metrics.inc("dds_shard_lease_expired_total",
                        shard=self.group_id,
                        help="fence leases that expired back to the "
                             "committed map (crashed reshard controller)")
            log.warning(
                "group %s fence lease expired: epoch %d reverts to "
                "committed epoch %d", self.group_id, expired.epoch,
                self._map.epoch,
            )

    @property
    def map(self) -> ShardMap:
        self._lease_check()
        return self._map

    @property
    def epoch(self) -> int:
        self._lease_check()
        return self._map.epoch

    @property
    def leased(self) -> bool:
        self._lease_check()
        return self._fallback is not None

    def lease_remaining(self) -> float:
        """Seconds until the current fence lease heals back (0 when the
        installed map is committed)."""
        self._lease_check()
        if self._fallback is None:
            return 0.0
        return max(0.0, self._lease_at - self._clock())

    def owns(self, key: str) -> bool:
        self._lease_check()
        return self._map.owner(key) == self.group_id

    def install(self, smap: ShardMap, force: bool = False,
                lease: float = 0.0) -> None:
        """Adopt a newer signed map. `force` permits an epoch rollback —
        reserved for the rebalancer's abort path, which restores the
        previous map after a failed migration. `lease > 0` installs the
        map PROVISIONALLY for that many seconds (see class docstring);
        re-installing the same epoch with a lease renews it, and
        installing with `lease=0` commits. A committed map never reverts."""
        if not smap.verify(self.secret):
            raise ValueError("shard map signature invalid")
        self._lease_check()
        if self._map is not None and smap.epoch < self._map.epoch and not force:
            raise ValueError(
                f"shard map epoch moved backwards "
                f"({self._map.epoch} -> {smap.epoch})"
            )
        if lease > 0:
            if self._fallback is None:
                # the map in force BEFORE the provisional install is the
                # committed state the lease heals back to
                self._fallback = self._map
            self._lease_at = self._clock() + lease
        else:
            self._fallback, self._lease_at = None, 0.0
        self._map = smap


class ShardManager:
    """The routing authority: holds the ACTIVE map (what routers resolve
    against) and the reshard state flag. During a live split the source
    and target groups fence under the NEW map while the manager still
    serves the old one; `activate()` is the final cut-over."""

    def __init__(self, smap: ShardMap, secret: bytes):
        if not smap.verify(secret):
            raise ValueError("shard map signature invalid")
        self.secret = secret
        self._map = smap
        self.state = "stable"  # stable | resharding

    def current(self) -> ShardMap:
        return self._map

    @property
    def epoch(self) -> int:
        return self._map.epoch

    def begin_reshard(self) -> None:
        self.state = "resharding"

    def end_reshard(self) -> None:
        self.state = "stable"

    def activate(self, smap: ShardMap) -> None:
        if not smap.verify(self.secret):
            raise ValueError("shard map signature invalid")
        if smap.epoch <= self._map.epoch:
            raise ValueError(
                f"activation requires a newer epoch "
                f"({smap.epoch} <= {self._map.epoch})"
            )
        self._map = smap
