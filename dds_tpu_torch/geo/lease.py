"""Read-lease bookkeeping for the read-local quorum geometry (copy of
`dds_tpu/geo/lease.py`).

One `LeaseTable` is shared by every replica of a quorum group (the
in-process config-push idiom of `shard.ShardState`). A grant is installed
by the replica that will serve the region's local reads and is at once
visible to the group's coordinators, which consult `holders()` to pin
their quorums (see `dds_tpu_torch.geo`).

Tokens are HMAC-derived from the grant fields plus a per-table counter,
so a token proves the grant came from this table and a stale token from
an earlier grant of the same (region, replica) pair is rejected after a
revoke or re-grant. The same secret, clock and grant order give the same
tokens in both packages.
"""

from __future__ import annotations

import hashlib
import hmac
import time
from dataclasses import dataclass
from typing import Callable, Optional

from dds_tpu_torch.obs.metrics import metrics


@dataclass(frozen=True)
class ReadLease:
    """An active read lease: `replica` may answer `region`-local reads
    for its group until `expires` (table-clock seconds)."""

    gid: str
    region: str
    replica: str
    token: str
    expires: float

    def active(self, now: float) -> bool:
        return now < self.expires


class LeaseTable:
    """Per-group read-lease registry: region -> ReadLease."""

    def __init__(self, gid: str, secret: bytes,
                 clock: Callable[[], float] = time.monotonic):
        self.gid = gid
        self.secret = secret
        self.clock = clock
        self._leases: dict[str, ReadLease] = {}
        self._grants = 0  # monotone: distinguishes re-grants of one pair

    def _token(self, region: str, replica: str, expires: float) -> str:
        blob = f"{self.gid}|{region}|{replica}|{expires}|{self._grants}"
        return hmac.new(self.secret, blob.encode(), hashlib.sha256).hexdigest()

    def grant(self, region: str, replica: str, ttl: float) -> ReadLease:
        """Install (or renew) the region's lease on `replica`."""
        self._grants += 1
        expires = self.clock() + ttl
        lease = ReadLease(self.gid, region, replica,
                          self._token(region, replica, expires), expires)
        self._leases[region] = lease
        metrics.inc("dds_geo_lease_grants_total", shard=self.gid,
                    region=region,
                    help="read-lease grants/renewals installed per group")
        return lease

    def revoke(self, region: str) -> bool:
        """Drop the region's lease; local reads fall back to a full quorum
        on their next attempt. Returns whether a lease was present."""
        if self._leases.pop(region, None) is None:
            return False
        metrics.inc("dds_geo_lease_revocations_total", shard=self.gid,
                    region=region,
                    help="read leases explicitly revoked per group")
        return True

    def active(self, region: str) -> Optional[ReadLease]:
        lease = self._leases.get(region)
        if lease is None:
            return None
        if not lease.active(self.clock()):
            # expiry is the availability escape hatch: it unblocks quorums
            # pinned on a dead holder without any message exchange
            del self._leases[region]
            metrics.inc("dds_geo_lease_expired_total", shard=self.gid,
                        region=lease.region,
                        help="read leases that aged out per group")
            return None
        return lease

    def valid(self, region: str, replica: str, token: str) -> bool:
        """May `replica` answer a region-local read bearing `token` now?"""
        lease = self.active(region)
        return (lease is not None and lease.replica == replica
                and hmac.compare_digest(lease.token, token))

    def holders(self) -> frozenset:
        """Replica names holding ANY active lease: the set every quorum
        this group closes must include while leases are out."""
        return frozenset(
            lease.replica for region in list(self._leases)
            for lease in [self.active(region)] if lease is not None
        )

    def held_by(self, replica: str) -> bool:
        return replica in self.holders()

    def census(self) -> dict:
        """Active leases for /health: region -> {replica, remaining}."""
        now = self.clock()
        out = {}
        for region in sorted(self._leases):
            lease = self.active(region)
            if lease is not None:
                out[region] = {"replica": lease.replica,
                               "remaining": round(lease.expires - now, 3)}
        return out
