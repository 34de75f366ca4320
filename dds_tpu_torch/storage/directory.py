"""Stratum tier directory: residency + decayed popularity per entry.

Copy of `dds_tpu/storage/directory.py`.

One record per (stripe, cipher): which tier holds the entry (hot = device
pool, warm = host cache, cold = segment store) and an exponentially
decayed touch count — `score` halves every `half_life` seconds, and each
touch from a fold/search/ingest path adds its weight. Under a Zipf
workload (the load plane's `clt/distribution.ZipfKeys` popularity model,
which doubles as the test harness) the decayed counts rank-order exactly
like the underlying popularity weights, so:

- eviction picks the tail (`coldest` — lowest score first),
- promotion picks entries whose score clears `promote_score` (touched
  repeatedly within recent half-lives, i.e. the Zipf head),
- the split planner routes each fold operand to the leg its current
  tier can serve without moving bytes first.

Pure in-memory dict math — safe to call from the event loop (the write
path's `note_write` touches go through here) and from worker threads.
"""

from __future__ import annotations

import threading
import time

HOT, WARM, COLD = "hot", "warm", "cold"
TIERS = (HOT, WARM, COLD)

Stripe = tuple  # (gid, tenant, modulus)


class _Entry:
    __slots__ = ("tier", "score", "stamp")

    def __init__(self, tier: str, now: float):
        self.tier = tier
        self.score = 0.0
        self.stamp = now


class TierDirectory:
    """Residency + EWMA popularity per (stripe, cipher)."""

    def __init__(self, half_life: float = 60.0):
        self.half_life = max(1e-3, float(half_life))
        self._lock = threading.Lock()
        self._entries: dict[Stripe, dict[int, _Entry]] = {}

    # ------------------------------------------------------------- scoring

    def _decayed(self, e: _Entry, now: float) -> float:
        dt = max(0.0, now - e.stamp)
        return e.score * (0.5 ** (dt / self.half_life))

    def touch(self, stripe: Stripe, cipher: int, weight: float = 1.0,
              tier: str | None = None) -> float:
        """Decay-then-add one touch; returns the new score. `tier` seeds
        residency for entries the directory has not met yet (a fresh
        quorum-read operand enters as hot — the pool ingests it)."""
        now = time.monotonic()
        with self._lock:
            dest = self._entries.setdefault(stripe, {})
            e = dest.get(cipher)
            if e is None:
                e = dest[cipher] = _Entry(tier or HOT, now)
            e.score = self._decayed(e, now) + weight
            e.stamp = now
            return e.score

    def score(self, stripe: Stripe, cipher: int) -> float:
        now = time.monotonic()
        with self._lock:
            dest = self._entries.get(stripe)
            e = dest.get(cipher) if dest else None
            return 0.0 if e is None else self._decayed(e, now)

    # ----------------------------------------------------------- residency

    def set_tier(self, stripe: Stripe, cipher: int, tier: str) -> None:
        assert tier in TIERS, tier
        now = time.monotonic()
        with self._lock:
            dest = self._entries.setdefault(stripe, {})
            e = dest.get(cipher)
            if e is None:
                dest[cipher] = _Entry(tier, now)
            else:
                e.tier = tier

    def tier_of(self, stripe: Stripe, cipher: int) -> str | None:
        with self._lock:
            dest = self._entries.get(stripe)
            e = dest.get(cipher) if dest else None
            return None if e is None else e.tier

    def drop(self, stripe: Stripe, cipher: int) -> None:
        with self._lock:
            dest = self._entries.get(stripe)
            if dest:
                dest.pop(cipher, None)

    def drop_stripe(self, stripe: Stripe) -> int:
        with self._lock:
            dest = self._entries.pop(stripe, None)
            return len(dest) if dest else 0

    # ------------------------------------------------------------ planning

    def coldest(self, candidates: list[tuple[Stripe, int]],
                k: int | None = None) -> list[tuple[Stripe, int]]:
        """`candidates` ordered coldest-first by decayed score (the Zipf
        tail leads); `k` truncates. Victim selection for both the pool's
        eviction rank and the warm cache's demotion sweep."""
        now = time.monotonic()
        with self._lock:
            def key(sc):
                stripe, c = sc
                dest = self._entries.get(stripe)
                e = dest.get(c) if dest else None
                return self._decayed(e, now) if e is not None else 0.0

            out = sorted(candidates, key=key)
        return out if k is None else out[:k]

    def counts(self) -> dict:
        with self._lock:
            out = {t: 0 for t in TIERS}
            for dest in self._entries.values():
                for e in dest.values():
                    out[e.tier] = out.get(e.tier, 0) + 1
            return out
