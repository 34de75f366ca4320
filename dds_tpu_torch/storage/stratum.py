"""Stratum: the three-tier ciphertext hierarchy and its fold planner.

Port of `dds_tpu/storage/stratum.py`. `Stratum` wraps a `ResidentPlane`
and grows it downward:

    hot   — the content-addressed ResidentPool rows in device memory
            (one fused gather+fold per aggregate),
    warm  — host numpy limb rows (`warm.WarmCache`), fed by pool eviction
            instead of a capacity reset: past `max_rows` the pool spills
            its coldest rows here and keeps serving the fused fast path
            for the rows that stay,
    cold  — the append-only HMAC'd segment log (`segment.SegmentStore`),
            fed by warm-budget overflow; logical-delete + compaction.

A `TierDirectory` tracks per-entry residency and an exponentially
decayed touch count fed from the fold and write-ingest paths (and, with
the search plane, its selections through `touch_keys`); under Zipf
access the decayed counts rank-order like the popularity weights, so
eviction takes the tail and promotion takes the head.

`fold_groups` is the tier planner: each group's operand multiset splits
into a *resident leg* (hot + never-seen operands while the pool has room,
folded by the plane's fused fold) and *streamed legs* (warm rows stacked
from host memory, cold rows read + re-verified from segments, and
operands past the pool's room converted directly), folded in
`chunk_rows` slices by `ops/mont_cuda.reduce_mul` on the plane's device
(the reference calls `ModCtx.reduce_mul`). The legs merge through
`parallel/mesh.combine_partials` — an exact modular product — so the
answer is bit-for-bit the all-resident answer; capacity is no longer
bounded by device memory. The movement is traced as `tier.demote`,
`tier.promote` and `tier.cold_read` spans, and `pressure()` is the
0..1 occupancy signal the reference's autoscaler reads.

Threading: every byte-moving method (fold_groups, demote, promote) runs
on worker threads — the server reaches them via `asyncio.to_thread`, the
pool's spill fires inside fold/ingest calls that are already off-loop.
Only the pure-dict popularity touches (`note_write`, `touch`,
`touch_keys`) are loop-safe.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx
from dds_tpu_torch.parallel.mesh import combine_partials
from dds_tpu_torch.storage.directory import COLD, HOT, WARM, TierDirectory
from dds_tpu_torch.storage.segment import SegmentStore
from dds_tpu_torch.storage.warm import WarmCache
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.stratum")

Stripe = tuple  # (gid, tenant, modulus)


class Stratum:
    """Tiered ciphertext storage over one ResidentPlane (module docstring)."""

    def __init__(self, plane, directory, *, warm_bytes: int = 64 << 20,
                 chunk_rows: int = 256, promote_score: float = 2.0,
                 max_promote: int = 256, half_life: float = 60.0,
                 keep: int = 3, compact_segments: int = 8,
                 secret: bytes | None = None, name: str = "stratum"):
        self.plane = plane
        self.warm = WarmCache(warm_bytes)
        self.cold = SegmentStore(directory, name=name, secret=secret,
                                 keep=keep, compact_segments=compact_segments)
        self.dir = TierDirectory(half_life=half_life)
        self.chunk_rows = max(2, int(chunk_rows))
        self.promote_score = float(promote_score)
        self.max_promote = max(1, int(max_promote))
        self._lock = threading.Lock()
        self._hits = {HOT: 0, WARM: 0, COLD: 0}
        self._evictions = {HOT: 0, WARM: 0}
        self._cold_reads = 0
        self._promotions = 0
        self._demotions = 0
        # bounded write-time (tenant, key) -> (gid, ciphers) map: the
        # Spyglass selection path speaks keys, the directory speaks
        # ciphertexts — this is the translation that lets a search hit
        # warm its row's fold operands. Loop-thread only (note_write /
        # touch_keys both run on the event loop), insertion-ordered so
        # overflow drops the oldest mapping.
        self._keymap: dict[tuple[str, str], tuple[str, tuple[int, ...]]] = {}
        self._keymap_max = 65536
        # boot: verify + index every durable segment (crash-mid-demotion
        # orphans included) and seed the directory's cold residency
        loaded = self.cold.load()
        for stripe, ciphers in self.cold.entries().items():
            for c in ciphers:
                self.dir.set_tier(stripe, c, COLD)
        if loaded:
            log.info("stratum cold tier loaded: %d entries, %d segments",
                     loaded, self.cold.stats()["segments"])
        self.attach(plane)

    # ------------------------------------------------------------- plumbing

    def attach(self, plane) -> None:
        """Become the plane's tier sink: new pools wire at creation
        (`ResidentPlane.pool`), existing ones retrofit here — after this,
        capacity overflow demotes instead of resetting."""
        plane.tier_sink = self
        with plane._lock:
            pools = list(plane._pools.items())
        for key, pool in pools:
            self.wire_pool(key, pool)

    def wire_pool(self, key: Stripe, pool) -> None:
        pool.spill = lambda rows, _s=key: self.demote(_s, rows)
        pool.evict_rank = lambda cs, _s=key: self.rank(_s, cs)

    def rank(self, stripe: Stripe, ciphers: list[int]) -> list[int]:
        """Coldest-first eviction order for a pool's victim pick."""
        return [c for _, c in self.dir.coldest(
            [(stripe, c) for c in ciphers]
        )]

    # ------------------------------------------------------------- demotion

    def demote(self, stripe: Stripe, rows: list[tuple[int, np.ndarray]]) -> None:
        """Pool spill sink (hot -> warm), cascading warm -> cold when the
        host budget overflows. Runs inside fold/ingest worker threads."""
        if not rows:
            return
        t0 = time.perf_counter()
        moved = 0
        for cipher, row in rows:
            self.warm.put(stripe, cipher, row)
            self.dir.set_tier(stripe, cipher, WARM)
            moved += row.nbytes
        gid = stripe[0] or "-"
        with self._lock:
            self._evictions[HOT] += len(rows)
            self._demotions += len(rows)
        metrics.inc("dds_tier_evictions_total", len(rows), tier="hot",
                    shard=gid, help="entries demoted out of a tier")
        self._rebalance_warm()
        tracer.record(
            "tier.demote", (time.perf_counter() - t0) * 1e3,
            rows=len(rows), bytes=moved, shard=gid,
        )

    def _rebalance_warm(self) -> None:
        """Push the coldest warm rows into the segment log until the host
        byte budget holds. One durable append per wave (fsync'd before
        return), so a row acked out of warm memory is on disk first."""
        over = self.warm.over_budget()
        if not over:
            return
        items = self.warm.items()
        order = self.dir.coldest([(stripe, c) for stripe, c, _ in items])
        batch: dict[Stripe, list[int]] = {}
        freed = 0
        for stripe, cipher in order:
            if freed >= over:
                break
            row = self.warm.pop(stripe, cipher)
            if row is None:
                continue
            freed += row.nbytes
            batch.setdefault(stripe, []).append(cipher)
        if not batch:
            return
        self.cold.append(batch)
        n = 0
        for stripe, ciphers in batch.items():
            for c in ciphers:
                self.dir.set_tier(stripe, c, COLD)
            n += len(ciphers)
            metrics.inc("dds_tier_evictions_total", len(ciphers), tier="warm",
                        shard=stripe[0] or "-",
                        help="entries demoted out of a tier")
        with self._lock:
            self._evictions[WARM] += n

    # ------------------------------------------------------------ promotion

    def _promote(self, stripe: Stripe, candidates: list[int]) -> int:
        """Warm/cold -> hot for entries whose decayed score cleared the
        promotion bar (the Zipf head re-enters the fused fast path)."""
        if not candidates:
            return 0
        gid, tenant, modulus = stripe
        cands = candidates[: self.max_promote]
        t0 = time.perf_counter()
        pool = self.plane.pool(gid, modulus, tenant)
        grew = pool.ingest(cands)
        for c in cands:
            self.warm.pop(stripe, c)
            self.dir.set_tier(stripe, c, HOT)
        self.cold.discard(stripe, cands)
        with self._lock:
            self._promotions += len(cands)
        metrics.inc("dds_tier_promotions_total", len(cands),
                    shard=gid or "-",
                    help="entries promoted back into the hot (HBM) tier")
        tracer.record(
            "tier.promote", (time.perf_counter() - t0) * 1e3,
            rows=len(cands), ingested=grew, shard=gid or "-",
        )
        return len(cands)

    # ---------------------------------------------------- popularity inputs

    def note_write(self, gid: str, ciphers: list[int], tenant: str = "",
                   modulus: int | None = None, key: str | None = None) -> None:
        """Write-ingest popularity: committed ciphertexts count toward the
        EWMA under every modulus stripe this group has established (pure
        dict math — loop-safe, mirrors `ResidentPlane.note_write`). With
        `key`, also records the key -> ciphers mapping the search-path
        feed (`touch_keys`) translates through."""
        if not ciphers:
            return
        if key is not None:
            km, kk = self._keymap, (tenant, key)
            km.pop(kk, None)
            km[kk] = (gid, tuple(ciphers))
            while len(km) > self._keymap_max:
                km.pop(next(iter(km)))
        with self.plane._lock:
            moduli = [m for g, t, m in self.plane._pools
                      if g == gid and t == tenant]
        for m in moduli or ([modulus] if modulus else []):
            stripe = (gid, tenant, m)
            for c in ciphers:
                self.dir.touch(stripe, c, weight=0.5)

    def touch(self, gid: str, modulus: int, ciphers, tenant: str = "",
              weight: float = 1.0) -> None:
        """Search/analytics-path popularity (Spyglass hits keep their
        matched values' fold rows warm). Loop-safe."""
        stripe = (gid, tenant, modulus)
        for c in ciphers:
            self.dir.touch(stripe, c, weight=weight)

    def touch_keys(self, keys, tenant: str = "",
                   weight: float = 1.0) -> None:
        """Search-path popularity: a Spyglass selection names KEYS, and
        every selected key this stripe has seen committed (bounded
        write-time key->cipher map) touches its fold ciphertexts — rows
        users keep finding stay in the fused hot leg. Loop-safe."""
        moduli_by_gid: dict[str, list[int]] = {}
        for k in keys:
            ent = self._keymap.get((tenant, k))
            if ent is None:
                continue
            gid, ciphers = ent
            moduli = moduli_by_gid.get(gid)
            if moduli is None:
                with self.plane._lock:
                    moduli = [m for g, t, m in self.plane._pools
                              if g == gid and t == tenant]
                moduli_by_gid[gid] = moduli
            for m in moduli:
                stripe = (gid, tenant, m)
                for c in ciphers:
                    self.dir.touch(stripe, c, weight=weight)

    # ------------------------------------------------------------ the planner

    def fold_groups(self, parts: list[tuple[str, list[int]]], modulus: int,
                    tenant: str = "") -> int | None:
        """prod over every group's operands mod `modulus`, split per group
        into a resident-fused leg and streamed warm/cold legs, merged via
        the exact `combine_partials` product — bit-for-bit the plane's
        all-resident answer. Returns None only when the plane itself
        cannot serve a resident leg (operand set wider than `max_rows`
        even after eviction), matching the plane's fallback contract."""
        parts = [(gid, ops) for gid, ops in parts if ops]
        if not parts:
            return 1 % modulus
        ctx = ModCtx.make(modulus)
        resident_parts: list[tuple[str, list[int]]] = []
        streamed: list[tuple[Stripe, list[int], list[int]]] = []
        promote_cands: dict[Stripe, list[int]] = {}
        for gid, ops in parts:
            stripe = (gid, tenant, modulus)
            pool = self.plane.pool(gid, modulus, tenant)
            member = pool.membership(ops)
            hot_ops: list[int] = []
            warm_ops: list[int] = []
            cold_ops: list[int] = []
            direct_ops: list[int] = []
            seen_scored: set[int] = set()
            # the resident leg must keep its distinct operand set within
            # the pool (ensure() answers None past max_rows, losing the
            # whole fused leg): hot members are already rows, so fresh
            # never-seen operands only admit while room remains — the
            # rest stream directly and adopt into the warm tier below
            fresh_budget = pool.max_rows - len(
                {c for c, m in zip(ops, member) if m}
            )
            fresh_admitted: set[int] = set()
            for c, is_hot in zip(ops, member):
                score = self.dir.touch(stripe, c)
                if is_hot:
                    hot_ops.append(c)
                    continue
                if self.warm.contains(stripe, c):
                    warm_ops.append(c)
                elif self.cold.contains(stripe, c):
                    cold_ops.append(c)
                elif (c in fresh_admitted
                        or len(fresh_admitted) < fresh_budget):
                    # never-seen operand (fresh from the quorum read):
                    # enters through the hot path like before Stratum
                    fresh_admitted.add(c)
                    hot_ops.append(c)
                    continue
                else:
                    direct_ops.append(c)
                    continue
                if score >= self.promote_score and c not in seen_scored:
                    seen_scored.add(c)
                    promote_cands.setdefault(stripe, []).append(c)
            gidl = gid or "-"
            if hot_ops:
                metrics.inc("dds_tier_hits_total", len(hot_ops), tier="hot",
                            shard=gidl,
                            help="fold operands served per tier")
            if warm_ops:
                metrics.inc("dds_tier_hits_total", len(warm_ops), tier="warm",
                            shard=gidl,
                            help="fold operands served per tier")
            if cold_ops:
                metrics.inc("dds_tier_hits_total", len(cold_ops), tier="cold",
                            shard=gidl,
                            help="fold operands served per tier")
            with self._lock:
                self._hits[HOT] += len(hot_ops)
                self._hits[WARM] += len(warm_ops)
                self._hits[COLD] += len(cold_ops)
            if hot_ops:
                resident_parts.append((gid, hot_ops))
            if warm_ops or cold_ops or direct_ops:
                streamed.append((stripe, warm_ops, cold_ops, direct_ops))
        partials: list[int] = []
        if resident_parts:
            r = self.plane.fold_groups(resident_parts, modulus, tenant)
            if r is None:
                return None  # wider than the pool: caller's legacy fallback
            partials.append(r)
        adopted = False
        for stripe, warm_ops, cold_ops, direct_ops in streamed:
            partials.append(
                self._stream_fold(stripe, ctx, warm_ops, cold_ops,
                                  direct_ops)
            )
            adopted = adopted or bool(direct_ops)
        if adopted:
            # direct-overflow rows adopted into warm above: enforce the
            # byte budget once per fold, not once per group
            self._rebalance_warm()
        if not partials:
            return 1 % modulus
        result = (combine_partials(partials, modulus)
                  if len(partials) > 1 else partials[0] % modulus)
        for stripe, cands in promote_cands.items():
            self._promote(stripe, cands)
        return result

    def _stream_fold(self, stripe: Stripe, ctx: ModCtx,
                     warm_ops: list[int], cold_ops: list[int],
                     direct_ops: list[int] = ()) -> int:
        """Fold the streamed legs of one group: warm rows stack straight
        from host memory, cold rows read + re-verify from segments under
        the `tier.cold_read` stage, and `direct_ops` (never-seen overflow
        past the pool's admission budget) convert from the operand ints —
        then adopt into warm so the next fold serves them from a tier.
        `chunk_rows` slices fold through `mont_cuda.reduce_mul` on the
        plane's device, and the chunk partials combine exactly."""
        gid = stripe[0] or "-"
        rows: list[np.ndarray] = []
        for c in dict.fromkeys(direct_ops):
            if self.warm.contains(stripe, c):
                continue  # adopted by an earlier duplicate this fold
            row = np.asarray(bn.int_to_limbs(c % ctx.n, ctx.L),
                             dtype=np.uint32)
            self.warm.put(stripe, c, row)
            self.dir.set_tier(stripe, c, WARM)
        for c in direct_ops:
            row = self.warm.get(stripe, c)
            if row is None:  # raced out by a concurrent rebalance
                row = bn.int_to_limbs(c % ctx.n, ctx.L)
            rows.append(np.asarray(row, dtype=np.uint32))
        for c in warm_ops:
            row = self.warm.get(stripe, c)
            if row is None:  # raced away (demoted mid-plan): reconvert
                row = bn.int_to_limbs(c % ctx.n, ctx.L)
            rows.append(np.asarray(row, dtype=np.uint32))
        if cold_ops:
            t0 = time.perf_counter()
            try:
                cold_rows = self.cold.read_rows(stripe, cold_ops, ctx.L)
            except (KeyError, ValueError) as e:
                # compacted away / quarantined between plan and read: the
                # operand ints are in hand, convert directly
                log.debug("cold read fell back to conversion: %s", e)
                cold_rows = bn.ints_to_batch(
                    [c % ctx.n for c in cold_ops], ctx.L
                )
            rows.extend(np.asarray(r, dtype=np.uint32) for r in cold_rows)
            with self._lock:
                self._cold_reads += len(cold_ops)
            metrics.inc("dds_tier_cold_reads_total", len(cold_ops),
                        shard=gid,
                        help="fold operands streamed from the segment log")
            tracer.record(
                "tier.cold_read", (time.perf_counter() - t0) * 1e3,
                rows=len(cold_ops), shard=gid,
            )
        if not rows:
            return 1 % ctx.n
        chunk_partials: list[int] = []
        for i in range(0, len(rows), self.chunk_rows):
            stack = bn.to_device(np.stack(rows[i: i + self.chunk_rows]),
                                 self.plane.device)
            out = mont_cuda.reduce_mul(ctx, stack)
            chunk_partials.append(bn.limbs_to_int(bn.to_host(out)[0]))
        return (combine_partials(chunk_partials, ctx.n)
                if len(chunk_partials) > 1 else chunk_partials[0])

    # -------------------------------------------------------------- surface

    def pressure(self) -> float:
        """0..1 capacity signal for Helmsman's `pool_pressure` input: the
        fullest pool's hot occupancy, or the warm budget's fill when that
        is higher — either tier saturating means this group set is living
        past its memory and the autoscaler should reshape."""
        with self.plane._lock:
            pools = list(self.plane._pools.values())
        hot = max(
            (p.resident / p.max_rows for p in pools if p.max_rows), default=0.0
        )
        warm = (self.warm.bytes / self.warm.max_bytes
                if self.warm.max_bytes else 0.0)
        return round(min(1.0, max(hot, warm)), 4)

    def stats(self) -> dict:
        """The /health "storage" section."""
        with self.plane._lock:
            pools = list(self.plane._pools.values())
        hot_rows = sum(p.resident for p in pools)
        hot_bytes = sum(p.nbytes() for p in pools)
        with self._lock:
            hits = dict(self._hits)
            evictions = dict(self._evictions)
            cold_reads = self._cold_reads
            promotions = self._promotions
            demotions = self._demotions
        return {
            "tiers": {
                "hot": {"rows": hot_rows, "bytes": hot_bytes},
                "warm": self.warm.stats(),
                "cold": self.cold.stats(),
            },
            "directory": self.dir.counts(),
            "hits": hits,
            "evictions": evictions,
            "cold_reads": cold_reads,
            "promotions": promotions,
            "demotions": demotions,
            "pressure": self.pressure(),
        }

    def export_gauges(self, registry=metrics) -> None:
        """Scrape-time dds_tier_{rows,bytes}{tier,shard} gauges (the
        counters — hits/evictions/cold_reads — increment at event time)."""
        with self.plane._lock:
            pools = list(self.plane._pools.items())
        per_gid: dict[str, list] = {}
        for (gid, _tenant, _mod), pool in pools:
            agg = per_gid.setdefault(gid or "-", [0, 0])
            agg[0] += pool.resident
            agg[1] += pool.nbytes()
        for gid, (rows, nbytes) in per_gid.items():
            registry.set("dds_tier_rows", rows, tier="hot", shard=gid,
                         help="entries resident per storage tier")
            registry.set("dds_tier_bytes", nbytes, tier="hot", shard=gid,
                         help="bytes held per storage tier")
        warm_gid: dict[str, list] = {}
        for stripe, _c, nbytes in self.warm.items():
            agg = warm_gid.setdefault(stripe[0] or "-", [0, 0])
            agg[0] += 1
            agg[1] += nbytes
        for gid, (rows, nbytes) in warm_gid.items():
            registry.set("dds_tier_rows", rows, tier="warm", shard=gid,
                         help="entries resident per storage tier")
            registry.set("dds_tier_bytes", nbytes, tier="warm", shard=gid,
                         help="bytes held per storage tier")
        cold_rows_by_gid: dict[str, int] = {}
        for stripe, ciphers in self.cold.entries().items():
            gid = stripe[0] or "-"
            cold_rows_by_gid[gid] = cold_rows_by_gid.get(gid, 0) + len(ciphers)
        for gid, rows in cold_rows_by_gid.items():
            registry.set("dds_tier_rows", rows, tier="cold", shard=gid,
                         help="entries resident per storage tier")
        # segment files are shared across stripes: bytes report unsharded
        registry.set("dds_tier_bytes", self.cold.stats()["bytes"],
                     tier="cold", shard="-",
                     help="bytes held per storage tier")
