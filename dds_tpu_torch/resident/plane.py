"""The resident plane: per-group pools and the fused multi-group fold.

Port of `dds_tpu/resident/plane.py`. `ResidentPlane` owns one
`ResidentPool` per (shard group, tenant, modulus) and turns an aggregate
whose operands are partitioned by owning group into one segmented halving
tree on the device: every group's rows gather from its pool, every group
folds at once, and the group partials merge through the same tree's tail
levels — one `mont_cuda.mul` launch a level for all groups, where S
separate folds would launch S trees and combine on the host.

Layout (`fold_groups`), as `ops/foldmany.fold_many`: one limbs-major
(L, P2 * Sp) int32 tensor filled with the Montgomery identity R mod n;
Sp is the group count padded to a power of two and P2 the largest
group's operand count padded to a power of two. Column `elem * Sp + g`
holds group g's element `elem`, written transposed from the rows
`pool.rows_for` gathered. Levels:
- log2(P2) local levels: x[:, :h Sp] * x[:, h Sp : 2h Sp], every group
  at once (elem i with elem i + h);
- log2(Sp) tail levels over the (L, Sp) partials;
- one multiply by R^total mod n, total the real operand count of all
  groups.
So a K = 8,192 fold over S = 4 groups of 2,048 is 11 + 2 + 1 = 14
launches in mode 0. The product family (`DDS_KARATSUBA`) is read once a
fold and passed to every level, so a fold never mixes families.

R-power accounting (structure-independent, the reference's argument): K
real operands plus any number of identity pads through any tree shape
yield prod * R^-(K-1); the final multiply by R^K mod n gives prod mod n,
bit for bit the reference's integer.

Placement: one card, so every group's pool lives on the plane's device
(`parallel/mesh.group_sharding`). The reference's multi-device branch
(`shard_map` over a mesh, one all_gather of the partials) comes with the
mesh plane.

The write-path ingest queue (`note_write` / `ingest_pending`) lets the
proxy push committed ciphertexts into existing pools off the request's
critical path, so a warm fleet's first post-write aggregate pays no
ingest. Content addressing makes this safe: an ingested row is keyed by
its value, so a racing aggregate either finds the row (identical bytes)
or ingests it itself.
"""

from __future__ import annotations

import threading
import time

import torch

from dds_tpu_torch.obs import kprof
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import flags, mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx
from dds_tpu_torch.parallel.mesh import group_sharding
from dds_tpu_torch.resident.pool import ResidentPool
from dds_tpu_torch.utils.queues import TimedQueue


def fused_fold_launches(sizes: list[int]) -> int:
    """Multiplies of one fused fold over groups of `sizes` operands (each
    >= 1): log2(P2) local levels + log2(Sp) tail levels + the fix. Each is
    one mont_mul launch in mode 0."""
    P2 = 1 << max(0, (max(sizes) - 1).bit_length())
    Sp = 1 << max(0, (len(sizes) - 1).bit_length())
    return P2.bit_length() - 1 + Sp.bit_length() - 1 + 1


def fused_fold(ctx: ModCtx, slabs: list[torch.Tensor], mode) -> torch.Tensor:
    """prod over every row of every (K_g, L) slab mod n as a (1, L) int32
    tensor, in one segmented halving tree (module docstring). The slabs
    share one device; `mode` is the product family for every level."""
    device = slabs[0].device
    L = ctx.L
    S = len(slabs)
    Sp = 1 << max(0, (S - 1).bit_length())
    P2 = 1 << max(0, (max(s.shape[0] for s in slabs) - 1).bit_length())
    x = torch.empty((L, P2 * Sp), dtype=torch.int32, device=device)
    x[:] = ctx.consts(device)["one_mont"][:, None]
    cols = x.view(L, P2, Sp)
    for g, rows in enumerate(slabs):
        cols[:, : rows.shape[0], g] = rows.T
    w = P2 * Sp
    while w > 1:  # local levels, then the tail over the group partials
        h = w // 2
        x = mont_cuda.mul(ctx, x[:, :h], x[:, h: 2 * h], mode)
        w = h
    total = sum(s.shape[0] for s in slabs)
    return mont_cuda.mul(ctx, x, ctx.fold_fix(total, device), mode).T


class ResidentPlane:
    """Per-group resident pools on `device` + the fused multi-group fold.

    `reduce_factory(modulus)` optionally supplies the per-pool single-fold
    reduce (backends inject theirs, so lone-group folds run the kernels of
    the flat path). `max_pending` bounds the write-ingest queue."""

    def __init__(self, device="cuda", initial_rows: int = 256,
                 max_rows: int = 1 << 20, reduce_factory=None,
                 max_pending: int = 8192):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            # at construction, like SearchPlane: a plane meant for the card
            # never quietly comes up on the host
            raise RuntimeError("ResidentPlane: no CUDA device available (pass "
                               "device='cpu' to build the plane on the host)")
        self.initial_rows = int(initial_rows)
        self.max_rows = int(max_rows)
        self.max_pending = int(max_pending)
        self._reduce_factory = reduce_factory
        self._lock = threading.Lock()
        # (gid, tenant, modulus) -> pool: the tenant id is in the pool
        # address, so one tenant overflowing its pool can never reset
        # another tenant's rows; tenant "" is the single-tenant stripe
        self._pools: dict[tuple[str, str, int], ResidentPool] = {}
        self._order: dict[str, int] = {}  # gid -> placement index
        # Stratum (storage/): when attached, every pool wires its
        # spill/evict_rank to the tier hierarchy at creation — capacity
        # overflow then demotes to the warm tier instead of resetting
        self.tier_sink = None
        # queued (gid, tenant, cipher) write ingests, enqueue-timestamped,
        # drops reason-labelled
        self._pending = TimedQueue("lodestone-ingest", maxlen=self.max_pending)

    @property
    def kernel(self) -> str:
        """The product family folds run on now: "cios", "k1" or "fused"
        (DDS_KARATSUBA, read at every fold)."""
        return flags.karatsuba_mode() or "cios"

    # ------------------------------------------------------------- topology

    def register_groups(self, gids) -> None:
        """Pin the group -> placement order up front (first-use
        registration works too; explicit registration keeps placement
        deterministic across proxy restarts)."""
        with self._lock:
            for gid in gids:
                self._order.setdefault(gid, len(self._order))

    def pool(self, gid: str, modulus: int, tenant: str = "") -> ResidentPool:
        with self._lock:
            idx = self._order.setdefault(gid, len(self._order))
            key = (gid, tenant, modulus)
            p = self._pools.get(key)
            if p is None:
                p = self._pools[key] = ResidentPool(
                    modulus,
                    reduce=(
                        self._reduce_factory(modulus)
                        if self._reduce_factory is not None else None
                    ),
                    initial_rows=self.initial_rows,
                    max_rows=self.max_rows,
                    device=group_sharding(self.device, idx),
                    gid=(f"{gid}|{tenant}" if tenant else gid),
                )
                if self.tier_sink is not None:
                    self.tier_sink.wire_pool(key, p)
            return p

    # ----------------------------------------------------- write-path ingest

    def note_write(self, gid: str, ciphers: list[int],
                   tenant: str = "") -> int:
        """Queue a committed write's ciphertext columns for ingest into
        this group's existing pools for this tenant stripe (every modulus
        a past aggregate has established). Returns how many were queued.
        With no pool for the (group, tenant) yet there is nothing to
        convert against: the entries count as reason="no_pool" drops and
        the first aggregate ingests as before. A full queue rejects with
        reason="full"; a dropped entry re-ingests lazily at the next fold."""
        if not ciphers:
            return 0
        with self._lock:
            has_pool = any(
                g == gid and t == tenant for g, t, _ in self._pools
            )
        if not has_pool:
            self._pending.drop(len(ciphers), reason="no_pool")
            return 0
        return self._pending.offer_many((gid, tenant, c) for c in ciphers)

    def pending_ingest(self) -> int:
        return self._pending.depth()

    def ingest_pending(self) -> int:
        """Drain the write-ingest queue into the matching pools (run on a
        worker thread). Returns rows newly ingested across all pools."""
        batch = self._pending.drain()
        if not batch:
            return 0
        with self._lock:
            pools = list(self._pools.items())
        by_stripe: dict[tuple[str, str], list[int]] = {}
        for gid, tenant, cipher in batch:
            by_stripe.setdefault((gid, tenant), []).append(cipher)
        grew = 0
        for (gid, tenant), ciphers in by_stripe.items():
            for (g, t, _mod), pool in pools:
                if g == gid and t == tenant:
                    grew += pool.ingest(ciphers)
        return grew

    # ------------------------------------------------------------ evaluation

    def fold_groups(
        self, parts: list[tuple[str, list[int]]], modulus: int,
        tenant: str = "",
    ) -> int | None:
        """prod over every group's operands mod `modulus` in one fused
        halving tree, or None when any group's operand set cannot fit its
        pool even after a reset (callers fall back to the marshaling
        paths)."""
        parts = [(gid, ops) for gid, ops in parts if ops]
        if not parts:
            return 1 % modulus
        ctx = ModCtx.make(modulus)
        mode = flags.karatsuba_mode()  # one family for the whole fold
        slabs = []
        for gid, ops in parts:
            rows = self.pool(gid, modulus, tenant).rows_for(ops)
            if rows is None:
                return None
            slabs.append(rows)
        out = kprof.profiled(
            "resident_fold", lambda: fused_fold(ctx, slabs, mode),
            k=sum(len(ops) for _, ops in parts), shards=len(parts),
        )
        return bn.limbs_to_int(bn.to_host(out)[0])

    def rows_for(self, gid: str, modulus: int, cs: list[int],
                 tenant: str = ""):
        """Gathered device rows (K, L) for `cs` from this group's pool, or
        None when the set is wider than the pool (callers marshal host
        ints as before)."""
        if not cs:
            return None
        return self.pool(gid, modulus, tenant).rows_for(cs)

    # --------------------------------------------------------------- surface

    def stats(self) -> dict:
        """Per-pool view (the reference serves it under GET /health)."""
        with self._lock:
            pools = dict(self._pools)
        resets = sum(p.resets for p in pools.values())
        last_ts = max(
            (p._last_reset_ts for p in pools.values()
             if p._last_reset_ts is not None),
            default=None,
        )
        return {
            "kernel": self.kernel,
            "mesh_devices": 1,
            "pending_ingest": self._pending.depth(),
            "dropped_pending": self._pending.dropped(),
            "resets": resets,
            "last_reset_age_s": (
                round(time.time() - last_ts, 1) if last_ts is not None
                else None
            ),
            "tiered": self.tier_sink is not None,
            "pools": [
                {"shard": gid or "-", "tenant": tenant or "-",
                 "modulus_bits": mod.bit_length(), **pool.stats()}
                for (gid, tenant, mod), pool in sorted(
                    pools.items(), key=lambda kv: kv[0]
                )
            ],
        }

    def evict_tenant(self, tenant: str) -> int:
        """Drop every pool in `tenant`'s stripe (the data-lifecycle half
        of a crypto-shred: the keys are gone, so the resident rows are
        noise — free the device memory). Returns pools dropped."""
        with self._lock:
            victims = [k for k in self._pools if k[1] == tenant]
            for k in victims:
                self._pools.pop(k, None)
        if victims:
            metrics.inc("dds_tenant_pool_evictions_total",
                        n=len(victims),
                        help="resident pools dropped by tenant eviction "
                             "(crypto-shred data lifecycle)")
        return len(victims)

    def export_gauges(self, registry=metrics) -> None:
        """Scrape-time gauges: dds_resident_{rows,bytes,hit_ratio,resets}
        aggregated per shard label (pools for several moduli sum; the hit
        ratio weights by operands served), per-tenant stripes, and the
        write-ingest queue's dds_queue_* family."""
        self._pending.export_gauges(registry)
        with self._lock:
            pools = list(self._pools.items())
        per_gid: dict[str, list] = {}
        per_tenant: dict[str, list] = {}
        for (gid, tenant, _mod), pool in pools:
            agg = per_gid.setdefault(gid or "-", [0, 0, 0, [0, 0, 0]])
            agg[0] += pool.resident
            agg[1] += pool.nbytes()
            agg[2] += pool.resets
            for i in range(3):
                agg[3][i] += pool._served[i]
            if tenant:
                tag = per_tenant.setdefault(tenant, [0, 0, 0])
                tag[0] += pool.resident
                tag[1] += pool.nbytes()
                tag[2] += pool.resets
        for tenant, (rows, nbytes, resets) in per_tenant.items():
            registry.set("dds_tenant_resident_rows", rows, tenant=tenant,
                         help="ciphertext rows resident per tenant stripe")
            registry.set("dds_tenant_resident_bytes", nbytes, tenant=tenant,
                         help="device bytes pinned per tenant stripe")
            registry.set("dds_tenant_resident_resets", resets, tenant=tenant,
                         help="pool capacity resets per tenant stripe (one "
                              "tenant's overflow cannot reset another's)")
        for gid, (rows, nbytes, resets, served) in per_gid.items():
            registry.set("dds_resident_rows", rows, shard=gid,
                         help="ciphertext rows resident per shard group")
            registry.set("dds_resident_bytes", nbytes, shard=gid,
                         help="device bytes pinned by resident pools per "
                              "shard group")
            registry.set("dds_resident_resets", resets, shard=gid,
                         help="cumulative resident-pool capacity resets "
                              "per shard group")
            total = sum(served)
            if total:
                registry.set(
                    "dds_resident_hit_ratio", round(served[0] / total, 4),
                    shard=gid,
                    help="fraction of fold operands served from resident "
                         "rows per shard group",
                )
