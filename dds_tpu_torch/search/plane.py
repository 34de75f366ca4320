"""Spyglass plane: per-group search indexes on the plane's device.

Port of `dds_tpu/search/plane.py`. The legacy `Search*`/`Order*` routes
answer every query with a full keyspace materialization (`_fetch_stored`)
followed by a host Python filter loop. The search plane keeps a per-group,
per-column index of the DET (equality) and OPE (order/range) column
families with their lanes on the plane's device, so a warm query costs ONE
batched tag-validation round plus one batch of predicate ops
(`ops/predicate`), never a keyspace re-read.

Freshness is the aggregate cache's linearizability argument verbatim
(`http/server._fetch_stored`): every index entry carries the ABD tag of a
COMPLETED quorum op (the proxy's own write, or a full `fetch_tagged`
re-read), so value@tag is known fully written. A query validates all
entries with one `read_tags` fingerprint round; an entry is served only
when the quorum-max tag EQUALS its indexed tag, which honest replies can
never deflate below a completed write. Stale or missing keys alone take
full ABD reads and are re-ingested, so indexed results are exactly what
the legacy scan would return. The forged-entry class (a Byzantine
coordinator planting value@true-tag) is bounded as for the aggregate
cache: by its per-round audits, whose flush also invalidates this plane
(the server couples `_flush_cache` to `invalidate()`).

Device masks over digest lanes are CANDIDATE filters (64-bit digests can
collide); every candidate is confirmed against the exact ciphertext string
on the host through `DetKey.compare` (constant-time), so a collision costs
a stray confirm, never a wrong result. Packed OPE compares and sorts are
exact: the packing is the identity on [0, 2^52). A column that is not
packable (a value out of [0, PACK_MAX]) and a threshold out of that band
take the reference's host branches (`_HOST_OPS`, the early returns): the
reference's semantics, not a fallback.

Device: `SearchPlane(device=...)` builds every group's packs there (int64
lane tensors, built once with the pack and dropped with it); a `cuda`
device without a card raises at construction. The proxy passes its
backend's device (`cuda`), or the CPU for a host backend (`cpu`), the
resident plane's rule.

Writes reach the index off the request path through the resident plane's
pattern: `note_write` queues (group, key, tag, value) bounded by
`max_pending`, the server's debounced drain applies them on a worker
thread. A dropped or still-queued update just means the next query's tag
round sees that key as stale and repairs it — never a wrong answer.
"""

from __future__ import annotations

import logging
import operator
import threading

import numpy as np
import torch

from dds_tpu_torch.models.det import DetKey
from dds_tpu_torch.ops import predicate
from dds_tpu_torch.utils.queues import TimedQueue

log = logging.getLogger("dds_torch.search")

_HOST_OPS = {
    "gt": operator.gt,
    "ge": operator.ge,
    "lt": operator.lt,
    "le": operator.le,
}


def _rows(mask: torch.Tensor) -> list[int]:
    """Row indices where a device mask is set, on the host."""
    return mask.nonzero().view(-1).tolist()


class GroupIndex:
    """One group's search index: key -> (tag, value) entries plus
    lazily-built per-(column, family) packs the predicate ops consume. Any
    entry mutation drops the packs (epoch invalidation, like the resident
    pool's reset); they rebuild on the next query."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._entries: dict[str, tuple] = {}  # key -> (tag, value|None)
        self._packs: dict = {}

    # ------------------------------------------------------------ mutation

    def upsert(self, key: str, tag, value) -> None:
        """Remember a completed op's (tag, value); newest tag wins, like
        the server's `_cache_put`. value None is a tombstone: it keeps
        the tag validatable while excluding the key from every pack."""
        if tag is None:
            return
        with self._lock:
            cur = self._entries.get(key)
            if cur is not None and not (cur[0] is None or cur[0] < tag):
                return
            self._entries[key] = (tag, value)
            self._packs.clear()

    def remove(self, key: str) -> None:
        with self._lock:
            if self._entries.pop(key, None) is not None:
                self._packs.clear()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._packs.clear()

    def tag(self, key: str):
        e = self._entries.get(key)
        return None if e is None else e[0]

    def __len__(self) -> int:
        return len(self._entries)

    def pack_count(self) -> int:
        return len(self._packs)

    # ---------------------------------------------------------- pack build

    def _pairs(self) -> list[tuple[str, list]]:
        """Live (key, value) rows in sorted-key order — the legacy scan's
        row order, which every tie-break below leans on."""
        return [
            (k, e[1]) for k, e in sorted(self._entries.items())
            if e[1] is not None
        ]

    def _ope_pack(self, pos: int) -> dict:
        pack = self._packs.get(("ope", pos))
        if pack is not None:
            return pack
        keys: list[str] = []
        vals: list[int] = []
        numeric = True
        for k, v in self._pairs():
            if pos < len(v):
                keys.append(k)
                try:
                    vals.append(int(v[pos]))
                except (TypeError, ValueError):
                    # the legacy scan's int() raises here too — the route
                    # answers 400 either way (eval re-raises per query)
                    numeric = False
                    break
        pack = {"keys": keys, "vals": vals, "numeric": numeric}
        if numeric and keys and all(predicate.packable(v) for v in vals):
            pack["hi"], pack["lo"] = predicate.pack_ints(vals, self.device)
        self._packs[("ope", pos)] = pack
        return pack

    def _det_pack(self, pos: int) -> dict:
        pack = self._packs.get(("det", pos))
        if pack is not None:
            return pack
        keys: list[str] = []
        svals: list[str] = []
        for k, v in self._pairs():
            if pos < len(v):
                keys.append(k)
                svals.append(str(v[pos]))
        pack = {"keys": keys, "svals": svals}
        if keys:
            pack["dhi"], pack["dlo"] = predicate.pack_digests(svals, self.device)
        self._packs[("det", pos)] = pack
        return pack

    def _entry_pack(self) -> dict:
        pack = self._packs.get(("entry",))
        if pack is not None:
            return pack
        keys: list[str] = []
        rows: list[list[str]] = []
        for k, v in self._pairs():
            keys.append(k)
            rows.append([str(e) for e in v])
        width = max((len(r) for r in rows), default=0)
        pack = {"keys": keys, "rows": rows, "width": width}
        if keys and width:
            dhi = np.zeros((len(keys), width), np.int64)
            dlo = np.zeros((len(keys), width), np.int64)
            valid = np.zeros((len(keys), width), bool)
            for i, r in enumerate(rows):
                for j, s in enumerate(r):
                    dhi[i, j], dlo[i, j] = predicate.digest_lanes(s)
                    valid[i, j] = True
            pack["dhi"], pack["dlo"], pack["valid"] = (
                torch.from_numpy(a).to(self.device) for a in (dhi, dlo, valid)
            )
        self._packs[("entry",)] = pack
        return pack

    # ------------------------------------------------------------- queries

    def eval_compare(self, pos: int, op: str, item: int) -> set[str]:
        """Keys whose position-`pos` int satisfies `op item` (op in
        gt/ge/lt/le)."""
        with self._lock:
            pack = self._ope_pack(pos)
            if not pack["numeric"]:
                raise ValueError(f"non-integer value at position {pos}")
            keys, vals = pack["keys"], pack["vals"]
            if not keys:
                return set()
            if "hi" in pack:
                # packed column is exact on [0, PACK_MAX]; out-of-band
                # thresholds resolve without a dispatch
                if item < 0:
                    return set(keys) if op in ("gt", "ge") else set()
                if item > predicate.PACK_MAX:
                    return set(keys) if op in ("lt", "le") else set()
                mask = predicate.compare_mask(pack["hi"], pack["lo"], op, item,
                                              device=self.device)
                return {keys[i] for i in _rows(mask)}
            opfn = _HOST_OPS[op]
            return {k for k, v in zip(keys, vals) if opfn(v, item)}

    def eval_range(self, pos: int, lo_bound: int, hi_bound: int) -> set[str]:
        """Keys with lo_bound <= value[pos] <= hi_bound."""
        with self._lock:
            pack = self._ope_pack(pos)
            if not pack["numeric"]:
                raise ValueError(f"non-integer value at position {pos}")
            keys, vals = pack["keys"], pack["vals"]
            if not keys or lo_bound > hi_bound:
                return set()
            if "hi" in pack:
                lo_c = max(lo_bound, 0)
                hi_c = min(hi_bound, predicate.PACK_MAX)
                if lo_c > hi_c:
                    return set()
                mask = predicate.range_mask(pack["hi"], pack["lo"], lo_c, hi_c,
                                            device=self.device)
                return {keys[i] for i in _rows(mask)}
            return {k for k, v in zip(keys, vals) if lo_bound <= v <= hi_bound}

    def eval_order(self, pos: int, descending: bool) -> list[tuple[int, str]]:
        """This group's sorted run: (comparable, key) tuples ascending by
        (comparable, key) — comparable is the value (or its negation for
        descending order), so `heapq.merge` across groups reproduces the
        global stable sort, ties in ascending key order. Records without
        the column are excluded (the Search* convention)."""
        with self._lock:
            pack = self._ope_pack(pos)
            if not pack["numeric"]:
                raise ValueError(f"non-integer value at position {pos}")
            keys, vals = pack["keys"], pack["vals"]
            if not keys:
                return []
            if "hi" in pack:
                order = predicate.sort_perm(pack["hi"], pack["lo"], descending,
                                            device=self.device).tolist()
            else:
                order = sorted(range(len(keys)), key=vals.__getitem__,
                               reverse=descending)
            sign = -1 if descending else 1
            return [(sign * vals[i], keys[i]) for i in order]

    def eval_eq(self, pos: int, item: str, want_eq: bool) -> set[str]:
        """DET equality/inequality over position `pos`: device digest
        candidates, confirmed on the host (collision-proof)."""
        with self._lock:
            pack = self._det_pack(pos)
            keys, svals = pack["keys"], pack["svals"]
            if not keys:
                return set()
            mask = predicate.eq_mask(pack["dhi"], pack["dlo"], item,
                                     device=self.device)
            matched = {
                keys[i] for i in _rows(mask)
                if DetKey.compare(svals[i], item)
            }
            return matched if want_eq else set(keys) - matched

    def eval_entry(self, queries: list[str], mode: str) -> set[str]:
        """Element-membership search over whole records: mode "any" keeps
        rows where any element matches any query (SearchEntry/EntryOR),
        "all" keeps rows where every query matches some element
        (SearchEntryAND). Device candidates, confirmed on the host."""
        with self._lock:
            pack = self._entry_pack()
            keys, rows = pack["keys"], pack["rows"]
            if not keys or not pack["width"] or not queries:
                return set()
            mask = predicate.entry_mask(pack["dhi"], pack["dlo"], pack["valid"],
                                        queries, mode, device=self.device)
            out = set()
            for i in _rows(mask):
                row = rows[i]
                if mode == "all":
                    ok = all(any(DetKey.compare(e, q) for e in row)
                             for q in queries)
                else:
                    ok = any(DetKey.compare(e, q)
                             for q in queries for e in row)
                if ok:
                    out.add(keys[i])
            return out


class SearchPlane:
    """All groups' indexes plus the bounded write-ingest queue (the
    resident plane's `note_write` pattern: queue on the request path,
    drain debounced on a worker thread). Dropped or still-queued updates
    are SAFE — the query-time tag round classifies those keys stale and
    repairs them through full quorum reads."""

    def __init__(self, max_pending: int = 8192, device="cpu"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SearchPlane: no CUDA device available (pass device='cpu' "
                "to build the plane on the host)"
            )
        self._lock = threading.Lock()
        # (gid, tenant) -> index: the tenant id is part of the index
        # address, so one tenant's writes/invalidation churn cannot thrash
        # another's packs; tenant "" is the single-tenant stripe
        self._groups: dict[tuple[str, str], GroupIndex] = {}
        # queued (gid, tenant, key, tag, value) updates; enqueue-
        # timestamped so the drain attributes ingest-queue-wait, full-
        # queue drops are reason-labelled (the key reads stale and
        # repairs at next query)
        self._pending = TimedQueue("spyglass-ingest", maxlen=max_pending)
        self.max_pending = max_pending
        self._ingested = 0
        self._invalidations = 0
        # optional (keys, tenant) -> None popularity sink: Stratum wires
        # `touch_keys` here so every selection's hit set warms those
        # rows' fold ciphertexts in the tier directory (pure dict math,
        # loop-safe)
        self.touch_sink = None

    def group(self, gid: str, tenant: str = "") -> GroupIndex:
        with self._lock:
            g = self._groups.get((gid, tenant))
            if g is None:
                g = self._groups[(gid, tenant)] = GroupIndex(self.device)
            return g

    def register_groups(self, gids) -> None:
        for gid in gids:
            self.group(gid)

    def note_selected(self, keys, tenant: str = "") -> None:
        """Report a query's selected keys to the tiered-storage
        popularity feed, when one is wired. Best-effort: a sink failure
        must never fail the query that fed it."""
        sink = self.touch_sink
        if sink is None or not keys:
            return
        try:
            sink(keys, tenant)
        except Exception:  # popularity is advisory, queries are not
            log.debug("search touch sink failed", exc_info=True)

    def group_ids(self) -> list[str]:
        return sorted({gid for gid, _t in self._groups})

    # ------------------------------------------------------- write ingest

    def note_write(self, gid: str, key: str, tag, value,
                   tenant: str = "") -> bool:
        """Queue one committed write for ingest; False = queue full (the
        key will read as stale and be repaired at the next query)."""
        return self._pending.offer((gid, tenant, key, tag, value))

    def pending_ingest(self) -> int:
        return self._pending.depth()

    def ingest_pending(self) -> int:
        batch = self._pending.drain()
        for gid, tenant, key, tag, value in batch:
            self.group(gid, tenant).upsert(key, tag, value)
        with self._lock:
            self._ingested += len(batch)
        return len(batch)

    # ---------------------------------------------------- direct mutation

    def upsert(self, gid: str, key: str, tag, value,
               tenant: str = "") -> None:
        self.group(gid, tenant).upsert(key, tag, value)

    def tag(self, gid: str, key: str, tenant: str = ""):
        g = self._groups.get((gid, tenant))
        return None if g is None else g.tag(key)

    def remove(self, gid: str, key: str, tenant: str = "") -> None:
        g = self._groups.get((gid, tenant))
        if g is not None:
            g.remove(key)

    def evict_tenant(self, tenant: str) -> int:
        """Drop every index in `tenant`'s stripe (crypto-shred data
        lifecycle: undecryptable entries are noise). Returns indexes
        dropped."""
        with self._lock:
            victims = [k for k in self._groups if k[1] == tenant]
            for k in victims:
                self._groups.pop(k, None)
        return len(victims)

    def invalidate(self) -> None:
        """Drop every entry and queued update (the `_flush_cache`
        coupling: an aggregate-cache audit mismatch means some completed-
        op provenance is in doubt — rebuild from quorum reads)."""
        with self._lock:
            groups = list(self._groups.values())
            self._invalidations += 1
        self._pending.clear(reason="invalidated")
        for g in groups:
            g.clear()

    # ------------------------------------------------------ observability

    def stats(self) -> dict:
        with self._lock:
            groups = dict(self._groups)
        return {
            "groups": {
                (f"{gid or '-'}|{tenant}" if tenant else gid or "-"):
                    {"keys": len(g), "packs": g.pack_count()}
                for (gid, tenant), g in groups.items()
            },
            "indexed_keys": sum(len(g) for g in groups.values()),
            "pending_ingest": self._pending.depth(),
            "ingested": self._ingested,
            "dropped": self._pending.dropped("full"),
            "invalidations": self._invalidations,
        }

    def export_gauges(self, registry) -> None:
        """Scrape-time `dds_search_*` gauges (per-group series labelled
        shard=gid, '-' for the unsharded group), plus the ingest queue's
        dds_queue_* family."""
        self._pending.export_gauges(registry)
        st = self.stats()
        with self._lock:
            groups = dict(self._groups)
        per_shard: dict[str, list] = {}
        per_tenant: dict[str, list] = {}
        for (gid, tenant), g in groups.items():
            agg = per_shard.setdefault(gid or "-", [0, 0])
            agg[0] += len(g)
            agg[1] += g.pack_count()
            if tenant:
                tag = per_tenant.setdefault(tenant, [0, 0])
                tag[0] += len(g)
                tag[1] += g.pack_count()
        for gid, (keys, packs) in per_shard.items():
            registry.set("dds_search_index_keys", keys, shard=gid,
                         help="Spyglass indexed keys per shard group")
            registry.set("dds_search_index_packs", packs, shard=gid,
                         help="Spyglass built column packs per shard group")
        for tenant, (keys, packs) in per_tenant.items():
            registry.set("dds_tenant_search_keys", keys, tenant=tenant,
                         help="Spyglass indexed keys per tenant stripe")
            registry.set("dds_tenant_search_packs", packs, tenant=tenant,
                         help="Spyglass column packs per tenant stripe")
        registry.set("dds_search_pending_ingest", st["pending_ingest"],
                     help="Spyglass write-ingest queue depth")
        registry.set("dds_search_ingest_dropped", st["dropped"],
                     help="Spyglass ingest queue overflows "
                          "(keys repaired at next query)")
        registry.set("dds_search_invalidations", st["invalidations"],
                     help="Spyglass whole-plane invalidations")
