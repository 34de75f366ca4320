"""Resident pools: device-pinned, content-addressed ciphertext limb rows.

Port of `dds_tpu/resident/pool.py`. A `ResidentPool` is the `(rows, L)`
int32 limb buffer one shard group keeps in device memory for one modulus.
Each distinct ciphertext value is ingested once (int -> 16-bit limbs ->
device row); every later aggregate gathers resident rows on the device
instead of re-marshaling host ints. Content addressing keeps the
dependability story intact: the proxy still runs full quorum validation
per aggregate, the pool only memoizes the conversion and transfer of
bytes the device has already seen, so a stale row cannot exist by
construction.

Capacity doubles up to `max_rows`. Past that the behaviour depends on
whether a tier sink is wired (`spill`, set by Stratum, `storage/`): with
one, the pool EVICTS its coldest rows (order from `evict_rank`, the tier
directory's decayed popularity; at least a quarter of the rows a wave,
never the operands being ensured) to the warm tier as host numpy uint32
rows and keeps serving the fused fast path for the rows that stay.
Without a sink the pool resets (entries re-ingest on demand, `epoch`
bumps, every row-index memo invalidates, `resets` counts it) and files a
`resident_reset` flight incident (`obs/flight.py`, when `[obs]
flight-dir` is set).

Concurrency: folds run on proxy worker threads. The reference could gather
from a buffer snapshot outside its lock because JAX arrays are immutable;
a torch buffer is written in place, so here the gather (`index_select`)
is enqueued while the lock is held. Stream order then puts it before any
later write to the buffer. Growth, resets and eviction waves swap in a
fresh buffer and never write the old one; an eviction builds it from one
device-to-host copy of the old buffer. Evicted rows go to the sink after
the lock is released (the sink may write to disk).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dds_tpu_torch.obs import context as obs_context
from dds_tpu_torch.obs import kprof
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.resident")


@dataclass
class ResidentPool:
    """Resident (rows, L) int32 limb buffer for one (group, modulus) on
    `device`.

    `reduce` is the device-level fold callable ((K, L) tensor -> (1, L));
    backends inject theirs (CudaBackend.reduce_mul_device) so kernel
    dispatch lives in one place. Default: `ops/mont_cuda.reduce_mul` (the
    kernel on a CUDA pool, its plain PyTorch version on a CPU pool). `gid`
    labels this pool's metric series (`shard=` label); empty = the
    unsharded single store. `spill` receives the evicted [(cipher, (L,)
    uint32 host row)] batch when capacity overflows; `evict_rank` orders
    candidate ciphers coldest-first. Both None = reset on overflow."""

    modulus: int
    reduce: object = None
    initial_rows: int = 256
    max_rows: int = 1 << 20  # 1 GiB of device memory at L=256
    device: object = "cuda"
    gid: str = ""
    spill: object = None
    evict_rank: object = None
    _ctx: ModCtx = field(init=False, repr=False)
    _buf: torch.Tensor = field(init=False, repr=False)
    _index: dict[int, int] = field(init=False, repr=False)
    _count: int = field(init=False, default=0, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._ctx = ModCtx.make(self.modulus)
        if self.reduce is None:
            ctx = self._ctx
            self.reduce = lambda rows: mont_cuda.reduce_mul(ctx, rows)
        self._buf = self._zeros(self.initial_rows)
        self._index = {}
        # (cs-list identity, epoch, device index tensor): aggregates pass
        # the same operand list object while the proxy's caches validate
        # unchanged, so the O(K) big-int lookups run once per distinct
        # list. The strong ref keeps the keyed list alive (identity stays
        # unique); epoch invalidates across resets and eviction waves.
        self._idx_memo: tuple | None = None
        self._epoch = 0
        self._resets = 0
        self._last_reset_ts: float | None = None
        # rows evicted under the lock, delivered to `spill` after release
        self._spill_out: list[list] = []
        self._served = [0, 0, 0]  # operands: resident / ingested / direct
        self._lock = threading.Lock()

    def _zeros(self, rows: int) -> torch.Tensor:
        return torch.zeros((rows, self._ctx.L), dtype=torch.int32, device=self.device)

    # -------------------------------------------------------------- surface

    @property
    def resident(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return int(self._buf.shape[0])

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def resets(self) -> int:
        return self._resets

    def nbytes(self) -> int:
        """Device bytes this pool's buffer occupies (rows x L x 4)."""
        return self.capacity * self._ctx.L * 4

    def hit_ratio(self) -> float | None:
        """Fraction of fold operands served from resident rows (None
        until the pool has served any)."""
        total = sum(self._served)
        return (self._served[0] / total) if total else None

    def stats(self) -> dict:
        ratio = self.hit_ratio()
        return {
            "rows": self._count,
            "capacity": self.capacity,
            "bytes": self.nbytes(),
            "epoch": self._epoch,
            "resets": self._resets,
            "last_reset_age_s": (
                round(time.time() - self._last_reset_ts, 1)
                if self._last_reset_ts is not None else None
            ),
            "hit_ratio": round(ratio, 4) if ratio is not None else None,
        }

    # --------------------------------------------------------------- ingest

    def _grow(self, need: int, protect=()) -> None:
        cap = self.capacity
        while cap < need:
            cap *= 2
        if cap > self.max_rows:
            if self.spill is not None:
                # eviction to the warm tier instead of a reset: the counter
                # stays frozen and the fused path degrades gradually
                self._evict(need, protect)
                return
            log.warning("resident pool %s over max_rows (%d > %d): resetting",
                        self.gid or "-", need, self.max_rows)
            self._index.clear()
            self._count = 0
            self._epoch += 1  # row indices changed: invalidate idx memos
            self._resets += 1
            self._last_reset_ts = time.time()
            metrics.inc(
                "dds_resident_resets_total", shard=self.gid or "-",
                help="resident-pool capacity resets (entries re-ingest "
                     "on demand)",
            )
            self._file_reset_incident(need)
            cap = max(self.initial_rows, min(cap, self.max_rows))
            self._buf = self._zeros(cap)
            return
        buf = self._zeros(cap)
        buf[: self.capacity] = self._buf
        self._buf = buf

    def _file_reset_incident(self, need: int) -> None:
        """A capacity reset drops the fused fast path until the working
        set re-ingests: incident-worthy, not just a log line. Pool calls
        run on worker threads (a synchronous write is fine there); an
        on-loop caller dispatches the write as a supervised task."""
        import asyncio

        from dds_tpu_torch.obs.flight import flight

        if not flight.enabled:
            return
        info = {
            "shard": self.gid or "-", "need": need,
            "max_rows": self.max_rows, "resets": self._resets,
        }
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            try:
                flight.record("resident_reset", **info)
            except Exception:  # noqa: BLE001 - telemetry never breaks ingest
                log.exception("resident_reset incident write failed")
            return
        from dds_tpu_torch.utils.tasks import supervised_task

        supervised_task(
            flight.record_async("resident_reset", **info),
            name="resident.reset_incident",
        )

    def _evict(self, need: int, protect=()) -> None:
        """Demote the coldest rows to the tier sink so `need` total rows
        fit under `max_rows` (caller holds `_lock`). `protect` (the
        operand set being ensured) is never evicted; |distinct protect| <=
        max_rows always fits because every other row is evictable. The
        compacted buffer is built on the host from one device-to-host copy
        and placed as a fresh tensor; the spilled batch is queued and
        delivered outside the lock."""
        protect = set(protect)
        if len(protect) > self.max_rows:
            return  # aggregate wider than the pool: ensure() answers None
        incoming = need - self._count
        if incoming > self.max_rows:
            return
        evictable = [c for c in self._index if c not in protect]
        # at least a quarter per wave: hysteresis against per-row thrash
        evict_n = max(need - self.max_rows, (self._count + 3) // 4)
        evict_n = min(evict_n, len(evictable))
        if evict_n <= 0:
            return
        if self.evict_rank is not None:
            try:
                ranked = [c for c in self.evict_rank(evictable)
                          if c in self._index and c not in protect]
            except Exception:  # noqa: BLE001 — a sink bug must not lose rows
                log.exception("evict_rank failed; falling back to FIFO")
                ranked = evictable
        else:
            ranked = evictable
        victims = list(dict.fromkeys(ranked))[:evict_n]
        if len(victims) < evict_n:
            seen = set(victims)
            for c in evictable:
                if c not in seen:
                    victims.append(c)
                    if len(victims) >= evict_n:
                        break
        vset = set(victims)
        host = bn.to_host(self._buf[: self._count])  # one D2H copy
        spilled = [(c, host[self._index[c]].copy()) for c in victims]
        survivors = [c for c in self._index if c not in vset]
        cap = self.capacity
        while cap < len(survivors) + incoming and cap < self.max_rows:
            cap *= 2
        cap = min(max(cap, self.initial_rows), self.max_rows)
        newbuf = np.zeros((cap, self._ctx.L), np.uint32)
        if survivors:
            newbuf[: len(survivors)] = host[[self._index[c] for c in survivors]]
        self._buf = bn.to_device(newbuf, self.device)
        self._index = {c: i for i, c in enumerate(survivors)}
        self._count = len(survivors)
        self._epoch += 1  # row indices changed: invalidate idx memos
        self._spill_out.append(spilled)
        metrics.inc(
            "dds_resident_evictions_total", len(victims),
            shard=self.gid or "-",
            help="rows evicted from resident pools to the warm tier "
                 "(Stratum; replaces capacity resets)",
        )
        log.info("resident pool %s evicted %d cold rows to the warm tier "
                 "(%d stay resident)", self.gid or "-", len(victims), len(survivors))

    def _flush_spill(self) -> None:
        """Deliver queued evictions to the tier sink outside `_lock`."""
        sink = self.spill
        while True:
            with self._lock:
                if not self._spill_out:
                    return
                batch = self._spill_out.pop(0)
            if sink is None:
                continue
            try:
                sink(batch)
            except Exception:  # noqa: BLE001 — sink bugs must not break folds
                log.exception("tier spill sink failed (%d rows dropped "
                              "back to lazy re-ingest)", len(batch))

    def membership(self, cs: list[int]) -> list[bool]:
        """Per-operand hot-tier residency, one lock round — the Stratum
        planner's split primitive."""
        with self._lock:
            return [c in self._index for c in cs]

    def ensure(self, cs: list[int], pre: dict | None = None) -> np.ndarray | None:
        """Ingest any unseen ciphertexts; return row indices for all of cs.
        Caller holds `_lock`. `pre` maps ciphertext -> limb row converted
        outside the lock. None when the distinct operands cannot fit even
        after a reset or an eviction wave (callers fold directly)."""
        missing = sorted({c for c in cs if c not in self._index})
        if missing:
            if self._count + len(missing) > self.capacity:
                self._grow(self._count + len(missing), protect=cs)
                missing = sorted({c for c in cs if c not in self._index})
            if self._count + len(missing) > self.capacity:
                return None  # wider than max_rows even when empty
            if pre is not None and all(c in pre for c in missing):
                rows = np.stack([pre[c] for c in missing])
            else:
                rows = bn.ints_to_batch(
                    [c % self.modulus for c in missing], self._ctx.L
                )
            start = self._count
            self._buf[start: start + len(missing)] = bn.to_device(rows, self.device)
            for i, c in enumerate(missing):
                self._index[c] = start + i
            self._count += len(missing)
        return np.asarray([self._index[c] for c in cs], dtype=np.int64)

    def ingest(self, cs: list[int], rows: np.ndarray | None = None) -> int:
        """Ingest ciphertexts eagerly (the write-path entry point): limb
        conversion outside the lock, placement under it. `rows` optionally
        supplies the (len(cs), L) uint32 limb rows already converted
        (rows[i] holds cs[i] mod the modulus). Returns how many new rows
        landed; operand sets wider than the pool are skipped (they only
        ever fold directly)."""
        if rows is not None:
            pre = {c: rows[i] for i, c in enumerate(cs)}
        else:
            distinct = list(dict.fromkeys(cs))
            missing = [c for c in distinct if c not in self._index]
            if not missing:
                return 0
            converted = bn.ints_to_batch(
                [c % self.modulus for c in missing], self._ctx.L
            )
            pre = {c: converted[i] for i, c in enumerate(missing)}
        t_h2d = time.perf_counter()
        with self._lock:
            missing_now = [c for c in pre if c not in self._index]
            self.ensure(list(pre), pre)
            # count placements, not the buffer delta: an eviction wave in
            # the same ensure() can shrink _count while rows still land
            grew = sum(1 for c in missing_now if c in self._index)
        self._flush_spill()
        if grew:
            moved = grew * self._ctx.L * 4  # each placed row: L int32 limbs
            cur = obs_context.current()
            tracer.record(
                "ingest.h2d", (time.perf_counter() - t_h2d) * 1e3,
                _ctx=obs_context.child(cur) if cur is not None else None,
                rows=grew, bytes=moved, shard=self.gid or "-",
            )
            metrics.inc(
                "dds_ingest_h2d_bytes_total", moved, shard=self.gid or "-",
                help="bytes placed into device-resident pools (rows*L*4)",
            )
            metrics.inc(
                "dds_resident_ingest_total", grew, shard=self.gid or "-",
                path="write",
                help="rows ingested into resident pools by path",
            )
        return grew

    # ----------------------------------------------------------------- read

    def _account(self, n_resident: int, n_ingested: int, n_direct: int) -> None:
        self._served[0] += n_resident
        self._served[1] += n_ingested
        self._served[2] += n_direct
        help_ = "fold operands served from device-resident rows vs ingested"
        if n_resident:
            metrics.inc("dds_cipher_store_total", n_resident,
                        outcome="resident", help=help_)
        if n_ingested:
            metrics.inc("dds_cipher_store_total", n_ingested,
                        outcome="ingested", help=help_)
            metrics.inc(
                "dds_resident_ingest_total", n_ingested,
                shard=self.gid or "-", path="fold",
                help="rows ingested into resident pools by path",
            )
        if n_direct:
            metrics.inc("dds_cipher_store_total", n_direct,
                        outcome="direct", help=help_)

    def _gather(self, cs: list[int], idx: torch.Tensor, n_ingested: int) -> torch.Tensor:
        """Enqueue the row gather (caller holds `_lock`) and account."""
        self._idx_memo = (cs, self._epoch, idx)
        self._account(len(cs) - n_ingested, n_ingested, 0)
        return self._buf.index_select(0, idx)

    def rows_for(self, cs: list[int]) -> torch.Tensor | None:
        """The (K, L) rows for `cs` gathered on the device, ingesting any
        unseen operands first — the gather half of `fold`, shared with the
        plane's fused multi-group fold. None when the distinct operands
        cannot fit even after a reset or an eviction wave (callers marshal
        directly). Accounts resident / ingested / direct operands."""
        with self._lock:
            m = self._idx_memo
            if m is not None and m[0] is cs and m[1] == self._epoch:
                return self._gather(cs, m[2], 0)
            missing = sorted({c for c in cs if c not in self._index})
            if not missing:
                idx = self.ensure(cs)
                return self._gather(cs, torch.from_numpy(idx).to(self.device), 0)
        # limb-convert the unseen operands OUTSIDE the lock (the CPU-heavy
        # part); ensure() recomputes what is missing under the lock
        converted = bn.ints_to_batch(
            [c % self.modulus for c in missing], self._ctx.L
        )
        pre = {c: converted[i] for i, c in enumerate(missing)}
        with self._lock:
            idx = self.ensure(cs, pre)
            if idx is None:
                self._account(0, 0, len(cs))
                out = None
            else:
                out = self._gather(cs, torch.from_numpy(idx).to(self.device),
                                   len(missing))
        # deliver any eviction wave to the tier sink outside the lock
        self._flush_spill()
        return out

    def fold(self, cs: list[int]) -> int:
        """prod(cs) mod modulus, gathering resident rows on the device."""
        if not cs:
            return 1 % self.modulus
        rows = self.rows_for(cs)
        resident = rows is not None
        if rows is None:  # aggregate wider than the pool: direct fold
            rows = bn.to_device(
                bn.ints_to_batch([c % self.modulus for c in cs], self._ctx.L),
                self.device,
            )
        with tracer.span("kernel.fold", k=len(cs), resident=resident):
            out = kprof.profiled(
                "store.reduce", lambda: self.reduce(rows), k=len(cs),
            )
            return bn.limbs_to_int(bn.to_host(out)[0])
