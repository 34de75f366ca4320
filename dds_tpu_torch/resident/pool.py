"""Resident pools: device-pinned, content-addressed ciphertext limb rows.

Port of `dds_tpu/resident/pool.py`. A `ResidentPool` is the `(rows, L)`
int32 limb buffer one modulus keeps in device memory. Each distinct
ciphertext value is ingested once (int -> 16-bit limbs -> device row);
every later aggregate gathers resident rows on the device instead of
re-marshaling host ints. Content addressing keeps the dependability story
intact: the proxy still runs full quorum validation per aggregate, the
pool only memoizes the conversion and transfer of bytes the device has
already seen, so a stale row cannot exist by construction.

Capacity doubles up to `max_rows`; past that the pool resets (entries
re-ingest on demand, `epoch` bumps, every row-index memo invalidates).
Tiered eviction (Stratum's `spill`/`evict_rank`) waits for a later slice.

Concurrency: folds run on proxy worker threads. The reference could gather
from a buffer snapshot outside its lock because JAX arrays are immutable;
a torch buffer is written in place, so here the gather (`index_select`)
is enqueued while the lock is held. Stream order then puts it before any
later write to the buffer, and a reset swaps in a fresh buffer besides.
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
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.resident")


@dataclass
class ResidentPool:
    """Resident (rows, L) int32 limb buffer for one modulus on `device`.

    `reduce` is the device-level fold callable ((K, L) tensor -> (1, L));
    backends inject theirs (CudaBackend.reduce_mul_device) so kernel
    dispatch lives in one place. Default: `ops/mont_cuda.reduce_mul` (the
    kernel on a CUDA pool, its plain PyTorch version on a CPU pool)."""

    modulus: int
    reduce: object = None
    initial_rows: int = 256
    max_rows: int = 1 << 20  # 1 GiB of device memory at L=256
    device: object = "cuda"
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
        # unique); epoch invalidates across resets.
        self._idx_memo: tuple | None = None
        self._epoch = 0
        self._resets = 0
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

    def hit_ratio(self) -> float | None:
        """Fraction of fold operands served from resident rows."""
        total = sum(self._served)
        return (self._served[0] / total) if total else None

    # --------------------------------------------------------------- ingest

    def _grow(self, need: int) -> None:
        cap = self.capacity
        while cap < need:
            cap *= 2
        if cap > self.max_rows:
            log.warning("resident pool over max_rows (%d > %d): resetting",
                        need, self.max_rows)
            self._index.clear()
            self._count = 0
            self._epoch += 1  # row indices changed: invalidate idx memos
            self._resets += 1
            cap = max(self.initial_rows, min(cap, self.max_rows))
            self._buf = self._zeros(cap)
            return
        buf = self._zeros(cap)
        buf[: self.capacity] = self._buf
        self._buf = buf

    def ensure(self, cs: list[int], pre: dict | None = None) -> np.ndarray | None:
        """Ingest any unseen ciphertexts; return row indices for all of cs.
        Caller holds `_lock`. `pre` maps ciphertext -> limb row converted
        outside the lock. None when the distinct operands cannot fit even
        after a reset (callers fold directly)."""
        missing = sorted({c for c in cs if c not in self._index})
        if missing:
            if self._count + len(missing) > self.capacity:
                self._grow(self._count + len(missing))
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
        """Ingest ciphertexts eagerly: limb conversion outside the lock,
        placement under it. `rows` optionally supplies the (len(cs), L)
        uint32 limb rows already converted (rows[i] holds cs[i] mod the
        modulus). Returns how many new rows landed; operand sets wider
        than the pool are skipped (they only ever fold directly)."""
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
            missing_now = {c for c in pre if c not in self._index}
            self.ensure(list(pre), pre)
            grew = sum(1 for c in missing_now if c in self._index)
        if grew:
            cur = obs_context.current()
            tracer.record(
                "ingest.h2d", (time.perf_counter() - t_h2d) * 1e3,
                _ctx=obs_context.child(cur) if cur is not None else None,
                rows=grew, bytes=grew * self._ctx.L * 4,
            )
        return grew

    # ----------------------------------------------------------------- read

    def _gather(self, cs: list[int], idx: torch.Tensor, n_ingested: int) -> torch.Tensor:
        """Enqueue the row gather (caller holds `_lock`) and account."""
        self._idx_memo = (cs, self._epoch, idx)
        self._served[0] += len(cs) - n_ingested
        self._served[1] += n_ingested
        return self._buf.index_select(0, idx)

    def rows_for(self, cs: list[int]) -> torch.Tensor | None:
        """The (K, L) rows for `cs` gathered on the device, ingesting any
        unseen operands first. None when the distinct operands cannot fit
        even after a reset (callers marshal directly)."""
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
                self._served[2] += len(cs)
                return None
            return self._gather(cs, torch.from_numpy(idx).to(self.device), len(missing))

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
