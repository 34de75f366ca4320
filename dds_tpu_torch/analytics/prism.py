"""Prism: server-side encrypted analytics over the stored ciphertexts.

Port of `dds_tpu/analytics/prism.py`. The store's aggregate routes fold
ONE position across all records (`SumAll`/`MultAll`); Prism generalises
that to plaintext-matrix x Paillier-ciphertext-vector products (PC-MM):

    Enc(W @ x)[r] = prod_j Enc(x_j) ** W[r][j]   mod n^2

evaluated entirely proxy-side from PUBLIC parameters (ciphertexts, the
client's plaintext weight matrix, and n^2 from the request, never keys),
the trust boundary of every other ciphertext route. Negative weights ride
the n - |w| exponent encoding (`models/paillier.matvec_encode`). The
routes are encrypted scoring (`MatVec`), weighted aggregates
(`WeightedSum`, one row) and group-by rollups (`GroupBySum`, 0/1 selector
rows).

On a sharded proxy (`owner`, the router's key -> group resolver) the
operand columns partition by owning group: one weighted fold a group,
dispatched concurrently on worker threads, each row's partials merged by
`parallel/mesh.combine_partials` (every group shares one Paillier
modulus, so the result is the unsharded fold's). Request validation failures raise ValueError
(400 at the REST edge); the row cap (`ops/flags.analytics_max_rows`)
bounds how much kernel work one request can demand.
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

from dds_tpu_torch.models.paillier import PaillierPublicKey
from dds_tpu_torch.obs.metrics import SIZE_BUCKETS, metrics
from dds_tpu_torch.parallel.mesh import combine_partials
from dds_tpu_torch.utils.trace import tracer


@dataclass
class Prism:
    """The analytics engine one REST proxy owns: a ciphertext backend, the
    per-request row cap, (when sharded) the key -> group-id resolver the
    scatter partition uses (None = unsharded, one dispatch), and (with
    `[resident]`) the resident plane whose per-group pools the operand
    columns gather from, so the device path skips the per-request host
    int -> limb marshaling."""

    backend: object
    max_rows: int = 256
    owner: Optional[Callable[[str], str]] = None
    resident: object = None

    # ------------------------------------------------------------ validation

    @staticmethod
    def parse_nsqr(nsqr: str) -> tuple[int, int]:
        """(n, n^2) from the route's decimal `nsqr` query param. The weight
        encoding needs n itself: a non-square `nsqr` cannot be a Paillier
        modulus and is rejected as a bad request."""
        try:
            n2 = int(nsqr)
        except ValueError:
            raise ValueError("nsqr must be a decimal integer") from None
        n = math.isqrt(n2) if n2 > 0 else 0
        if n < 3 or n * n != n2:
            raise ValueError("nsqr must be a perfect square (Paillier n^2)")
        return n, n2

    def encode_weights(
        self, rows: list[list[int]], n: int, cols: int
    ) -> list[list[int]]:
        """Shape-check a signed weight matrix against the operand count and
        encode it to exponent residues (negatives -> n - |w|)."""
        if not rows:
            raise ValueError("weights must have at least one row")
        if len(rows) > self.max_rows:
            raise ValueError(
                f"{len(rows)} weight rows exceed the analytics row cap "
                f"{self.max_rows} (DDS_ANALYTICS_MAX_ROWS / [analytics] "
                f"max-rows)"
            )
        for row in rows:
            if len(row) != cols:
                raise ValueError(
                    f"weight rows must span the {cols} stored operand "
                    f"column(s) at this position, got {len(row)}"
                )
        return PaillierPublicKey(n).matvec_encode(rows)

    def selector_rows(
        self, groups: dict[str, list[str]], keys: list[str]
    ) -> tuple[list[str], list[list[int]]]:
        """GroupBySum's 0/1 weight matrix: one selector row per group
        label (sorted, for a deterministic response), 1 where the operand
        column's record key is in the group. A group naming a key that is
        not an operand column is a bad request: dropping it would return a
        rollup over a different set than asked for."""
        if not groups:
            raise ValueError("groups must name at least one group")
        if len(groups) > self.max_rows:
            raise ValueError(
                f"{len(groups)} groups exceed the analytics row cap "
                f"{self.max_rows}"
            )
        index = {k: i for i, k in enumerate(keys)}
        labels = sorted(groups)
        rows = []
        for label in labels:
            row = [0] * len(keys)
            for k in groups[label]:
                i = index.get(k)
                if i is None:
                    raise ValueError(
                        f"group {label!r} names unknown record key {k!r}"
                    )
                row[i] = 1
            rows.append(row)
        return labels, rows

    # ------------------------------------------------------------ evaluation

    def _partition(self, keys: list[str]) -> list[tuple[str, list[int]]]:
        """Column indices grouped by owning shard group id; unsharded = one
        anonymous group (a single dispatch either way when only one part
        comes back)."""
        if self.owner is None:
            return [("", list(range(len(keys))))]
        groups: dict[str, list[int]] = {}
        for i, k in enumerate(keys):
            groups.setdefault(self.owner(k), []).append(i)
        return list(groups.items())

    def _gather(self, gid: str, ciphers: list[int], rows: int, n2: int,
                tenant: str = ""):
        """One group's operands' resident device rows from the tenant's
        stripe, or None when residency does not apply: no plane, a host
        backend (it works from the ints), a below-crossover request (the
        host loop wins), or a column wider than its pool. None always means
        the marshaling path."""
        mdb = getattr(self.backend, "min_device_batch", None)
        if self.resident is None or mdb is None:
            return None
        if rows * len(ciphers) < mdb:
            return None
        return self.resident.rows_for(gid, n2, ciphers, tenant)

    def _matvec(self, gid: str, ciphers: list[int], encoded: list[list[int]],
                n2: int, tenant: str = "") -> list[int]:
        # one gather a group, on the worker thread: the pool's lock is held
        # while the gather enqueues, never on the event loop
        rows = self._gather(gid, ciphers, len(encoded), n2, tenant)
        return self.backend.matvec(ciphers, encoded, n2, rows)

    async def evaluate(
        self, route: str, keys: list[str], ciphers: list[int],
        encoded: list[list[int]], n2: int, tenant: str = "",
    ) -> list[int]:
        """One request's encoded weighted fold on worker threads: scattered
        one fold a shard group when the columns span groups and merged per
        row by `combine_partials`; with a resident plane each group's
        operands gather from `tenant`'s stripe ("" the single-tenant
        one)."""
        R, K = len(encoded), len(ciphers)
        metrics.inc(
            "dds_analytics_requests_total", route=route,
            help="Prism encrypted-analytics requests by route",
        )
        metrics.observe(
            "dds_analytics_rows", R, buckets=SIZE_BUCKETS,
            help="weight rows per analytics request",
        )
        metrics.observe(
            "dds_analytics_cols", K, buckets=SIZE_BUCKETS,
            help="ciphertext operand columns per analytics request",
        )
        parts = self._partition(keys)
        t0 = time.perf_counter()
        with tracer.span(
            "analytics.matvec", rows=R, cols=K, shards=len(parts),
            backend=getattr(self.backend, "name", "?"),
        ):
            if len(parts) > 1:
                def one(gid: str, idxs: list[int]):
                    return asyncio.to_thread(
                        self._matvec, gid, [ciphers[i] for i in idxs],
                        [[row[i] for i in idxs] for row in encoded], n2, tenant)

                partials = await asyncio.gather(*(one(g, ix) for g, ix in parts))
                out = [combine_partials([p[r] for p in partials], n2)
                       for r in range(R)]
            else:
                gid = parts[0][0] if parts else ""
                out = await asyncio.to_thread(self._matvec, gid, ciphers, encoded,
                                              n2, tenant)
        metrics.observe(
            "dds_analytics_matvec_seconds", time.perf_counter() - t0,
            help="analytics weighted-fold evaluation latency",
        )
        return out
