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

Sharding is not ported: every request is one weighted fold on the
backend (the reference's per-shard scatter and `combine_partials` gather
come with the mesh work). Request validation failures raise ValueError
(400 at the REST edge); the row cap (`ops/flags.analytics_max_rows`)
bounds how much kernel work one request can demand.
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass

from dds_tpu_torch.models.paillier import PaillierPublicKey
from dds_tpu_torch.obs.metrics import SIZE_BUCKETS, metrics
from dds_tpu_torch.utils.trace import tracer


@dataclass
class Prism:
    """The analytics engine one REST proxy owns: a ciphertext backend, the
    per-request row cap, and (with `[resident]`) the resident plane whose
    pool the operand column gathers from, so the device path skips the
    per-request host int -> limb marshaling."""

    backend: object
    max_rows: int = 256
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

    def _gather(self, ciphers: list[int], rows: int, n2: int, tenant: str = ""):
        """The operands' resident device rows from the tenant's stripe, or
        None when residency does not apply: no plane, a host backend (it
        works from the ints), a below-crossover request (the host loop
        wins), or a column wider than its pool. None always means the
        marshaling path."""
        mdb = getattr(self.backend, "min_device_batch", None)
        if self.resident is None or mdb is None:
            return None
        if rows * len(ciphers) < mdb:
            return None
        return self.resident.rows_for("", n2, ciphers, tenant)

    def _matvec(self, ciphers: list[int], encoded: list[list[int]], n2: int,
                tenant: str = "") -> list[int]:
        # one gather a request, on the worker thread: the pool's lock is
        # held while the gather enqueues, never on the event loop
        rows = self._gather(ciphers, len(encoded), n2, tenant)
        return self.backend.matvec(ciphers, encoded, n2, rows)

    async def evaluate(
        self, route: str, ciphers: list[int], encoded: list[list[int]], n2: int,
        tenant: str = "",
    ) -> list[int]:
        """One request's encoded weighted fold, on a worker thread; with a
        resident plane its operands gather from `tenant`'s stripe ("" the
        single-tenant one)."""
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
        t0 = time.perf_counter()
        with tracer.span(
            "analytics.matvec", rows=R, cols=K, shards=1,
            backend=getattr(self.backend, "name", "?"),
        ):
            out = await asyncio.to_thread(self._matvec, ciphers, encoded, n2, tenant)
        metrics.observe(
            "dds_analytics_matvec_seconds", time.perf_counter() - t0,
            help="analytics weighted-fold evaluation latency",
        )
        return out
