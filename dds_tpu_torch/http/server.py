"""REST proxy: the encrypted query engine.

Copy of `dds_tpu/http/server.py` without tenancy, serving the reference's
data routes with its parameters, JSON shapes and status codes:

- `POST /PutSet`, `GET /GetSet/<key>`, `DELETE /RemoveSet/<key>`: quorum
  write, read and removal of a record, keyed by its content hash;
- `PUT /AddElement/<key>`, `GET /ReadElement/<key>?position=p`,
  `PUT /WriteElement/<key>?position=p`, `POST /IsElement/<key>`: one
  element of a record (a write past the end appends);
- `GET /Sum` and `GET /Mult` (`key1`, `key2`, `position`, and `nsqr` or
  `pubkey`): one modular product of two records' ciphertexts on the host;
- `GET /SumAll?position=p&nsqr=n2` and `GET /MultAll?position=p&pubkey=n`:
  the homomorphic sum (Paillier, mod n^2) or product (RSA, mod n) of
  column p over every stored record, folded on the configured backend
  (the `cuda` backend runs the Hopper Montgomery kernels, one resident
  pool per modulus). Without the modulus: the plain sum or product;
- `GET /OrderLS`, `GET /OrderSL`, `POST /SearchEq`, `/SearchNEq`,
  `/SearchGt`, `/SearchGtEq`, `/SearchLt`, `/SearchLtEq`, `/Range`,
  `/SearchEntry`, `/SearchEntryOR`, `/SearchEntryAND`: the reference's
  legacy scans over every stored record, paged by `offset`/`limit`;
- `POST /MatVec`, `/WeightedSum` and `/GroupBySum` (`position`, `nsqr`):
  Prism's encrypted analytics (`analytics/`), Enc(W @ x) over column p of
  every stored record for a plaintext weight matrix, one row, or 0/1
  group selectors, on the backend's weighted fold; on by default
  (`analytics_enabled`), 413 past `analytics_max_request_bytes`.

Concurrent aggregates whose folds each sit below the backend's
`min_device_batch` coalesce per modulus: they wait `coalesce_window`
seconds and share one `modmul_fold_many` pass on the device (`_fold`, the
reference's coalescer at `dds_tpu/http/server.py:2605-2723`; its adaptive
window comes with admission control, not yet ported).

Every other route answers 404. The aggregate and search paths keep the
reference's tag-validated cache and audit exactly: ONE batched tag-only
quorum round validates every cached record per request, a random sample
of cache-served keys is re-read through full quorums, and a
non-corroborated mismatch flushes the cache. The proxy sees ciphertexts
and public parameters only, never keys.

With `[resident]` (`ProxyConfig.resident`) every modular SumAll/MultAll
at least `min-fold` wide runs through the resident plane (`resident/`):
one fused gather+fold over the operands' group pools (one anonymous group
here: sharding is not ported), on the backend's device. Committed writes
queue their ciphertext columns for ingest into the existing pools off the
request path, so the first aggregate after a write ingests nothing. With
`[storage]` as well, Stratum (`storage/`) routes the fold through its
hot/warm/cold planner and pool overflow evicts instead of resetting.
The search plane (the indexed Spyglass search) is not ported yet; the
proxy refuses to start with it enabled rather than serve without it.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import random
import time
from dataclasses import dataclass
from typing import Optional

from dds_tpu_torch.analytics import Prism
from dds_tpu_torch.core.errors import ByzantineError
from dds_tpu_torch.core.quorum_client import AbdClient
from dds_tpu_torch.http import json_protocol as J
from dds_tpu_torch.http.miniserver import HttpServer, Request, Response
from dds_tpu_torch.models.backend import CryptoBackend, get_backend
from dds_tpu_torch.models.det import DetKey
from dds_tpu_torch.obs import context as obs_context
from dds_tpu_torch.ops.flags import analytics_max_rows
from dds_tpu_torch.resident import ResidentPlane
from dds_tpu_torch.storage import Stratum
from dds_tpu_torch.utils import sigs
from dds_tpu_torch.utils.retry import (
    Deadline,
    DeadlineExceededError,
    RetryPolicy,
    retry_deadline,
)
from dds_tpu_torch.utils.tasks import supervised_task
from dds_tpu_torch.utils.trace import tracer
from dds_tpu_torch.utils.trust import NoTrustedNodesError

log = logging.getLogger("dds_torch.rest")

# the per-request time budget, minted once in handle() and read by every
# nested storage helper
_REQ_DEADLINE: contextvars.ContextVar = contextvars.ContextVar(
    "dds_torch_request_deadline", default=None
)

# transient storage-layer failures worth retrying; anything else (a
# programming error, a bad request) propagates immediately
_RETRYABLE = (ByzantineError, asyncio.TimeoutError, NoTrustedNodesError, OSError)


@dataclass
class ProxyConfig:
    host: str = "127.0.0.1"
    port: int = 0
    # one overall budget per request, minted at the REST edge; quorum
    # attempts and full-jitter backoffs retry inside it, and exhaustion
    # degrades to 503 + Retry-After
    request_budget: float = 8.0
    retry_backoff: float = 0.3
    retry_max_delay: float = 2.0
    retry_attempts: int = 0            # > 0 caps attempts on top of the budget
    retry_after_hint: float = 1.0
    handler_timeout: float = 0.0
    crypto_backend: str = "cuda"
    device: str = "cuda"
    min_device_batch: Optional[int] = None
    # tag-validated aggregate cache: one batched tag-only quorum round
    # validates all cached records per aggregate instead of K full reads
    aggregate_cache: bool = True
    # cache-served keys re-read through a full quorum per aggregate; a
    # non-corroborated mismatch flushes the cache (bounds how long a
    # Byzantine coordinator's forged value can persist)
    aggregate_cache_audit: int = 2
    # cross-request fold coalescing: concurrent SumAll folds that each sit
    # below the backend's device-batch crossover are gathered for this many
    # seconds and dispatched as ONE segmented device fold (ops/foldmany),
    # paying the launch latency once for all of them. A group of one takes
    # the plain host path, so the window only costs latency when there is
    # something to gain. 0 disables.
    coalesce_window: float = 0.002
    # Prism's routes (POST /MatVec, /WeightedSum, /GroupBySum): the row cap
    # bounds one request's kernel work (DDS_ANALYTICS_MAX_ROWS overrides
    # it; ops/flags.analytics_max_rows validates whichever wins); the byte
    # cap answers 413 before the body is parsed
    analytics_enabled: bool = True
    analytics_max_rows: int = 256
    analytics_max_request_bytes: int = 1 << 20
    # the resident plane (a utils.config.ResidentConfig; None = off) and
    # Stratum under it (a utils.config.StorageConfig; needs the plane)
    resident: object = None
    storage: object = None
    # the search plane is not ported yet: True refuses to start
    search: bool = False


def _make_backend(cfg: ProxyConfig) -> CryptoBackend:
    if cfg.crypto_backend == "cuda":
        return get_backend("cuda", device=cfg.device,
                           min_device_batch=cfg.min_device_batch)
    return get_backend(cfg.crypto_backend)


async def _cancel_task(task: asyncio.Task) -> None:
    """Cancel a background task and swallow its CancelledError."""
    task.cancel()
    try:
        await task
    except asyncio.CancelledError:
        pass


class DDSRestServer:
    def __init__(self, abd: AbdClient, config: ProxyConfig | None = None):
        self.abd = abd
        self.cfg = config or ProxyConfig()
        if self.cfg.search:
            raise NotImplementedError(
                "the search plane is not ported to dds_tpu_torch yet"
            )
        self.backend: CryptoBackend = _make_backend(self.cfg)
        self.stored_keys: set[str] = set()
        # key -> (tag, value): every entry comes from a COMPLETED quorum op,
        # so value@tag is written to a full quorum — the invariant the
        # tag-validation read path relies on for linearizability
        self._cache: dict[str, tuple] = {}
        # versions + memos for the aggregate hot path: between writes the
        # per-request O(K) bookkeeping is identical, so it is computed once
        # per (stored_keys, cache) state. The tag round and the audit still
        # run on EVERY aggregate.
        self._stored_version = 0
        self._cache_version = 0
        self._agg_memo: tuple | None = None
        self._pairs_memo: tuple | None = None
        self._operand_memo: tuple | None = None
        # modulus -> [(enqueue_t, operands, future, waiter trace ctx)];
        # drained by _drain_folds
        self._fold_pending: dict[int, list] = {}
        self._fold_drainer: asyncio.Task | None = None
        self._folds_inflight = 0  # folds currently executing (any path)
        self._owner_memo: tuple | None = None  # pairs identity -> (gid, ops)
        # the resident plane: per-group device-resident pools + the fused
        # fold. A cuda backend builds it on its own device; a host backend
        # (`cpu`) gets a plane on the CPU, the reference's rule for host
        # backends. None when disabled.
        rescfg = self.cfg.resident
        self._resident: ResidentPlane | None = None
        self._resident_min_fold = 0
        self._resident_write_ingest = False
        self._resident_ingest_window = 0.005
        self._ingest_task: asyncio.Task | None = None
        if rescfg is not None and rescfg.enabled:
            if hasattr(self.backend, "resident_plane"):
                self._resident = self.backend.resident_plane(
                    rescfg.initial_rows, rescfg.max_rows
                )
            else:
                self._resident = ResidentPlane(
                    device="cpu", initial_rows=rescfg.initial_rows,
                    max_rows=rescfg.max_rows,
                )
            self._resident_min_fold = (
                rescfg.min_fold if rescfg.min_fold > 0
                else getattr(self.backend, "min_device_batch", 0)
            )
            self._resident_write_ingest = rescfg.write_ingest
            self._resident_ingest_window = max(0.0, rescfg.ingest_window)
        # Stratum: the tier planner under the plane, built only when a
        # plane exists (the hot tier IS the pool); attaching rewires pool
        # overflow from reset to eviction. None when disabled.
        stcfg = self.cfg.storage
        self._stratum: Stratum | None = None
        if stcfg is not None and stcfg.enabled and self._resident is not None:
            self._stratum = Stratum(
                self._resident, stcfg.dir,
                warm_bytes=stcfg.warm_bytes, chunk_rows=stcfg.chunk_rows,
                promote_score=stcfg.promote_score,
                max_promote=stcfg.max_promote, half_life=stcfg.half_life,
                keep=stcfg.keep, compact_segments=stcfg.compact_segments,
            )
        # Prism: the same backend and public-parameter boundary, and the
        # resident plane, so MatVec operands gather from its pool
        self.prism: Prism | None = None
        if self.cfg.analytics_enabled:
            self.prism = Prism(
                backend=self.backend,
                max_rows=analytics_max_rows(self.cfg.analytics_max_rows),
                resident=self._resident,
            )
        self._column_memo: tuple | None = None  # pairs identity -> columns
        self._http = HttpServer(self.cfg.host, self.cfg.port, self.handle,
                                handler_timeout=self.cfg.handler_timeout)

    async def start(self) -> None:
        await self._http.start()
        self.cfg.port = self._http.port  # resolve OS-assigned port 0

    async def stop(self) -> None:
        await self._http.stop()
        if self._ingest_task is not None:
            await _cancel_task(self._ingest_task)
            self._ingest_task = None
        if self._fold_drainer is not None and not self._fold_drainer.done():
            # resolve queued folds before teardown so no request future is
            # orphaned and no task outlives the server
            await _cancel_task(self._fold_drainer)
            err = ConnectionError("proxy stopping")
            for group in self._fold_pending.values():
                for _, _, fut, _ in group:
                    if not fut.done():
                        fut.set_exception(err)
            self._fold_pending.clear()
            self._fold_drainer = None

    # ----------------------------------------------------------- ABD access

    def _request_deadline(self) -> Deadline:
        dl = _REQ_DEADLINE.get()
        return dl if dl is not None else Deadline(self.cfg.request_budget)

    async def _retry(self, f, deadline: Deadline):
        attempts = self.cfg.retry_attempts
        policy = RetryPolicy(
            base=self.cfg.retry_backoff,
            max_delay=self.cfg.retry_max_delay,
            max_attempts=(attempts + 1) if attempts > 0 else None,
        )
        return await retry_deadline(f, deadline, policy, retry_on=_RETRYABLE)

    def _cache_put(self, key: str, tag, value) -> None:
        """Remember a completed op's (tag, value); newest tag wins."""
        if tag is None or not self.cfg.aggregate_cache:
            return
        cur = self._cache.get(key)
        if cur is None or cur[0] < tag:
            self._cache[key] = (tag, value)
            self._cache_version += 1

    def _flush_cache(self) -> None:
        self._cache.clear()
        self._cache_version += 1

    def _note_stored(self, key: str) -> None:
        if key not in self.stored_keys:
            self.stored_keys.add(key)
            self._stored_version += 1

    def _agg_state(self):
        """(state, keys, cached, digest, fingerprint, cached_tags) for the
        current aggregate view, memoized per (stored, cache) version."""
        state = (self._stored_version, self._cache_version)
        memo = self._agg_memo
        if memo is not None and memo[0] == state:
            return memo
        keys = sorted(self.stored_keys)
        cached = [k for k in keys if k in self._cache]
        cached_tags = [self._cache[k][0] for k in cached]
        digest = sigs.key_from_set(cached)
        fp = sigs.tags_fingerprint(cached_tags)
        self._agg_memo = (state, keys, cached, digest, fp, cached_tags)
        return self._agg_memo

    async def _fetch_tagged(self, key: str, exclude=()):
        dl = self._request_deadline()
        value, tag, coord = await self._retry(
            lambda: self.abd.fetch_set_attributed(key, exclude, deadline=dl), dl
        )
        self._cache_put(key, tag, value)
        return value, tag, coord

    async def _fetch(self, key: str):
        return (await self._fetch_tagged(key))[0]

    async def _write(self, key: str, value):
        dl = self._request_deadline()
        k, tag = await self._retry(
            lambda: self.abd.write_set_tagged(key, value, deadline=dl), dl
        )
        self._cache_put(key, tag, value)
        self._note_resident_write(key, value)
        return k

    # ------------------------------------------------ resident write ingest

    def _note_resident_write(self, key: str, value) -> None:
        """Queue a committed write's ciphertext columns for resident-pool
        ingest off the request's critical path, so the first aggregate
        after the write gathers every row on the device with no ingest.
        Content addressing keeps this safe: the quorum read still decides
        which ciphertexts fold; the pool only pre-pays their limb
        conversion and transfer."""
        plane = self._resident
        if plane is None or not self._resident_write_ingest or not value:
            return
        ciphers = []
        for col in value:
            if isinstance(col, bool):
                continue
            if isinstance(col, int):
                ciphers.append(col)
            elif isinstance(col, str):
                try:
                    ciphers.append(int(col))
                except ValueError:
                    continue  # non-numeric column: never an aggregate operand
        if not ciphers:
            return
        if self._stratum is not None:
            # popularity only (pure dict math, loop-safe): a rewritten
            # tiered row warms its directory score
            self._stratum.note_write("", ciphers, key=key)
        if plane.note_write("", ciphers):
            self._resident_ingest_soon()

    def _resident_ingest_soon(self) -> None:
        """Debounced drain: coalesce a write burst into few ingest passes,
        each on a worker thread so limb conversion never stalls request
        handling."""
        if self._ingest_task is not None and not self._ingest_task.done():
            return

        async def _drain():
            while self._resident.pending_ingest():
                await asyncio.sleep(self._resident_ingest_window)
                await asyncio.to_thread(self._resident.ingest_pending)

        self._ingest_task = supervised_task(_drain(), name="proxy.resident_ingest")

    def tier_pressure(self) -> float:
        """Blended hot+warm occupancy in [0, 1] (Stratum's `pressure`):
        how close the fullest pool is to its max_rows, or the warm cache
        to its byte budget, whichever is tighter. 0.0 without Stratum."""
        if self._stratum is None:
            return 0.0
        try:
            return float(self._stratum.pressure())
        except Exception:
            return 0.0

    async def _fetch_stored(self) -> list[tuple[str, list]]:
        """Every stored (key, value), for the aggregate and search routes.

        With the aggregate cache on, ONE batched tag-only quorum round
        (`AbdClient.read_tags`) validates all cached entries: a cached
        value is served only when the quorum-max tag EQUALS its cached tag,
        which is linearizable because cached values come from completed
        ops and any completed later write shows a higher tag in every
        quorum. Keys that fail validation (or were never cached) take the
        full ABD read, refilling the cache; the audit below bounds how long
        a forged cached value can persist."""
        with tracer.span("proxy.fetch_stored"):
            return await self._fetch_stored_traced()

    async def _fetch_stored_traced(self) -> list[tuple[str, list]]:
        state, keys, cached, digest, fp, cached_tags = self._agg_state()
        if not keys:
            return []
        fresh: dict[str, object] = {}
        fresh_tags: dict[str, object] = {}
        if self.cfg.aggregate_cache and cached:
            try:
                dl = self._request_deadline()
                tags = await self._retry(
                    lambda: self.abd.read_tags(
                        cached, digest=digest, fingerprint=fp,
                        cached_tags=cached_tags, deadline=dl,
                    ),
                    dl,
                )
                if tags is cached_tags:
                    # every vote said "unchanged": the whole cache is fresh.
                    # With memoized pairs for this exact state only the
                    # audit remains.
                    pm = self._pairs_memo
                    if pm is not None and pm[0] == state:
                        if await self._audit_cached(cached):
                            return pm[1]
                        # audit flushed the cache: rebuild from quorum reads
                    else:
                        for k in cached:
                            ct, cv = self._cache[k]
                            fresh[k] = cv
                            fresh_tags[k] = ct
                else:
                    for k, t in zip(cached, tags):
                        ct, cv = self._cache[k]
                        if t == ct:
                            fresh[k] = cv
                            fresh_tags[k] = ct
            except Exception as e:  # validation trouble => plain full fetch
                log.debug("tag validation failed (%s); full refetch", e)

        # audit sample: re-read a few cache-served keys through full quorums
        audit = random.sample(
            sorted(fresh), min(self.cfg.aggregate_cache_audit, len(fresh))
        )
        stale = [k for k in keys if k not in fresh or k in audit]
        results = await asyncio.gather(
            *(self._fetch_tagged(k) for k in stale), return_exceptions=True
        )
        fetched = {}
        for k, r in zip(stale, results):
            if isinstance(r, Exception):
                raise r
            fetched[k] = r  # (value, tag, coordinator)
        pre = {k: (fresh_tags[k], fresh[k]) for k in audit}
        if await self._audit_verdict(audit, pre, fetched):
            log.warning("aggregate cache audit mismatch: flushing cache")
            self._flush_cache()
            fresh.clear()  # serve only quorum-read data this round
            remaining = [k for k in keys if k not in fetched]
            more = await asyncio.gather(
                *(self._fetch_tagged(k) for k in remaining),
                return_exceptions=True,
            )
            for k, r in zip(remaining, more):
                if isinstance(r, Exception):
                    raise r
                fetched[k] = r
        out = []
        for k in keys:
            v = fetched[k][0] if k in fetched else fresh[k]
            if v is not None:
                out.append((k, v))
        # memoize only if the (stored, cache) state did not move meanwhile
        if (self._stored_version, self._cache_version) == state:
            self._pairs_memo = (state, out)
        return out

    async def _audit_verdict(self, audit: list[str], pre: dict,
                             fetched: dict) -> list[str]:
        """Forged/suspect classification shared by both audit paths.

        `pre[k] = (tag, value)` is what the cache served; `fetched[k] =
        (value, tag, coordinator)` the audit's full quorum re-read. A value
        mismatch at the cached tag or below is a forgery. A strictly newer
        (value, tag) is usually a benign concurrent write, but its tag came
        from the audited read itself, so it is corroborated by one more
        full read through a DIFFERENT coordinator; a failed corroboration
        counts as forged (the conservative flush)."""
        forged, suspect = [], []
        for k in audit:
            value, tag, _coord = fetched[k]
            pre_tag, pre_value = pre[k]
            if value == pre_value:
                continue
            if tag is None or tag <= pre_tag:
                forged.append(k)
            else:
                suspect.append(k)
        if suspect:
            checks = await asyncio.gather(
                *(self._fetch_tagged(k, exclude=(fetched[k][2],)) for k in suspect),
                return_exceptions=True,
            )
            for k, r in zip(suspect, checks):
                if isinstance(r, Exception) or r[:2] != fetched[k][:2]:
                    forged.append(k)
        return forged

    async def _audit_cached(self, cached: list[str]) -> bool:
        """Audit a fully cache-served aggregate round; False when the cache
        was flushed."""
        audit = random.sample(
            cached, min(self.cfg.aggregate_cache_audit, len(cached))
        )
        if not audit:
            return True
        pre = {k: self._cache[k] for k in audit}
        results = await asyncio.gather(
            *(self._fetch_tagged(k) for k in audit), return_exceptions=True
        )
        fetched = {}
        for k, r in zip(audit, results):
            if isinstance(r, Exception):
                raise r
            fetched[k] = r
        if await self._audit_verdict(audit, pre, fetched):
            log.warning("aggregate cache audit mismatch: flushing cache")
            self._flush_cache()
            return False
        return True

    # -------------------------------------------------------------- routing

    async def handle(self, req: Request) -> Response:
        route = req.path.split("/", 2)[1] if "/" in req.path else req.path
        # one budget per request: every storage helper reads it from the
        # context var, so nested retries shrink toward the same deadline
        token = _REQ_DEADLINE.set(Deadline(self.cfg.request_budget))
        try:
            with tracer.span(f"http.{req.method}.{route or 'root'}",
                             _ctx=obs_context.root()):
                return await self._route(req)
        except (ValueError, KeyError, TypeError) as e:
            return Response.text(f"bad request: {e}", 400)
        except (DeadlineExceededError, NoTrustedNodesError) as e:
            # the quorum is unreachable within the budget: say when to
            # come back instead of hanging
            log.warning("degraded %s %s: %s", req.method, req.path, e)
            return Response(
                503, f"service unavailable: {e}".encode(),
                headers={"Retry-After": str(max(1, round(self.cfg.retry_after_hint)))},
            )
        except Exception:
            log.exception("route failure %s %s", req.method, req.path)
            return Response(500)
        finally:
            _REQ_DEADLINE.reset(token)

    async def _route(self, req: Request) -> Response:
        parts = [p for p in req.path.split("/") if p]
        if not parts:
            return Response(404)
        name, arg = parts[0], (parts[1] if len(parts) > 1 else None)
        match (req.method, name):
            case ("GET", "GetSet") if arg:
                value = await self._fetch(arg)
                if value is None:
                    return Response(404)
                return Response.json(J.dds_set(value))

            case ("POST", "PutSet"):
                body = req.json()
                if body is None:
                    key, value = sigs.random_key(), None
                else:
                    value = J.parse_set(body)
                    key = sigs.key_from_set(value)
                await self._write(key, value)
                self._note_stored(key)
                return Response.text(key)

            case ("DELETE", "RemoveSet") if arg:
                await self._write(arg, None)
                if arg in self.stored_keys:
                    # stop aggregating it: the version bump invalidates the
                    # aggregate memos keyed on the stored set
                    self.stored_keys.discard(arg)
                    self._stored_version += 1
                return Response(200)

            case ("PUT", "AddElement") if arg:
                item = J.parse_item(req.json())
                value = await self._fetch(arg)
                if value is None:
                    return Response(404)
                await self._write(arg, value + [item])
                return Response(200)

            case ("GET", "ReadElement") if arg:
                pos = self._pos(req)
                value = await self._fetch(arg)
                if value is None or pos > len(value) - 1:
                    return Response(404)
                return Response.json({"value": value[pos]})

            case ("PUT", "WriteElement") if arg:
                pos = self._pos(req)
                item = J.parse_item(req.json())
                value = await self._fetch(arg)
                if value is None:
                    return Response(404)
                new = list(value)
                if pos > len(new) - 1:
                    new.append(item)
                else:
                    new[pos] = item
                await self._write(arg, new)
                return Response(200)

            case ("POST", "IsElement") if arg:
                item = J.parse_item(req.json())
                value = await self._fetch(arg)
                if value is None:
                    return Response(404)
                # deterministic-HE compare degenerates to ciphertext equality
                found = any(str(elem) == str(item) for elem in value)
                return Response.json(J.value_result(found))

            # ---------------- ciphertext-compute aggregates ----------------

            case ("GET", "Sum"):
                return await self._pair_aggregate(req, "nsqr")

            case ("GET", "SumAll"):
                return await self._fold_aggregate(req, "nsqr")

            case ("GET", "Mult"):
                return await self._pair_aggregate(req, "pubkey")

            case ("GET", "MultAll"):
                return await self._fold_aggregate(req, "pubkey")

            # ------------------------- encrypted search (legacy scans) -----

            case ("GET", "OrderLS") | ("GET", "OrderSL"):
                return await self._order_route(name, req)

            case ("POST", "SearchEq") | ("POST", "SearchNEq"):
                return await self._eq_route(name, req)

            case ("POST", "SearchGt") | ("POST", "SearchGtEq") | (
                "POST",
                "SearchLt",
            ) | ("POST", "SearchLtEq"):
                return await self._cmp_route(name, req)

            case ("POST", "Range"):
                return await self._range_route(req)

            case ("POST", "SearchEntry") | ("POST", "SearchEntryOR") | (
                "POST",
                "SearchEntryAND",
            ):
                return await self._entry_route(name, req)

            case ("POST", "MatVec") | ("POST", "WeightedSum") | (
                "POST",
                "GroupBySum",
            ) if self.prism is not None:
                return await self._analytics(name, req)
        return Response(404)

    # ------------------------------------------------------- search routes

    @staticmethod
    def _page_params(req: Request) -> tuple[int, int | None]:
        """`offset`/`limit` pagination params (every search/order route):
        non-negative ints, ValueError -> 400 via handle()."""
        off = int(req.query.get("offset", 0))
        if off < 0:
            raise ValueError("offset must be >= 0")
        lim = req.query.get("limit")
        lim = int(lim) if lim is not None else None
        if lim is not None and lim < 0:
            raise ValueError("limit must be >= 0")
        return off, lim

    @staticmethod
    def _page_response(keyset: list[str],
                       page: tuple[int, int | None]) -> Response:
        off, lim = page
        end = None if lim is None else off + lim
        return Response.json(J.keys_result(keyset[off:end]))

    async def _order_route(self, name: str, req: Request) -> Response:
        pos = self._pos(req)
        page = self._page_params(req)
        descending = name == "OrderLS"
        pairs = await self._fetch_stored()
        # records without the column are EXCLUDED (the Search* convention);
        # non-integer columns raise -> 400, like every Search* int cast
        rows = [(int(v[pos]), k) for k, v in pairs if pos < len(v)]
        ordered = [
            k for _, k in
            sorted(rows, key=lambda t: t[0], reverse=descending)
        ]
        return self._page_response(ordered, page)

    async def _eq_route(self, name: str, req: Request) -> Response:
        pos = self._pos(req)
        item = str(J.parse_item(req.json()))
        page = self._page_params(req)
        want_eq = name == "SearchEq"
        pairs = await self._fetch_stored()
        keyset = [
            k for k, v in pairs
            if pos < len(v) and DetKey.compare(str(v[pos]), item) == want_eq
        ]
        return self._page_response(keyset, page)

    async def _cmp_route(self, name: str, req: Request) -> Response:
        pos = self._pos(req)
        item = int(J.parse_item(req.json()))
        page = self._page_params(req)
        pairs = await self._fetch_stored()
        op = {
            "SearchGt": lambda e: e > item,
            "SearchGtEq": lambda e: e >= item,
            "SearchLt": lambda e: e < item,
            "SearchLtEq": lambda e: e <= item,
        }[name]
        keyset = [k for k, v in pairs if pos < len(v) and op(int(v[pos]))]
        return self._page_response(keyset, page)

    async def _range_route(self, req: Request) -> Response:
        pos = self._pos(req)
        lo_bound, hi_bound = J.parse_range(req.json())
        page = self._page_params(req)
        pairs = await self._fetch_stored()
        keyset = [
            k for k, v in pairs
            if pos < len(v) and lo_bound <= int(v[pos]) <= hi_bound
        ]
        return self._page_response(keyset, page)

    async def _entry_route(self, name: str, req: Request) -> Response:
        if name == "SearchEntry":
            vals = [str(J.parse_item(req.json()))]
        else:
            vals = [str(x) for x in J.parse_triplet(req.json())]
        page = self._page_params(req)
        pairs = await self._fetch_stored()
        if name == "SearchEntryAND":
            keyset = [
                k for k, v in pairs
                if all(any(DetKey.compare(str(e), q) for e in v)
                       for q in vals)
            ]
        else:
            keyset = [
                k for k, v in pairs
                if any(DetKey.compare(str(e), q) for q in vals for e in v)
            ]
        return self._page_response(keyset, page)

    # ----------------------------------------------------- aggregate helpers

    async def _pair_aggregate(self, req: Request, modparam: str) -> Response:
        """`Sum` / `Mult`: combine one position of two records. One
        multiply never pays a launch, so it is the backend's host
        `modmul`."""
        key1, key2 = req.query["key1"], req.query["key2"]
        pos = self._pos(req)
        mod = req.query.get(modparam)
        set1, set2 = await asyncio.gather(self._fetch(key1), self._fetch(key2))
        if set1 is None or set2 is None:
            return Response(404)
        if len(set1) - 1 < pos or len(set2) - 1 < pos:
            return Response(404)
        c1, c2 = int(set1[pos]), int(set2[pos])
        if mod:
            result = self.backend.modmul(c1, c2, self._parse_modulus(mod))
        else:
            result = c1 + c2 if modparam == "nsqr" else c1 * c2
        return Response.json(J.value_result(str(result)))

    async def _fold_aggregate(self, req: Request, modparam: str) -> Response:
        """`SumAll` / `MultAll`: fold one position across ALL stored
        records — the north-star workload. With the modulus (`nsqr` or
        `pubkey`) the fold is the modular product of the ciphertexts on
        the backend; without it, the plain sum or product."""
        pos = self._pos(req)
        mod = req.query.get(modparam)
        pairs = await self._fetch_stored()
        memo = self._operand_memo
        if memo is not None and memo[0] is pairs and memo[1] == pos:
            # identity match: _fetch_stored returned its memoized pairs, so
            # the extracted column (and its identity, which the resident
            # pool's row-index memo keys on) is unchanged too
            operands = memo[2]
        else:
            operands = [int(v[pos]) for _, v in pairs if pos < len(v)]
            self._operand_memo = (pairs, pos, operands)
        if not operands:
            return Response(404)
        if mod:
            modulus = self._parse_modulus(mod)
            result = None
            if (self._resident is not None
                    and len(operands) >= self._resident_min_fold):
                # the resident plane: one fused gather+fold over the group
                # pools (through Stratum's tier planner when it is on);
                # None only when an operand set is wider than its pool
                # even after a reset, and then the flat fold below runs
                parts = self._owner_operands(pairs, pos)
                folder = (self._stratum.fold_groups if self._stratum is not None
                          else self._resident.fold_groups)
                with tracer.span("proxy.resident_fold", k=len(operands),
                                 shards=len(parts), backend=self.backend.name):
                    result = await asyncio.to_thread(folder, parts, modulus, "")
            if result is None:
                with tracer.span("proxy.fold", k=len(operands),
                                 backend=self.backend.name):
                    result = await self._fold(operands, modulus)
        elif modparam == "nsqr":
            result = sum(operands)
        else:
            result = 1
            for o in operands:
                result *= o
        return Response.json(J.value_result(str(result)))

    # -------------------------------------------------- Prism analytics routes

    def _columns(self, pairs, pos: int) -> tuple[list[str], list[int]]:
        """(keys, ciphertexts) of every stored record holding position
        `pos`, in sorted-key order: the operand column order the analytics
        routes expose (and echo back as `keys`, so clients can line their
        weight matrices up). Memoized per pairs identity like the flat
        operand memo, so the resident pool's row-index memo holds too."""
        memo = self._column_memo
        if memo is not None and memo[0] is pairs and memo[1] == pos:
            return memo[2], memo[3]
        keys = [k for k, v in pairs if pos < len(v)]
        ciphers = [int(v[pos]) for _, v in pairs if pos < len(v)]
        self._column_memo = (pairs, pos, keys, ciphers)
        return keys, ciphers

    async def _analytics(self, name: str, req: Request) -> Response:
        """`MatVec` / `WeightedSum` / `GroupBySum`: server-side Enc(W @ x)
        over the stored records' position-`pos` ciphertexts
        (`analytics/prism.py`). Validation failures raise ValueError (400
        in handle()); the body-size cap answers 413 before the JSON parse,
        so an oversized weight blob never costs one."""
        cap = self.cfg.analytics_max_request_bytes
        if cap > 0 and len(req.body) > cap:
            return Response(
                413,
                f"analytics request body exceeds {cap} bytes".encode(),
            )
        pos = self._pos(req)
        n, n2 = self.prism.parse_nsqr(req.query["nsqr"])
        pairs = await self._fetch_stored()
        keys, ciphers = self._columns(pairs, pos)
        if not ciphers:
            return Response(404)
        body = req.json()
        labels = None
        if name == "MatVec":
            rows = J.parse_weight_matrix(body)
        elif name == "WeightedSum":
            rows = [J.parse_weight_row(body)]
        else:  # GroupBySum: 0/1 selector rollups over record keys
            labels, rows = self.prism.selector_rows(J.parse_groups(body), keys)
        encoded = self.prism.encode_weights(rows, n, cols=len(ciphers))
        out = await self.prism.evaluate(name, ciphers, encoded, n2)
        if name == "WeightedSum":
            return Response.json({"result": str(out[0]), "keys": keys})
        if labels is not None:
            return Response.json(
                {"result": {lb: str(c) for lb, c in zip(labels, out)}}
            )
        return Response.json({"result": [str(c) for c in out], "keys": keys})

    def _owner_operands(self, pairs, pos: int) -> list[tuple[str, list[int]]]:
        """Aggregate operands partitioned by owning shard group, with the
        group id attached (the pool key). Sharding is not ported, so this
        is one anonymous group. Memoized per pairs identity like the flat
        operand memo: the stable operand-list identity is what the pools'
        row-index memos key on."""
        memo = self._owner_memo
        if memo is not None and memo[0] is pairs and memo[1] == pos:
            return memo[2]
        ops = [int(v[pos]) for _, v in pairs if pos < len(v)]
        out = [("", ops)] if ops else []
        self._owner_memo = (pairs, pos, out)
        return out

    def _backend_fold_fn(self):
        """The backend's single-aggregate fold entry point (the
        device-store-aware variant when the backend has one)."""
        return getattr(self.backend, "modmul_fold_resident", self.backend.modmul_fold)

    async def _fold(self, operands: list[int], modulus: int) -> int:
        """Dispatch one aggregate's fold: wide folds go straight to the
        backend on a worker thread, so concurrent aggregates overlap their
        device work and the event loop keeps serving; small folds (below
        the device-batch crossover, where launch latency beats the math)
        enter the coalescing window so CONCURRENT small aggregates share
        one segmented device pass (ProxyConfig.coalesce_window).

        A small fold only enters the window when other folds are already
        executing or queued: observed concurrency is the signal there is
        something to coalesce with, so a lone request pays no extra
        latency."""
        be = self.backend
        min_batch = getattr(be, "min_device_batch", 0)
        concurrent = self._folds_inflight > 0 or bool(self._fold_pending)
        if (
            self.cfg.coalesce_window <= 0
            or not hasattr(be, "modmul_fold_many")
            or len(operands) >= min_batch
            or not concurrent
        ):
            self._folds_inflight += 1
            try:
                return await asyncio.to_thread(self._backend_fold_fn(), operands, modulus)
            finally:
                self._folds_inflight -= 1
        fut = asyncio.get_running_loop().create_future()
        # carry the waiter's trace context and enqueue time into the drain:
        # the dispatcher runs under the DRAINER task's context, so the
        # per-waiter coalesce-wait / fold spans are re-homed explicitly
        self._fold_pending.setdefault(modulus, []).append(
            (time.perf_counter(), operands, fut, obs_context.current())
        )
        if self._fold_drainer is None or self._fold_drainer.done():
            self._fold_drainer = supervised_task(self._drain_folds(),
                                                 name="proxy.fold_drainer")
        return await fut

    async def _drain_folds(self) -> None:
        await asyncio.sleep(self.cfg.coalesce_window)
        while self._fold_pending:
            # snapshot ALL pending groups and dispatch them concurrently:
            # different moduli overlap their dispatches, and draining one at
            # a time would let a continuously re-queued modulus starve others
            groups = list(self._fold_pending.items())
            self._fold_pending.clear()
            await asyncio.gather(*(self._dispatch_fold_group(m, g) for m, g in groups))

    async def _dispatch_fold_group(self, modulus: int, group: list) -> None:
        folds = [ops_ for _, ops_, _, _ in group]
        futs = [f for _, _, f, _ in group]
        t_start = time.perf_counter()
        for t_enq, ops_, _, wctx in group:
            # each waiter's time in the window, in ITS OWN trace
            tracer.record(
                "proxy.coalesce_wait", (t_start - t_enq) * 1e3,
                _ctx=obs_context.child(wctx) if wctx is not None else None,
                batch=len(group), k=len(ops_),
            )
        self._folds_inflight += 1
        try:
            total = sum(len(f) for f in folds)
            if len(folds) == 1 or total < getattr(self.backend, "min_device_batch", 0):
                # a lone fold, or a group whose COMBINED width is still
                # below the device crossover: host folds win there, one
                # worker thread each, as without the window
                fold = self._backend_fold_fn()
                results = await asyncio.gather(
                    *(asyncio.to_thread(fold, f, modulus) for f in folds)
                )
            else:
                results = await asyncio.to_thread(
                    self.backend.modmul_fold_many, folds, modulus
                )
            t_done = time.perf_counter()
            for _, ops_, _, wctx in group:
                # the shared dispatch, visible from every waiter's trace
                tracer.record(
                    "proxy.coalesced_fold", (t_done - t_start) * 1e3,
                    _ctx=obs_context.child(wctx) if wctx is not None else None,
                    batch=len(group), k=len(ops_),
                )
            for f, r in zip(futs, results):
                if not f.cancelled():
                    f.set_result(r)
        except Exception as e:  # surface to every waiting request
            for f in futs:
                if not f.cancelled():
                    f.set_exception(e)
        finally:
            self._folds_inflight -= 1
            # a cancellation (stop() mid-dispatch) must not orphan the
            # group: its futures are no longer in _fold_pending, so stop()'s
            # sweep cannot see them — fail them here
            for f in futs:
                if not f.done():
                    f.set_exception(ConnectionError("proxy stopping"))

    @staticmethod
    def _pos(req: Request) -> int:
        """Parse `position`; negative values are rejected (python negative
        indexing must not leak ciphertext columns)."""
        pos = int(req.query["position"])
        if pos < 0:
            raise ValueError("position must be >= 0")
        return pos

    @staticmethod
    def _parse_modulus(mod: str) -> int:
        """`nsqr` arrives as decimal n^2, `pubkey` as the decimal RSA
        modulus n (the reference's wire format: the bare modulus, not the
        original system's X509 key blob)."""
        return int(mod)
