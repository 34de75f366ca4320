"""REST proxy: the encrypted query engine.

Copy of `dds_tpu/http/server.py`, serving the reference's data routes
with its parameters, JSON shapes and status codes:

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
  `/SearchEntry`, `/SearchEntryOR`, `/SearchEntryAND`: the selections and
  orderings over every stored record, paged by `offset`/`limit` — the
  reference's legacy scans, or with `[search]` its indexed path;
- `POST /MatVec`, `/WeightedSum` and `/GroupBySum` (`position`, `nsqr`):
  Prism's encrypted analytics (`analytics/`), Enc(W @ x) over column p of
  every stored record for a plaintext weight matrix, one row, or 0/1
  group selectors, on the backend's weighted fold; on by default
  (`analytics_enabled`), 413 past `analytics_max_request_bytes`.

Concurrent aggregates whose folds each sit below the backend's
`min_device_batch` coalesce per modulus: they wait `coalesce_window`
seconds and share one `modmul_fold_many` pass on the device (`_fold`, the
reference's coalescer at `dds_tpu/http/server.py:2605-2723`). With
`[admission] adaptive-coalesce` the window is sized from the observed fold
arrival rate instead (`core/admission.AdaptiveCoalescer`).

Every request passes the edge in `handle`: the `x-dds-tenant` header is
validated (400 when malformed; absent is the default tenant) and set as
the request's tenant (`_REQ_TENANT`), then with `[admission]` (Bulwark,
`core/admission`) the controller admits it or answers 429 (the tenant's
class bucket is dry; Retry-After its refill ETA) or 503 (its class is
shed; Retry-After the nearest breaker probe or the ratchet's cadence)
before a Deadline is minted. /health, /metrics and /slo are exempt; the
reserved canary tenant passes its own rate-bounded bucket (`[heliograph]
rate/burst`). Every answered request is classified good or bad by the SLO
engine (`obs/slo`, `GET /slo` with the Watchtower's audit summary and the
admission report, `slo_route_enabled`); its burn alerts and the breaker
census drive the shed ratchet.

With `[tenancy]` (Bastion, `ProxyConfig.tenancy`) the header is an
isolation boundary. Each stored key belongs to the tenant whose PutSet
claimed it (stored keys without a record to the default tenant); a
request touching another tenant's key answers a typed 403 `{"error",
"tenant", "key"}` (a PutSet replaying another tenant's content too), and
every aggregate, analytics route, legacy scan and search-plane query sees
only the caller's records (`_fetch_visible`, `_tenant_stored_keys`). The
resident, Stratum and search planes keep a stripe a tenant
(`_plane_tenant`; the default tenant is the "" stripe). Each answer feeds
the SLO engine's tenant bins, Bulwark's burn-shed window
(`note_outcome`) and Chronoscope's usage ledger; `/health` gains a
`tenants` section and `/metrics` `dds_tenant_stored_keys`. The proxy holds
no tenant key: each tenant folds under its own n^2, and folds still
coalesce by modulus alone. Whether tenancy is on or off, the canary
tenant (`__heliograph__`) sees only its own rows and no other tenant sees
them.

`GET /health` answers the proxy's view of the quorum (active and
reachable replicas, breakers, 503 + Retry-After when fewer than a quorum
are reachable) with a section for each plane it runs and, with local
replicas, `recovery`: each replica's Merkle root, anti-entropy rounds and
snapshot generation. `GET /metrics` (`metrics_route_enabled`, `[obs]
metrics-route`) serves the Prometheus text of `obs.metrics`, state gauges
sampled at scrape time (with the `dds_admission_*`, `dds_slo_*` and
`dds_audit_*` families). With a `supervisor` the proxy asks it for the
freshest active replicas every `replica_refresh_interval` seconds, so a
promoted spare joins its quorum view. `GET /profile` (`?fmt=folded`,
`profile_route_enabled`, on by default) serves Chronoscope's profile,
whose `dds_pipe_*` gauges export at scrape time; `GET /_trace`
(`trace_route_enabled`, `debug` or `[obs] trace-route`) the tracer's span
summary, counters and store size; `POST /_sync` adds a peer's keys to the
aggregate key set (204).

The aggregate key set (`stored_keys`) survives a restart two ways, both
opt-in as in the reference. With `keys_path` the proxy keeps it in a JSON
snapshot — the sorted key list, or `{"keys", "tenants"}` when tenancy has
recorded owners, so a restarted proxy still answers 403 across tenants —
written atomically (tmp + rename) about 200 ms after a burst of PutSets
or RemoveSets, flushed at `stop` and loaded at `start`; the reference's
snapshots load here and the port's there, in both shapes. With
`key_sync_enabled` it pulls `GET /_sync` from each of its `peers` at
start, pushes its set to them (`POST /_sync`) every `key_sync_interval`
seconds after `key_sync_warmup`, and serves `GET /_sync` (404 without
key sync: the set reveals the workload's shape). The set only names the
records an aggregate covers; their values still come from full quorum
reads. With `ssl_server_context` the edge serves HTTPS (mutual TLS when
the context requires client certs); `ssl_client_context` reaches the key
sync peers and the canary's targets.

With `[heliograph] enabled` the proxy starts Heliograph's prober
(`obs/heliograph.py`) once its listener is bound: golden transactions
under the canary tenant against its own loopback edge first, then each
configured target, every answer decrypted and verified. `GET /canary`
serves its report (`{"enabled": false}` without it), `/health` its
`canary` section (`{"status": "disabled"}` without it) and `/metrics` the
`dds_canary_*` gauges; `stop` cancels and awaits its task. /profile,
/_trace and /canary are exempt from admission like /health.

Every other route answers 404. The aggregate and search paths keep the
reference's tag-validated cache and audit exactly: ONE batched tag-only
quorum round validates every cached record per request, a random sample
of cache-served keys is re-read through full quorums, and a
non-corroborated mismatch flushes the cache. The proxy sees ciphertexts
and public parameters only, never keys.

With `[resident]` (`ProxyConfig.resident`) every modular SumAll/MultAll
at least `min-fold` wide runs through the resident plane (`resident/`):
one fused gather+fold over the operands' group pools (one pool a shard
group, one anonymous group unsharded), on the backend's device. Committed writes
queue their ciphertext columns for ingest into the existing pools off the
request path, so the first aggregate after a write ingests nothing. With
`[storage]` as well, Stratum (`storage/`) routes the fold through its
hot/warm/cold planner and pool overflow evicts instead of resetting. The
plane is the cuda backend's own; a host backend (`cpu`) gets the portable
plane on `ProxyConfig.device`, the reference's "default device" (a `cuda`
device without a card raises at construction).

With `[search]` (`ProxyConfig.search`) the twelve Search*, Order* and
Range routes take the search plane (`search/`, the reference's Spyglass):
one batched `read_tags` round validates every index entry per query
(`_spy_validate`; stale and missing keys alone take full ABD reads and are
re-ingested), then the predicate ops run over the packed columns on the
plane's device (`_spy_filter`, `_spy_order`), the answers identical to
the legacy scan's. Committed writes queue their (tag, value) for index
upsert off the request path (RemoveSet a tombstone), an audit flush
invalidates the plane, and with Stratum every selection warms its rows in
the tier directory (`touch_sink` -> `Stratum.touch_keys`).
`dds_search_requests_total{route,path}` counts both paths and
`dds_search_index_total{outcome}` the index's hits, stale and missing keys.

Given a `shard.ShardRouter` in place of one `AbdClient` (a Constellation,
`run.launch` with `[shard]`), the proxy serves the keyspace of S quorum
groups: point routes reach the owning group alone (a `WrongShardError`
fence retries under the request's budget and re-resolves the owner), the
aggregate cache's tag round scatters per group, a modular SumAll/MultAll
below the resident plane folds once a group, concurrently (a group's fold
at or above the device crossover is a device fold of its own; smaller
ones enter the coalescing window like any small fold: one `fold_many`
pass when their combined width reaches the crossover, host folds below
it), and merges the
partials with `parallel/mesh.combine_partials` (`proxy.scatter_fold`); the resident and
search planes keep a pool and an index a group, and Prism one weighted
fold a group. `GET /shards` serves the signed active map, the reshard
state and each group's replicas, with the epoch as its ETag (a matching
`If-None-Match` answers 304, and with a gossip hub (`gossip=`, Meridian's
`fabric.gossip.EpochGossipHub`) `?wait=N` parks the request until the
next epoch bump or `shards_wait_cap`); `/health` gains `shards`, `shard_epoch` and
`reshard_state`, and `/metrics` the `dds_shard_*` gauges. With
`reshard_route_enabled` (`[fabric] admin-routes`) and a reshard controller
(`run.ConstellationReshard`), `POST /_reshard` drives a live split or
merge: an identical request in flight attaches to the running plan, a
replay of a completed one answers the current map, a different plan in
flight answers 409 `{"busy"}` with a Retry-After from its phase, and an
aborted plan 409 `{"aborted"}` with the old map in force. With a Helmsman
(`fleet/`) as well, `POST /_helmsman {"pin": true|false}` freezes or
resumes its autoscaling and `/health` carries its report. Both routes are
exempt from admission, like /health. With a Panopticon collector
(`fleet=`, a Meridian proxy with `[obs.fleet]`, `obs/panopticon.py`),
`GET /fleet/metrics`, `/fleet/slo`, `/fleet/incidents` (`?trace_id=`),
`/fleet/profile` and `/fleet/canary` serve the federated fleet views,
exempt from admission too.
"""

from __future__ import annotations

import asyncio
import contextvars
import heapq
import json
import logging
import math
import os
import pathlib
import random
import ssl
import time
from dataclasses import dataclass, field
from typing import Optional

from dds_tpu_torch.analytics import Prism
from dds_tpu_torch.clt.canary import CanaryTarget, parse_canary_targets
from dds_tpu_torch.core.admission import AdaptiveCoalescer, AdmissionController, TokenBucket
from dds_tpu_torch.core.errors import AllBreakersOpenError, ByzantineError, WrongShardError
from dds_tpu_torch.core.quorum_client import AbdClient
from dds_tpu_torch.core.tenant import (CANARY_TENANT, DEFAULT_TENANT, TenantError,
                                       validate_tenant)
from dds_tpu_torch.http import json_protocol as J
from dds_tpu_torch.http.miniserver import HttpServer, Request, Response, http_request
from dds_tpu_torch.models.backend import CryptoBackend, get_backend
from dds_tpu_torch.models.det import DetKey
from dds_tpu_torch.obs import context as obs_context
from dds_tpu_torch.obs.chronoscope import chronoscope
from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.heliograph import Heliograph
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.obs.slo import SloEngine
from dds_tpu_torch.obs.watchtower import watchtower
from dds_tpu_torch.ops.flags import analytics_max_rows
from dds_tpu_torch.parallel.mesh import combine_partials
from dds_tpu_torch.resident import ResidentPlane
from dds_tpu_torch.search import SearchPlane
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

# the current request's validated tenant, set in handle() next to the
# deadline and read by the ownership checks and the data-plane helpers
_REQ_TENANT: contextvars.ContextVar = contextvars.ContextVar(
    "dds_torch_request_tenant", default=DEFAULT_TENANT
)

# transient storage-layer failures worth retrying; anything else (a
# programming error, a bad request) propagates immediately. WrongShardError
# is the Constellation fence: the retry re-resolves the owner under the
# router's current map
_RETRYABLE = (ByzantineError, WrongShardError, asyncio.TimeoutError,
              NoTrustedNodesError, OSError)

# observability and operator-control routes bypass admission, so operators
# can see why the edge sheds, and reshape the fleet, while it sheds
_ADMISSION_EXEMPT = frozenset({"health", "metrics", "slo", "shards", "fleet", "profile",
                               "_trace", "_reshard", "_helmsman", "canary"})


@dataclass
class ProxyConfig:
    host: str = "127.0.0.1"
    port: int = 0
    # Atlas ([fabric] region): the region this proxy process runs in, on
    # /health and the canary's loopback target
    region: str = ""
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
    # proxy -> proxy key gossip: push the aggregate key set to `peers`
    # ("host:port") every key_sync_interval seconds after key_sync_warmup,
    # pull it from them once at start, serve GET /_sync
    key_sync_enabled: bool = False
    key_sync_warmup: float = 1.0
    key_sync_interval: float = 5.0
    peers: list[str] = field(default_factory=list)
    # the aggregate key set's snapshot ("" = in memory only, so a restart
    # would shrink every aggregate until re-population): written atomically
    # ~200 ms after a burst of mutations, flushed at stop, loaded at start
    keys_path: str = ""
    # Prism's routes (POST /MatVec, /WeightedSum, /GroupBySum): the row cap
    # bounds one request's kernel work (DDS_ANALYTICS_MAX_ROWS overrides
    # it; ops/flags.analytics_max_rows validates whichever wins); the byte
    # cap answers 413 before the body is parsed
    analytics_enabled: bool = True
    analytics_max_rows: int = 256
    analytics_max_request_bytes: int = 1 << 20
    # the resident plane (a utils.config.ResidentConfig; None = off),
    # Stratum under it (a utils.config.StorageConfig; needs the plane) and
    # the search plane (a utils.config.SearchConfig; None = off)
    resident: object = None
    storage: object = None
    search: object = None
    # active-replica refresh from the supervisor (None = no supervisor)
    supervisor: Optional[str] = None
    replica_refresh_interval: float = 5.0
    # the cap on the `wait` a GET /shards long-poll may ask for
    # (If-None-Match + ?wait=N, parked on the server's gossip hub)
    shards_wait_cap: float = 60.0
    # GET /_trace: per-span timing summary, the tracer's counters and the
    # store size. Off by default: it reveals workload shape; launch turns
    # it on with `debug` or `[obs] trace-route`
    trace_route_enabled: bool = False
    # POST /_reshard and POST /_helmsman, the operator's reshape controls
    # (launch sets it from `[fabric] admin-routes`); without a reshard
    # controller (or a Helmsman) wired the routes still 404
    reshard_route_enabled: bool = False
    # GET /metrics (Prometheus text)
    metrics_route_enabled: bool = True
    # GET /slo: per-route objectives and burn state, the Watchtower's audit
    # summary and, with admission on, the admission report
    slo_route_enabled: bool = True
    # GET /profile (Chronoscope's per-route, per-stage profile and slow-trace
    # exemplars; `?fmt=folded` the folded flamegraph text)
    profile_route_enabled: bool = True
    # Bulwark (a utils.config.AdmissionConfig; None or disabled = every
    # request admitted) and [heliograph] (a utils.config.HeliographConfig):
    # its rate/burst size the canary tenant's carve-out bucket, and with
    # `enabled` the prober starts once the listener is bound
    admission: object = None
    heliograph: object = None
    # Bastion (a utils.config.TenancyConfig; None or disabled = one
    # keyspace): key ownership with typed 403s, tenant-scoped aggregates,
    # searches and plane stripes, weighted-fair admission and attribution
    tenancy: object = None
    # TLS (`[security] tls-enabled`): the server context serves HTTPS
    # (mutual auth); the client context reaches the key-sync peers and the
    # canary's targets
    ssl_server_context: object = None
    ssl_client_context: object = None


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
    def __init__(self, abd: AbdClient, config: ProxyConfig | None = None,
                 local_replicas: dict | None = None,
                 slo: SloEngine | None = None, reshard=None, helmsman=None,
                 gossip=None, fleet=None):
        self.abd = abd
        self.cfg = config or ProxyConfig()
        # the Panopticon FleetCollector serving GET /fleet/* (None but on a
        # fleet-enabled Meridian proxy: the routes 404)
        self._fleet = fleet
        # Meridian: the EpochGossipHub parked GET /shards long-polls sleep
        # on; a reshard activation wakes them, `stop` releases them
        self._gossip = gossip
        # `reshard` is the controller behind POST /_reshard (async
        # split(source, target) and merge(source), `phase` and
        # `retry_after()` for the 409's Retry-After); `helmsman` the fleet
        # autoscaler (its report in /health, pinned via POST /_helmsman)
        self._reshard = reshard
        self.helmsman = helmsman
        # the POST /_reshard plan in flight: {"key": (action, source,
        # target), "task"}; an identical request attaches to its task
        self._reshard_inflight: dict | None = None
        # per-route SLO accounting: every request is classified good or
        # bad in handle(); launch passes an engine built from [obs]
        self.slo = slo or SloEngine()
        # this process's replicas (name -> BFTABDNode), read by /health's
        # recovery section and the scrape-time gauges
        self.local_replicas = local_replicas
        self._tasks: list[asyncio.Task] = []
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
        # Constellation: a ShardRouter (duck-typed by its shard_manager)
        # turns point routes into one-group ops and aggregates into
        # per-group folds; a plain AbdClient leaves every path as it was
        self._shards = getattr(abd, "shard_manager", None)
        # (pairs identity, pos, map epoch) -> [(gid, ops)]
        self._owner_memo: tuple | None = None
        # the resident plane: per-group device-resident pools + the fused
        # fold. A cuda backend builds it on its own device; a host backend
        # (`cpu`) gets the portable plane on `device`, the reference's
        # default device for host backends. None when disabled.
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
                    device=self.cfg.device, initial_rows=rescfg.initial_rows,
                    max_rows=rescfg.max_rows,
                )
            self._resident_min_fold = (
                rescfg.min_fold if rescfg.min_fold > 0
                else getattr(self.backend, "min_device_batch", 0)
            )
            self._resident_write_ingest = rescfg.write_ingest
            self._resident_ingest_window = max(0.0, rescfg.ingest_window)
            if self._shards is not None:
                # the group -> placement order pinned up front
                self._resident.register_groups(self.abd.group_ids())
        # the search plane: per-group indexes over the DET/OPE column
        # families, written from the request path (queued, debounced — the
        # resident ingest pattern) and validated per query with one
        # batched read_tags round. Built on the backend's device, or on
        # `device` for a host backend. None when disabled: every Search*/
        # Order*/Range route then takes the legacy scan.
        scfg = self.cfg.search
        self._search: SearchPlane | None = None
        self._search_write_ingest = False
        self._search_ingest_window = 0.005
        self._search_ingest_task: asyncio.Task | None = None
        if scfg is not None and scfg.enabled:
            self._search = SearchPlane(
                max_pending=scfg.max_pending,
                device=getattr(self.backend, "device", self.cfg.device),
            )
            self._search_write_ingest = scfg.write_ingest
            self._search_ingest_window = max(0.0, scfg.ingest_window)
            if self._shards is not None:
                self._search.register_groups(self.abd.group_ids())
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
            if self._search is not None:
                # selections feed the tier directory: keys a query keeps
                # finding hold their fold rows hot
                self._search.touch_sink = self._stratum.touch_keys
        # Prism: the same backend and public-parameter boundary, the
        # router's owner resolver when sharded (one weighted fold a group),
        # and the resident plane, so MatVec operands gather from its pools
        self.prism: Prism | None = None
        if self.cfg.analytics_enabled:
            self.prism = Prism(
                backend=self.backend,
                max_rows=analytics_max_rows(self.cfg.analytics_max_rows),
                owner=(self.abd.owner if self._shards is not None else None),
                resident=self._resident,
            )
        self._column_memo: tuple | None = None  # pairs identity -> columns
        # Bastion: with tenancy the validated x-dds-tenant header is an
        # isolation boundary. The proxy holds no tenant key (the keyring,
        # models/tenancy, is client-side); its tenancy is ownership
        # (typed 403s), plane stripes, tenant-filtered aggregates and
        # attribution. `_tenant_owner` maps each stored key to the tenant
        # whose PutSet claimed it.
        tcfg = self.cfg.tenancy
        self._tenancy_enabled = bool(tcfg is not None and getattr(tcfg, "enabled", False))
        self._tenant_owner: dict[str, str] = {}
        self._tenant_pairs_memo: dict[str, tuple] = {}
        # keys the canary tenant owns, tracked whether tenancy is on or
        # off: aggregates, searches and analytics never fold canary rows
        # into user answers, nor user rows into the canary's
        self._canary_keys: set[str] = set()
        # the stored-keys snapshot's debounce: a pending write, its saver
        self._keys_dirty = False
        self._keys_saver: asyncio.Task | None = None
        # Bulwark: the admission gate and shed ratchet, fed by the SLO
        # engine's burn alerts and the breaker census, and the adaptive
        # coalescing window sized from observed fold arrivals. Both None
        # when admission is off. With tenancy its buckets are weighted-fair
        # and a burning tenant sheds itself.
        acfg = self.cfg.admission
        self.admission: AdmissionController | None = None
        self._coalescer: AdaptiveCoalescer | None = None
        if acfg is not None and getattr(acfg, "enabled", False):
            self.admission = AdmissionController.from_config(
                acfg, alerts=self.slo.alerts, breakers=self._breaker_census,
                tenancy=(tcfg if self._tenancy_enabled else None),
            )
            if getattr(acfg, "adaptive_coalesce", True) and self.cfg.coalesce_window > 0:
                self._coalescer = AdaptiveCoalescer(
                    base_window=self.cfg.coalesce_window,
                    max_window=getattr(acfg, "coalesce_max_window", 0.02),
                    target_folds=getattr(acfg, "coalesce_target_folds", 8.0),
                )
        # the canary tenant's carve-out: it bypasses tenant-fair admission
        # through this dedicated bucket, so a squatter on the reserved id
        # can never flood the edge
        hcfg = self.cfg.heliograph
        self.heliograph: Heliograph | None = None
        self._canary_bucket = TokenBucket(
            float(getattr(hcfg, "rate", 20.0) or 20.0),
            float(getattr(hcfg, "burst", 40.0) or 40.0),
        )
        self._http = HttpServer(self.cfg.host, self.cfg.port, self.handle,
                                self.cfg.ssl_server_context,
                                handler_timeout=self.cfg.handler_timeout)

    async def start(self) -> None:
        self._load_keys()
        await self._http.start()
        self.cfg.port = self._http.port  # resolve OS-assigned port 0
        if self.cfg.key_sync_enabled and self.cfg.peers:
            await self._bootstrap_keys_from_peers()
            self._tasks.append(supervised_task(self._key_sync_loop(),
                                               name="proxy.key_sync"))
        if self.cfg.supervisor:
            if self.abd.cfg.supervisor is None:
                self.abd.cfg.supervisor = self.cfg.supervisor  # pin ActiveReplicas source
            self._tasks.append(supervised_task(self._replica_refresh_loop(),
                                               name="proxy.replica_refresh"))
        if self.admission is not None:
            self._tasks.append(supervised_task(self._admission_loop(),
                                               name="proxy.admission"))
        hcfg = self.cfg.heliograph
        if hcfg is not None and getattr(hcfg, "enabled", False):
            # after the bind: the loopback target needs the resolved port
            self.heliograph = Heliograph(hcfg, self._canary_targets(hcfg),
                                         slo=self.slo, watchtower=watchtower,
                                         ssl_context=self.cfg.ssl_client_context)
            self.heliograph.start()

    def _canary_targets(self, hcfg) -> list[CanaryTarget]:
        """Probe targets: this proxy's own loopback edge first, then each
        configured "host:port" or "region=host:port" entry."""
        host = self.cfg.host
        if host in ("0.0.0.0", "::", ""):
            host = "127.0.0.1"
        targets = [CanaryTarget(host, self.cfg.port, region=self.cfg.region)]
        extra, bad = parse_canary_targets(getattr(hcfg, "targets", []))
        for entry in bad:
            log.warning("heliograph: skipping malformed target %r", entry)
        return targets + extra

    async def _replica_refresh_loop(self) -> None:
        while True:
            self.abd.refresh_from(self.cfg.supervisor)
            await asyncio.sleep(self.cfg.replica_refresh_interval)

    async def stop(self) -> None:
        if self.heliograph is not None:
            await self.heliograph.stop()
        if self._gossip is not None:
            self._gossip.close()  # parked /shards long-polls answer now
        await self._http.stop()
        for task in self._tasks:
            await _cancel_task(task)
        self._tasks.clear()
        if self._ingest_task is not None:
            await _cancel_task(self._ingest_task)
            self._ingest_task = None
        if self._search_ingest_task is not None:
            await _cancel_task(self._search_ingest_task)
            self._search_ingest_task = None
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
        if self._keys_saver is not None:
            await _cancel_task(self._keys_saver)
            self._keys_saver = None
        if self._keys_dirty:
            self._write_keys_snapshot()  # flush pending mutations at shutdown

    # ------------------------------------------------- stored_keys recovery

    def _load_keys(self) -> None:
        """`stored_keys` (and the owner map) from the snapshot at
        `keys_path`, in either shape; an unreadable or malformed file is
        logged and ignored."""
        if not self.cfg.keys_path:
            return
        p = pathlib.Path(self.cfg.keys_path)
        if not p.exists():
            return
        try:
            keys = json.loads(p.read_text())
        except (OSError, ValueError) as e:
            log.warning("ignoring unreadable stored-keys snapshot %s: %s", p, e)
            return
        owners = {}
        if isinstance(keys, dict):
            # the tenancy shape: {"keys": [...], "tenants": {key: tenant}}
            owners = keys.get("tenants") or {}
            keys = keys.get("keys")
        if not isinstance(keys, list):  # hand-edited or corrupted
            log.warning("ignoring malformed stored-keys snapshot %s", p)
            return
        for k in keys:
            if isinstance(k, str):
                self.stored_keys.add(k)
        if isinstance(owners, dict):
            for k, t in owners.items():
                if isinstance(k, str) and isinstance(t, str):
                    self._tenant_owner[k] = t
        self._stored_version += 1
        log.info("recovered %d stored keys from %s", len(self.stored_keys), p)

    def _write_keys_snapshot(self) -> None:
        """Atomic write (tmp + rename): a crash mid-write leaves the
        previous snapshot intact, never a truncated file."""
        self._keys_dirty = False
        p = pathlib.Path(self.cfg.keys_path)
        if self._tenant_owner:
            # ownership rides the snapshot: a restarted proxy keeps refusing
            # cross-tenant access to keys written before it stopped
            body = {"keys": sorted(self.stored_keys),
                    "tenants": dict(self._tenant_owner)}
        else:
            body = sorted(self.stored_keys)
        try:
            p.parent.mkdir(parents=True, exist_ok=True)
            tmp = p.with_name(p.name + ".tmp")
            tmp.write_text(json.dumps(body))
            os.replace(tmp, p)
        except OSError as e:
            log.warning("stored-keys snapshot to %s failed: %s", p, e)

    def _save_keys_soon(self) -> None:
        """Debounced snapshot: a burst of mutations becomes one write."""
        if not self.cfg.keys_path:
            return
        self._keys_dirty = True
        if self._keys_saver is not None and not self._keys_saver.done():
            return

        async def _saver():
            while self._keys_dirty:
                await asyncio.sleep(0.2)
                # off the loop: a large key set must not stall requests
                # (stop writes synchronously; the loop is going down)
                await asyncio.to_thread(self._write_keys_snapshot)

        self._keys_saver = supervised_task(_saver(), name="proxy.keys_saver")

    async def _bootstrap_keys_from_peers(self) -> None:
        """One pull of `GET /_sync` from every peer at start, concurrently,
        so a restarted proxy need not wait for a push; a failed pull is
        logged and never fails the boot."""

        async def pull(peer: str) -> None:
            host, _, port = peer.partition(":")
            try:
                status, body = await http_request(
                    host, int(port), "GET", "/_sync",
                    ssl_context=self.cfg.ssl_client_context, timeout=5.0)
                if status != 200:
                    return
                before = len(self.stored_keys)
                for k in J.parse_keys(json.loads(body)):
                    self._note_stored(k)
                log.info("bootstrapped %d stored keys from peer %s",
                         len(self.stored_keys) - before, peer)
            except (OSError, ValueError, EOFError, asyncio.TimeoutError) as e:
                # EOFError covers IncompleteReadError (a peer closing mid-body)
                log.debug("stored-keys bootstrap from %s failed: %s", peer, e)

        await asyncio.gather(*(pull(p) for p in self.cfg.peers))

    async def _key_sync_loop(self) -> None:
        await asyncio.sleep(self.cfg.key_sync_warmup)
        while True:
            for peer in self.cfg.peers:
                host, _, port = peer.partition(":")
                try:
                    await http_request(
                        host, int(port), "POST", "/_sync",
                        json.dumps(J.keys_result(sorted(self.stored_keys))).encode(),
                        ssl_context=self.cfg.ssl_client_context, timeout=5.0,
                    )
                except ssl.SSLError as e:
                    # loud: under mutual TLS this usually means the peer has
                    # another CA (per-node dev certs on a multi-host
                    # deployment: provision `tls-ca`)
                    log.warning("key-sync peer %s TLS failure: %s", peer, e)
                except OSError:
                    log.debug("key-sync peer %s unreachable", peer)
                except asyncio.TimeoutError:
                    log.debug("key-sync peer %s timed out", peer)
            await asyncio.sleep(self.cfg.key_sync_interval)

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
        try:
            return await retry_deadline(f, deadline, policy, retry_on=_RETRYABLE)
        except _RETRYABLE as e:
            if policy.max_attempts is None:
                raise
            # the attempt cap ran out before the budget: degrade to 503 +
            # Retry-After as an exhausted budget does. The reference lets
            # the last attempt's error through, which answers 500
            raise DeadlineExceededError(
                f"{policy.max_attempts} attempt(s) failed: {e!r}",
                attempts=policy.max_attempts, elapsed=deadline.elapsed(), last_error=e,
            ) from e

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
        if self._search is not None:
            # the search index inherits the cache's completed-op trust
            # argument, so an audit-triggered flush voids it too: the next
            # query rebuilds every entry from full quorum reads
            self._search.invalidate()

    def _note_stored(self, key: str) -> None:
        if key not in self.stored_keys:
            self.stored_keys.add(key)
            self._stored_version += 1
            self._save_keys_soon()

    # ------------------------------------------------------ Bastion tenancy

    def _plane_tenant(self, tenant: str | None = None) -> str:
        """The tenant id as the data planes see it: tenancy off, or the
        default tenant, is the anonymous "" stripe, so single-tenant pool
        keys, group indexes and gauge label sets stay as they were."""
        if not self._tenancy_enabled:
            return ""
        t = tenant if tenant is not None else _REQ_TENANT.get()
        return "" if t == DEFAULT_TENANT else t

    def _key_tenant(self, key: str) -> str | None:
        """The tenant a key belongs to: its ownership record; else the
        default tenant for a stored key (data written before tenancy);
        else None, unclaimed, free for any tenant's first write."""
        t = self._tenant_owner.get(key)
        if t is not None:
            return t
        return DEFAULT_TENANT if key in self.stored_keys else None

    def _note_owner(self, key: str) -> None:
        """Record the writing tenant as `key`'s owner (the first writer
        owns it; `_tenant_denied` refuses any other before this runs).
        Canary ownership is kept with tenancy off too: the scoping of
        `_tenant_pairs` and `_tenant_stored_keys` rests on it."""
        tenant = _REQ_TENANT.get()
        if tenant == CANARY_TENANT and key not in self._canary_keys:
            self._canary_keys.add(key)
            self._tenant_pairs_memo.clear()
        if not self._tenancy_enabled:
            return
        if self._tenant_owner.get(key) != tenant:
            self._tenant_owner[key] = tenant
            self._tenant_pairs_memo.clear()
            self._save_keys_soon()

    def _tenant_denied(self, *keys: str) -> Response | None:
        """A typed 403 when the request's tenant does not own a key it
        touches, else None. Unclaimed keys admit (a first PutSet claims
        one; a read of a missing key answers 404 as always). The refusal
        is counted (`dds_tenant_denied_total`) and flight-recorded: no
        request is ever served another tenant's ciphertexts."""
        if not self._tenancy_enabled:
            return None
        tenant = _REQ_TENANT.get()
        for key in keys:
            owner = self._key_tenant(key)
            if owner is not None and owner != tenant:
                metrics.inc(
                    "dds_tenant_denied_total", tenant=tenant,
                    help="cross-tenant key accesses refused with 403",
                )
                flight.record("tenant_denied", tenant=tenant, key=key)
                return Response.json(
                    {"error": "cross-tenant access denied", "tenant": tenant, "key": key},
                    status=403,
                )
        return None

    def _visible(self, tenant: str):
        """The predicate of the stored keys `tenant` sees. With tenancy:
        its own. Without: the canary tenant exactly its own rows, every
        other tenant every row but the canary's."""
        if self._tenancy_enabled:
            own = self._key_tenant
            return lambda k: own(k) == tenant
        ck = self._canary_keys
        if tenant == CANARY_TENANT:
            return ck.__contains__
        return lambda k: k not in ck

    def _sees_all(self, tenant: str) -> bool:
        return (not self._tenancy_enabled and tenant != CANARY_TENANT
                and not self._canary_keys)

    def _tenant_pairs(self, pairs: list[tuple[str, list]]) -> list:
        """The aggregate and search view filtered to what the request
        tenant sees (`_visible`), memoized per (tenant, pairs identity),
        since the operand and column memos key on the filtered list's
        identity. Tenancy off with no canary key stored: the same list
        object."""
        tenant = _REQ_TENANT.get()
        if self._sees_all(tenant):
            return pairs
        memo = self._tenant_pairs_memo.get(tenant)
        if memo is not None and memo[0] is pairs:
            return memo[1]
        keep = self._visible(tenant)
        filtered = [(k, v) for k, v in pairs if keep(k)]
        self._tenant_pairs_memo[tenant] = (pairs, filtered)
        return filtered

    def _tenant_stored_keys(self) -> list[str]:
        """The sorted stored keys the request tenant sees (the search
        plane's query universe)."""
        tenant = _REQ_TENANT.get()
        if self._sees_all(tenant):
            return sorted(self.stored_keys)
        return sorted(filter(self._visible(tenant), self.stored_keys))

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
        self._note_search_write(key, tag, value)
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
        gid = self._owner(key)
        tenant = self._plane_tenant()
        if self._stratum is not None:
            # popularity only (pure dict math, loop-safe): a rewritten
            # tiered row warms its directory score
            self._stratum.note_write(gid, ciphers, tenant=tenant, key=key)
        if plane.note_write(gid, ciphers, tenant=tenant):
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

    # ------------------------------------------------- search plane ingest

    def _note_search_write(self, key: str, tag, value) -> None:
        """Queue a committed write's (tag, value) for search-index upsert
        off the request path, like the resident ingest. value None
        (RemoveSet) becomes a tombstone so the index never resurrects a
        deleted record. A full queue is safe: the key just reads stale at
        the next query and is repaired there."""
        plane = self._search
        if plane is None or not self._search_write_ingest:
            return
        if plane.note_write(self._owner(key), key, tag, value,
                            tenant=self._plane_tenant()):
            self._search_ingest_soon()

    def _search_ingest_soon(self) -> None:
        """Debounced drain, one task at a time (the _resident_ingest_soon
        pattern): coalesce a write burst into few index-upsert batches on
        a worker thread."""
        if (self._search_ingest_task is not None
                and not self._search_ingest_task.done()):
            return
        # capture the plane: the drain sleeps between batches, and the
        # attribute can be unplugged (shutdown, tests) while it does
        plane = self._search

        async def _drain():
            while plane.pending_ingest():
                await asyncio.sleep(self._search_ingest_window)
                await asyncio.to_thread(plane.ingest_pending)

        self._search_ingest_task = supervised_task(
            _drain(), name="proxy.search_ingest"
        )

    def _owner(self, key: str) -> str:
        """The key's shard group under the router's active map; "", the
        anonymous group, when unsharded."""
        return self.abd.owner(key) if self._shards is not None else ""

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

    async def _fetch_visible(self) -> list[tuple[str, list]]:
        """`_fetch_stored` scoped to the request tenant: the quorum and tag
        machinery validates the whole stored view (one shared round,
        whoever asks), then `_tenant_pairs` keeps the caller's own
        records. Every aggregate, analytics route and legacy scan reads
        through it."""
        return self._tenant_pairs(await self._fetch_stored())

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

    def _breaker_census(self) -> tuple[int, list[float]]:
        """(trusted coordinator count, refusing-breaker half-open ETAs)
        from the storage client; a client without the surface (a test
        stub) reads as healthy."""
        census = getattr(self.abd, "breaker_census", None)
        return census() if census is not None else (0, [])

    def _admission_reject(self, d, route: str) -> Response:
        """One Bulwark rejection: 429 (the tenant's class bucket) or 503
        (the class is shed). No Deadline was minted and no storage work
        ran; Retry-After comes from the bucket's refill ETA, or for a shed
        from the nearest breaker probe or the ratchet's cadence."""
        if d.status == 429:
            retry_after = max(1, math.ceil(d.retry_after)) \
                if 0 < d.retry_after < math.inf \
                else max(1, math.ceil(self.cfg.retry_after_hint))
        else:
            retry_after = self._derive_retry_after(d.retry_after)
        # shed 503s burn the route's SLO budget (they are ours); throttle
        # 429s are the tenant's own rate and do not
        self.slo.observe(route or "root", d.status, 0.0)
        return Response(
            d.status,
            f"admission rejected ({d.reason})".encode(),
            headers={"Retry-After": str(retry_after)},
        )

    async def _admission_loop(self) -> None:
        """Controller heartbeat: decide() ticks the ratchet lazily under
        traffic, and this timer keeps evaluations flowing when the shed
        class is the only traffic, so the level can step down."""
        interval = max(0.05, self.admission.eval_interval)
        while True:
            await asyncio.sleep(interval)
            self.admission.evaluate()

    @staticmethod
    def _tenant_reject(e: TenantError) -> Response:
        """Typed 400 for a malformed tenant header: wire garbage never
        becomes a bucket or metric label."""
        metrics.inc(
            "dds_tenant_header_rejects_total", reason=e.reason,
            help="malformed x-dds-tenant headers refused with 400",
        )
        return Response.json(
            {"error": "invalid tenant header", "reason": e.reason}, status=400,
        )

    async def handle(self, req: Request) -> Response:
        route = req.path.split("/", 2)[1] if "/" in req.path else req.path
        header = self.admission.tenant_header \
            if self.admission is not None else "x-dds-tenant"
        try:
            tenant = validate_tenant(req.headers.get(header))
        except TenantError as e:
            return self._tenant_reject(e)
        adm_ms = None
        decision = None
        if tenant == CANARY_TENANT:
            # the canary carve-out: probes bypass tenant-fair admission but
            # pass their own rate-bounded bucket
            if (route not in _ADMISSION_EXEMPT
                    and not self._canary_bucket.try_acquire()):
                metrics.inc(
                    "dds_canary_throttled_total", route=route or "root",
                    help="canary requests refused by the rate-bounded "
                         "admission carve-out",
                )
                eta = self._canary_bucket.refill_eta()
                return Response(
                    429, b"canary rate bound exceeded",
                    headers={"Retry-After": (
                        "60" if not math.isfinite(eta)
                        else str(max(1, math.ceil(eta))))},
                )
        elif self.admission is not None and route not in _ADMISSION_EXEMPT:
            t_adm = time.perf_counter()
            decision = self.admission.decide(route, tenant)
            adm_ms = (time.perf_counter() - t_adm) * 1e3
            if not decision.admitted:
                return self._admission_reject(decision, route)
        # one budget per request: every storage helper reads it from the
        # context var, so nested retries shrink toward the same deadline
        token = _REQ_DEADLINE.set(Deadline(self.cfg.request_budget))
        ttoken = _REQ_TENANT.set(tenant)
        ctx = obs_context.root()
        t0 = time.perf_counter()
        status = 500
        try:
            with tracer.span(f"http.{req.method}.{route or 'root'}", _ctx=ctx):
                if adm_ms is not None:
                    # decided before the trace root existed: backdated into
                    # the tree as the admission stage
                    tracer.record("proxy.admission", adm_ms,
                                  _ctx=obs_context.child())
                resp = await self._route(req)
            status = resp.status
            return resp
        except (ValueError, KeyError, TypeError) as e:
            status = 400
            return Response.text(f"bad request: {e}", 400)
        except (DeadlineExceededError, NoTrustedNodesError,
                AllBreakersOpenError) as e:
            # the quorum is unreachable within the budget: say when to
            # come back instead of hanging. AllBreakersOpenError is the
            # fast-fail variant and carries the nearest probe's ETA
            status = 503
            log.warning("degraded %s %s: %s", req.method, req.path, e)
            if isinstance(e, DeadlineExceededError):
                kind = "deadline_exceeded"
            elif isinstance(e, AllBreakersOpenError):
                kind = "all_breakers_open"
            else:
                kind = "no_trusted_nodes"
            metrics.inc(
                "dds_degraded_total", route=route or "root", kind=kind,
                help="requests degraded to 503 (budget exhausted / no quorum)",
            )
            # the faulting request's span tree, frozen for post-mortem
            await flight.record_async(
                kind, trace_id=ctx.trace_id, route=route or "root",
                method=req.method, error=str(e),
            )
            return self._unavailable(str(e), getattr(e, "eta", None))
        except Exception:
            log.exception("route failure %s %s", req.method, req.path)
            return Response(500)
        finally:
            _REQ_DEADLINE.reset(token)
            _REQ_TENANT.reset(ttoken)
            dur = time.perf_counter() - t0
            if status != 304 and tenant != CANARY_TENANT:
                # a 304 is a parked gossip long-poll (or a free freshness
                # probe): its held time is the design, not latency. Synthetic
                # canary load never dilutes (or burns) the user routes'
                # objectives
                self.slo.observe(route or "root", status, dur,
                                 tenant=(tenant if self._tenancy_enabled else None))
            if self._tenancy_enabled and tenant != CANARY_TENANT:
                # attribution: the admitted request's outcome feeds the
                # burn-shed window (a flooding tenant's 5xxs count against
                # it, not the fleet) and Chronoscope's usage ledger
                if decision is not None:
                    self.admission.note_outcome(tenant, decision.klass, status < 500)
                chronoscope.note_usage(tenant, route or "root", dur)

    def _unavailable(self, why: str, eta: float | None = None) -> Response:
        """503 with a Retry-After derived from the recovery state."""
        return Response(
            503,
            f"service unavailable: {why}".encode(),
            headers={"Retry-After": str(self._derive_retry_after(eta))},
        )

    async def _route(self, req: Request) -> Response:
        parts = [p for p in req.path.split("/") if p]
        if not parts:
            return Response(404)
        name, arg = parts[0], (parts[1] if len(parts) > 1 else None)
        match (req.method, name):
            case ("GET", "GetSet") if arg:
                if (denied := self._tenant_denied(arg)) is not None:
                    return denied
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
                # content addressing makes another tenant's PutSet of the
                # same content a key collision: the first writer owns the
                # key and the replay is refused like any cross-tenant access
                if (denied := self._tenant_denied(key)) is not None:
                    return denied
                await self._write(key, value)
                self._note_stored(key)
                self._note_owner(key)
                return Response.text(key)

            case ("DELETE", "RemoveSet") if arg:
                if (denied := self._tenant_denied(arg)) is not None:
                    return denied
                await self._write(arg, None)
                if arg in self.stored_keys:
                    # stop aggregating it: the version bump invalidates the
                    # aggregate memos keyed on the stored set
                    self.stored_keys.discard(arg)
                    self._stored_version += 1
                    self._save_keys_soon()
                if self._tenant_owner.pop(arg, None) is not None:
                    self._tenant_pairs_memo.clear()
                if arg in self._canary_keys:
                    self._canary_keys.discard(arg)
                    self._tenant_pairs_memo.clear()
                return Response(200)

            case ("PUT", "AddElement") if arg:
                if (denied := self._tenant_denied(arg)) is not None:
                    return denied
                item = J.parse_item(req.json())
                value = await self._fetch(arg)
                if value is None:
                    return Response(404)
                await self._write(arg, value + [item])
                return Response(200)

            case ("GET", "ReadElement") if arg:
                if (denied := self._tenant_denied(arg)) is not None:
                    return denied
                pos = self._pos(req)
                value = await self._fetch(arg)
                if value is None or pos > len(value) - 1:
                    return Response(404)
                return Response.json({"value": value[pos]})

            case ("PUT", "WriteElement") if arg:
                if (denied := self._tenant_denied(arg)) is not None:
                    return denied
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
                if (denied := self._tenant_denied(arg)) is not None:
                    return denied
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

            # --------------- encrypted search (legacy scan or indexed) ----

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

            case ("POST", "_sync"):
                # a peer's gossip push: the keys join the aggregate key set
                for k in J.parse_keys(req.json()):
                    self._note_stored(k)
                return Response(204)

            case ("GET", "_sync") if self.cfg.key_sync_enabled:
                # a (re)starting peer's pull. Gated like the push side:
                # without key sync it would hand any client the whole
                # record-key set (the workload's shape)
                return Response.json(J.keys_result(sorted(self.stored_keys)))

            case ("GET", "health"):
                return self._health()

            case ("GET", "shards") if self._shards is not None:
                # the ACTIVE signed map (epoch and HMAC, verifiable against
                # the intranet secret), the reshard state and each group's
                # replicas; on whenever sharded, like /health it reveals
                # topology, not workload shape. `If-None-Match` naming the
                # epoch answers 304, and `?wait=N` parks it on the gossip
                # hub, so remote routers get the next bump as a push
                return await self._shards_route(req)

            case ("POST", "_reshard") if (
                self.cfg.reshard_route_enabled and self._reshard is not None
            ):
                # operator control: a live split or merge through the
                # reshard controller. Body {"source": gid[, "target":
                # gid][, "action": "split"|"merge"]}; answers the activated
                # epoch, 409 {"aborted"} (the old map back in force) or
                # 409 {"busy"} with a phase-derived Retry-After while a
                # DIFFERENT plan holds the controller
                return await self._reshard_route(req)

            case ("POST", "_helmsman") if (
                self.cfg.reshard_route_enabled and self.helmsman is not None
            ):
                # manual override: {"pin": true} freezes the fleet shape
                # (autoscaling halts, dead-group promotion keeps running),
                # {"pin": false} resumes. Answers the controller's report
                body = req.json() or {}
                pin = body.get("pin")
                if not isinstance(pin, bool):
                    return Response.text("body must set pin: true|false", 400)
                (self.helmsman.pin if pin else self.helmsman.unpin)()
                return Response.json(self.helmsman.report())

            case ("GET", "canary"):
                # Heliograph's report: per-kind verdicts and latencies,
                # counts, failure exemplars, region streaks
                if self.heliograph is None:
                    return Response.json({"enabled": False})
                return Response.json(self.heliograph.report())

            case ("GET", "fleet") if self._fleet is not None and arg:
                # Panopticon's federation: every fleet process's telemetry,
                # served from the proxy's collector
                if arg == "metrics":
                    # every source's exposition relabelled host/role/shard,
                    # with each source's age and staleness
                    self._sample_state_gauges()
                    self._fleet.sample_gauges()
                    return Response(
                        200,
                        self._fleet.fleet_metrics().encode(),
                        content_type="text/plain; version=0.0.4; charset=utf-8",
                    )
                if arg == "slo":
                    # per-host reports and the fleet rollup: worst-of and
                    # sum-of burn per route and window, resident-pool
                    # pressure per group, shed level per host
                    return Response.json(self._fleet.fleet_slo())
                if arg == "incidents":
                    # shipped flight incidents correlated by trace id, and
                    # the collector-fed Watchtower's verdicts
                    tid = req.query.get("trace_id") or None
                    return Response.json(self._fleet.fleet_incidents(tid))
                if arg == "profile":
                    # every host's dds_pipe_* gauges rolled up into the
                    # fleet-wide bottleneck stage
                    self._sample_state_gauges()
                    return Response.json(self._fleet.fleet_profile())
                if arg == "canary":
                    # every host's dds_canary_* gauges rolled up into per-
                    # host verdicts and the fleet-wide worst-of view
                    self._sample_state_gauges()
                    return Response.json(self._fleet.fleet_canary())
                return Response(404)

            case ("GET", "profile") if self.cfg.profile_route_enabled:
                # Chronoscope's per-route, per-stage profile; ?fmt=folded
                # the flamegraph folded text
                if req.query.get("fmt") == "folded":
                    return Response(
                        200, chronoscope.folded().encode(),
                        content_type="text/plain; charset=utf-8",
                    )
                return Response.json(chronoscope.profile())

            case ("GET", "_trace") if self.cfg.trace_route_enabled:
                # per-span timing summary, the counters under their own key
                # (occurrences, not durations) and the store size; no
                # ciphertext or key leaves
                return Response.json({
                    "spans": tracer.summary(),
                    "counters": tracer.counters(),
                    "stored_keys": len(self.stored_keys),
                })

            case ("GET", "slo") if self.cfg.slo_route_enabled:
                # per-route objective and burn state, the Watchtower's audit
                # summary and, with Bulwark armed, what admission is doing
                body = {"slo": self.slo.report(), "audit": watchtower.stats()}
                if self.admission is not None:
                    body["admission"] = self.admission.report()
                return Response.json(body)

            case ("GET", "metrics") if self.cfg.metrics_route_enabled:
                # state gauges (breakers, suspicion, membership) are sampled
                # at scrape time: scrape-time freshness is all a gauge
                # promises
                self._sample_state_gauges()
                return Response(
                    200,
                    metrics.render().encode(),
                    content_type="text/plain; version=0.0.4; charset=utf-8",
                )
        return Response(404)

    # ------------------------------------------------- health and metrics

    def _health(self) -> Response:
        """Liveness/degradation probe: the active-replica view, the quorum
        requirement, per-coordinator breaker states, each plane's stats
        and, with local replicas, the recovery section. Always on: it
        reveals cluster health, not workload shape."""
        trusted = self.abd.replicas.get_trusted()
        breakers = self.abd.breaker_states()
        # reachable = trusted minus nodes whose breaker refuses traffic
        reachable = [
            n for n in trusted
            if n not in self.abd.breakers or self.abd.breakers[n].allow()
        ]
        shards = None
        if self._shards is not None:
            # sharded: the merged replica pool says nothing about quorum
            # health; each GROUP must hold its own quorum
            shards = self.abd.shards_health()
            degraded = any(s["degraded"] for s in shards.values())
        else:
            degraded = len(reachable) < self.abd.cfg.quorum_size
        health = {
            "status": "degraded" if degraded else "ok",
            "active_replicas": len(trusted),
            "reachable_replicas": len(reachable),
            "quorum_size": self.abd.cfg.quorum_size,
            "breakers": breakers,
            "stored_keys": len(self.stored_keys),
            "request_budget": self.cfg.request_budget,
        }
        if self.cfg.region:
            health["region"] = self.cfg.region
        if self._tenancy_enabled:
            # the ownership footprint and who is shedding itself (never
            # the fleet)
            health["tenants"] = {
                "owned_keys": len(self._tenant_owner),
                "shed": (self.admission.shed_tenants()
                         if self.admission is not None else []),
            }
        if shards is not None:
            health["shards"] = shards
            health["shard_epoch"] = self._shards.epoch
            health["reshard_state"] = self._shards.state
        if self._resident is not None:
            health["resident"] = self._resident.stats()
        if self._stratum is not None:
            health["storage"] = self._stratum.stats()
        if self._search is not None:
            health["search"] = self._search.stats()
        if self.helmsman is not None:
            # pin state, budget, streaks and the recent decisions
            health["helmsman"] = self.helmsman.report()
        recovery = self._recovery_status()
        if recovery is not None:
            health["recovery"] = recovery
        # Heliograph's section, from the ledger's memory alone: a wedged
        # prober reads "stale", never blocks the probe
        health["canary"] = (
            self.heliograph.health_section()
            if self.heliograph is not None else {"status": "disabled"}
        )
        resp = Response.json(health, status=503 if degraded else 200)
        if degraded:
            resp.headers["Retry-After"] = str(self._derive_retry_after())
        return resp

    async def _reshard_route(self, req: Request) -> Response:
        from dds_tpu_torch.shard.rebalance import ReshardAborted

        body = req.json() or {}
        action = body.get("action", "split")
        if action not in ("split", "merge"):
            return Response.text("action must be split or merge", 400)
        source = body.get("source")
        if not isinstance(source, str) or not source:
            return Response.text("missing source group", 400)
        target = body.get("target")
        ctl = self._reshard
        split_fn = getattr(ctl, "split", ctl)
        merge_fn = getattr(ctl, "merge", None)
        if action == "merge" and merge_fn is None:
            return Response.text("merge is not supported by this controller", 400)

        smap = self._shards.current()
        # COMPLETED idempotency: the shape this request asks for already
        # holds, so answer the current map instead of failing the replay
        done = (
            (action == "split" and isinstance(target, str)
             and target in smap.groups and source in smap.groups)
            or (action == "merge" and source not in smap.groups)
        )
        if done and self._reshard_inflight is None:
            return Response.json({"epoch": smap.epoch, "groups": list(smap.groups),
                                  "idempotent": True})

        key = (action, source, target)
        inflight = self._reshard_inflight
        if inflight is not None and inflight["key"] != key:
            # a DIFFERENT plan holds the controller: refuse honestly, with
            # a Retry-After derived from its phase
            ra = getattr(ctl, "retry_after", None)
            retry = float(ra()) if callable(ra) else 5.0
            resp = Response.json(
                {"busy": {"action": inflight["key"][0], "source": inflight["key"][1],
                          "target": inflight["key"][2]},
                 "phase": getattr(ctl, "phase", None)}, status=409,
            )
            resp.headers["Retry-After"] = str(max(1, int(retry + 0.5)))
            return resp
        if inflight is not None:
            task = inflight["task"]  # identical repeat: attach, no new plan
        else:
            async def run():
                # exceptions become results so an attached repeat sees the
                # same outcome instead of racing exception retrieval
                try:
                    if action == "merge":
                        return "ok", await merge_fn(source)
                    return "ok", await split_fn(source, target)
                except ReshardAborted as e:
                    return "aborted", str(e)
                except ValueError as e:
                    # operator error (unknown group, taken target): the
                    # request is wrong, not the fleet
                    return "invalid", str(e)

            task = supervised_task(run(), name=f"reshard-{action}-{source}")
            rec = {"key": key, "task": task}
            self._reshard_inflight = rec
            task.add_done_callback(
                lambda _t, rec=rec: (
                    setattr(self, "_reshard_inflight", None)
                    if self._reshard_inflight is rec else None
                )
            )
        # shield: an impatient client disconnecting must not cancel a
        # half-streamed migration
        status, result = await asyncio.shield(task)
        if status == "invalid":
            return Response.text(result, 400)
        if status == "aborted":
            return Response.json({"aborted": result, "epoch": self._shards.epoch},
                                 status=409)
        new_map = result if hasattr(result, "epoch") else self._shards.current()
        return Response.json({"epoch": new_map.epoch, "groups": list(new_map.groups)})

    async def _shards_route(self, req: Request) -> Response:
        """GET /shards: the router's status with the epoch as its ETag. An
        `If-None-Match` naming the current epoch answers 304; with `?wait=N`
        and a gossip hub it first waits up to N s (at most
        `shards_wait_cap`) for the epoch to move."""
        etag = req.headers.get("if-none-match", "").strip().strip('"')
        if etag and etag == str(self._shards.epoch):
            try:
                wait = float(req.query.get("wait", 0) or 0)
            except ValueError:
                wait = 0.0
            if wait > 0 and self._gossip is not None:
                await self._gossip.wait_change(min(wait, self.cfg.shards_wait_cap))
            if etag == str(self._shards.epoch):
                return Response(304, headers={"ETag": f'"{self._shards.epoch}"'})
        resp = Response.json(self.abd.status())
        resp.headers["ETag"] = f'"{self._shards.epoch}"'
        return resp

    def _derive_retry_after(self, *candidates: float | None) -> int:
        """Retry-After from the recovery state: the nearest breaker
        half-open probe and any caller-supplied ETA (a fast-fail's, a
        shed's), falling back to `retry_after_hint` when nothing is
        pending."""
        vals = [c for c in candidates if c is not None and 0 < c < math.inf]
        _, etas = self._breaker_census()
        vals.extend(e for e in etas if e > 0)
        eta = min(vals) if vals else self.cfg.retry_after_hint
        return max(1, math.ceil(eta))

    _BREAKER_STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}

    def _sample_state_gauges(self) -> None:
        """Refresh scrape-time gauges: breaker and suspicion state per
        coordinator, membership, store size, each plane's gauges, and per
        local replica its anti-entropy divergence and snapshot age."""
        for node, state in self.abd.breaker_states().items():
            metrics.set(
                "dds_breaker_state", self._BREAKER_STATE_CODE.get(state, -1),
                node=node.rsplit("/", 1)[-1],
                help="per-coordinator breaker: 0=closed 1=half_open 2=open",
            )
        for node, strikes in self.abd.replicas.suspicions().items():
            metrics.set(
                "dds_replica_suspicion", strikes, node=node.rsplit("/", 1)[-1],
                help="permanent protocol-violation strikes per replica",
            )
        metrics.set(
            "dds_trusted_replicas", len(self.abd.replicas.get_trusted()),
            help="replicas under the 3-strike suspicion limit",
        )
        metrics.set("dds_stored_keys", len(self.stored_keys),
                    help="aggregate key-set size")
        if self._tenancy_enabled and self._tenant_owner:
            counts_t: dict[str, int] = {}
            for k in self.stored_keys:
                t = self._key_tenant(k)
                if t == CANARY_TENANT:
                    continue  # synthetic keyspace, not a tenant footprint
                counts_t[t] = counts_t.get(t, 0) + 1
            for t, n in counts_t.items():
                metrics.set(
                    "dds_tenant_stored_keys", n, tenant=t,
                    help="stored aggregate keys per tenant (proxy view)",
                )
        if self._shards is not None:
            smap = self._shards.current()
            metrics.set("dds_shard_epoch", smap.epoch,
                        help="active shard-map epoch")
            metrics.set(
                "dds_shard_reshard_state",
                1 if self._shards.state == "resharding" else 0,
                help="0=stable 1=resharding",
            )
            metrics.set("dds_shard_groups", len(smap.groups),
                        help="quorum groups in the active shard map")
            counts = {g: 0 for g in smap.groups}
            for k in self.stored_keys:  # the proxy's aggregate-key view
                owner = smap.owner(k)
                counts[owner] = counts.get(owner, 0) + 1
            for gid, n in counts.items():
                metrics.set(
                    "dds_shard_keys", n, shard=gid,
                    help="stored aggregate keys per shard (proxy view)",
                )
        # Bulwark: the shed level is set at transition time too, but a
        # scrape between transitions still deserves the truth; the
        # coalescing window is pure scrape-time state
        if self.admission is not None:
            metrics.set(
                "dds_admission_shed_level", self.admission.shed_level,
                help="Bulwark shed level (0=none; higher sheds lower "
                     "priority classes first)",
            )
        if self._coalescer is not None:
            metrics.set(
                "dds_admission_coalesce_window_seconds",
                self._coalescer.window(),
                help="current adaptive fold-coalescing window",
            )
        if self._resident is not None:
            self._resident.export_gauges(metrics)
        if self._stratum is not None:
            self._stratum.export_gauges(metrics)
        if self._search is not None:
            self._search.export_gauges(metrics)
        # Chronoscope's dds_pipe_* gauges: per-route, per-stage self-times
        chronoscope.export_gauges(metrics)
        metrics.set(
            "dds_queue_depth",
            sum(len(g) for g in self._fold_pending.values()),
            queue="fold-coalescer",
            help="entries waiting in a bounded pipeline queue",
        )
        metrics.set(
            "dds_metrics_dropped_series", metrics.overflow_total(),
            help="total label sets dropped into overflow series by the "
                 "per-family cardinality cap",
        )
        # Heliograph's dds_canary_* gauges: last verdict and last-ok age a
        # kind, failure exemplars, unreachable regions
        if self.heliograph is not None:
            self.heliograph.export_gauges(metrics)
        # SLO burn and budget gauges, and the audit backlog (the violation
        # counter increments at detection time in the auditor itself)
        self.slo.export_gauges(metrics)
        wt = watchtower.stats()
        metrics.set("dds_audit_traces_audited", wt["traces_audited"],
                    help="traces audited by the Watchtower since start")
        metrics.set("dds_audit_pending_traces", wt["pending_traces"],
                    help="in-flight traces buffered awaiting audit")
        for node in (self.local_replicas or {}).values():
            stats = node.antientropy.stats()
            metrics.set(
                "dds_antientropy_divergent_buckets",
                stats["divergent_buckets"], replica=node.name,
                help="divergent Merkle buckets seen in the last sync round",
            )
            if stats["last_sync_age"] is not None:
                metrics.set(
                    "dds_antientropy_last_sync_age_seconds",
                    stats["last_sync_age"], replica=node.name,
                    help="seconds since the last completed anti-entropy round",
                )
            sm = node.snapshot_meta
            if sm.get("generation") is not None:
                metrics.set(
                    "dds_snapshot_generation", sm["generation"],
                    replica=node.name,
                    help="latest snapshot generation written or loaded",
                )
            if sm.get("saved_at"):
                metrics.set(
                    "dds_snapshot_age_seconds",
                    max(0.0, time.time() - sm["saved_at"]), replica=node.name,
                    help="seconds since this replica's snapshot was written",
                )

    def _recovery_status(self) -> dict | None:
        """Per-local-replica recovery view for /health: anti-entropy sync
        state and snapshot durability state."""
        if not self.local_replicas:
            return None
        out = {}
        for node in self.local_replicas.values():
            stats = node.antientropy.stats()
            sm = node.snapshot_meta
            out[node.name] = {
                "merkle_root": node.merkle.root()[:16],
                "tracked_keys": len(node.merkle),
                "anti_entropy": {
                    "rounds": stats["rounds"],
                    "repaired_keys": stats["repaired_keys"],
                    "divergent_buckets": stats["divergent_buckets"],
                    "last_sync_age": stats["last_sync_age"],
                    "running": stats["running"],
                },
                "snapshot": {
                    "generation": sm.get("generation"),
                    "age": (
                        max(0.0, round(time.time() - sm["saved_at"], 3))
                        if sm.get("saved_at") else None
                    ),
                    "verify_failures": metrics.value(
                        "dds_snapshot_verify_failures_total",
                        replica=node.name,
                    ) or 0,
                },
            }
        return out

    # ------------------------------------------------------- search routes

    async def _spy_validate(self) -> list[str]:
        """Freshness for one indexed query: validate every stored key's
        index entry with ONE batched `read_tags` fingerprint round (the
        `_fetch_stored` linearizability argument verbatim — entries come
        from completed quorum ops, and honest replies can never deflate
        the quorum-max tag below a completed write). Only stale or
        missing keys take full ABD reads, re-ingesting as they land.
        Returns the sorted stored keys; afterwards every one has a
        validated index entry, so indexed results are exactly the legacy
        scan's."""
        plane = self._search
        pt = self._plane_tenant()
        keys = self._tenant_stored_keys()
        if not keys:
            return keys
        cached: list[str] = []
        cached_tags: list = []
        missing: list[str] = []
        for k in keys:
            t = plane.tag(self._owner(k), k, tenant=pt)
            if t is None:
                missing.append(k)
            else:
                cached.append(k)
                cached_tags.append(t)
        stale = list(missing)
        if cached:
            try:
                dl = self._request_deadline()
                digest = sigs.key_from_set(cached)
                fp = sigs.tags_fingerprint(cached_tags)
                tags = await self._retry(
                    lambda: self.abd.read_tags(
                        cached, digest=digest, fingerprint=fp,
                        cached_tags=cached_tags, deadline=dl,
                    ),
                    dl,
                )
                if tags is not cached_tags:
                    # identity return = every vote said "unchanged";
                    # otherwise compare per key
                    stale.extend(
                        k for k, t, ct in zip(cached, tags, cached_tags)
                        if t != ct
                    )
            except Exception as e:  # validation trouble => full refetch
                log.debug("search tag validation failed (%s); refetch", e)
                stale = list(keys)
        if stale:
            results = await asyncio.gather(
                *(self._fetch_tagged(k) for k in stale),
                return_exceptions=True,
            )
            for k, r in zip(stale, results):
                if isinstance(r, Exception):
                    raise r
                value, tag, _coord = r
                plane.upsert(self._owner(k), k, tag, value, tenant=pt)
        metrics.inc(
            "dds_search_index_total", max(0, len(keys) - len(stale)),
            outcome="hit", help="Spyglass index keys per query by outcome",
        )
        metrics.inc(
            "dds_search_index_total", max(0, len(stale) - len(missing)),
            outcome="stale", help="Spyglass index keys per query by outcome",
        )
        metrics.inc(
            "dds_search_index_total", len(missing), outcome="miss",
            help="Spyglass index keys per query by outcome",
        )
        return keys

    def _spy_partition(self, keys: list[str]) -> dict[str, list[str]]:
        """Stored keys by owning shard group (one anonymous group when
        unsharded): the scatter side of a query's per-group dispatch."""
        if self._shards is None:
            return {"": keys}
        parts: dict[str, list[str]] = {}
        for k in keys:
            parts.setdefault(self.abd.owner(k), []).append(k)
        return parts

    async def _spy_filter(self, evalfn) -> list[str]:
        """One indexed selection query: validate, dispatch `evalfn` per
        group concurrently (each group's predicate ops run on a worker
        thread), union the key sets, and return them in sorted-key order —
        exactly the legacy scan's output order."""
        keys = await self._spy_validate()
        if not keys:
            return []
        parts = self._spy_partition(keys)
        pt = self._plane_tenant()
        with tracer.span("proxy.search_eval", k=len(keys), shards=len(parts)):
            sets = await asyncio.gather(
                *(asyncio.to_thread(evalfn, self._search.group(gid, tenant=pt))
                  for gid in parts)
            )
        selected = set().union(*sets)
        hits = [k for k in keys if k in selected]
        self._search.note_selected(hits, pt)
        return hits

    async def _spy_order(self, pos: int, descending: bool) -> list[str]:
        """One indexed order-by query: per-group device-sorted runs merged
        on the host. Run elements are (comparable, key) with the comparable
        negated for descending order, so `heapq.merge` reproduces the
        global stable sort — ties in ascending key order, like the legacy
        stable `sorted` over sorted-key pairs."""
        keys = await self._spy_validate()
        if not keys:
            return []
        parts = self._spy_partition(keys)
        pt = self._plane_tenant()
        with tracer.span("proxy.search_eval", k=len(keys), shards=len(parts)):
            runs = await asyncio.gather(
                *(asyncio.to_thread(self._search.group(gid, tenant=pt).eval_order,
                                    pos, descending)
                  for gid in parts)
            )
        stored = set(keys)
        ordered = [k for _, k in heapq.merge(*runs) if k in stored]
        self._search.note_selected(ordered, pt)
        return ordered

    @staticmethod
    def _page_params(req: Request) -> tuple[int, int | None]:
        """`offset`/`limit` pagination params (every search/order route,
        both paths): non-negative ints, ValueError -> 400 via handle()."""
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

    @staticmethod
    def _count_search(route: str, path: str) -> None:
        metrics.inc(
            "dds_search_requests_total", route=route, path=path,
            help="search/order/range requests by evaluation path",
        )

    async def _order_route(self, name: str, req: Request) -> Response:
        pos = self._pos(req)
        page = self._page_params(req)
        descending = name == "OrderLS"
        if self._search is not None:
            self._count_search(name, "indexed")
            return self._page_response(
                await self._spy_order(pos, descending), page
            )
        self._count_search(name, "legacy")
        pairs = await self._fetch_visible()
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
        if self._search is not None:
            self._count_search(name, "indexed")
            keyset = await self._spy_filter(
                lambda idx: idx.eval_eq(pos, item, want_eq)
            )
            return self._page_response(keyset, page)
        self._count_search(name, "legacy")
        pairs = await self._fetch_visible()
        keyset = [
            k for k, v in pairs
            if pos < len(v) and DetKey.compare(str(v[pos]), item) == want_eq
        ]
        return self._page_response(keyset, page)

    _CMP_OPS = {"SearchGt": "gt", "SearchGtEq": "ge",
                "SearchLt": "lt", "SearchLtEq": "le"}

    async def _cmp_route(self, name: str, req: Request) -> Response:
        pos = self._pos(req)
        item = int(J.parse_item(req.json()))
        page = self._page_params(req)
        if self._search is not None:
            self._count_search(name, "indexed")
            keyset = await self._spy_filter(
                lambda idx: idx.eval_compare(pos, self._CMP_OPS[name], item)
            )
            return self._page_response(keyset, page)
        self._count_search(name, "legacy")
        pairs = await self._fetch_visible()
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
        if self._search is not None:
            self._count_search("Range", "indexed")
            keyset = await self._spy_filter(
                lambda idx: idx.eval_range(pos, lo_bound, hi_bound)
            )
            return self._page_response(keyset, page)
        self._count_search("Range", "legacy")
        pairs = await self._fetch_visible()
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
        mode = "all" if name == "SearchEntryAND" else "any"
        page = self._page_params(req)
        if self._search is not None:
            self._count_search(name, "indexed")
            keyset = await self._spy_filter(
                lambda idx: idx.eval_entry(vals, mode)
            )
            return self._page_response(keyset, page)
        self._count_search(name, "legacy")
        pairs = await self._fetch_visible()
        if mode == "all":
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
        if (denied := self._tenant_denied(key1, key2)) is not None:
            return denied
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
        pairs = await self._fetch_visible()
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
                    result = await asyncio.to_thread(folder, parts, modulus,
                                                     self._plane_tenant())
            if result is not None:
                return Response.json(J.value_result(str(result)))
            shard_ops = (self._shard_operands(pairs, pos)
                         if self._shards is not None else None)
            if shard_ops is not None and len(shard_ops) > 1:
                # Constellation scatter-gather: one fold a group, all
                # dispatched at once through `_fold` (each group at or
                # above the device crossover folds on the device by
                # itself; smaller ones enter the coalescing window), then the
                # partials' modular product; every group shares one
                # modulus, so the result is bit-identical to the
                # unsharded fold
                with tracer.span("proxy.scatter_fold", k=len(operands),
                                 shards=len(shard_ops), backend=self.backend.name):
                    partials = await asyncio.gather(
                        *(self._fold(g, modulus) for g in shard_ops)
                    )
                    result = combine_partials([int(p) for p in partials], modulus)
            else:
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
        pairs = await self._fetch_visible()
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
        out = await self.prism.evaluate(name, keys, ciphers, encoded, n2,
                                        tenant=self._plane_tenant())
        if name == "WeightedSum":
            return Response.json({"result": str(out[0]), "keys": keys})
        if labels is not None:
            return Response.json(
                {"result": {lb: str(c) for lb, c in zip(labels, out)}}
            )
        return Response.json({"result": [str(c) for c in out], "keys": keys})

    def _owner_operands(self, pairs, pos: int) -> list[tuple[str, list[int]]]:
        """Aggregate operands partitioned by owning shard group, with the
        group id attached (the pool key); unsharded proxies get one
        anonymous group. Memoized per pairs identity like the flat operand
        memo (the stable operand-list identities are what the pools'
        row-index memos key on) AND on the active map's epoch: a split,
        merge or takeover keeps every tag, so the pairs list can outlive
        it, and the next aggregate must group under the new owners. (The
        reference keys on the pairs alone and keeps the old grouping,
        `dds_tpu/http/server.py::_owner_operands`.)"""
        epoch = self._shards.current().epoch if self._shards is not None else -1
        memo = self._owner_memo
        if memo is not None and memo[0] is pairs and memo[1] == pos and memo[2] == epoch:
            return memo[3]
        groups: dict[str, list[int]] = {}
        for k, v in pairs:
            if pos < len(v):
                groups.setdefault(self._owner(k), []).append(int(v[pos]))
        out = [(gid, g) for gid, g in groups.items() if g]
        self._owner_memo = (pairs, pos, epoch, out)
        return out

    def _shard_operands(self, pairs, pos: int) -> list[list[int]]:
        """Aggregate operands partitioned by owning shard group: the
        memoized `_owner_operands` lists, so each group's fold keeps its
        operand-list identity between writes."""
        return [g for _, g in self._owner_operands(pairs, pos)]

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
        if self._coalescer is not None:
            # every fold arrival feeds the rate the adaptive window is
            # sized from, whichever path it takes below
            self._coalescer.note_fold(len(operands))
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

    def _coalesce_window(self) -> float:
        """This drain's gather window: adaptive (sized from the observed
        fold arrival rate) when Bulwark armed it, else the config
        constant."""
        if self._coalescer is not None:
            return self._coalescer.window()
        return self.cfg.coalesce_window

    async def _drain_folds(self) -> None:
        await asyncio.sleep(self._coalesce_window())
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
