"""Typed configuration: one dataclass tree, loadable from TOML or JSON.

Copy of `dds_tpu/utils/config.py`: every section, key and default of the
reference, so every file in `configs/` parses here as it does there, and
`run.launch` boots each of them as written. `[client]
failed-contact-attempts-threshold` is read by no client, so any value but
the reference's default raises at parse.

The port's defaults differ from the reference's in these fields only:
- `[replicas]`: 4 endpoints, quorum 3, f = 1 and no `sentinent` spares,
  the north-star topology of `benchmarks/bft_sum.py` (the reference: 9
  endpoints, 2 sentinent, quorum 5), the topology every earlier slice of
  the port measured.
- `[recovery] enabled`: off (the reference: on). That topology has no
  spare for the proactive timer to swap in; `configs/default.toml` and
  `sharded.toml` turn it on and get the reference's behaviour.
- `[proxy] crypto-backend = "cuda"` (the reference: `cpu`) and `port = 0`
  (OS-assigned; the reference: 8443), so several stacks boot in one
  process without a port clash.
- Fields of the port alone: `[proxy] device` and `min-device-batch`, and
  `[client] device`: where the `cuda` backends and the Sanctum device plan
  run ("cpu" runs their plain PyTorch path on hosts without a card) and
  the host/device crossover.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ReplicaTopology:
    # the north-star topology (the reference: 9 endpoints, replica-7 and
    # replica-8 sentinent, quorum 5, f = 2; dds-system.conf:131-132)
    endpoints: list[str] = field(
        default_factory=lambda: [f"replica-{i}" for i in range(4)]
    )
    sentinent: list[str] = field(default_factory=list)
    byz_quorum_size: int = 3           # 2f+1
    byz_max_faults: int = 1
    # Multi-host topology (transport.kind = "tcp" only), mirroring the
    # reference's per-host endpoint URIs + `replicas.local` split
    # (`dds-system.conf:113-128`, `Main.scala:90-99`):
    # - addresses: replica name -> "host:port" of the process hosting it;
    #   unmapped names default to this process's transport address.
    # - local: names THIS process instantiates (empty = every name whose
    #   address resolves to this process).
    # - supervisor_address: "host:port" of the process running the
    #   supervisor (empty = this process).
    addresses: dict = field(default_factory=dict)
    local: list[str] = field(default_factory=list)
    supervisor_address: str = ""


@dataclass
class SecurityConfig:
    abd_mac_secret: str = "intranet-abd-secret"
    proxy_mac_secret: str = "rest2abd"          # dds-system.conf:94 default
    nonce_challenge_increment: int = 1
    transport_frame_secret: str = ""            # empty -> unauthenticated frames
    # mutual TLS on the HTTP hops (certificates/ JKS analogue, SURVEY §2.20).
    # Multi-host deployments MUST pre-provision one shared CA and per-host
    # certs via tls_ca/tls_cert/tls_key; when those are empty a per-node
    # dev CA auto-generates under tls_dir (single-host only — two nodes
    # with independent CAs cannot verify each other).
    tls_enabled: bool = False
    # mutual TLS on the replica/supervisor TCP fabric (the reference's
    # netty-SSL intranet, dds-system.conf:18-58). Shares the tls_* material
    # below; only meaningful with transport.kind = "tcp".
    intranet_tls_enabled: bool = False
    tls_dir: str = "certs"
    tls_ca: str = ""
    tls_cert: str = ""
    tls_key: str = ""
    tls_verify_hostname: bool = False  # reference's accept-all verifier default
    # Per-node transport identity (utils/nodeauth, tcp transport only):
    # binds every frame's claimed src to the sending PROCESS's Ed25519 key,
    # so one compromised member cannot spoof another's sender-keyed quorum
    # votes (WriteAck / Suspect / TagBatchReply). node_key_path holds this
    # process's private key (hex; auto-generated if missing);
    # node_public_keys maps every "host:port" to its public key hex,
    # provisioned like the TLS certs. Enabled when node_public_keys is
    # non-empty.
    node_key_path: str = ""
    node_public_keys: dict = field(default_factory=dict)


@dataclass
class RecoveryConfig:
    # off without spares in the default topology (the reference: on)
    enabled: bool = False
    warm_up: float = 5.0               # dds-system.conf:137
    interval: float = 7.0              # dds-system.conf:138
    sentinent_awake_timeout: float = 5.0
    crashed_recovery_timeout: float = 12.0
    # optional snapshot-to-disk (SURVEY §5.4: replication stays the source
    # of truth; snapshots only warm cold starts). 0 disables.
    snapshot_dir: str = ""
    snapshot_interval: float = 0.0
    # snapshot v2 (core/snapshot.py): generations kept per replica, and an
    # optional explicit MAC-key base for the authenticated footer (empty =
    # derived from security.abd_mac_secret + the node key file when
    # security.node_key_path is provisioned)
    snapshot_keep: int = 3
    snapshot_secret: str = ""
    # Aegis verified state transfer (core/supervisor.py): recovery seeds
    # are cross-checked against a quorum of HMAC-signed state manifests;
    # the recovering node accepts only entries attested by >= f+1 distinct
    # signers. Off = the reference's single-spare trust.
    verified_transfer: bool = True
    manifest_timeout: float = 2.0
    state_chunk_keys: int = 256
    # Merkle anti-entropy (core/antientropy.py): every local replica runs
    # a background pull loop on a jittered timer, so healed partitions,
    # snapshot-restored rejoiners, and post-reseed holes converge without
    # waiting for client reads
    anti_entropy_enabled: bool = True
    anti_entropy_interval: float = 5.0
    anti_entropy_jitter: float = 2.0


@dataclass
class ProxySettings:
    host: str = "127.0.0.1"
    port: int = 0                      # 0 = OS-assigned (the reference: 8443)
    crypto_backend: str = "cuda"       # cuda | cpu (the reference: cpu)
    # where the cuda backend's pools live and folds run ("cpu" runs the
    # plain PyTorch path, for hosts without a card); the port's own field
    device: str = "cuda"
    # host/device fold crossover; None = the backend's measured default
    min_device_batch: Optional[int] = None
    intranet_request_timeout: float = 5.0
    # deadline-propagated retry (utils/retry; see http/server.ProxyConfig):
    # one request_budget per REST request, exponential backoff + full
    # jitter from retry_backoff up to retry_max_delay; retry_attempts > 0
    # adds a hard attempt cap (0 = deadline-governed); exhaustion returns
    # 503 with Retry-After = retry_after_hint seconds
    request_budget: float = 8.0
    retry_attempts: int = 0
    retry_backoff: float = 0.3
    retry_max_delay: float = 2.0
    retry_after_hint: float = 1.0
    handler_timeout: float = 0.0       # miniserver backstop, 0 = off
    # per-coordinator circuit breaker (transient-failure steering that
    # self-heals after breaker_reset seconds via a half-open probe)
    breaker_threshold: int = 3
    breaker_reset: float = 2.0
    key_sync_enabled: bool = False
    key_sync_warm_up: float = 1.0
    key_sync_interval: float = 5.0
    remote_peers: list[str] = field(default_factory=list)
    # stored_keys snapshot file (empty = in-memory only, the reference's
    # lossy behavior); restarted proxies also pull keys from remote_peers
    # at start when key_sync_enabled
    stored_keys_path: str = ""
    # gather window (s) for coalescing concurrent small aggregate folds
    # into one device dispatch; 0 disables
    coalesce_window: float = 0.002


@dataclass
class TransportConfig:
    kind: str = "memory"               # memory | tcp
    host: str = "127.0.0.1"
    port: int = 2552
    # Peer-visible address of this process ("host" or "host:port"); set it
    # whenever the bind address differs from how peers name this process
    # (0.0.0.0 binds, NAT, hostname-vs-IP). Empty = bind address. With
    # per-node identity enabled, launch() fails fast if the advertised
    # address is missing from security.node_public_keys — peers could
    # never verify this process's frames.
    advertise: str = ""


@dataclass
class DataTableConfig:
    max_nr_of_columns: int = 16
    fixed_nr_of_columns: int = 8
    fixed_columns_mappings: list[str] = field(
        default_factory=lambda: ["Int", "String", "Int", "Int", "String", "String", "String", "Blob"]
    )
    fixed_columns_hcrypt: list[str] = field(
        default_factory=lambda: ["OPE", "CHE", "PSSE", "MSE", "CHE", "CHE", "CHE", "None"]
    )


@dataclass
class ClientSettings:
    nr_of_local_clients: int = 1
    nr_of_operations: int = 100
    # parsed, but read by no client (nor by the reference's): only the
    # reference's default is accepted, so a config relying on another value
    # raises instead of silently running without it
    failed_contact_attempts_threshold: int = 3
    http_requests_timeout: float = 10.0
    proportions: dict = field(default_factory=dict)   # op name -> fraction
    data_table: DataTableConfig = field(default_factory=DataTableConfig)
    paillier_bits: int = 2048
    rsa_bits: int = 1024
    # HE key persistence (client.conf:81-88 ships serialized keys so runs
    # are reproducible against existing data; same contract, sane format):
    # - he_keys_path: load HEKeys JSON from this file if it exists; after
    #   generating fresh keys, save them there so the next run (fresh
    #   process) can decrypt yesterday's store.
    # - he_keys_inline: a full HEKeys JSON blob directly in the config
    #   (wins over the path when set).
    he_keys_path: str = ""
    he_keys_inline: str = ""
    # PSSE encryption obfuscators: True = DJN short-exponent blinding
    # (models/paillier.py blind_fast — ~5x cheaper per ciphertext, rests on
    # the DJN subgroup assumption), False = textbook full-width r^n.
    fast_blinding: bool = True
    # route bulk client-side encryption (workload PutSet rows) through this
    # CryptoBackend's batched modexp ("cuda" | "cpu"; empty = host per-op
    # DJN path). Above the batch threshold one device dispatch precomputes
    # every full-width obfuscator a digest needs.
    bulk_encrypt_backend: str = ""
    # where the cuda bulk backend and, with `[crypto] secret-device`, the
    # Sanctum device plan run ("cpu" = their plain PyTorch path); the
    # port's own field
    device: str = "cuda"

    def __post_init__(self):
        if self.failed_contact_attempts_threshold != 3:
            raise ValueError(
                "[client] failed-contact-attempts-threshold: no client reads it, "
                "so only the reference's default 3 is accepted, not "
                f"{self.failed_contact_attempts_threshold!r}"
            )


@dataclass
class FleetObsConfig:
    """Panopticon fleet observability plane (dds_tpu_torch/obs/panopticon):
    every non-proxy Meridian process ships completed span trees, flight
    incidents, and metric/SLO snapshots to the proxy-role collector over
    the existing TcpNet fabric; the collector stitches cross-host traces
    back into single trees for the Watchtower (re-arming quorum audits on
    multi-host splits), federates /fleet/metrics and /fleet/slo, and
    correlates incidents fleet-wide at /fleet/incidents. DEPLOY.md
    "Fleet observability (Panopticon)" is the runbook."""

    enabled: bool = False
    # collector transport "host:port" (the PROXY process's [transport]
    # bind). Empty on the proxy role itself — the collector listens on
    # the process's own TcpNet under the "panopticon" endpoint name.
    collector: str = ""
    # telemetry-batch HMAC secret; empty = derive from
    # security.abd-mac-secret (telemetry is integrity-checked, but a
    # Byzantine host can still lie about its OWN stats — see DEPLOY.md)
    secret: str = ""
    # shipper spool bound (completed span TREES, not spans). Overflow
    # drops the oldest tree and increments
    # dds_fleet_ship_dropped_total{reason="spool_overflow"} — the request
    # path is never blocked by telemetry.
    spool_max: int = 256
    # max span trees per shipped batch and the flush-loop period
    batch_max: int = 32
    flush_interval: float = 0.25
    # how long the collector holds a locally-completed root span before
    # replaying the stitched tree into the Watchtower (remote handler
    # spans must cross a socket + one flush interval to arrive)
    stitch_window: float = 1.0
    # a federated source whose last batch is older than this is marked
    # stale in /fleet/metrics and /fleet/slo (0 disables marking)
    staleness: float = 10.0


@dataclass
class ObsConfig:
    """Telescope (the reference's obs planes) wiring. Env-flag twins exist for harnesses
    that cannot pass a config: DDS_OBS_FLIGHT_DIR / DDS_OBS_FLIGHT_MAX /
    DDS_OBS_FLIGHT_INTERVAL (flight recorder), DDS_OBS_RING /
    DDS_OBS_TRACE (tracer ring size / kill switch)."""

    # GET /metrics (Prometheus text of obs.metrics)
    metrics_route: bool = True
    # GET /_trace (per-span stats; reveals workload shape). `debug = true`
    # also enables it, preserving the old behavior.
    trace_route: bool = False
    # flight recorder: directory for fault-triggered JSONL incident dumps
    # (empty = disabled unless DDS_OBS_FLIGHT_DIR is set)
    flight_dir: str = ""
    flight_max_incidents: int = 32
    # min seconds between incidents of the same kind (a flapping breaker
    # must not fill a disk)
    flight_min_interval: float = 1.0
    # Watchtower online BFT invariant auditor (obs/watchtower): subscribes
    # to completed traces and checks quorum intersection, per-key tag
    # monotonicity, read-sees-latest, anti-entropy repair convergence, and
    # breaker/suspicion state-machine legality; violations become
    # dds_audit_violations_total + flight incidents, never exceptions.
    audit_enabled: bool = True
    # quorum-intersection checks need every replica's handler spans in
    # THIS process's tracer ring; launch() additionally disables them when
    # the topology splits replicas across hosts
    audit_quorum_checks: bool = True
    # SLO engine (obs/slo): per-route latency objectives + error-budget
    # burn-rate windows, served at GET /slo and as dds_slo_* gauges.
    # Default: objective of requests per route answer < latency-ms without
    # a 5xx; per-route overrides under [obs.slo-routes.<Route>].
    slo_route: bool = True
    slo_objective: float = 0.99
    slo_latency_ms: float = 250.0
    slo_fast_window: float = 300.0
    slo_slow_window: float = 3600.0
    # page signal: both windows burning error budget at >= this multiple
    # of the sustainable rate (14.4x = a 30-day budget gone in ~2 days)
    slo_burn_alert: float = 14.4
    # route name -> {"objective": float, "latency-ms": float}
    slo_routes: dict = field(default_factory=dict)
    # Panopticon fleet plane ([obs.fleet] in TOML)
    fleet: FleetObsConfig = field(default_factory=FleetObsConfig)


@dataclass
class ShardConfig:
    """Constellation sharding plane (the reference's shard/; ported, live resharding,
    the plan journal and, over TCP, Meridian included): partition the
    keyspace across `count` independent BFT-ABD quorum groups, each with
    its own replicas, spares, supervisor, anti-entropy loop, and attack
    surface. Point ops route to one group; SumAll/MultAll scatter-gather
    per-shard folds. With `transport.kind = "memory"` the whole
    constellation lives in one process; with `"tcp"` the Meridian plane
    ([fabric] section) spreads groups and proxies across OS processes,
    distributing the signed map via GET /shards + epoch gossip
    (DEPLOY.md "Sharding" and "Multi-host (Meridian)")."""

    enabled: bool = False
    count: int = 2
    # consistent-hash ring positions contributed per group; more vnodes =
    # smoother key balance, marginally slower owner lookups
    vnodes_per_group: int = 16
    # per-group geometry (groups are homogeneous; n = active + spares)
    replicas_per_group: int = 4
    sentinent_per_group: int = 1
    quorum_size: int = 3               # 2f+1 at f=1 for the default 4
    max_faults: int = 1
    # live resharding (shard/rebalance): migration stream chunking and
    # the attestation/ack collection timeouts
    migrate_chunk_keys: int = 256
    manifest_timeout: float = 2.0
    ack_timeout: float = 5.0
    # fence-lease TTL (seconds) for a reshard's freeze installs: a plan
    # whose coordinator crashes before commit heals back to the committed map
    # when the lease expires, so no group stays fenced forever. 0 keeps
    # the legacy forever-fenced-until-next-install behavior. Size it
    # comfortably above freeze->commit under load (attest + stream +
    # one ack timeout)
    fence_lease: float = 30.0
    # directory for the crash-safe reshard plan journal (empty = keep
    # plan state in memory only — fine for tests and ephemeral fleets,
    # but a restarted coordinator then cannot resolve an interrupted plan)
    plan_dir: str = ""


@dataclass
class AnalyticsConfig:
    """The Prism encrypted-analytics plane (`analytics/`): plaintext-matrix
    x Paillier-ciphertext-vector products served as REST routes (POST
    /MatVec, /WeightedSum, /GroupBySum). The proxy sees ciphertexts and the
    client's PLAINTEXT weights, public parameters only, never keys; a
    deployment whose query matrix is sensitive should not use these routes.
    Copy of the reference's `AnalyticsConfig`: the same fields, defaults
    and keys."""

    enabled: bool = True
    # per-request weight-row / group cap (bounds the kernel work one
    # request can demand; DDS_ANALYTICS_MAX_ROWS overrides it, both
    # validated by ops/flags.analytics_max_rows)
    max_rows: int = 256
    # request-body byte cap of the analytics routes (413 beyond; 0 = off)
    max_request_bytes: int = 1048576


@dataclass
class ResidentConfig:
    """The resident ciphertext plane (`resident/`): per-group
    content-addressed limb pools pinned in device memory, write-path
    ingest, and the fused multi-group fold. Device memory per pool is
    rows x L x 4 bytes (L = limbs of the aggregate modulus: 256 for
    Paillier-2048's n^2, 1 KiB a row); past `max-rows` a pool resets and
    re-ingests on demand (or, with `[storage]`, evicts to the warm tier) —
    never a wrong result, only a re-paid ingest. Copy of the reference's
    `ResidentConfig`: the same fields, defaults and keys."""

    enabled: bool = False
    # per-pool capacity: start here, double up to max-rows
    initial_rows: int = 256
    max_rows: int = 65536
    # smallest total aggregate width routed through the fused resident
    # fold; 0 = the backend's own device crossover decides (a cpu-backend
    # proxy with 0 sends every modular aggregate through the plane)
    min_fold: int = 0
    # write-path ingest: committed PutSet/AddElement/WriteElement
    # ciphertexts ingest into existing pools off the request's critical
    # path, coalesced in ingest-window seconds
    write_ingest: bool = True
    ingest_window: float = 0.005


@dataclass
class StorageConfig:
    """Stratum tiered ciphertext storage (`storage/`): device pools (hot),
    a host numpy limb cache (warm) and an append-only HMAC'd segment log
    on disk (cold). Pool overflow then evicts coldest-first instead of
    resetting, and aggregates split into a resident-fused leg plus
    streamed legs merged exactly. Needs `[resident]` enabled (the hot tier
    IS the resident plane); without it no Stratum is built. Copy of the
    reference's `StorageConfig`: the same fields, defaults and keys."""

    enabled: bool = False
    # segment + manifest directory (created on first demotion/boot)
    dir: str = "./stratum"
    # warm-tier host budget: rows are L x 4 bytes (1 KiB at L=256)
    warm_bytes: int = 64 << 20
    # streamed-fold slice: rows per host->device transfer + device fold
    chunk_rows: int = 256
    # promotion: decayed touch score a warm/cold entry must clear to
    # re-enter the device, and the per-fold promotion cap (anti-thrash)
    promote_score: float = 2.0
    max_promote: int = 256
    # popularity decay half-life (seconds) for the tier directory's EWMA
    half_life: float = 60.0
    # manifest generations kept and the live-segment count that triggers
    # compaction
    keep: int = 3
    compact_segments: int = 8


@dataclass
class SearchConfig:
    """The Spyglass encrypted search plane (`search/`): per-group,
    per-column indexes over the DET (equality) and OPE (order/range) column
    families, validated per query with ONE batched tag round and evaluated
    with the `ops/predicate` ops on the plane's device. Off = every
    Search*/Order*/Range request takes the legacy full-keyspace scan. Copy
    of the reference's `SearchConfig`: the same fields, defaults and keys."""

    enabled: bool = False
    # write-path ingest (the resident plane's pattern): committed writes
    # queue their (tag, value) for index upsert off the request path,
    # coalesced in ingest-window seconds; max-pending bounds the queue —
    # overflowed keys simply read as stale at the next query and are
    # repaired
    write_ingest: bool = True
    ingest_window: float = 0.005
    max_pending: int = 8192


@dataclass
class AdmissionConfig:
    """Bulwark overload control (core/admission): per-tenant/
    per-priority-class token buckets and SLO-burn-driven load shedding at
    the REST edge, decided BEFORE a Deadline is minted — rejected
    requests answer 429/503 in microseconds with a Retry-After derived
    from actual refill/breaker state. Priority classes: `interactive`
    (point ops) > `aggregate` (folds/search/analytics) > `background`
    (gossip, unclassified); the shedding ratchet drops the lowest class
    first and recovers one level per `shed-hold` clean evaluations.
    DEPLOY.md "Overload control (Bulwark)" is the runbook."""

    enabled: bool = False
    # tenant attribution header; absent header = the "default" tenant
    tenant_header: str = "x-dds-tenant"
    # per-tenant token buckets, one per priority class: `rate` sustained
    # requests/s refilling up to `burst` capacity. Sized so a single
    # well-behaved tenant never notices them; the point is that ONE hot
    # tenant exhausts its own bucket, not the fleet's Deadline budgets.
    interactive_rate: float = 400.0
    interactive_burst: float = 800.0
    aggregate_rate: float = 64.0
    aggregate_burst: float = 128.0
    background_rate: float = 16.0
    background_burst: float = 32.0
    # route name -> class name overrides (e.g. { "SearchEq" = "background" })
    classes: dict = field(default_factory=dict)
    # shedding controller: evaluated every eval-interval seconds (and
    # lazily under traffic); distress = any SERVED class's multiwindow SLO
    # burn alert firing, or >= breaker-shed-fraction of trusted
    # coordinators refusing traffic. Recovery steps down ONE level after
    # shed-hold consecutive clean evaluations (hysteresis).
    eval_interval: float = 1.0
    shed_hold: int = 3
    # 1 sheds background, 2 also aggregates, 3 also interactive (a full
    # shed: only the exempt /health /metrics /slo /shards keep answering).
    # Default stops at 2 — interactive traffic is never shed unless an
    # operator explicitly allows it.
    max_shed_level: int = 2
    breaker_shed_fraction: float = 0.5
    # storage-layer fast-fail (AbdClient): when ALL of a group's
    # coordinators have open breakers and none will half-open within the
    # remaining budget, degrade instantly instead of burning the Deadline
    fast_fail: bool = True
    # adaptive fold coalescing: size proxy.coalesce-window from the
    # observed fold arrival rate — stretch toward coalesce-max-window
    # until ~coalesce-target-folds arrivals share a dispatch under load,
    # snap back to the base window when idle
    adaptive_coalesce: bool = True
    coalesce_max_window: float = 0.02
    coalesce_target_folds: float = 8.0


@dataclass
class TenancyConfig:
    """Bastion multi-tenant isolation (per-tenant crypto domains +
    blast-radius containment). The `x-dds-tenant` header is ALWAYS
    validated at the REST edge (charset/length clamp, typed 400 on
    garbage, absent = "default"); `enabled = true` additionally turns on
    keyspace ownership enforcement (typed 403 on cross-tenant key
    access), tenant-striped Lodestone pools and Spyglass indexes,
    per-tenant SLO/usage attribution, and weighted-fair admission with
    per-tenant burn-driven shedding. DEPLOY.md "Multi-tenancy (Bastion)"
    is the runbook."""

    enabled: bool = False
    # tracked-tenant cardinality bound shared by admission state, SLO
    # attribution, and the keyring; tenants beyond it fold into an
    # "overflow" aggregate (requests still serve — only attribution
    # coarsens)
    max_tenants: int = 1024
    # weighted-fair admission: tenant id -> relative weight; unlisted
    # tenants get default-weight. Under class overload each tenant's
    # bucket refill contracts to its weight share of the class rate.
    weights: dict = field(default_factory=dict)
    default_weight: float = 1.0
    # per-tenant burn-driven shedding: a tenant whose bad-outcome share
    # exceeds burn-threshold of the distress window is shed by itself
    # (429s for its sheddable classes) for at least shed-hold clean
    # evaluations, instead of ratcheting the whole fleet
    burn_threshold: float = 0.5
    shed_hold: int = 3
    # key lifecycle: rotation grace window (seconds) during which a
    # rotated-out epoch still decrypts (re-encrypt-on-read); key family
    # sizes for lazily-generated tenant keyrings
    rotation_grace: float = 300.0
    paillier_bits: int = 2048
    rsa_bits: int = 1024
    # per-family metric series cap applied to the process registry
    # (obs/metrics cardinality guard)
    metrics_max_series: int = 1024


@dataclass
class CryptoConfig:
    """Sanctum secret-material execution plane (`sanctum/`): where
    computation that TOUCHES private-key material runs — today the CRT
    legs of batched Paillier decryption (client-side verification and
    `HomoProvider.decrypt_rows`). Host-only by default. `secret-device =
    true` is the explicit opt-in that fuses both CRT legs into one
    batched device dispatch: faster bulk decryption, in exchange for
    transient HBM residency of p^2/q^2-derived values (the kernels are
    built from source text alone; every secret is a runtime kernel
    argument, copied to the card per dispatch). The device is `[client]
    device`. The
    DDS_SECRET_DEVICE env twin overrides; both are validated loudly by
    ops/flags.secret_device. DEPLOY.md "Secret-material trust boundary
    (Sanctum)" is the runbook."""

    secret_device: bool = False


@dataclass
class FabricConfig:
    """Meridian multi-host shard fabric (`dds_tpu_torch/fabric`; `admin-routes` also
    gates POST /_reshard and /_helmsman on an in-process proxy): spread a
    Constellation's S quorum groups plus separate proxies across N OS
    processes/hosts over `TcpNet`, from one shared TOML that differs per
    process only in `role` (and transport bind). Active with
    `shard.enabled = true` + `transport.kind = "tcp"`.

    Roles:
    - `"all"`    — the whole constellation (groups + router + REST proxy)
                   in this process, over real sockets;
    - `"group:N"`— only quorum group sN (replicas, spares, supervisor,
                   anti-entropy, Trudy) plus its fabric agent and a
                   status listener serving the signed map at GET /shards;
    - `"proxy"`  — the REST proxy + ShardRouter: bootstraps the shard map
                   from `bootstrap` peers' signed GET /shards, stays
                   fresh via epoch-gossip long-polls, and hosts the
                   reshard controller (POST /_reshard when
                   `admin-routes`).

    `groups` maps every group id (including standby split targets not yet
    in the map) to the TRANSPORT "host:port" of its owning process;
    replica/supervisor/agent endpoint addresses derive from it plus the
    homogeneous [shard] geometry, identically in every process.
    DEPLOY.md "Multi-host (Meridian)" is the runbook."""

    role: str = "all"
    groups: dict = field(default_factory=dict)    # gid -> "host:port"
    # Atlas (dds_tpu_torch/geo): the region THIS process runs in. Surfaces as
    # the `region` label on /health and /metrics (and Panopticon's
    # federation),
    # homes this process's proxy for read-local leases, and keys the
    # [retry] per-region overrides. Empty = geo-unaware.
    region: str = ""
    # REST "host:port" peers serving GET /shards (group status listeners
    # and/or other proxies) — bootstrap + gossip sources
    bootstrap: list[str] = field(default_factory=list)
    # long-poll hold requested from gossip peers (seconds); the serving
    # side caps it at proxy shards_wait_cap
    gossip_wait: float = 25.0
    # group-role status listener (GET /shards + /health + /metrics);
    # empty host = transport.host, port 0 = OS-assigned
    status_host: str = ""
    status_port: int = 0
    # enable POST /_reshard on proxy-role processes (operator control)
    admin_routes: bool = False
    # per-peer bootstrap attempt timeout; agent-RPC ack timeout
    bootstrap_timeout: float = 3.0
    rpc_timeout: float = 5.0
    # total Deadline budget one agent control RPC may spend across
    # retried attempts (rpc_timeout bounds each attempt); 0 derives
    # ~3.5x rpc_timeout
    rpc_budget: float = 0.0


@dataclass
class HelmsmanConfig:
    """Helmsman fleet autoscaler (the reference's fleet/helmsman; ported, started with
    `[shard]` on the in-process Constellation, without it no controller): closes the
    loop from SLO burn to fleet shape — splits a hot group onto a warm
    standby under distress, merges a cold group back when calm, promotes
    a standby over a dead group process. Hysteresis (streaks + cooldown)
    and a migrated-bytes budget keep it from thrashing; `pin` (or the
    controller's runtime `pin()`) freezes the shape for maintenance.
    DEPLOY.md "Self-driving capacity (Helmsman)" is the runbook."""

    enabled: bool = False
    # decision tick period (seconds)
    interval: float = 5.0
    # consecutive hot/cold ticks required before acting
    hot_streak: int = 3
    cold_streak: int = 6
    # a group's share of routed ops that counts as hot / cold
    hot_share: float = 0.5
    cold_share: float = 0.1
    # minimum routed ops per tick for shares to be trusted at all
    min_ops: int = 20
    # fleet shape bounds
    min_groups: int = 1
    max_groups: int = 8
    # quiet period after any action (seconds)
    cooldown: float = 30.0
    # migrated-bytes budget: at most `budget_bytes` of ciphertext may be
    # re-moved per sliding `budget_window` seconds (the BTS cost model —
    # goodput tracks how little you migrate)
    budget_bytes: int = 67108864
    budget_window: float = 600.0
    # a group whose Panopticon heartbeat is older than this is DEAD and
    # its keyspace is promoted onto a standby
    heartbeat_timeout: float = 15.0
    # start pinned (autoscaling frozen, liveness promotion still active)
    pin: bool = False


@dataclass
class GeoConfig:
    """Atlas geo-distribution plane (`dds_tpu_torch/geo`, the in-process
    Constellation): region-aware replica placement, TTL-leased read-local
    quorum geometry, and cross-region anti-entropy pairing. With `enabled = true` the constellation build
    spreads each group's replicas across `regions` (placement = "span")
    or packs groups into round-robin home regions ("home"), carries the
    signed region assignment on the ShardMap, and — when `lease_ttl > 0`
    — installs per-group read-lease tables so an in-region replica can
    answer reads in one hop while every quorum its group closes includes
    the lease holders (the safety argument in `dds_tpu_torch/geo`).
    DEPLOY.md "Geo-distribution (Atlas)" is the runbook."""

    enabled: bool = False
    regions: list[str] = field(default_factory=list)
    placement: str = "span"            # span | home
    # read-local leases: TTL per grant, renew when remaining < margin,
    # and the single-hop LocalRead budget before quorum fallback.
    # lease_ttl = 0 disables leases (placement/labels still apply).
    lease_ttl: float = 2.0
    lease_renew_margin: float = 0.5
    local_read_timeout: float = 0.75
    # anti-entropy cross-region pairing: probability a pull round goes
    # cross-region, plus extra de-synchronising sleep before WAN rounds
    cross_region_bias: float = 0.5
    cross_jitter: float = 0.5


@dataclass
class RetryConfig:
    """Per-region retry/deadline overrides (`[retry]`, Atlas): a proxy in
    a 100-300 ms-RTT region needs different budgets than a same-rack one.
    `profiles` maps a region name to an override table applied over the
    [proxy] defaults for processes whose `[fabric] region` matches:

        [retry.profiles.eu]
        rtt-ms = 120                 # derivation input, see below
        request-budget = 4.0         # explicit keys win over derivation

    With `rtt-ms` set, unset keys derive from one WAN round trip R (the
    floor any cross-region attempt must clear; DEPLOY.md "Geo-
    distribution (Atlas)" documents the rationale): retry-backoff = 2R
    (first backoff outlives one in-flight straggler), retry-max-delay =
    8R, request-budget = 24R (~3 attempts at max backoff), and
    retry-after-hint = 2R."""

    profiles: dict = field(default_factory=dict)

    _KEYS = ("request_budget", "retry_backoff", "retry_max_delay",
             "retry_after_hint", "intranet_request_timeout")

    def overrides_for(self, region: str) -> dict:
        """Effective [proxy]-field overrides for `region` (snake_case
        keys); {} when the region has no profile."""
        prof = {k.replace("-", "_"): v
                for k, v in dict(self.profiles.get(region, {})).items()}
        out: dict = {}
        rtt_ms = prof.pop("rtt_ms", None)
        if rtt_ms is not None:
            rtt = float(rtt_ms) / 1e3
            out["retry_backoff"] = 2.0 * rtt
            out["retry_max_delay"] = 8.0 * rtt
            out["request_budget"] = 24.0 * rtt
            out["retry_after_hint"] = 2.0 * rtt
        unknown = set(prof) - set(self._KEYS)
        if unknown:
            raise ValueError(
                f"unknown [retry.profiles.{region}] keys {sorted(unknown)}"
            )
        for k, v in prof.items():
            out[k] = float(v)
        return out


@dataclass
class ChaosNetConfig:
    """Seeded WAN fault fabric (`[chaos]`, Atlas): named link profiles
    applied to the ChaosNet that `attacks.chaos_enabled` wraps the
    transport in. `profiles` maps a directed ("eu->us") or symmetric
    ("eu<->us") region pair to a WAN preset name ("wan-100" | "wan-200" |
    "wan-300", RTT milliseconds) or an explicit spec table (delay-ms /
    jitter-ms / drop / duplicate / reorder / corrupt) — parsed by
    `dds_tpu_torch/geo/wan.py` (the reference's geo/wan.py), so both
    see the identical seeded WAN. `scale` shrinks every delay uniformly
    (tests run the same topology at a fraction of real time)."""

    profiles: dict = field(default_factory=dict)
    scale: float = 1.0


@dataclass
class AttackConfig:
    enabled: bool = False
    # crash | byzantine | partition | delay | flood | heal (the network
    # attacks need chaos_enabled so a ChaosNet fabric exists to drive).
    # "stale_tag" arms a Meridian group process's replicas as
    # properly-MAC'd stale-read forgers in the reference (its
    # malicious/trudy.StaleTagForger), the cross-host audit regression
    # schedule; the port refuses it until fleet observability is ported.
    type: str = "byzantine"
    # wrap the transport in a seeded ChaosNet (core/chaos.py) and use the
    # Nemesis schedule, so deployments can soak under deterministic network
    # fault schedules; the seed reproduces the exact fault trace
    chaos_enabled: bool = False
    chaos_seed: int = 0


@dataclass
class HeliographConfig:
    """Heliograph active canary plane (`[heliograph]`, `obs/heliograph.py`,
    the reference's obs/heliograph): a supervised async prober per proxy
    (and, in the reference, per Meridian process) owning the reserved
    `__heliograph__` tenant, continuously driving golden transactions
    through the real client crypto path — PutSet -> quorum write ->
    GetSet read-your-write, SumAll/MultAll decrypt-and-compare over a
    known plaintext population, one Spyglass search, one Prism MatVec —
    and verifying every answer by decrypting
    it. Outcomes (ok / slow / wrong-answer / unreachable) land in the
    CanaryLedger (`GET /canary`, `/metrics`, `/health`; the reference
    also federates it as `GET /fleet/canary`), synthetic per-route-class
    SLO streams, a Watchtower incident on wrong-answer, and the
    unreachable-region streaks that the reference's Helmsman reads (no
    caller reads them in the port yet). DEPLOY.md "Active probing
    (Heliograph)" is the runbook."""

    enabled: bool = False
    # seconds between probe cycles (each cycle runs every probe kind once)
    cadence: float = 5.0
    # fraction of cadence randomized per sleep (0.5 = +/-50%): jittered
    # scheduling so a fleet of probers never phase-locks into a thundering
    # herd against one proxy
    jitter: float = 0.5
    # per-probe wall deadline (seconds); a probe past it is `unreachable`
    deadline: float = 2.0
    # latency above which an otherwise-correct probe is verdicted `slow`
    slow_ms: float = 250.0
    # known plaintext rows the canary keyspace holds (aggregate ground truth)
    population: int = 4
    # canary crypto domain key sizes — deliberately small: the prober
    # measures the PIPE, not the modmul kernel, and generates at startup
    paillier_bits: int = 512
    rsa_bits: int = 512
    # explicit rate bound on the canary admission carve-out: probe
    # requests bypass tenant-fair admission but pass a dedicated token
    # bucket, so a wedged/looping prober can never self-DoS the fleet
    rate: float = 20.0
    burst: float = 40.0
    # probe kinds to run (subset of: putget sum mult search matvec)
    probes: list[str] = field(
        default_factory=lambda: ["putget", "sum", "mult", "search", "matvec"])
    # extra proxy targets ("host:port" or "region=host:port") probed
    # round-robin in addition to the local loopback edge — per-region /
    # per-group targeting in fleets; [] probes only the local process
    targets: list[str] = field(default_factory=list)
    # consecutive unreachable probe cycles against one region before the
    # ledger flags it to Helmsman's region_down/promotion signal
    unreachable_streak: int = 3


@dataclass
class DDSConfig:
    replicas: ReplicaTopology = field(default_factory=ReplicaTopology)
    security: SecurityConfig = field(default_factory=SecurityConfig)
    recovery: RecoveryConfig = field(default_factory=RecoveryConfig)
    proxy: ProxySettings = field(default_factory=ProxySettings)
    transport: TransportConfig = field(default_factory=TransportConfig)
    client: ClientSettings = field(default_factory=ClientSettings)
    attacks: AttackConfig = field(default_factory=AttackConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    shard: ShardConfig = field(default_factory=ShardConfig)
    analytics: AnalyticsConfig = field(default_factory=AnalyticsConfig)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    resident: ResidentConfig = field(default_factory=ResidentConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    fabric: FabricConfig = field(default_factory=FabricConfig)
    helmsman: HelmsmanConfig = field(default_factory=HelmsmanConfig)
    tenancy: TenancyConfig = field(default_factory=TenancyConfig)
    crypto: CryptoConfig = field(default_factory=CryptoConfig)
    geo: GeoConfig = field(default_factory=GeoConfig)
    retry: RetryConfig = field(default_factory=RetryConfig)
    chaos: ChaosNetConfig = field(default_factory=ChaosNetConfig)
    heliograph: HeliographConfig = field(default_factory=HeliographConfig)
    debug: bool = False

    # ------------------------------------------------------------- loading

    @staticmethod
    def _build(cls, data):
        if dataclasses.is_dataclass(cls) and isinstance(data, dict):
            fields = {f.name: f for f in dataclasses.fields(cls)}
            kwargs = {}
            for k, v in data.items():
                k = k.replace("-", "_")
                if k not in fields:
                    raise ValueError(f"unknown config key {k!r} for {cls.__name__}")
                sub = _SUBSECTIONS.get((cls.__name__, k))
                kwargs[k] = DDSConfig._build(sub, v) if sub else v
            return cls(**kwargs)
        return data

    @staticmethod
    def from_dict(data: dict) -> "DDSConfig":
        return DDSConfig._build(DDSConfig, data)

    @staticmethod
    def load(path: str | pathlib.Path) -> "DDSConfig":
        p = pathlib.Path(path)
        if p.suffix == ".toml":
            import tomllib

            data = tomllib.loads(p.read_text())
        else:
            data = json.loads(p.read_text())
        return DDSConfig.from_dict(data)


_SUBSECTIONS = {
    ("DDSConfig", "replicas"): ReplicaTopology,
    ("DDSConfig", "security"): SecurityConfig,
    ("DDSConfig", "recovery"): RecoveryConfig,
    ("DDSConfig", "proxy"): ProxySettings,
    ("DDSConfig", "transport"): TransportConfig,
    ("DDSConfig", "client"): ClientSettings,
    ("DDSConfig", "attacks"): AttackConfig,
    ("DDSConfig", "obs"): ObsConfig,
    ("DDSConfig", "shard"): ShardConfig,
    ("DDSConfig", "analytics"): AnalyticsConfig,
    ("DDSConfig", "admission"): AdmissionConfig,
    ("DDSConfig", "resident"): ResidentConfig,
    ("DDSConfig", "storage"): StorageConfig,
    ("DDSConfig", "search"): SearchConfig,
    ("DDSConfig", "fabric"): FabricConfig,
    ("DDSConfig", "helmsman"): HelmsmanConfig,
    ("DDSConfig", "tenancy"): TenancyConfig,
    ("DDSConfig", "crypto"): CryptoConfig,
    ("DDSConfig", "geo"): GeoConfig,
    ("DDSConfig", "retry"): RetryConfig,
    ("DDSConfig", "chaos"): ChaosNetConfig,
    ("DDSConfig", "heliograph"): HeliographConfig,
    ("ClientSettings", "data_table"): DataTableConfig,
    ("ObsConfig", "fleet"): FleetObsConfig,
}
