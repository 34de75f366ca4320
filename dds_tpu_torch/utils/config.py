"""Typed configuration: one dataclass tree, loadable from TOML or JSON.

Trimmed copy of `dds_tpu/utils/config.py`, holding the sections the
ported paths read. Its defaults ARE the north-star topology of
`benchmarks/bft_sum.py`: 4 BFT-ABD replicas with quorum 3 (f = 1), no
sentinent spares, proactive recovery off, in-memory transport, the proxy
on an OS-assigned port, folds on the `cuda` backend. The `[client]`
section configures the generated workload (`run.run_workload`: clients,
operations, proportions and the data table, with the reference's
defaults), the client's keys and its bulk-encryption backend
(`run.load_provider`). `[resident]` and `[storage]` configure the
resident plane and Stratum with the reference's fields and keys. The
`search` plane and `[crypto] secret-device` are not ported yet: enabling
one raises instead of silently serving without it. `[client]
failed-contact-attempts-threshold` is read by no client, so any value but
the reference's default raises too.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ReplicaTopology:
    endpoints: list[str] = field(
        default_factory=lambda: [f"replica-{i}" for i in range(4)]
    )
    byz_quorum_size: int = 3           # 2f+1
    byz_max_faults: int = 1


@dataclass
class SecurityConfig:
    abd_mac_secret: str = "intranet-abd-secret"
    proxy_mac_secret: str = "rest2abd"
    nonce_challenge_increment: int = 1


@dataclass
class RecoveryConfig:
    # proactive recovery needs the supervisor, which is not ported yet
    enabled: bool = False


@dataclass
class ProxySettings:
    host: str = "127.0.0.1"
    port: int = 0                      # 0 = OS-assigned
    crypto_backend: str = "cuda"       # cuda | cpu
    # where the cuda backend's pools live and folds run ("cpu" runs the
    # plain PyTorch path, for hosts without a card)
    device: str = "cuda"
    # host/device fold crossover; None = the backend's measured default
    min_device_batch: Optional[int] = None
    intranet_request_timeout: float = 5.0
    request_budget: float = 8.0
    retry_attempts: int = 0
    retry_backoff: float = 0.3
    retry_max_delay: float = 2.0
    retry_after_hint: float = 1.0
    handler_timeout: float = 0.0       # miniserver backstop, 0 = off
    # seconds concurrent small SumAll folds wait to share one device pass
    # (0 disables coalescing)
    coalesce_window: float = 0.002


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
    # HE key persistence (client.conf:81-88): he_keys_inline is a full
    # HEKeys JSON blob (wins over the path); he_keys_path is loaded when
    # it exists, else fresh keys are generated and saved there (0600)
    he_keys_path: str = ""
    he_keys_inline: str = ""
    # PSSE obfuscators: True = DJN short-exponent blinding, False =
    # textbook full-width r^n
    fast_blinding: bool = True
    # backend whose batched modexp precomputes every full-width PSSE
    # obfuscator of a digest: "cuda" | "cpu"; "" = the per-op host path
    bulk_encrypt_backend: str = ""
    # where the cuda bulk backend runs ("cpu" = its plain PyTorch path)
    device: str = "cuda"

    def __post_init__(self):
        if self.failed_contact_attempts_threshold != 3:
            raise ValueError(
                "[client] failed-contact-attempts-threshold: no client reads it, "
                "so only the reference's default 3 is accepted, not "
                f"{self.failed_contact_attempts_threshold!r}"
            )


@dataclass
class CryptoSettings:
    # the reference's Sanctum device opt-in for the decrypt CRT legs; not
    # ported, so True makes run.load_provider raise
    secret_device: bool = False


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
class PlaneSwitch:
    """A serving plane of the reference that this slice does not port."""

    enabled: bool = False


@dataclass
class DDSConfig:
    replicas: ReplicaTopology = field(default_factory=ReplicaTopology)
    security: SecurityConfig = field(default_factory=SecurityConfig)
    recovery: RecoveryConfig = field(default_factory=RecoveryConfig)
    proxy: ProxySettings = field(default_factory=ProxySettings)
    client: ClientSettings = field(default_factory=ClientSettings)
    crypto: CryptoSettings = field(default_factory=CryptoSettings)
    resident: ResidentConfig = field(default_factory=ResidentConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    search: PlaneSwitch = field(default_factory=PlaneSwitch)
    debug: bool = False

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
    ("DDSConfig", "client"): ClientSettings,
    ("DDSConfig", "crypto"): CryptoSettings,
    ("DDSConfig", "resident"): ResidentConfig,
    ("DDSConfig", "storage"): StorageConfig,
    ("DDSConfig", "search"): PlaneSwitch,
    ("ClientSettings", "data_table"): DataTableConfig,
}
