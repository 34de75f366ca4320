"""System bootstrap: the replicas and the REST proxy of one deployment.

Trimmed copy of `dds_tpu/run.py`. `launch(cfg)` boots the topology the
config describes — by default the north-star one of
`benchmarks/bft_sum.py`: 4 BFT-ABD replicas, quorum 3 (f = 1), no spares,
proactive recovery off, the in-memory transport, and the proxy on an
OS-assigned port folding on the `cuda` backend. The dependability plane
comes up as the reference wires it: `[replicas] sentinent` spares start
sentinent, the supervisor (`core/supervisor.py`) answers suspicion
quorums and with `[recovery] enabled` proactively recovers the oldest
active replica every `interval` seconds, redeploying a crashed one
through the launch's factory; `[recovery] snapshot-dir` restores replica
snapshots at boot (and saves every `snapshot-interval` seconds),
`anti-entropy-enabled` starts each replica's Merkle sync loop, `[obs]
flight-dir` arms the flight recorder and `[attacks] enabled` lets Trudy's
crash or byzantine attack through (`dep.trudy`, fired by
`run_workload`). `Deployment.stop` cancels and awaits every loop.
`[resident]`, `[storage]` and
`[search]` reach the proxy as their config sections, so Stratum keeps its
segment log in `[storage] dir` and the search plane indexes the
Search*/Order*/Range columns, and `[analytics]` arms Prism's routes (on
by default). The REST edge comes up as the reference wires it: `[admission]`
(Bulwark's buckets, shed ratchet and adaptive coalescing window), the SLO
engine built from `[obs]` (`GET /slo` with `slo-route`, `GET /_trace`
with `debug` or `trace-route`, `GET /profile`) and `[heliograph]`: its
rate/burst size the canary tenant's bucket and with `enabled` the proxy
starts Heliograph's prober against its own edge and the file's targets
(`GET /canary`); `[tenancy]` (Bastion) makes
the tenant header an isolation boundary at the proxy (key ownership,
tenant-scoped aggregates and plane stripes, weighted-fair admission,
attribution), its `metrics-max-series` capping the process registry
first. With `[obs] audit-enabled` the process-wide Watchtower is reset,
configured for this topology (quorum `byz-quorum-size`, the endpoints less
the spares, quorum checks as `audit-quorum-checks` says, every replica
being local) and attached to the tracer last, then Chronoscope (always,
as the reference's single-process launch does; `DDS_OBS_PIPE=0` keeps it
dormant); `Deployment.stop` detaches both and resets Chronoscope. A config
that enables a plane the port does not serve (`unported_plane`) is refused
with `NotImplementedError` naming it, so every file in `configs/` parses
but none boots without what it asks for; `configs/default.toml`,
`configs/tenancy.toml` and `configs/heliograph.toml` boot.
`load_provider(cfg)` builds the
client's HE provider from the `[client]` section: its keys, its bulk
encryption backend (`bulk-encrypt-backend = "cuda"` precomputes PSSE
obfuscators with the exp kernel) and, with `[crypto] secret-device`, the
Sanctum handle that runs bulk decryption's CRT legs on the card.
`run_workload(dep)` drives
`[client] nr-of-local-clients` concurrent clients over digests the
workload generator draws from `[client] proportions`, and with `[attacks]
enabled` triggers Trudy 0.1 s in, her victims drawn from the same seeded
rng. The TCP transport, ChaosNet and Nemesis wait for later slices.

Run the deployment and a generated workload, print each client's report,
and with --serve keep serving until interrupted (on a host without a card,
pass --device cpu; --backend picks the proxy's crypto backend, as the
reference's flag does):

    python -m dds_tpu_torch.run --ops 100 --seed 7 [--serve] [--port 8443]
    python -m dds_tpu_torch.run --config configs/default.toml --backend cuda
    python -m dds_tpu_torch.run --config configs/default.toml --device cpu --backend cpu
    python -m dds_tpu_torch.run --config configs/tenancy.toml --backend cuda
    python -m dds_tpu_torch.run --config configs/heliograph.toml --port 0 --backend cuda
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import pathlib
import random
from dataclasses import dataclass, field

from dds_tpu_torch.clt.client import ClientConfig, DDSHttpClient
from dds_tpu_torch.clt.generator import generate
from dds_tpu_torch.clt.instructions import Digest
from dds_tpu_torch.core import snapshot as snap
from dds_tpu_torch.core.quorum_client import AbdClient, AbdClientConfig
from dds_tpu_torch.core.replica import BFTABDNode, ReplicaConfig
from dds_tpu_torch.core.supervisor import BFTSupervisor, SupervisorConfig
from dds_tpu_torch.core.transport import InMemoryNet
from dds_tpu_torch.http.server import DDSRestServer, ProxyConfig
from dds_tpu_torch.malicious.trudy import AttackType, Trudy
from dds_tpu_torch.models.backend import get_backend
from dds_tpu_torch.models.facade import HomoProvider
from dds_tpu_torch.models.keys import HEKeys
from dds_tpu_torch.obs.chronoscope import chronoscope
from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.obs.slo import SloEngine
from dds_tpu_torch.obs.watchtower import watchtower
from dds_tpu_torch.ops.flags import secret_device
from dds_tpu_torch.sanctum import SecretBackend
from dds_tpu_torch.utils.config import DDSConfig
from dds_tpu_torch.utils.tasks import supervised_task
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.run")

SUPERVISOR_NAME = "supervisor"


@dataclass
class Deployment:
    cfg: DDSConfig
    net: InMemoryNet
    replicas: dict[str, BFTABDNode]
    server: DDSRestServer
    supervisor: BFTSupervisor | None = None
    trudy: Trudy | None = None
    # loops launch started (anti-entropy, snapshots): each has `stop()`
    _stoppables: list = field(default_factory=list)
    # the flight recorder's directory before launch configured it
    _flight_dir: str | None = None

    async def stop(self) -> None:
        if self.supervisor is not None:
            await self.supervisor.stop()
        await self.server.stop()
        for s in self._stoppables:
            await s.stop()
        await self.net.quiesce()
        if self.cfg.obs.audit_enabled:
            # the auditor was configured for THIS deployment's quorum
            # geometry; left attached it would audit a later deployment (or
            # test) against the wrong q/n
            watchtower.detach()
        # Chronoscope is process-wide too: a later deployment (or test)
        # starts with a clean feed
        chronoscope.detach()
        chronoscope.reset()
        if self.cfg.obs.flight_dir:
            # the recorder is process-wide: hand it back as launch found it,
            # so a later deployment (or test) never files into this one's
            # directory
            flight.configure(dir=self._flight_dir or "")


def unported_plane(cfg: DDSConfig) -> str | None:
    """The first plane `cfg` enables that the port does not serve, or
    None: shard first, then fabric, helmsman, geo, the attacks
    other than Trudy's crash and byzantine, then the other serving
    surfaces of the reference that are not ported."""
    attack_ok = {a.value for a in (AttackType.CRASH, AttackType.BYZANTINE)}
    checks = (
        (cfg.shard.enabled, "[shard] enabled: sharding"),
        (cfg.fabric.role != "all" or bool(cfg.fabric.groups), "[fabric]: the shard fabric"),
        (cfg.helmsman.enabled, "[helmsman] enabled: helmsman"),
        (cfg.geo.enabled, "[geo] enabled: geo"),
        (cfg.attacks.chaos_enabled, "[attacks] chaos-enabled: attacks on ChaosNet (Nemesis)"),
        (cfg.attacks.enabled and cfg.attacks.type.strip().lower() not in attack_ok,
         f"[attacks] type = {cfg.attacks.type!r}: attacks other than Trudy's "
         "crash and byzantine"),
        (cfg.obs.fleet.enabled, "[obs.fleet] enabled: fleet observability"),
        (cfg.transport.kind != "memory", f"[transport] kind = {cfg.transport.kind!r}: "
                                         "the TCP transport"),
        (bool(cfg.replicas.addresses or cfg.replicas.local
              or cfg.replicas.supervisor_address), "[replicas] addresses: multi-host"),
        (cfg.security.tls_enabled or cfg.security.intranet_tls_enabled, "[security]: TLS"),
        (bool(cfg.security.node_public_keys), "[security] node-public-keys: node identity"),
        (cfg.proxy.key_sync_enabled or bool(cfg.proxy.remote_peers),
         "[proxy] key-sync-enabled: key sync"),
        (bool(cfg.proxy.stored_keys_path), "[proxy] stored-keys-path: stored-keys snapshots"),
    )
    return next((name for on, name in checks if on), None)


async def launch(cfg: DDSConfig | None = None) -> Deployment:
    cfg = cfg or DDSConfig()
    plane = unported_plane(cfg)
    if plane is not None:
        raise NotImplementedError(
            f"{plane} is not ported to dds_tpu_torch; the config enables it, "
            "so the deployment is refused rather than served without it"
        )
    if cfg.tenancy.enabled:
        # the cardinality ceiling applies process-wide before any
        # tenant-labelled series exists: a tenant flood overflows into the
        # guard series instead of growing the registry
        metrics.max_series = int(cfg.tenancy.metrics_max_series)
    flight_dir = flight.dir
    if cfg.obs.flight_dir:
        # the process-wide recorder stays disabled without a directory:
        # fault-path disk writes are opt-in
        flight.configure(
            dir=cfg.obs.flight_dir,
            max_incidents=cfg.obs.flight_max_incidents,
            min_interval=cfg.obs.flight_min_interval,
        )
    net = InMemoryNet()
    rcfg = ReplicaConfig(
        quorum_size=cfg.replicas.byz_quorum_size,
        nonce_increment=cfg.security.nonce_challenge_increment,
        abd_mac_secret=cfg.security.abd_mac_secret.encode(),
        proxy_mac_secret=cfg.security.proxy_mac_secret.encode(),
        debug=cfg.debug,
        allow_fault_injection=cfg.attacks.enabled,
    )
    endpoints = list(cfg.replicas.endpoints)
    spares = set(cfg.replicas.sentinent)
    sentinent = [e for e in endpoints if e in spares]
    active = [e for e in endpoints if e not in spares]
    replicas = {
        e: BFTABDNode(e, endpoints, SUPERVISOR_NAME, net, rcfg) for e in endpoints
    }
    for e in sentinent:
        replicas[e].behavior = "sentinent"

    # optional snapshot restore: corrupt or forged files are quarantined
    # by load_all, never allowed to abort this boot
    snap_secret = None
    if cfg.recovery.snapshot_dir:
        snap_secret = snap.derive_secret(
            (cfg.recovery.snapshot_secret or cfg.security.abd_mac_secret).encode(),
            cfg.security.node_key_path or None,
        )
        restored = snap.load_all(replicas, cfg.recovery.snapshot_dir,
                                 secret=snap_secret)
        if restored:
            log.info("restored %d replica snapshots from %s", restored,
                     cfg.recovery.snapshot_dir)

    def _start_antientropy(node: BFTABDNode) -> None:
        node.antientropy.configure(
            interval=cfg.recovery.anti_entropy_interval,
            jitter=cfg.recovery.anti_entropy_jitter,
        )
        node.antientropy.start()

    async def redeploy(endpoint: str) -> None:
        """The supervisor's factory for a crashed replica: a fresh node at
        the same endpoint (one still on the transport is not rebuilt, so a
        stray redeploy never wipes a live replica)."""
        if net.has_endpoint(endpoint):
            return
        old = replicas.get(endpoint)
        if old is not None:
            old.antientropy.cancel()  # the replaced node's loop must die
        replicas[endpoint] = BFTABDNode(endpoint, endpoints, SUPERVISOR_NAME, net, rcfg)
        if cfg.recovery.anti_entropy_enabled:
            _start_antientropy(replicas[endpoint])

    supervisor = BFTSupervisor(
        SUPERVISOR_NAME,
        active,
        sentinent,
        net,
        SupervisorConfig(
            quorum_size=cfg.replicas.byz_quorum_size,
            proactive_recovery_warmup=cfg.recovery.warm_up,
            proactive_recovery_interval=cfg.recovery.interval,
            sentinent_awake_timeout=cfg.recovery.sentinent_awake_timeout,
            crashed_recovery_timeout=cfg.recovery.crashed_recovery_timeout,
            proactive_recovery_enabled=cfg.recovery.enabled,
            verified_transfer=cfg.recovery.verified_transfer,
            manifest_timeout=cfg.recovery.manifest_timeout,
            state_chunk_keys=cfg.recovery.state_chunk_keys,
            abd_mac_secret=cfg.security.abd_mac_secret.encode(),
            debug=cfg.debug,
        ),
        redeploy=redeploy,
    )
    supervisor.start()
    abd = AbdClient(
        "proxy-0",
        net,
        active,
        AbdClientConfig(
            proxy_mac_secret=cfg.security.proxy_mac_secret.encode(),
            nonce_increment=cfg.security.nonce_challenge_increment,
            request_timeout=cfg.proxy.intranet_request_timeout,
            abd_mac_secret=cfg.security.abd_mac_secret.encode(),
            quorum_size=cfg.replicas.byz_quorum_size,
            breaker_threshold=cfg.proxy.breaker_threshold,
            breaker_reset=cfg.proxy.breaker_reset,
            fast_fail_all_open=cfg.admission.fast_fail,
        ),
    )
    p = cfg.proxy
    server = DDSRestServer(
        abd,
        ProxyConfig(
            host=p.host,
            port=p.port,
            request_budget=p.request_budget,
            retry_backoff=p.retry_backoff,
            retry_max_delay=p.retry_max_delay,
            retry_attempts=p.retry_attempts,
            retry_after_hint=p.retry_after_hint,
            handler_timeout=p.handler_timeout,
            crypto_backend=p.crypto_backend,
            device=p.device,
            min_device_batch=p.min_device_batch,
            coalesce_window=p.coalesce_window,
            analytics_enabled=cfg.analytics.enabled,
            analytics_max_rows=cfg.analytics.max_rows,
            analytics_max_request_bytes=cfg.analytics.max_request_bytes,
            resident=cfg.resident,
            storage=cfg.storage,
            search=cfg.search,
            supervisor=SUPERVISOR_NAME,
            trace_route_enabled=cfg.debug or cfg.obs.trace_route,
            metrics_route_enabled=cfg.obs.metrics_route,
            slo_route_enabled=cfg.obs.slo_route,
            admission=cfg.admission,
            heliograph=cfg.heliograph,
            tenancy=cfg.tenancy,
        ),
        local_replicas=replicas,
        slo=SloEngine.from_obs(cfg.obs),
    )
    await server.start()

    stoppables = []
    if cfg.recovery.anti_entropy_enabled:
        # one pull agent per replica, on a jittered timer so the rounds
        # spread out instead of thundering
        for node in replicas.values():
            _start_antientropy(node)

        class _AntiEntropyStopper:
            async def stop(self):
                for node in replicas.values():
                    await node.antientropy.stop()

        stoppables.append(_AntiEntropyStopper())

    trudy = Trudy(net, active, cfg.replicas.byz_max_faults, addr="trudy")
    dep = Deployment(cfg, net, replicas, server, supervisor, trudy, stoppables,
                     flight_dir)

    if cfg.recovery.snapshot_dir and cfg.recovery.snapshot_interval > 0:
        async def _snapshot_loop():
            while True:
                await asyncio.sleep(cfg.recovery.snapshot_interval)
                # off-loop: serializing large repositories must not stall
                # ABD handling or recovery timers
                await asyncio.to_thread(
                    snap.save_all, dict(dep.replicas),
                    cfg.recovery.snapshot_dir,
                    snap_secret, cfg.recovery.snapshot_keep,
                )

        task = supervised_task(_snapshot_loop(), name="run.snapshot_loop")

        class _TaskStopper:
            async def stop(self):
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass

        stoppables.append(_TaskStopper())

    # the Watchtower rides the process tracer, attached last, once nothing
    # else in this launch can fail, so an aborted boot never leaves a
    # misconfigured auditor behind. It starts from a clean ledger, so its
    # stats and verdicts are this deployment's. Every replica records its
    # handler spans in this process, so the quorum checks are sound.
    if cfg.obs.audit_enabled:
        watchtower.reset()
        watchtower.configure(
            quorum_size=cfg.replicas.byz_quorum_size,
            n_replicas=len(cfg.replicas.endpoints) - len(cfg.replicas.sentinent),
            check_quorum=cfg.obs.audit_quorum_checks,
        )
        watchtower.attach(tracer)
    # Chronoscope rides the same tracer: every span is local in this
    # single-process launch
    chronoscope.attach(tracer)
    return dep


def _write_secret_file(path: pathlib.Path, content: str) -> None:
    """Create a file born 0600 (O_EXCL): never world-readable, not even
    for the instant before a chmod."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(content)


def load_provider(cfg: DDSConfig) -> HomoProvider:
    """Client HE keys per config: inline blob > keys file > fresh
    generation (saved to the file, 0600, when a path is configured) — a
    restarted client can re-attach to an existing store and still decrypt
    it. Then the bulk encryption backend, `cuda` on `[client] device`, and
    the Sanctum posture of the decrypt CRT legs: host-only unless
    `[crypto] secret-device` (or DDS_SECRET_DEVICE) opts in, validated
    here, at construction, so a mistyped opt-in or opt-out never silently
    changes where key material computes; the device plan runs on
    `[client] device`."""
    c = cfg.client
    secret = None
    if secret_device(default=cfg.crypto.secret_device):
        secret = SecretBackend(device=c.device)
    path = pathlib.Path(c.he_keys_path) if c.he_keys_path else None
    if c.he_keys_inline:
        keys = HEKeys.from_json(c.he_keys_inline)
    elif path is not None and path.exists():
        keys = HEKeys.from_json(path.read_text())
    else:
        keys = HEKeys.generate(c.paillier_bits, c.rsa_bits)
        if path is not None:
            _write_secret_file(path, keys.to_json())
    bulk = None
    if c.bulk_encrypt_backend:
        kwargs = {"device": c.device} if c.bulk_encrypt_backend == "cuda" else {}
        bulk = get_backend(c.bulk_encrypt_backend, **kwargs)
    return HomoProvider(keys, fast_blinding=c.fast_blinding, bulk_backend=bulk,
                        secret_backend=secret)


async def run_workload(dep: Deployment, provider: HomoProvider | None = None,
                       seed: int | None = None):
    """Spawn the configured clients and drive generated digests; returns
    their reports. Every client's rng and digest, then Trudy's victims,
    are drawn from one seeded rng in the reference's order, so one seed
    gives both packages the same digests and the same victims."""
    cfg = dep.cfg
    provider = provider or load_provider(cfg)
    rng = random.Random(seed)
    if dep.trudy is not None:
        dep.trudy._rng = rng  # --seed reproduces the attack's victims
    if cfg.attacks.enabled and dep.trudy is not None:
        # fire mid-run: the workload below must complete correct quorums
        # against a damaged cluster
        asyncio.get_running_loop().call_later(
            0.1, lambda: dep.trudy.trigger(cfg.attacks.type)
        )
    dt = cfg.client.data_table
    runs = []
    for _ in range(cfg.client.nr_of_local_clients):
        client = DDSHttpClient(
            provider,
            ClientConfig(
                proxies=[f"{cfg.proxy.host}:{dep.server.cfg.port}"],
                request_timeout=cfg.client.http_requests_timeout,
                fixed_columns=dt.fixed_nr_of_columns,
                schema=dt.fixed_columns_hcrypt,
            ),
            rng=random.Random(rng.getrandbits(64)),
        )
        ops = generate(
            cfg.client.nr_of_operations,
            cfg.client.proportions or None,
            dt.max_nr_of_columns,
            dt.fixed_columns_mappings,
            dt.fixed_columns_hcrypt,
            rng=random.Random(rng.getrandbits(64)),
        )
        runs.append(client.execute(Digest(ops)))
    # clients run concurrently, like the reference's N client actors
    return list(await asyncio.gather(*runs))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Run a dds_tpu_torch deployment + workload")
    ap.add_argument("--config", help="TOML/JSON config path")
    ap.add_argument("--ops", type=int, help="override nr-of-operations")
    ap.add_argument("--backend", choices=["cpu", "cuda"], help="the proxy's crypto backend")
    ap.add_argument("--port", type=int, help="proxy port (0 = auto)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--serve", action="store_true", help="keep serving after workload")
    ap.add_argument("--device", choices=["cuda", "cpu"],
                    help="where the cuda backends fold and encrypt and the Sanctum "
                         "device plan decrypts (default cuda)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")
    cfg = DDSConfig.load(args.config) if args.config else DDSConfig()
    if args.ops is not None:
        cfg.client.nr_of_operations = args.ops
    if args.backend:
        cfg.proxy.crypto_backend = args.backend
    if args.port is not None:
        cfg.proxy.port = args.port
    if args.device:
        cfg.proxy.device = cfg.client.device = args.device

    async def go():
        dep = await launch(cfg)
        try:
            if cfg.client.nr_of_operations > 0:
                reports = await run_workload(dep, seed=args.seed)
                for i, r in enumerate(reports):
                    print(
                        f"client {i}: {r.operations} ops in {r.wall_seconds:.2f}s "
                        f"-> {r.ops_per_second:.1f} ops/s "
                        f"({r.succeeded} ok, {r.not_found} miss, {r.failed} failed)"
                    )
            if args.serve:
                print(
                    f"serving on {dep.server.cfg.host}:{dep.server.cfg.port} "
                    f"(ctrl-c to stop)", flush=True,
                )
                await asyncio.Event().wait()
        finally:
            await dep.stop()

    asyncio.run(go())


if __name__ == "__main__":
    main()
