"""System bootstrap: the replicas and the REST proxy of one deployment.

Trimmed copy of `dds_tpu/run.py`. `launch(cfg)` boots the topology the
config describes — by default the north-star one of
`benchmarks/bft_sum.py`: 4 BFT-ABD replicas, quorum 3 (f = 1), proactive
recovery off, the in-memory transport, and the proxy on an OS-assigned
port folding on the `cuda` backend; `[resident]`, `[storage]` and
`[search]` reach the proxy as their config sections, so Stratum keeps its
segment log in `[storage] dir` and the search plane indexes the
Search*/Order*/Range columns, and `[analytics]` arms Prism's routes (on
by default). A config that enables a plane the port does not serve
(`unported_plane`) is refused with `NotImplementedError` naming it, so
every file in `configs/` parses but none boots without what it asks for.
`load_provider(cfg)` builds the
client's HE provider from the `[client]` section: its keys and its bulk
encryption backend (`bulk-encrypt-backend = "cuda"` precomputes PSSE
obfuscators with the exp kernel). `run_workload(dep)` drives
`[client] nr-of-local-clients` concurrent clients over digests the
workload generator draws from `[client] proportions`. The supervisor, TCP
transport and attack simulation wait for later slices.

Run the deployment and a generated workload, print each client's report,
and with --serve keep serving until interrupted (on a host without a card,
pass --device cpu):

    python -m dds_tpu_torch.run --ops 100 --seed 7 [--serve] [--port 8443]
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import pathlib
import random
from dataclasses import dataclass

from dds_tpu_torch.clt.client import ClientConfig, DDSHttpClient
from dds_tpu_torch.clt.generator import generate
from dds_tpu_torch.clt.instructions import Digest
from dds_tpu_torch.core.quorum_client import AbdClient, AbdClientConfig
from dds_tpu_torch.core.replica import BFTABDNode, ReplicaConfig
from dds_tpu_torch.core.transport import InMemoryNet
from dds_tpu_torch.http.server import DDSRestServer, ProxyConfig
from dds_tpu_torch.models.backend import get_backend
from dds_tpu_torch.models.facade import HomoProvider
from dds_tpu_torch.models.keys import HEKeys
from dds_tpu_torch.utils.config import DDSConfig

SUPERVISOR_NAME = "supervisor"


@dataclass
class Deployment:
    cfg: DDSConfig
    net: InMemoryNet
    replicas: dict[str, BFTABDNode]
    server: DDSRestServer

    async def stop(self) -> None:
        await self.server.stop()
        await self.net.quiesce()


def unported_plane(cfg: DDSConfig) -> str | None:
    """The first plane `cfg` enables that the port does not serve, or
    None: recovery and anti-entropy first, then shard, admission,
    tenancy, the obs audit, fabric, helmsman, geo, heliograph, attacks,
    `[crypto] secret-device`, then the other serving surfaces of the
    reference that are not ported."""
    checks = (
        (cfg.recovery.enabled, "[recovery] enabled: proactive recovery (the supervisor)"),
        (cfg.recovery.anti_entropy_enabled, "[recovery] anti-entropy-enabled: anti-entropy"),
        (bool(cfg.replicas.sentinent), "[replicas] sentinent: spares (the supervisor)"),
        (bool(cfg.recovery.snapshot_dir), "[recovery] snapshot-dir: snapshots"),
        (cfg.shard.enabled, "[shard] enabled: sharding"),
        (cfg.admission.enabled, "[admission] enabled: admission control"),
        (cfg.tenancy.enabled, "[tenancy] enabled: tenancy"),
        (cfg.obs.audit_enabled, "[obs] audit-enabled: the obs audit (Watchtower)"),
        (cfg.fabric.role != "all" or bool(cfg.fabric.groups), "[fabric]: the shard fabric"),
        (cfg.helmsman.enabled, "[helmsman] enabled: helmsman"),
        (cfg.geo.enabled, "[geo] enabled: geo"),
        (cfg.heliograph.enabled, "[heliograph] enabled: heliograph"),
        (cfg.attacks.enabled or cfg.attacks.chaos_enabled, "[attacks]: attacks"),
        (_secret_device(cfg.crypto.secret_device),
         "[crypto] secret-device: the Sanctum secret-material plane"),
        (cfg.obs.metrics_route, "[obs] metrics-route: the /metrics route"),
        (cfg.obs.slo_route, "[obs] slo-route: the SLO engine"),
        (cfg.obs.trace_route, "[obs] trace-route: the /_trace route"),
        (bool(cfg.obs.flight_dir), "[obs] flight-dir: the flight recorder"),
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
    net = InMemoryNet()
    rcfg = ReplicaConfig(
        quorum_size=cfg.replicas.byz_quorum_size,
        nonce_increment=cfg.security.nonce_challenge_increment,
        abd_mac_secret=cfg.security.abd_mac_secret.encode(),
        proxy_mac_secret=cfg.security.proxy_mac_secret.encode(),
        debug=cfg.debug,
    )
    endpoints = list(cfg.replicas.endpoints)
    replicas = {
        e: BFTABDNode(e, endpoints, SUPERVISOR_NAME, net, rcfg) for e in endpoints
    }
    abd = AbdClient(
        "proxy-0",
        net,
        endpoints,
        AbdClientConfig(
            proxy_mac_secret=cfg.security.proxy_mac_secret.encode(),
            nonce_increment=cfg.security.nonce_challenge_increment,
            request_timeout=cfg.proxy.intranet_request_timeout,
            abd_mac_secret=cfg.security.abd_mac_secret.encode(),
            quorum_size=cfg.replicas.byz_quorum_size,
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
        ),
    )
    await server.start()
    return Deployment(cfg, net, replicas, server)


def _secret_device(default: bool) -> bool:
    """The reference's Sanctum device opt-in: DDS_SECRET_DEVICE when set,
    else the `[crypto] secret-device` value; a malformed value raises."""
    env = os.environ.get("DDS_SECRET_DEVICE", "").strip().lower()
    if not env:
        return bool(default)
    if env in ("1", "true", "on", "yes"):
        return True
    if env in ("0", "false", "off", "no"):
        return False
    raise ValueError(f"unknown DDS_SECRET_DEVICE value {env!r} (use 1/true/on/yes "
                     "or 0/false/off/no)")


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
    it. Then the bulk encryption backend, `cuda` on `[client] device`."""
    if _secret_device(cfg.crypto.secret_device):
        raise NotImplementedError(
            "[crypto] secret-device: the Sanctum secret-material plane is not "
            "ported to dds_tpu_torch; PSSE decryption is host-only"
        )
    c = cfg.client
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
    return HomoProvider(keys, fast_blinding=c.fast_blinding, bulk_backend=bulk)


async def run_workload(dep: Deployment, provider: HomoProvider | None = None,
                       seed: int | None = None):
    """Spawn the configured clients and drive generated digests; returns
    their reports. The reference's `run_workload` without the attack
    trigger: every client's rng and digest are drawn from one seeded rng
    in the same order, so one seed gives both packages the same digests."""
    cfg = dep.cfg
    provider = provider or load_provider(cfg)
    rng = random.Random(seed)
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
    ap.add_argument("--port", type=int, help="proxy port (0 = auto)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--serve", action="store_true", help="keep serving after workload")
    ap.add_argument("--device", choices=["cuda", "cpu"],
                    help="where the cuda backends fold and encrypt (default cuda)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")
    cfg = DDSConfig.load(args.config) if args.config else DDSConfig()
    if args.ops is not None:
        cfg.client.nr_of_operations = args.ops
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
