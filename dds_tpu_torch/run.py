"""System bootstrap: the replicas and the REST proxy of one deployment.

Trimmed copy of `dds_tpu/run.py`. `launch(cfg)` boots the topology the
config describes — by default the north-star one of
`benchmarks/bft_sum.py`: 4 BFT-ABD replicas, quorum 3 (f = 1), proactive
recovery off, the in-memory transport, and the proxy on an OS-assigned
port folding on the `cuda` backend. The supervisor, TCP transport, client
workload and attack simulation wait for later slices.

Serve until interrupted (on a host without a card, pass --device cpu):

    python -m dds_tpu_torch.run --port 8443
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from dataclasses import dataclass

from dds_tpu_torch.core.quorum_client import AbdClient, AbdClientConfig
from dds_tpu_torch.core.replica import BFTABDNode, ReplicaConfig
from dds_tpu_torch.core.transport import InMemoryNet
from dds_tpu_torch.http.server import DDSRestServer, ProxyConfig
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


async def launch(cfg: DDSConfig | None = None) -> Deployment:
    cfg = cfg or DDSConfig()
    if cfg.recovery.enabled:
        raise NotImplementedError(
            "proactive recovery needs the supervisor, which is not ported "
            "to dds_tpu_torch yet"
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
            resident=cfg.resident.enabled,
            storage=cfg.storage.enabled,
            search=cfg.search.enabled,
        ),
    )
    await server.start()
    return Deployment(cfg, net, replicas, server)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Serve a dds_tpu_torch deployment")
    ap.add_argument("--config", help="TOML/JSON config path")
    ap.add_argument("--port", type=int, help="proxy port (0 = auto)")
    ap.add_argument("--device", choices=["cuda", "cpu"], help="fold device")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")
    cfg = DDSConfig.load(args.config) if args.config else DDSConfig()
    if args.port is not None:
        cfg.proxy.port = args.port
    if args.device:
        cfg.proxy.device = args.device

    async def go():
        dep = await launch(cfg)
        try:
            print(f"serving on {dep.server.cfg.host}:{dep.server.cfg.port} "
                  f"(ctrl-c to stop)", flush=True)
            await asyncio.Event().wait()
        finally:
            await dep.stop()

    asyncio.run(go())


if __name__ == "__main__":
    main()
