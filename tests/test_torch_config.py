"""The port's config tree against the reference's, over every file in
`configs/`.

Both packages load each TOML file. Every key the file sets must read the
same value in both trees; every other field must equal the reference's
default, except the port's documented divergences (`DIVERGENCES`, the
module docstring of `dds_tpu_torch/utils/config.py`) and the fields only
the port has (`PORT_ONLY`). `launch` accepts every file: it boots and
stops on the CPU, the multi-process files of `configs/multihost/` and
`configs/geo/` a role at a time with their hosts and ports rewritten to
loopback. The planes ported since (recovery, anti-entropy, spares, snapshots,
Trudy's attacks, /metrics, the flight recorder, admission, the obs audit,
the SLO engine, tenancy, Heliograph's prober, /_trace, sharding, ChaosNet
with Nemesis and its partition attack, key sync, the stored-keys
snapshot, live resharding under `[shard]` with `[fabric] admin-routes`
(POST /_reshard) and `[shard] plan-dir` (a journaled reshard plan),
Helmsman with `[shard]` and, as in the reference, without it, where it
boots no controller, `[obs.fleet]` and the stale-tag forgers, which a
single-process launch leaves unwired, as the reference's does) each launch and stop cleanly, the prober's and
Helmsman's tasks cancelled and awaited with the rest, and
`DDSConfig()` with `[search] enabled` boots, as does `[crypto] secret-device` (Sanctum), whose provider
decrypts through its device plan. `default.toml` boots with Bulwark, the
SLO engine and the Watchtower armed as the file says, and the CLI's
`--device cpu --backend cpu` launches it; `tenancy.toml` boots with
Bastion's weights, 403s and `/health` section, and so does its CLI.
`[chaos.profiles]` (geo's WAN matrices) boots with its ChaosNet.
"""

import asyncio
import dataclasses
import json
import pathlib
import tomllib

import pytest

from dds_tpu.utils.config import DDSConfig as RefConfig
from dds_tpu_torch.core.chaos import ChaosNet
from dds_tpu_torch.core.transport import TcpNet
from dds_tpu_torch.malicious.trudy import Nemesis
from dds_tpu_torch.run import launch
from dds_tpu_torch.utils.config import DDSConfig, SearchConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.relative_to(ROOT).as_posix()
                 for p in (ROOT / "configs").rglob("*.toml"))
TOP = [c for c in CONFIGS if c.count("/") == 1]

# the port's own defaults (dotted field path -> value), each with its
# reason in the config module's docstring
DIVERGENCES = {
    "replicas.endpoints": [f"replica-{i}" for i in range(4)],
    "replicas.sentinent": [],
    "replicas.byz_quorum_size": 3,
    "replicas.byz_max_faults": 1,
    "recovery.enabled": False,
    "proxy.port": 0,
    "proxy.crypto_backend": "cuda",
}
# fields the reference does not have
PORT_ONLY = {"proxy.device": "cuda", "proxy.min_device_batch": None,
             "client.device": "cuda"}
# the files of one multi-process fleet each (their addresses name each
# other): they launch a role at a time, rewritten to loopback
FLEETS = {"configs/multihost": ["group0", "group1", "standby2", "proxy"],
          "configs/geo": ["group0_eu", "group1_us", "group2_ap", "proxy_eu"]}


def launch_accepts(cfg) -> bool:
    """`launch` boots `cfg` and the deployment stops: what the refusal of
    an unported plane used to decide."""
    async def boot():
        dep = await launch(cfg)
        await dep.stop()

    asyncio.run(asyncio.wait_for(boot(), 60))
    return True


def flat(obj, prefix: str = "") -> dict:
    """{dotted path: value} over a dataclass tree (dict fields are leaves)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        path = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(flat(v, path + "."))
        else:
            out[path] = v
    return out


def set_paths(data: dict, leaves: set, prefix: str = "") -> set:
    """The dotted field paths a parsed TOML document sets."""
    out = set()
    for k, v in data.items():
        path = prefix + k.replace("-", "_")
        if path in leaves:
            out.add(path)
        else:
            out |= set_paths(v, leaves, path + ".")
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_every_config_reads_as_the_reference(name):
    path = ROOT / name
    port, ref = flat(DDSConfig.load(path)), flat(RefConfig.load(path))
    default = flat(RefConfig())
    assert set(port) - set(PORT_ONLY) == set(ref) == set(default)
    given = set_paths(tomllib.loads(path.read_text()), set(ref))
    assert given, name
    for p in given:
        assert port[p] == ref[p], p
    for p in set(ref) - given:
        assert ref[p] == default[p], p
        assert port[p] == DIVERGENCES.get(p, default[p]), p
    for p, v in PORT_ONLY.items():
        assert port[p] == v, p


def test_defaults_equal_the_reference_except_the_divergences():
    port, ref = flat(DDSConfig()), flat(RefConfig())
    assert set(DIVERGENCES) <= set(ref)
    for p, v in ref.items():
        if p in DIVERGENCES:
            assert v != DIVERGENCES[p] and port[p] == DIVERGENCES[p], p
        else:
            assert port[p] == v, p
    assert DDSConfig().search == SearchConfig()
    assert dataclasses.asdict(DDSConfig().search) == dataclasses.asdict(RefConfig().search)
    cfg = DDSConfig()
    cfg.proxy.device = "cpu"
    assert launch_accepts(cfg)


@pytest.mark.parametrize("name", CONFIGS)
def test_launch_refuses_each_config_naming_a_plane(name, tmp_path):
    """`launch` refuses no file: each boots and stops on the CPU as
    written, a file of a multi-process fleet with every host and port
    rewritten to loopback (its peers absent) and its keys file under the
    test's directory."""
    directory, stem = name.rsplit("/", 1)
    stem = stem.removesuffix(".toml")
    if stem in FLEETS.get(directory, ()):
        from tests.test_torch_meridian_mixed import loopback_fleet

        cfg = loopback_fleet(FLEETS[directory], directory, tmp_path)[stem]
        assert cfg.obs.fleet.enabled
    else:
        cfg = DDSConfig.load(ROOT / name)
    cfg.proxy.device = "cpu"
    cfg.proxy.port = 0  # tenancy.toml's 8080 may be taken on the test host
    cfg.storage.dir = str(tmp_path / "stratum")  # stratum.toml's "./stratum"
    assert launch_accepts(cfg)


# (plane, section, refused): the index of each case is its id's suffix
PLANES = [
    ("recovery", {"recovery": {"enabled": True}}, False),
    ("anti-entropy", {"recovery": {"anti-entropy-enabled": True}}, False),
    ("spares", {"replicas": {"sentinent": ["replica-3"]}}, False),
    ("snapshots", {"recovery": {"snapshot-dir": "snaps"}}, False),
    ("sharding", {"shard": {"enabled": True}}, False),
    ("admission", {"admission": {"enabled": True}}, False),
    ("tenancy", {"tenancy": {"enabled": True}}, False),
    ("obs audit", {"obs": {"audit-enabled": True}}, False),
    ("fabric", {"fabric": {"role": "proxy"}}, False),
    ("helmsman", {"shard": {"enabled": True}, "helmsman": {"enabled": True}}, False),
    ("geo", {"geo": {"enabled": True}}, False),
    ("heliograph", {"heliograph": {"enabled": True}}, False),
    ("attacks", {"attacks": {"enabled": True}}, False),
    ("attacks", {"attacks": {"chaos-enabled": True}}, False),
    ("/metrics", {"obs": {"metrics-route": True}}, False),
    ("SLO engine", {"obs": {"slo-route": True}}, False),
    ("/_trace", {"obs": {"trace-route": True}}, False),
    ("flight recorder", {"obs": {"flight-dir": "incidents"}}, False),
    ("fleet observability", {"obs": {"fleet": {"enabled": True}}}, False),
    ("TCP transport", {"transport": {"kind": "tcp", "port": 0}}, False),
    ("multi-host", {"replicas": {"addresses": {"replica-0": "h:1"}}}, False),
    ("TLS", {"security": {"tls-enabled": True}}, False),
    ("node identity", {"security": {"node-public-keys": {"h:1": "00"}}}, False),
    ("key sync", {"proxy": {"device": "cpu", "key-sync-enabled": True}}, False),
    ("stored-keys", {"proxy": {"device": "cpu", "stored-keys-path": "keys.json"}}, False),
    ("admin-routes", {"shard": {"enabled": True}, "fabric": {"admin-routes": True}}, False),
    ("plan-dir", {"shard": {"enabled": True, "plan-dir": "plans"}}, False),
    ("partition", {"attacks": {"enabled": True, "chaos-enabled": True,
                               "type": "partition"}}, False),
    ("[chaos.profiles]", {"attacks": {"chaos-enabled": True},
                          "chaos": {"profiles": {"eu<->us": "wan-100"}}}, False),
    ("sharded chaos", {"shard": {"enabled": True}, "attacks": {"chaos-enabled": True}}, False),
    ("helmsman unsharded", {"helmsman": {"enabled": True}}, False),
    ("Meridian", {"shard": {"enabled": True}, "transport": {"kind": "tcp", "port": 0}},
     False),
    ("stale-tag forgers", {"attacks": {"enabled": True, "type": "stale_tag"}}, False),
]
IDS = [f"{p}-{i}" for i, (p, _, _) in enumerate(PLANES)]
PORTED = [(p, sec) for p, sec, refused in PLANES if not refused]


@pytest.mark.parametrize("plane,section", PORTED,
                         ids=[i for i, (_, _, r) in zip(IDS, PLANES) if not r])
def test_each_ported_plane_launches_and_stops(plane, section, monkeypatch,
                                              tmp_path):
    """The planes that used to be refused boot on the CPU and stop
    cleanly: every loop `launch` started is cancelled and awaited, the
    flight recorder is handed back as `launch` found it, and the
    Watchtower is detached."""
    from dds_tpu_torch.obs.flight import flight
    from dds_tpu_torch.obs.watchtower import watchtower
    from dds_tpu_torch.utils.tasks import _TASKS

    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    monkeypatch.chdir(tmp_path)
    cfg = DDSConfig.from_dict({"proxy": {"device": "cpu"}, **section})
    before = flight.dir

    async def boot():
        dep = await launch(cfg)
        try:
            assert dep.trudy is not None
            if plane in ("sharding", "sharded chaos", "helmsman", "admin-routes", "plan-dir",
                         "Meridian"):
                # one supervisor a group, no single-group supervisor
                assert dep.supervisor is None
                assert [g.gid for g in dep.constellation.groups] == ["s0", "s1"]
                assert dep.server.abd is dep.constellation.router
                assert len(dep.replicas) == 10
            else:
                assert dep.supervisor is not None
            if plane == "spares":
                assert dep.replicas["replica-3"].behavior == "sentinent"
                assert dep.supervisor.sentinent == ["replica-3"]
            if plane == "flight recorder":
                assert flight.dir == "incidents"
            if plane == "anti-entropy":
                assert all(n.antientropy.stats()["running"]
                           for n in dep.replicas.values())
            if plane == "admission":
                assert dep.server.admission is not None
                assert dep.server._coalescer is not None
            if plane == "obs audit":
                assert watchtower.attached and watchtower.quorum_size == 3
            if plane == "SLO engine":
                assert dep.server.cfg.slo_route_enabled
            if plane == "tenancy":
                assert dep.server._tenancy_enabled
            if plane == "heliograph":
                assert dep.server.heliograph is not None
            if plane == "/_trace":
                assert dep.server.cfg.trace_route_enabled
            if plane == "sharded chaos":
                assert isinstance(dep.net, ChaosNet)
                assert all(isinstance(g.trudy, Nemesis) and g.trudy.net is dep.net
                           for g in dep.constellation.groups)
            if plane in ("attacks", "partition"):
                chaotic = section["attacks"].get("chaos-enabled", False)
                assert isinstance(dep.net, ChaosNet) == chaotic
                assert isinstance(dep.trudy, Nemesis) == chaotic
            if plane == "partition":
                assert dep.trudy.trigger("partition") and dep.net.partitions
                dep.trudy.trigger("heal")
            if plane == "key sync":
                assert dep.server.cfg.key_sync_enabled
            if plane == "TCP transport":
                # bound on an OS-assigned port, every endpoint under it
                assert isinstance(dep.net, TcpNet) and dep.net.port != 0
                assert dep.net in dep._stoppables
                assert set(dep.replicas) == {f"127.0.0.1:{dep.net.port}/replica-{i}"
                                             for i in range(4)}
            if plane == "multi-host":
                # on the memory transport the address map names no other
                # process, as in the reference; the quorum audit is off
                assert set(dep.replicas) == {f"replica-{i}" for i in range(4)}
                assert not watchtower.check_quorum
            if plane == "TLS":
                assert dep.ssl_client is not None
                assert dep.server.cfg.ssl_server_context is not None
            if plane == "stored-keys":
                assert dep.server.cfg.keys_path == "keys.json"
                dep.server._note_stored("k-0")
            if plane == "helmsman":
                # started on the Constellation, unpinned, its loop running
                hm = dep.server.helmsman
                assert hm is not None and not hm.pinned and hm._task is not None
                assert hm in dep._stoppables
            if plane == "helmsman unsharded":
                assert dep.server.helmsman is None  # no controller to steer
            if plane == "admin-routes":
                assert dep.server.cfg.reshard_route_enabled
                assert dep.server._reshard is not None
            if plane == "Meridian":
                # role "all": the Constellation over this process's TcpNet,
                # every endpoint "host:port/name", the map on GET /shards
                # with gossip
                assert isinstance(dep.net, TcpNet) and dep.server._gossip is not None
                assert f"{dep.net.advertised}/s1-replica-4" in dep.replicas
            if plane == "fabric":
                # a [fabric] role without [shard] over TCP is the single-group
                # launch, as in the reference
                assert dep.constellation is None
            if plane == "fleet observability":
                # the plane lives in Meridian's roles; a single-process
                # launch has no collector, as in the reference
                assert dep.server._fleet is None
            if plane == "stale-tag forgers":
                # only a Meridian group process arms its replicas
                assert all(type(n).__name__ == "BFTABDNode" for n in dep.replicas.values())
            if plane == "plan-dir":
                journal = dep.constellation.rebalancer.journal
                assert journal.path == pathlib.Path("plans", "reshard_plan.json")
                assert journal.load() is None
        finally:
            await dep.stop()
        await asyncio.sleep(0)
        return [t.get_name() for t in _TASKS if not t.done()]

    leaked = asyncio.run(asyncio.wait_for(boot(), 30))
    assert not leaked, leaked
    if plane == "stored-keys":  # stop flushed the debounced snapshot
        assert json.loads((tmp_path / "keys.json").read_text()) == ["k-0"]
    assert flight.dir == before
    assert not watchtower.attached


def test_default_toml_launches_on_the_cpu_with_its_edge_planes(monkeypatch):
    """configs/default.toml on the CPU (`[proxy] device = "cpu"`, its own
    `crypto-backend = "cpu"`): the reference's topology, Bulwark with the
    file's buckets and adaptive window, the SLO engine with its per-route
    objectives, and the Watchtower configured for quorum 5 over 7 active
    replicas; it serves a PutSet, a GetSet and /slo, and stop detaches the
    auditor."""
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.obs.watchtower import watchtower

    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    cfg = DDSConfig.load(ROOT / "configs" / "default.toml")
    cfg.proxy.device = "cpu"

    async def boot():
        dep = await launch(cfg)
        try:
            s = dep.server
            port = s.cfg.port
            status, key = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                             b'{"contents": ["7", "x"]}')
            got, _ = await http_request("127.0.0.1", port, "GET", f"/GetSet/{key.decode()}")
            slo, body = await http_request("127.0.0.1", port, "GET", "/slo")
            return (s.backend.name, len(dep.replicas), dep.supervisor.sentinent,
                    s.admission.rates, s.admission.max_shed_level,
                    s._coalescer.max_window, s.slo.routes["SumAll"].latency_ms,
                    watchtower.attached, watchtower.quorum_size, watchtower.n_replicas,
                    status, got, slo, sorted(json.loads(body)))
        finally:
            await dep.stop()

    out = asyncio.run(asyncio.wait_for(boot(), 60))
    assert out == ("cpu", 9, ["replica-7", "replica-8"],
                   {"interactive": (400.0, 800.0), "aggregate": (64.0, 128.0),
                    "background": (16.0, 32.0)}, 2, 0.02, 1000.0, True, 5, 7,
                   200, 200, 200, ["admission", "audit", "slo"])
    assert not watchtower.attached


def test_tenancy_toml_launches_on_the_cpu_with_bastion(monkeypatch):
    """configs/tenancy.toml on the CPU (`--device cpu --backend cpu` as the
    driver's flags set it): 4 replicas, quorum 3, Bulwark with the file's
    rates and [tenancy.weights], tenancy on: a tenant's PutSet is its own,
    another tenant's GetSet of it answers the typed 403, /health counts the
    owned key, and stop detaches Chronoscope and the Watchtower."""
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.obs.chronoscope import chronoscope
    from dds_tpu_torch.obs.watchtower import watchtower

    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    cfg = DDSConfig.load(ROOT / "configs" / "tenancy.toml")
    cfg.proxy.device = "cpu"
    cfg.proxy.crypto_backend = "cpu"
    cfg.proxy.port = 0

    async def boot():
        dep = await launch(cfg)
        try:
            s = dep.server
            port = s.cfg.port
            gold = {"x-dds-tenant": "gold"}
            status, key = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                             b'{"contents": ["7"]}', headers=gold)
            mine, _ = await http_request("127.0.0.1", port, "GET", f"/GetSet/{key.decode()}",
                                         headers=gold)
            theirs, body = await http_request("127.0.0.1", port, "GET",
                                              f"/GetSet/{key.decode()}",
                                              headers={"x-dds-tenant": "batch-etl"})
            _, health = await http_request("127.0.0.1", port, "GET", "/health")
            return (len(dep.replicas), s.abd.cfg.quorum_size, s._tenancy_enabled,
                    s.admission.tenant_weights, s.admission.rates["aggregate"],
                    chronoscope.stats()["attached"], watchtower.attached, status, mine,
                    theirs, json.loads(body)["error"], json.loads(health)["tenants"])
        finally:
            await dep.stop()

    out = asyncio.run(asyncio.wait_for(boot(), 60))
    assert out == (4, 3, True, {"gold": 3.0, "batch-etl": 0.5}, (64.0, 128.0), True, True,
                   200, 200, 403, "cross-tenant access denied",
                   {"owned_keys": 1, "shed": []})
    assert not chronoscope.stats()["attached"] and not watchtower.attached


def test_cli_launches_default_toml_with_the_backend_flag(monkeypatch, capsys, tmp_path):
    """`python -m dds_tpu_torch.run --config configs/default.toml --device
    cpu --backend cpu --ops 0` (and tenancy.toml, heliograph.toml,
    sharded.toml, stratum.toml, the last from a scratch directory, where
    its "./stratum" lands): boots, runs no workload, stops."""
    from dds_tpu_torch import run as runmod

    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    monkeypatch.chdir(tmp_path)
    seen = {}
    real = runmod.launch

    async def spy(cfg):
        dep = await real(cfg)
        seen["backend"] = dep.server.backend.name
        seen["device"] = cfg.proxy.device
        return dep

    monkeypatch.setattr(runmod, "launch", spy)
    for name in ("default.toml", "tenancy.toml", "heliograph.toml", "sharded.toml",
                 "stratum.toml"):
        seen.clear()
        runmod.main(["--config", str(ROOT / "configs" / name), "--device", "cpu",
                     "--backend", "cpu", "--ops", "0", "--port", "0"])
        assert seen == {"backend": "cpu", "device": "cpu"}, name
    with pytest.raises(SystemExit):
        runmod.main(["--backend", "tpu"])


def test_default_config_with_search_enabled_launches(monkeypatch):
    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    cfg = DDSConfig.from_dict({"search": {"enabled": True}, "proxy": {"device": "cpu"}})

    async def boot():
        dep = await launch(cfg)
        try:
            return dep.server._search is not None, dep.server._search.device.type
        finally:
            await dep.stop()

    assert asyncio.run(boot()) == (True, "cpu")


def test_a_secret_device_config_launches_and_its_provider_decrypts(monkeypatch):
    """`[crypto] secret-device = true` boots now that Sanctum is ported,
    and the provider `load_provider` builds from it decrypts through its
    device plan (on the CPU here: `[client] device`)."""
    from dds_tpu_torch.run import load_provider
    from dds_tpu_torch.sanctum import is_secret_backend

    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    cfg = DDSConfig.from_dict({"crypto": {"secret-device": True},
                               "proxy": {"device": "cpu"},
                               "client": {"device": "cpu", "paillier-bits": 512,
                                          "rsa-bits": 512}})

    async def boot():
        dep = await launch(cfg)
        await dep.stop()

    asyncio.run(boot())
    provider = load_provider(cfg)
    assert is_secret_backend(provider.secret_backend)
    k = provider.keys.psse
    cts = [k.public.encrypt(m) for m in (5, 6, 7)]
    assert k.decrypt_batch(cts, backend=provider.secret_backend, min_batch=1) == [5, 6, 7]
    assert "device:cpu" in k.__dict__["_sanctum_plans"]


def test_unknown_keys_still_raise():
    for bad in ({"search": {"max-pendings": 1}}, {"obs": {"fleet": {"spool": 1}}},
                {"nope": {}}):
        with pytest.raises(ValueError, match="unknown config key"):
            DDSConfig.from_dict(bad)


@pytest.mark.parametrize("profile,want", [
    ({"rtt-ms": 100}, {"request_budget": 2.4, "retry_backoff": 0.2, "retry_max_delay": 0.8,
                       "retry_after_hint": 0.2}),
    ({"rtt-ms": 100, "request-budget": 4.0},
     {"request_budget": 4.0, "retry_backoff": 0.2, "retry_max_delay": 0.8,
      "retry_after_hint": 0.2}),
], ids=["rtt", "rtt_and_explicit_budget"])
def test_retry_profile_for_the_region_lands_on_proxy_in_both(profile, want):
    """ROADMAP §C 15: with `[fabric] region = "eu"` and a
    `[retry.profiles.eu]` table, both packages' `launch` apply the region's
    overrides onto `[proxy]` before the proxy is built (an explicit key wins
    over the rtt-ms derivation), so the served budgets are equal: every
    ProxyConfig field `RetryConfig._KEYS` names, on the launched config and
    on the proxy's own."""
    from dds_tpu.run import launch as ref_launch

    raw = {"proxy": {"port": 0, "crypto-backend": "cpu"}, "fabric": {"region": "eu"},
           "retry": {"profiles": {"eu": profile}}}
    keys = DDSConfig().retry._KEYS
    assert keys == RefConfig().retry._KEYS

    async def boot(cfg, run):
        dep = await run(cfg)
        try:
            return ({k: getattr(dep.cfg.proxy, k) for k in keys},
                    {k: getattr(dep.server.cfg, k) for k in keys if hasattr(dep.server.cfg, k)})
        finally:
            await dep.stop()

    ref = asyncio.run(asyncio.wait_for(boot(RefConfig.from_dict(raw), ref_launch), 60))
    port = asyncio.run(asyncio.wait_for(boot(DDSConfig.from_dict(raw), launch), 60))
    assert port == ref
    assert port[0]["intranet_request_timeout"] == DDSConfig().proxy.intranet_request_timeout
    for k, v in want.items():
        assert port[0][k] == pytest.approx(v) and port[1][k] == pytest.approx(v)
