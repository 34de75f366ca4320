"""The port's config tree against the reference's, over every file in
`configs/`.

Both packages load each TOML file. Every key the file sets must read the
same value in both trees; every other field must equal the reference's
default, except the port's documented divergences (`DIVERGENCES`, the
module docstring of `dds_tpu_torch/utils/config.py`) and the fields only
the port has (`PORT_ONLY`). `launch` on each file refuses with
`NotImplementedError` naming the first plane the port does not serve,
never with an unknown-key error; each refusal is checked on its own, and
`DDSConfig()` with `[search] enabled` boots, as does `[crypto]
secret-device` (Sanctum), whose provider decrypts through its device plan.
"""

import asyncio
import dataclasses
import pathlib
import tomllib

import pytest

from dds_tpu.utils.config import DDSConfig as RefConfig
from dds_tpu_torch.run import launch, unported_plane
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
    "recovery.anti_entropy_enabled": False,
    "proxy.port": 0,
    "proxy.crypto_backend": "cuda",
    "obs.audit_enabled": False,
    "obs.metrics_route": False,
    "obs.slo_route": False,
}
# fields the reference does not have
PORT_ONLY = {"proxy.device": "cuda", "proxy.min_device_batch": None,
             "client.device": "cuda"}
# the plane each top-level file's launch names first
FIRST_PLANE = {
    "configs/default.toml": "recovery",
    "configs/heliograph.toml": "obs audit",
    "configs/sharded.toml": "recovery",
    "configs/stratum.toml": "sharding",
    "configs/tenancy.toml": "admission",
}


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
    assert unported_plane(DDSConfig()) is None


@pytest.mark.parametrize("name", CONFIGS)
def test_launch_refuses_each_config_naming_a_plane(name):
    cfg = DDSConfig.load(ROOT / name)
    cfg.proxy.device = "cpu"
    with pytest.raises(NotImplementedError) as err:
        asyncio.run(launch(cfg))
    msg = str(err.value)
    assert "not ported" in msg and "unknown config key" not in msg
    if name in FIRST_PLANE:
        assert FIRST_PLANE[name] in msg, msg


REFUSALS = [
    ("recovery", {"recovery": {"enabled": True}}),
    ("anti-entropy", {"recovery": {"anti-entropy-enabled": True}}),
    ("spares", {"replicas": {"sentinent": ["replica-3"]}}),
    ("snapshots", {"recovery": {"snapshot-dir": "snaps"}}),
    ("sharding", {"shard": {"enabled": True}}),
    ("admission", {"admission": {"enabled": True}}),
    ("tenancy", {"tenancy": {"enabled": True}}),
    ("obs audit", {"obs": {"audit-enabled": True}}),
    ("fabric", {"fabric": {"role": "proxy"}}),
    ("helmsman", {"helmsman": {"enabled": True}}),
    ("geo", {"geo": {"enabled": True}}),
    ("heliograph", {"heliograph": {"enabled": True}}),
    ("attacks", {"attacks": {"enabled": True}}),
    ("attacks", {"attacks": {"chaos-enabled": True}}),
    ("/metrics", {"obs": {"metrics-route": True}}),
    ("SLO engine", {"obs": {"slo-route": True}}),
    ("/_trace", {"obs": {"trace-route": True}}),
    ("flight recorder", {"obs": {"flight-dir": "incidents"}}),
    ("fleet observability", {"obs": {"fleet": {"enabled": True}}}),
    ("TCP transport", {"transport": {"kind": "tcp"}}),
    ("multi-host", {"replicas": {"addresses": {"replica-0": "h:1"}}}),
    ("TLS", {"security": {"tls-enabled": True}}),
    ("node identity", {"security": {"node-public-keys": {"h:1": "00"}}}),
    ("key sync", {"proxy": {"key-sync-enabled": True}}),
    ("stored-keys", {"proxy": {"stored-keys-path": "keys.json"}}),
]


@pytest.mark.parametrize("plane,section", REFUSALS,
                         ids=[f"{p}-{i}" for i, (p, _) in enumerate(REFUSALS)])
def test_each_unported_plane_is_refused_by_name(plane, section, monkeypatch):
    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    cfg = DDSConfig.from_dict({"proxy": {"device": "cpu"}, **section})
    assert plane in unported_plane(cfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        asyncio.run(launch(cfg))


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
    assert unported_plane(cfg) is None

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
