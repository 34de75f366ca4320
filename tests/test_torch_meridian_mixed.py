"""One Meridian fleet, two packages, on loopback in one event loop.

The wire between the fabric's processes is the same bytes in both
packages (the agents' RPC frames, the signed map on `GET /shards`, the
gossip ETags), so a port proxy drives reference groups and a reference
proxy drives port groups:

- reference group processes host s0 and s1, a port process the standby
  s2, and a port proxy with its `MeridianController` bootstraps the map
  from the reference's `GET /shards`, folds a SumAll, splits s1 onto s2
  through the agents' RPC (a reference agent freezes, exports and prunes
  s1, a port agent takes s2) and folds the same SumAll from the same rows
  at S = 3;
- the reverse, a reference proxy over port groups, bootstraps and folds
  one SumAll equal to the host product;
- `launch` accepts each of the four `configs/multihost/` files and the
  four TCP files of `configs/geo/` as written, `[obs.fleet]` on (only
  the hosts and ports rewritten to loopback, the collector's too, and the
  proxy folding on the host): a group role starts its span shipper, the
  proxy its collector, whose `GET /fleet/*` answer; and both fleets,
  every role in one loop, serve a SumAll, the geo fleet (`group{0_eu,
  1_us,2_ap}` and `proxy_eu`) a GetSet read locally through the eu
  group's read lease.
"""

import asyncio
import json
import pathlib

import pytest

from tests.test_torch_fabric import (
    SECRET, MiniFleet, free_port, mod, put, request, seeded_rows)

pytestmark = pytest.mark.multihost

ROOT = pathlib.Path(__file__).resolve().parent.parent
MULTIHOST = ["group0", "group1", "standby2", "proxy"]
GEO = ["group0_eu", "group1_us", "group2_ap", "proxy_eu"]


@pytest.fixture(scope="module")
def key():
    return mod("dds_tpu", "models.paillier").PaillierKey.generate(512)


def host_product(rows, n2: int) -> int:
    out = 1
    for r in rows:
        out = out * int(r[0]) % n2
    return out


async def sumall(pkg, port, n2) -> int:
    status, _, body = await request(pkg, port, "GET", f"/SumAll?position=0&nsqr={n2}",
                                    timeout=30.0)
    assert status == 200, body
    return int(json.loads(body)["result"])


def splitting_rows(key, vals, seed: int):
    """`seeded_rows` redrawn (the seed stepped) until the split of s1 onto
    s2 moves at least one row."""
    from dds_tpu.shard.shardmap import ShardMap
    from dds_tpu.utils import sigs

    m2 = ShardMap.build(["s0", "s1"], 16).split("s1", "s2")
    while True:
        rows = seeded_rows(key, vals, seed)
        if any(m2.owner(sigs.key_from_set(r)) == "s2" for r in rows):
            return rows
        seed += 1


def test_port_proxy_bootstraps_reference_groups_and_splits_onto_a_port_group(key):
    vals = [7, 21, 301, 44, 5, 600, 12, 9]
    rows = splitting_rows(key, vals, seed=2402)
    n2 = key.public.nsquare
    want = host_product(rows, n2)

    async def go():
        fleet = MiniFleet("dds_tpu", standby=1, proxy_pkg="dds_tpu_torch",
                          group_pkg={"s2": "dds_tpu_torch"})
        await fleet.start()
        try:
            proxy = fleet.deps["proxy"]
            assert type(proxy.server).__module__.startswith("dds_tpu_torch.")
            assert type(fleet.deps["s0"].server).__module__.startswith("dds_tpu.")
            port = fleet.proxy_port()
            # the map came from a reference group's GET /shards
            st, _, body = await request("dds_tpu", fleet.s_ports["s0"], "GET", "/shards")
            ref_wire = json.loads(body)["map"]
            st2, _, body2 = await request("dds_tpu_torch", port, "GET", "/shards")
            assert st == st2 == 200
            assert json.loads(body2)["map"] == ref_wire
            keys = [await put("dds_tpu_torch", port, row) for row in rows]
            before = await sumall("dds_tpu_torch", port, n2)
            status, _, body = await request("dds_tpu_torch", port, "POST", "/_reshard",
                                            {"source": "s1"}, timeout=60.0)
            assert status == 200, body
            assert json.loads(body) == {"epoch": 2, "groups": ["s0", "s1", "s2"]}
            after = await sumall("dds_tpu_torch", port, n2)
            router = proxy.server.abd
            moved = [k for k in keys if router.owner(k) == "s2"]
            reads = []
            for k, row in zip(keys, rows):
                st, _, b = await request("dds_tpu_torch", port, "GET", f"/GetSet/{k}")
                reads.append(st == 200 and json.loads(b)["contents"] == row)
            # every group, reference or port, serves epoch 2
            epochs = []
            for gid, sp in fleet.s_ports.items():
                pkg = fleet.group_package(gid)
                st, h, b = await request(pkg, sp, "GET", "/shards")
                epochs.append((gid, st, h.get("etag"), json.loads(b)["map"]["epoch"]))
            s2_rows = sum(len(n.repository) for n in fleet.deps["s2"].replicas.values())
            return before, after, moved, reads, epochs, s2_rows
        finally:
            await fleet.stop()

    before, after, moved, reads, epochs, s2_rows = asyncio.run(asyncio.wait_for(go(), 120.0))
    assert before == after == want and key.decrypt(after) == sum(vals)
    assert moved and s2_rows > 0 and all(reads)
    assert epochs == [("s0", 200, '"2"', 2), ("s1", 200, '"2"', 2), ("s2", 200, '"2"', 2)]


def test_reference_proxy_bootstraps_port_groups_and_folds(key):
    vals = [3, 141, 59, 26, 535, 8979]
    rows = seeded_rows(key, vals, seed=2403)
    n2 = key.public.nsquare

    async def go():
        fleet = MiniFleet("dds_tpu_torch", proxy_pkg="dds_tpu")
        await fleet.start()
        try:
            port = fleet.proxy_port()
            assert type(fleet.deps["proxy"].server).__module__.startswith("dds_tpu.")
            st, _, body = await request("dds_tpu", port, "GET", "/shards")
            smap = mod("dds_tpu", "shard.shardmap").ShardMap.from_wire(json.loads(body)["map"])
            keys = [await put("dds_tpu", port, row) for row in rows]
            owners = {fleet.deps["proxy"].server.abd.owner(k) for k in keys}
            return st, smap.verify(SECRET), smap.epoch, owners, await sumall("dds_tpu", port,
                                                                             n2)
        finally:
            await fleet.stop()

    st, verified, epoch, owners, result = asyncio.run(asyncio.wait_for(go(), 60.0))
    assert st == 200 and verified and epoch == 1 and owners == {"s0", "s1"}
    assert result == host_product(rows, n2) and key.decrypt(result) == sum(vals)


@pytest.mark.parametrize("path", [f"configs/multihost/{n}.toml" for n in MULTIHOST]
                         + [f"configs/geo/{n}.toml" for n in GEO])
def test_unported_plane_names_only_fleet_observability(path, tmp_path):
    """`launch` accepts the file as written, its fleet plane on: a group
    role registers its span shipper at its transport, the proxy serves
    its collector's `GET /fleet/*`; the stop unregisters both."""
    directory, name = path.rsplit("/", 1)
    name = name.removesuffix(".toml")
    cfg = loopback_fleet(MULTIHOST if "multihost" in directory else GEO, directory,
                         tmp_path)[name]
    assert cfg.obs.fleet.enabled
    pan = mod("dds_tpu_torch", "obs.panopticon")

    async def go():
        dep = await mod("dds_tpu_torch", "run").launch(cfg)
        try:
            net = dep.net
            shipper = net.local_addr(pan.SHIPPER_ENDPOINT)
            collector = net.local_addr(pan.COLLECTOR_ENDPOINT)
            seen = (net.has_endpoint(shipper), net.has_endpoint(collector))
            routes = []
            if dep.cfg.fabric.role == "proxy":
                assert isinstance(dep.server._fleet, pan.FleetCollector)
                for arg in ("metrics", "slo", "incidents", "profile", "canary"):
                    st, _, _ = await request("dds_tpu_torch", dep.server.cfg.port, "GET",
                                             f"/fleet/{arg}")
                    routes.append(st)
        finally:
            await dep.stop()
        return dep.cfg.fabric.role, seen, routes, (net.has_endpoint(shipper),
                                                   net.has_endpoint(collector))

    role, seen, routes, after = asyncio.run(asyncio.wait_for(go(), 60.0))
    if role == "proxy":
        assert seen == (False, True) and routes == [200] * 5
    else:
        assert seen == (True, False)
    assert after == (False, False)


def loopback_fleet(names: list[str], directory: str, tmp_path) -> dict:
    """The files' configs with every host 127.0.0.1 and every port a free
    one (the collector's address among them), folding on the host:
    name -> DDSConfig."""
    DDSConfig = mod("dds_tpu_torch", "utils.config").DDSConfig
    cfgs = {n: DDSConfig.load(ROOT / directory / f"{n}.toml") for n in names}
    t_ports = {n: free_port() for n in names}
    s_ports = {n: free_port() for n in names}
    addr = {}  # the files' "host:port" -> loopback
    for n, cfg in cfgs.items():
        addr[f"{cfg.transport.host}:{cfg.transport.port}"] = f"127.0.0.1:{t_ports[n]}"
        if cfg.fabric.status_port:
            addr[f"{cfg.fabric.status_host}:{cfg.fabric.status_port}"] = \
                f"127.0.0.1:{s_ports[n]}"
    for n, cfg in cfgs.items():
        cfg.transport.host, cfg.transport.port = "127.0.0.1", t_ports[n]
        if cfg.fabric.status_port:
            cfg.fabric.status_host, cfg.fabric.status_port = "127.0.0.1", s_ports[n]
        cfg.fabric.groups = {g: addr[hp] for g, hp in cfg.fabric.groups.items()}
        cfg.fabric.bootstrap = [addr[hp] for hp in cfg.fabric.bootstrap]
        if cfg.obs.fleet.collector:
            cfg.obs.fleet.collector = addr[cfg.obs.fleet.collector]
        cfg.proxy.host, cfg.proxy.port = "127.0.0.1", 0
        cfg.proxy.crypto_backend, cfg.proxy.device = "cpu", "cpu"
        cfg.proxy.stored_keys_path = str(tmp_path / f"{n}_keys.json")
    return cfgs


@pytest.mark.parametrize("directory,names", [("configs/multihost", MULTIHOST),
                                             ("configs/geo", GEO)])
def test_each_role_of_the_fleet_files_launches_and_serves(directory, names, key, tmp_path):
    vals = [11, 22, 33, 44, 55, 66]
    rows = seeded_rows(key, vals, seed=2404)
    n2 = key.public.nsquare

    async def go():
        run = mod("dds_tpu_torch", "run")
        cfgs = loopback_fleet(names, directory, tmp_path)
        for cfg in cfgs.values():
            cfg.fabric.gossip_wait = 2.0
            cfg.recovery.enabled = False
        deps = {}
        try:
            for n in names:
                deps[n] = await run.launch(cfgs[n])
            proxy = deps[names[-1]]
            roles = [deps[n].cfg.fabric.role for n in names]
            port = proxy.server.cfg.port
            keys = [await put("dds_tpu_torch", port, row) for row in rows]
            total = await sumall("dds_tpu_torch", port, n2)
            router = proxy.server.abd
            local = []
            for k, row in zip(keys, rows):
                st, _, b = await request("dds_tpu_torch", port, "GET", f"/GetSet/{k}")
                assert st == 200 and json.loads(b)["contents"] == row
                gid = router.owner(k)
                local.append((gid, router.clients[gid].lease_state() is not None))
            return roles, total, local
        finally:
            for d in reversed(list(deps.values())):
                await d.stop()

    roles, total, local = asyncio.run(asyncio.wait_for(go(), 90.0))
    assert total == host_product(rows, n2) and key.decrypt(total) == sum(vals)
    if directory == "configs/geo":
        assert roles == ["group:0", "group:1", "group:2", "proxy"]
        # reads of the eu group's keys hold the eu read lease; the other
        # regions' groups are read through their quorums
        assert any(gid == "s0" and leased for gid, leased in local), local
        assert not any(leased for gid, leased in local if gid != "s0"), local
    else:
        assert roles == ["group:0", "group:1", "group:2", "proxy"]
