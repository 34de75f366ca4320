"""Meridian, the multi-host shard fabric, in the port against the reference.

Twins of `tests/test_fabric.py`: each case runs once on `dds_tpu` and once
on `dds_tpu_torch` from the same inputs, and the observations are compared.
Roles and the epoch-1 map (the wire map and its signature byte-equal), the
verified forward-only `RemoteShardManager`, role `all` over TCP with the
conditional `GET /shards`, the long-poll's push on an epoch bump, a remote
proxy's bootstrap (its SumAll equal to the host product of the same seeded
rows in both packages) and restart, the cross-host split under a seeded
ChaosNet on the proxy's and the target's fabrics, Zipf and percentile
math, the open-loop generator's coordinated-omission safety and its run
against a Constellation; the six reshape frames' wire bytes; a group
process stopped with a `/shards` long-poll parked on it, bounded in time;
and, marked `slow` as its twin, four `python -m dds_tpu_torch.run` OS
processes serving, splitting live and re-bootstrapping a restarted proxy.

Every fleet is loopback TCP inside one event loop (a `TcpNet` a process);
transport ports are taken free (bind 0, close) because each process's
config names the others'. The proxies fold on the host (`crypto-backend =
"cpu"`, the port's `device = "cpu"`).
"""

import asyncio
import importlib
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

pytestmark = pytest.mark.multihost

PKGS = ("dds_tpu", "dds_tpu_torch")
SECRET = b"intranet-abd-secret"
BOUND = 60.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def twin(scenario, *args, bound: float = BOUND):
    """`scenario(pkg, *args)` on both packages; equal observations."""
    ref, port = (asyncio.run(asyncio.wait_for(scenario(pkg, *args), bound)) for pkg in PKGS)
    assert port == ref
    return port


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def fabric_cfg(pkg, role, t_port, groups, bootstrap=(), status_port=0, *, count=2):
    """`tests/test_fabric.py`'s fabric config in package `pkg`."""
    cfg = mod(pkg, "utils.config").DDSConfig()
    cfg.shard.enabled = True
    cfg.shard.count = count
    cfg.transport.kind = "tcp"
    cfg.transport.port = t_port
    cfg.proxy.port = 0
    cfg.proxy.crypto_backend = "cpu"
    if pkg == "dds_tpu_torch":
        cfg.proxy.device = "cpu"
    cfg.recovery.enabled = False
    cfg.obs.audit_enabled = False
    cfg.fabric.role = role
    cfg.fabric.groups = dict(groups)
    cfg.fabric.bootstrap = list(bootstrap)
    cfg.fabric.status_port = status_port
    cfg.fabric.gossip_wait = 2.0
    cfg.fabric.admin_routes = True
    return cfg


async def request(pkg, port, method, target, obj=None, timeout=20.0, headers=None):
    status, hdrs, body = await mod(pkg, "http.miniserver").http_request_full(
        "127.0.0.1", port, method, target,
        json.dumps(obj).encode() if obj is not None else None,
        timeout=timeout, headers=headers)
    return status, hdrs, body


async def put(pkg, port, contents, timeout=20.0) -> str:
    status, _, body = await request(pkg, port, "POST", "/PutSet", {"contents": contents},
                                    timeout)
    assert status == 200, (status, body)
    return body.decode()


class MiniFleet:
    """S = 2 groups (and `standby` more) and a separate proxy of package
    `pkg`, each on its own TcpNet in this event loop. `proxy_pkg` and
    `group_pkg` mix the packages (tests/test_torch_meridian_mixed.py)."""

    def __init__(self, pkg, standby=0, proxy_pkg=None, group_pkg=None, chaos=()):
        self.proxy_pkg = proxy_pkg or pkg
        self.group_pkg = group_pkg or {}
        self.pkg = pkg
        self.t_ports = {f"s{i}": free_port() for i in range(2 + standby)}
        self.s_ports = {gid: free_port() for gid in self.t_ports}
        self.groups = {gid: f"127.0.0.1:{p}" for gid, p in self.t_ports.items()}
        self.bootstrap = [f"127.0.0.1:{p}" for p in self.s_ports.values()]
        self.chaos = set(chaos)  # names whose fabric runs under a ChaosNet
        self.deps = {}

    def group_package(self, gid):
        return self.group_pkg.get(gid, self.pkg)

    async def start(self):
        for gid, t_port in self.t_ports.items():
            pkg = self.group_package(gid)
            cfg = fabric_cfg(pkg, f"group:{gid[1:]}", t_port, self.groups, self.bootstrap,
                             self.s_ports[gid])
            if gid in self.chaos:
                cfg.attacks.chaos_enabled = True
                cfg.attacks.chaos_seed = 31
            self.deps[gid] = await mod(pkg, "run").launch(cfg)
        await self.start_proxy("proxy")
        return self

    async def start_proxy(self, name):
        cfg = fabric_cfg(self.proxy_pkg, "proxy", free_port(), self.groups, self.bootstrap)
        if "proxy" in self.chaos:
            cfg.attacks.chaos_enabled = True
            cfg.attacks.chaos_seed = 37
        self.deps[name] = await mod(self.proxy_pkg, "run").launch(cfg)
        return self.deps[name]

    def proxy_port(self, name="proxy"):
        return self.deps[name].server.cfg.port

    async def stop(self):
        for dep in reversed(list(self.deps.values())):
            await dep.stop()
        self.deps.clear()


def seeded_rows(pkg_key, vals, seed: int):
    """One Paillier-512 ciphertext a value, blinded from a seeded numpy
    generator, redrawn until the rows span both epoch-1 groups; the
    reference's `ShardMap` decides ownership (the maps are equal)."""
    from dds_tpu.shard.shardmap import ShardMap
    from dds_tpu.utils import sigs

    smap = ShardMap.build(["s0", "s1"], 16)
    rng = np.random.default_rng(seed)
    while True:
        rows = [[str(pkg_key.public.encrypt(v, r=int(rng.integers(2, 1 << 62))))]
                for v in vals]
        if {smap.owner(sigs.key_from_set(r)) for r in rows} == {"s0", "s1"}:
            return rows


@pytest.fixture(scope="module")
def key():
    return mod("dds_tpu", "models.paillier").PaillierKey.generate(512)


# ------------------------------------------------------------------- units


def test_parse_role_and_initial_map_wire_and_signature_byte_equal_twin():
    outs = {}
    for pkg in PKGS:
        deploy = mod(pkg, "fabric.deploy")
        roles = [deploy.parse_role(r) for r in ("all", "proxy", "group:2", "group:s7", "")]
        bad = []
        for r in ("bogus", "group:", "groups:1"):
            try:
                deploy.parse_role(r)
                bad.append(None)
            except ValueError:
                bad.append("refused")
        cfg = mod(pkg, "utils.config").DDSConfig()
        cfg.shard.count = 3
        m1, m2 = deploy.initial_map(cfg), deploy.initial_map(cfg)
        assert m1.vnodes == m2.vnodes and m1.epoch == m2.epoch == 1
        assert m1.verify(cfg.security.abd_mac_secret.encode())
        outs[pkg] = (roles, bad, json.dumps(m1.to_wire(), sort_keys=True), m1.signature)
    assert outs["dds_tpu_torch"] == outs["dds_tpu"]
    assert outs["dds_tpu"][0] == [("all", None), ("proxy", None), ("group", "s2"),
                                  ("group", "s7"), ("all", None)]
    assert outs["dds_tpu"][1] == ["refused"] * 3


def test_remote_shard_manager_verified_and_forward_only_twin():
    outs = {}
    for pkg in PKGS:
        ShardMap = mod(pkg, "shard.shardmap").ShardMap
        mgr_cls = mod(pkg, "fabric.gossip").RemoteShardManager
        m1 = ShardMap.build(["s0", "s1"], 8).sign(SECRET)
        mgr = mgr_cls(m1, SECRET)
        seen = [(mgr.epoch, mgr.state)]
        m2 = m1.split("s1", "s2").sign(SECRET)
        seen.append(mgr.install(m2, state="resharding"))
        seen.append((mgr.epoch, mgr.state))
        seen += [mgr.install(m2), mgr.install(m1, state="stable"), (mgr.epoch, mgr.state)]
        forged = ShardMap(m2.epoch + 1, m2.vnodes, m2.groups, b"nope")
        try:
            mgr.install(forged)
            seen.append("installed")
        except ValueError:
            seen.append("refused")
        outs[pkg] = (seen, m2.signature)
    assert outs["dds_tpu_torch"] == outs["dds_tpu"]
    assert outs["dds_tpu"][0] == [(1, "stable"), True, (2, "resharding"), False, False,
                                  (2, "stable"), "refused"]


def test_reshape_frames_encode_to_the_reference_bytes():
    """The six reshape frames (and the ack) of both codecs: equal bytes,
    and each decodes in the other package to an equal message."""
    ShardMap = mod("dds_tpu", "shard.shardmap").ShardMap
    wire = ShardMap.build(["s0", "s1"], 16).split("s1", "s2").sign(SECRET).to_wire()
    entries = {"K1": {"tag": [3, "127.0.0.1:7101/s0-replica-2"], "value": ["7", "x"]},
               "K2": {"tag": [1, "s1-replica-0"], "value": None}}
    args = {"ShardMapInstall": (wire, True, 11, 2.5), "ShardMapActivate": (wire, 12),
            "ShardMapAck": (13, 2, False, "shard map signature invalid"),
            "ShardExportRequest": ("127.0.0.1:7102/s1-replica-3", 14),
            "ShardExport": (15, entries), "ShardPruneRequest": (16,), "ShardPruned": (17, 5)}
    R, P = mod("dds_tpu", "core.messages"), mod("dds_tpu_torch", "core.messages")
    for name, a in args.items():
        ref, port = getattr(R, name)(*a), getattr(P, name)(*a)
        assert P.dumps(port) == R.dumps(ref), name
        assert P.loads(R.dumps(ref)) == port and R.loads(P.dumps(port)) == ref
    # the install's lease defaults to 0 (a commit) in both
    assert P.dumps(P.ShardMapInstall(wire, False, 1)) == R.dumps(R.ShardMapInstall(wire, False, 1))


# ------------------------------------------- role "all" over real sockets


async def all_role_conditional_get(pkg):
    dep = await mod(pkg, "run").launch(fabric_cfg(pkg, "all", 0, {}))
    try:
        port = dep.server.cfg.port
        key = await put(pkg, port, ["11", "22"])
        status, _, body = await request(pkg, port, "GET", f"/GetSet/{key}")
        got = [status, json.loads(body)["contents"]]
        status, headers, body = await request(pkg, port, "GET", "/shards")
        served = mod(pkg, "shard.shardmap").ShardMap.from_wire(json.loads(body)["map"])
        got += [status, headers.get("etag"), served.verify(SECRET)]
        status, headers, body = await request(pkg, port, "GET", "/shards",
                                              headers={"If-None-Match": '"1"'})
        got += [status, body, headers.get("etag")]
        status, _, body = await request(pkg, port, "GET", "/shards",
                                        headers={"If-None-Match": '"0"'})
        got += [status, json.loads(body)["map"]["epoch"]]
        return key, got
    finally:
        await dep.stop()


def test_tcp_all_role_smoke_and_shards_conditional_get_twin():
    key, got = twin(all_role_conditional_get)
    assert got == [200, ["11", "22"], 200, '"1"', True, 304, b"", '"1"', 200, 1]


async def longpoll_push(pkg):
    dep = await mod(pkg, "run").launch(fabric_cfg(pkg, "all", 0, {}))
    try:
        port = dep.server.cfg.port
        await put(pkg, port, ["1"])

        async def longpoll():
            t0 = time.monotonic()
            status, _, body = await request(pkg, port, "GET", "/shards?wait=30",
                                            headers={"If-None-Match": '"1"'}, timeout=40.0)
            return status, json.loads(body), time.monotonic() - t0

        poll = asyncio.ensure_future(longpoll())
        await asyncio.sleep(0.1)
        parked = not poll.done()
        status, _, body = await request(pkg, port, "POST", "/_reshard", {"source": "s1"},
                                        timeout=30.0)
        st, d, held = await asyncio.wait_for(poll, 10.0)
        smap = mod(pkg, "shard.shardmap").ShardMap.from_wire(d["map"])
        return [parked, status, json.loads(body), st, d["map"]["epoch"], held < 8.0,
                smap.verify(SECRET), json.dumps(d["map"], sort_keys=True)]
    finally:
        await dep.stop()


def test_shards_longpoll_returns_push_on_epoch_bump_twin():
    got = twin(longpoll_push)
    assert got[:7] == [True, 200, {"epoch": 2, "groups": ["s0", "s1", "s2"]}, 200, 2,
                       True, True]


# ----------------------------- multi-process-shaped fleet, one event loop


def test_remote_proxy_bootstrap_sumall_and_restart_twin(key):
    """A separate proxy bootstraps the signed map from a group's status
    listener, serves point ops and a scattered SumAll equal to the host
    product of the same seeded rows in both packages, and, stopped and
    started afresh, re-bootstraps from GET /shards with no operator
    input."""
    vals = [7, 21, 301, 44, 5, 600]
    rows = seeded_rows(key, vals, seed=2401)
    n2 = key.public.nsquare
    product = 1
    for r in rows:
        product = product * int(r[0]) % n2

    async def scenario(pkg):
        fleet = await MiniFleet(pkg).start()
        try:
            port = fleet.proxy_port()
            keys = [await put(pkg, port, row) for row in rows]
            owners = sorted({fleet.deps["proxy"].server.abd.owner(k) for k in keys})
            status, _, body = await request(pkg, port, "GET",
                                            f"/SumAll?position=0&nsqr={n2}", timeout=30.0)
            result = json.loads(body)["result"]
            await fleet.deps.pop("proxy").stop()
            await fleet.start_proxy("proxy2")
            port2 = fleet.proxy_port("proxy2")
            reads = []
            for k in keys:
                st, _, b = await request(pkg, port2, "GET", f"/GetSet/{k}")
                reads.append((st, json.loads(b)["contents"]))
            st, _, b = await request(pkg, port2, "GET", "/shards")
            smap = mod(pkg, "shard.shardmap").ShardMap.from_wire(json.loads(b)["map"])
            return (keys, owners, status, result, port2 != port, reads, st,
                    smap.verify(SECRET), smap.epoch)
        finally:
            await fleet.stop()

    keys, owners, status, result, moved, reads, st, verified, epoch = twin(scenario)
    assert owners == ["s0", "s1"] and status == 200
    assert int(result) == product and key.decrypt(int(result)) == sum(vals)
    assert moved and reads == [(200, r) for r in rows]
    assert st == 200 and verified and epoch == 1


def test_a_proxy_started_before_its_groups_answers_503_then_serves_twin():
    """No start order: a proxy launched before any group serves its own
    derived epoch-1 map (byte-equal to the one the groups derive) and
    answers 503 with a Retry-After, never a wrong answer, until the groups
    come up; then the same request succeeds."""

    async def scenario(pkg):
        fleet = MiniFleet(pkg)
        cfg = fabric_cfg(pkg, "proxy", free_port(), fleet.groups, fleet.bootstrap)
        cfg.proxy.request_budget = 0.5
        cfg.fabric.bootstrap_timeout = 0.5
        proxy = await mod(pkg, "run").launch(cfg)
        fleet.deps["proxy"] = proxy
        try:
            port = proxy.server.cfg.port
            st, _, body = await request(pkg, port, "GET", "/shards")
            early_map = json.loads(body)["map"]
            st1, h1, _ = await request(pkg, port, "POST", "/PutSet", {"contents": ["5"]})
            for gid, t_port in fleet.t_ports.items():
                fleet.deps[gid] = await mod(pkg, "run").launch(fabric_cfg(
                    pkg, f"group:{gid[1:]}", t_port, fleet.groups, fleet.bootstrap,
                    fleet.s_ports[gid]))
            _, _, gbody = await request(pkg, fleet.s_ports["s0"], "GET", "/shards")
            key = await put(pkg, port, ["5"])
            st2, _, body2 = await request(pkg, port, "GET", f"/GetSet/{key}")
            return (st, st1, int(h1.get("retry-after", 0)) >= 1,
                    early_map == json.loads(gbody)["map"],
                    json.dumps(early_map, sort_keys=True), st2, json.loads(body2))
        finally:
            await fleet.stop()

    got = twin(scenario)
    assert got[:4] == (200, 503, True, True) and got[5:] == (200, {"contents": ["5"]})


@pytest.mark.chaos
def test_cross_host_reshard_over_sockets_under_chaos_twin():
    """A standby group and a separate proxy beside S = 2, the proxy's and
    the target group's fabrics each a seeded ChaosNet over its TcpNet
    (delay, jitter and duplicates on the migration stream). Two writers
    hammer a key the split moves while POST /_reshard splits s1 onto s2
    across processes: the split activates epoch 2 everywhere, the value
    served afterwards is one of the writers' last acknowledged writes, the
    new owner serves it, the epoch fence engaged, and a Watchtower with
    each group's geometry finds no quorum-intersection violation. Chaos
    timing differs by package, so the twin compares these outcomes."""

    async def scenario(pkg):
        LinkFaults = mod(pkg, "core.chaos").LinkFaults
        metrics = mod(pkg, "obs.metrics").metrics
        tracer = mod(pkg, "utils.trace").tracer
        fleet = await MiniFleet(pkg, standby=1, chaos=("proxy", "s2")).start()
        wt = mod(pkg, "obs.watchtower").Watchtower(quorum_size=3, n_replicas=4)
        wt.configure(group_geometry={"s0": (3, 4), "s1": (3, 4), "s2": (3, 4)})
        wt.attach(tracer)
        try:
            port = fleet.proxy_port()
            smap = mod(pkg, "fabric.deploy").initial_map(fleet.deps["proxy"].cfg)
            m2 = smap.split("s1", "s2").sign(SECRET)
            rng = random.Random(5)
            moving = None
            while moving is None:
                k = await put(pkg, port, [str(rng.randrange(1 << 16))])
                if smap.owner(k) == "s1" and m2.owner(k) == "s2":
                    moving = k

            def fence_count():
                total = 0
                for s in ("s0", "s1", "s2"):
                    total += metrics.value("dds_wrong_shard_retries_total", shard=s) or 0
                    for msg in ("Envelope", "Write", "ReadTagBatch"):
                        total += metrics.value("dds_shard_fenced_total", shard=s,
                                               msg=msg) or 0
                return total

            fences_before = fence_count()
            for name in ("proxy", "s2"):
                fleet.deps[name].net.default_faults = LinkFaults(delay=0.005, jitter=0.02,
                                                                 duplicate=0.15)
            done = asyncio.Event()
            wrote = []

            async def writer(wid):
                i = 0
                while not (done.is_set() and i >= 3):
                    value = f"w{wid}-{i}"
                    status, _, _ = await request(pkg, port, "PUT",
                                                 f"/WriteElement/{moving}?position=0",
                                                 {"value": value})
                    if status == 200:
                        wrote.append(value)
                    i += 1

            async def split():
                await asyncio.sleep(0.05)
                try:
                    status, _, body = await request(pkg, port, "POST", "/_reshard",
                                                    {"source": "s1", "target": "s2"},
                                                    timeout=45.0)
                    return status, json.loads(body)
                finally:
                    done.set()

            _, _, (split_status, split_result) = await asyncio.gather(
                writer(0), writer(1), split())
            for name in ("proxy", "s2"):
                fleet.deps[name].net.default_faults = LinkFaults()
            status, _, body = await request(pkg, port, "GET", f"/GetSet/{moving}")
            final = json.loads(body)["contents"][0]
            last = {f"w{w}-{max(int(v.split('-')[1]) for v in wrote if v.startswith(f'w{w}-'))}"
                    for w in (0, 1) if any(v.startswith(f"w{w}-") for v in wrote)}
            epochs = []
            for gid, sp in fleet.s_ports.items():
                st, _, b = await request(pkg, sp, "GET", "/shards")
                epochs.append((gid, st, json.loads(b)["map"]["epoch"]))
            bad = [v for v in wt.verdicts() if v.invariant == "quorum_intersection"]
            return (split_status, split_result, bool(wrote), status, final in last,
                    fleet.deps["proxy"].server.abd.owner(moving), epochs,
                    fence_count() > fences_before, bad)
        finally:
            wt.detach()
            await fleet.stop()

    got = twin(scenario, bound=90.0)
    assert got == (200, {"epoch": 2, "groups": ["s0", "s1", "s2"]}, True, 200, True, "s2",
                   [("s0", 200, 2), ("s1", 200, 2), ("s2", 200, 2)], True, [])


# ------------------------------------------------------------- load plane


def test_zipf_distribution_skew_and_percentile_math_twin():
    outs = {}
    for pkg in PKGS:
        ZipfKeys = mod(pkg, "clt.distribution").ZipfKeys
        percentile = mod(pkg, "fabric.loadgen").percentile
        keys = [f"K{i}" for i in range(50)]
        z = ZipfKeys(keys, s=1.2, rng=random.Random(1))
        counts = {}
        for _ in range(4000):
            k = z.pick()
            counts[k] = counts.get(k, 0) + 1
        w = [z.weight(r) for r in range(1, 51)]
        try:
            ZipfKeys([], 1.0)
            empty = "built"
        except ValueError:
            empty = "refused"
        vals = sorted([0.01 * i for i in range(1, 101)])
        outs[pkg] = (counts, w, empty, percentile(vals, 50), percentile(vals, 99),
                     percentile([], 99))
    assert outs["dds_tpu_torch"] == outs["dds_tpu"]
    counts, w, empty, p50, p99, p_empty = outs["dds_tpu"]
    assert counts["K0"] == max(counts.values()) and counts["K0"] > 4000 / 50 * 4
    assert len(counts) > 25 and abs(sum(w) - 1.0) < 1e-9
    assert all(a >= b - 1e-12 for a, b in zip(w, w[1:]))
    assert empty == "refused" and p50 == pytest.approx(0.50) and p99 == pytest.approx(0.99)
    assert p_empty == 0.0


async def stalled_open_loop(pkg):
    """A stalled server does not slow the offered load, and the stall shows
    in the percentiles (latency from each scheduled arrival)."""
    ms = mod(pkg, "http.miniserver")
    ZipfKeys = mod(pkg, "clt.distribution").ZipfKeys
    stall = 0.25

    async def handler(req):
        await asyncio.sleep(stall)
        return ms.Response.json({"contents": ["1"]})

    server = ms.HttpServer("127.0.0.1", 0, handler)
    await server.start()
    try:
        load = mod(pkg, "fabric.loadgen").OpenLoopLoad(
            [f"127.0.0.1:{server.port}"], mix={"GetSet": 1.0}, timeout=2.0, seed=4,
            max_outstanding=512)
        load.keys = ["K"]
        load._zipf = ZipfKeys(load.keys, 1.0, random.Random(0))
        rate, duration = 80.0, 1.0
        report = await load.run(rate, duration)
        slo_total = load.slo.report()["routes"]["GetSet"]["windows"]["300s"]["total"]
        return (report.scheduled, report.scheduled > rate * duration * 0.6,
                report.good > 20, report.p50_ms >= stall * 1e3 * 0.95,
                report.p99_ms >= report.p95_ms >= report.p50_ms,
                slo_total >= report.completed)
    finally:
        await server.stop()


def test_open_loop_is_coordinated_omission_safe_twin():
    got = twin(stalled_open_loop)
    # the arrival schedule is the seeded Poisson draw: the same in both
    assert got[1:] == (True, True, True, True, True)


async def open_loop_constellation(pkg):
    const = mod(pkg, "shard").build_constellation(mod(pkg, "core.transport").InMemoryNet(),
                                                 shard_count=2, n_sentinent=0)
    pcfg = mod(pkg, "http.server").ProxyConfig(port=0, crypto_backend="cpu")
    if pkg == "dds_tpu_torch":
        pcfg.device = "cpu"
    server = mod(pkg, "http.server").DDSRestServer(const.router, pcfg)
    await server.start()
    try:
        load = mod(pkg, "fabric.loadgen").OpenLoopLoad([f"127.0.0.1:{server.cfg.port}"],
                                                       keys=10, seed=9, timeout=3.0)
        keys = await load.seed()
        r = (await load.sweep([60.0], 1.0))[0]
        d = r.to_dict()
        return (keys, r.scheduled, r.scheduled > 30 and r.good > 30, r.errors, r.failures,
                r.p50_ms <= r.p95_ms <= r.p99_ms,
                set(r.per_class) <= {"interactive", "aggregate"},
                "interactive" in r.per_class, "GetSet" in r.slo["routes"],
                json.loads(json.dumps(d)) == d)
    finally:
        await server.stop()
        await const.stop()


def test_open_loop_against_constellation_reports_slo_twin():
    got = twin(open_loop_constellation)
    assert len(got[0]) == 10 and len(set(got[0])) == 10
    assert got[2:] == (True, 0, 0, True, True, True, True, True)


# ----------------------------------------- stopping with a parked long-poll


def test_stopping_a_group_releases_its_parked_longpoll_at_once():
    """A group process holds a proxy's `/shards?wait=25` poll; stopping the
    process answers the poll (304: still epoch 1) and closes its
    connection at once, instead of waiting the poll out or a close timeout."""

    async def go():
        pkg = "dds_tpu_torch"
        t_port, s_port = free_port(), free_port()
        groups = {"s0": f"127.0.0.1:{t_port}", "s1": f"127.0.0.1:{free_port()}"}
        dep = await mod(pkg, "run").launch(
            fabric_cfg(pkg, "group:0", t_port, groups, (), s_port))
        stopped = False
        try:
            polls = [asyncio.ensure_future(request(
                pkg, s_port, "GET", "/shards?wait=25", headers={"If-None-Match": '"1"'},
                timeout=30.0)) for _ in range(3)]
            await asyncio.sleep(0.2)
            assert not any(p.done() for p in polls)
            t0 = time.monotonic()
            await dep.stop()
            stopped = True
            took = time.monotonic() - t0
            answers = await asyncio.wait_for(asyncio.gather(*polls), 2.0)
            return took, [a[0] for a in answers]
        finally:
            if not stopped:
                await dep.stop()

    took, statuses = asyncio.run(asyncio.wait_for(go(), 30.0))
    assert statuses == [304, 304, 304]
    assert took < 1.0, took


def test_group_role_health_and_status_listener_twin():
    """A group process's status listener: /health, the signed map with its
    replicas, the 405 and 404, in both packages."""

    async def scenario(pkg):
        t_port, s_port = free_port(), free_port()
        groups = {"s0": f"127.0.0.1:{t_port}", "s1": "127.0.0.1:1"}
        dep = await mod(pkg, "run").launch(
            fabric_cfg(pkg, "group:0", t_port, groups, (), s_port))
        try:
            st, _, body = await request(pkg, s_port, "GET", "/health")
            health = json.loads(body)
            st2, h2, body2 = await request(pkg, s_port, "GET", "/shards")
            shards = json.loads(body2)
            st3, _, _ = await request(pkg, s_port, "POST", "/shards", {})
            st4, _, _ = await request(pkg, s_port, "GET", "/nope")
            hp = groups["s0"]
            return (st, {k: health[k] for k in ("status", "role", "group", "shard_epoch",
                                                "reshard_state", "fence_epoch")},
                    sorted(n.replace(hp, "H") for n in health["replicas"]), st2,
                    h2.get("etag"), shards["state"],
                    {g: [a.replace(hp, "H") for a in v] for g, v in shards["groups"].items()
                     if g == "s0"},
                    json.dumps(shards["map"], sort_keys=True), st3, st4,
                    sorted(n.replace(hp, "H") for n in dep.replicas))
        finally:
            await dep.stop()

    got = twin(scenario)
    assert got[0] == 200 and got[1]["role"] == "group" and got[1]["fence_epoch"] == 1
    assert got[2] == [f"s0-replica-{i}" for i in range(5)] and got[8:10] == (405, 404)
    assert got[10] == [f"H/s0-replica-{i}" for i in range(5)]


# ------------------------------------------- flagship: real OS processes


def _fleet_tomls(tmp_path, t_ports, s_ports, proxy_port):
    groups = "\n".join(f's{i} = "127.0.0.1:{p}"' for i, p in enumerate(t_ports))
    bootstrap = json.dumps([f"127.0.0.1:{p}" for p in s_ports])
    common = ["[shard]", "enabled = true", "count = 2", "vnodes-per-group = 16",
              "replicas-per-group = 4", "sentinent-per-group = 1", "quorum-size = 3",
              "max-faults = 1", "", "[recovery]", "enabled = false", "",
              "[proxy]", 'host = "127.0.0.1"', f"port = {proxy_port}",
              'crypto-backend = "cpu"', 'device = "cpu"', ""]
    files = {}
    for name, role, t_port, s_port in (
            [(f"group{i}", f"group:{i}", t_ports[i], s_ports[i]) for i in range(3)]
            + [("proxy", "proxy", free_port(), 0)]):
        text = common + ["[transport]", 'kind = "tcp"', 'host = "127.0.0.1"',
                         f"port = {t_port}", "", "[fabric]", f'role = "{role}"',
                         f"status-port = {s_port}", f"bootstrap = {bootstrap}",
                         "gossip-wait = 2.0", "admin-routes = true", "",
                         "[fabric.groups]", groups, ""]
        files[name] = tmp_path / f"{name}.toml"
        files[name].write_text("\n".join(text))
    return files


@pytest.mark.slow
def test_flagship_multi_os_process_fleet_twin(tmp_path):
    """Four `python -m dds_tpu_torch.run` OS processes on loopback TCP (two
    groups, a standby group and a proxy): point ops and SumAll through the
    proxy, a live cross-host split mid-load, then the proxy process killed
    and restarted re-bootstraps the epoch-2 map from the groups."""
    t_ports = [free_port() for _ in range(3)]
    s_ports = [free_port() for _ in range(3)]
    port = free_port()
    files = _fleet_tomls(tmp_path, t_ports, s_ports, port)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = {}

    def spawn(name):
        log = open(tmp_path / f"{name}.log", "a")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "dds_tpu_torch.run", "--config", str(files[name]),
             "--serve", "--ops", "0"], cwd=root, stdout=log, stderr=subprocess.STDOUT)

    async def healthy():
        for _ in range(600):
            try:
                st, _, _ = await request("dds_tpu_torch", port, "GET", "/shards", timeout=2.0)
                if st == 200:
                    return
            except OSError:
                pass
            await asyncio.sleep(0.2)
        raise AssertionError("the fleet never served /shards")

    async def go():
        pkg = "dds_tpu_torch"
        await healthy()
        vals = [3, 141, 59, 26, 535, 8979]
        keys = [await put(pkg, port, [str(v)]) for v in vals]
        st, _, body = await request(pkg, port, "GET", "/SumAll?position=0", timeout=30.0)
        assert st == 200 and json.loads(body)["result"] == str(sum(vals))

        async def writer():
            ok = 0
            for i in range(30):
                st, _, _ = await request(pkg, port, "PUT", f"/WriteElement/{keys[0]}?position=1",
                                         {"value": f"mid-{i}"})
                ok += st == 200
                await asyncio.sleep(0.02)
            return ok

        async def split():
            await asyncio.sleep(0.1)
            st, _, body = await request(pkg, port, "POST", "/_reshard", {"source": "s1"},
                                        timeout=60.0)
            assert st == 200, body
            return json.loads(body)

        ok_writes, result = await asyncio.gather(writer(), split())
        assert result["epoch"] == 2 and "s2" in result["groups"] and ok_writes > 0
        st, _, body = await request(pkg, port, "GET", "/SumAll?position=0", timeout=30.0)
        assert st == 200 and json.loads(body)["result"] == str(sum(vals))
        proxy = procs.pop("proxy")
        proxy.send_signal(signal.SIGINT)
        proxy.wait(timeout=15)
        spawn("proxy")
        await healthy()
        st, _, body = await request(pkg, port, "GET", "/shards")
        d = json.loads(body)
        assert d["map"]["epoch"] == 2 and "s2" in d["map"]["groups"]
        for k, v in zip(keys, vals):
            st, _, body = await request(pkg, port, "GET", f"/GetSet/{k}")
            assert st == 200 and json.loads(body)["contents"][0] == str(v)

    try:
        for name in ("group0", "group1", "group2", "proxy"):
            spawn(name)
        asyncio.run(asyncio.wait_for(go(), 240.0))
    finally:
        for p in procs.values():
            p.send_signal(signal.SIGINT)
        for p in procs.values():
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=15)
