"""The port's ChaosNet, Nemesis and wire codec against the reference's
(`dds_tpu/core/chaos.py`, `malicious/trudy.py`, `core/messages.py`).

Twins of `tests/test_chaos.py`'s cases, each run in both packages and
compared: the fault trace of a seeded send sequence (corrupt included)
tuple for tuple, each fault kind, the partitions, `parse_attack`,
Nemesis's four attacks and its TypeError on a plain transport, the
breaker under timeouts, and the REST edge under a full partition (503
with Retry-After, then served again after heal) with statuses and bodies
equal. Then the codec: `dumps` byte-equal to the reference's for one
instance of every message class the port has, `loads(dumps(m)) == m`,
and a frame that names a class the port lacks decoding as nothing. The
cluster cases run on the virtual clock of
`tests/test_torch_linearizability.py`; the REST cases on a real loop.
"""

import asyncio
import dataclasses
import importlib
import json
import random
import time

import pytest

from tests.test_torch_linearizability import PACKAGES, Cluster, mods, run_virtual, seeded

pytestmark = pytest.mark.chaos


def both(fn, virtual: bool = True) -> dict:
    """`fn(pkg)` (a coroutine function) in each package; {pkg: result}."""
    if virtual:
        return {pkg: run_virtual(fn(pkg)) for pkg in PACKAGES}
    return {pkg: asyncio.run(asyncio.wait_for(fn(pkg), 30)) for pkg in PACKAGES}


def equal_in_both(fn, virtual: bool = True):
    out = both(fn, virtual)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    return out["dds_tpu_torch"]


async def scripted_sends(pkg: str, seed: int):
    """The reference's fixed send sequence through a faulty fabric
    (every fault kind, corrupt included); the trace and what arrived,
    each message as its wire form."""
    m = mods(pkg)
    net = m.chaos.ChaosNet(m.net.InMemoryNet(), seed=seed)
    net.default_faults = m.chaos.LinkFaults(
        drop=0.2, delay=0.001, jitter=0.002, duplicate=0.2, reorder=0.2, corrupt=0.2)
    got = []

    async def handler(sender, msg):
        got.append((sender, m.M.dumps(msg)))

    net.register("sink", handler)
    for i in range(40):
        net.send(f"src-{i % 3}", "sink", m.M.ReadTag(f"k{i}", i))
    await net.quiesce()
    return list(net.trace), sorted(got)


# ------------------------------------------------------------- determinism


def test_same_seed_gives_the_reference_trace_corrupt_included():
    out = equal_in_both(lambda pkg: scripted_sends(pkg, 1234))
    trace, got = out
    actions = {e[4].split("=")[0] for e in trace}
    assert {"drop", "duplicate", "parked", "delay"} <= actions
    assert actions & {"corrupt", "corrupt_undecodable"}
    # and again in the port: the trace is a function of the seed
    assert run_virtual(scripted_sends("dds_tpu_torch", 1234)) == out


def test_a_different_seed_changes_the_trace_in_both():
    a = equal_in_both(lambda pkg: scripted_sends(pkg, 4321))
    assert a[0] != run_virtual(scripted_sends("dds_tpu_torch", 1234))[0]


def test_the_trace_matches_the_reference_on_real_time_too():
    """Delivery times differ between hosts, the fault decisions do not:
    they are drawn inside send, in call order."""
    out = both(lambda pkg: scripted_sends(pkg, 99), virtual=False)
    assert out["dds_tpu_torch"][0] == out["dds_tpu"][0]
    assert out["dds_tpu_torch"][1] == out["dds_tpu"][1]


# --------------------------------------------------------- individual faults


def sink_net(m, seed=0):
    net = m.chaos.ChaosNet(m.net.InMemoryNet(), seed=seed)
    got = []

    async def handler(sender, msg):
        got.append(msg)

    net.register("sink", handler)
    return net, got


def test_drop_fault_twin():
    async def go(pkg):
        m = mods(pkg)
        net, got = sink_net(m)
        net.set_link("a", "sink", m.chaos.LinkFaults(drop=1.0))
        net.send("a", "sink", m.M.ReadTag("k", 1))
        net.send("b", "sink", m.M.ReadTag("k", 2))  # an unfaulted link flows
        await net.quiesce()
        return [x.nonce for x in got], net.trace

    nonces, trace = equal_in_both(go)
    assert nonces == [2] and [e[4] for e in trace] == ["drop"]


def test_delay_fault_defers_but_delivers_twin():
    async def go(pkg):
        m = mods(pkg)
        net, got = sink_net(m)
        net.set_dest("sink", m.chaos.LinkFaults(delay=0.03))
        t0 = time.monotonic()
        net.send("a", "sink", m.M.ReadTag("k", 1))
        early = list(got)
        await net.quiesce()
        return early, [x.nonce for x in got], time.monotonic() - t0 >= 0.025, net.trace

    early, nonces, waited, trace = equal_in_both(go, virtual=False)
    assert early == [] and nonces == [1] and waited
    assert trace == [(0, "a", "sink", "ReadTag", "delay=0.0300")]


def test_duplicate_fault_delivers_twice_twin():
    async def go(pkg):
        m = mods(pkg)
        net, got = sink_net(m)
        net.set_link("a", "sink", m.chaos.LinkFaults(duplicate=1.0))
        net.send("a", "sink", m.M.ReadTag("k", 7))
        await net.quiesce()
        return [x.nonce for x in got]

    assert equal_in_both(go) == [7, 7]


def test_reorder_fault_swaps_consecutive_messages_twin():
    async def go(pkg):
        m = mods(pkg)
        net, got = sink_net(m)
        net.set_link("a", "sink", m.chaos.LinkFaults(reorder=1.0))
        net.send("a", "sink", m.M.ReadTag("k", 1))  # parked
        net.send("a", "sink", m.M.ReadTag("k", 2))  # overtakes
        await net.quiesce()
        return [x.nonce for x in got], [e[4] for e in net.trace]

    nonces, actions = equal_in_both(go)
    assert nonces == [2, 1] and actions == ["parked", "released_reordered"]


def test_parked_message_flushes_on_a_quiet_link_twin():
    async def go(pkg):
        m = mods(pkg)
        net, got = sink_net(m)
        net.set_link("a", "sink", m.chaos.LinkFaults(reorder=1.0))
        net.send("a", "sink", m.M.ReadTag("k", 1))  # parked, nothing follows
        await asyncio.sleep(0.1)  # past the flush timer
        flushed = [x.nonce for x in got]
        net.send("a", "sink", m.M.ReadTag("k", 2))  # parked again
        await net.quiesce()  # quiesce releases it rather than stranding it
        return flushed, [x.nonce for x in got]

    assert equal_in_both(go) == ([1], [1, 2])


def test_corrupt_fault_mutates_or_drops_never_passes_verbatim_twin():
    async def go(pkg):
        m = mods(pkg)
        net, got = sink_net(m, seed=3)
        net.set_link("a", "sink", m.chaos.LinkFaults(corrupt=1.0))
        sent = [m.M.ReadTag(f"key-{i}", i) for i in range(20)]
        for x in sent:
            net.send("a", "sink", x)
        await net.quiesce()
        assert all(x not in sent for x in got)  # every survivor was mutated
        return [m.M.dumps(x) for x in got], net.trace

    got, trace = equal_in_both(go)
    assert 0 < len(got) < 20
    assert {e[4] for e in trace} == {"corrupt", "corrupt_undecodable"}


def test_an_undecodable_corruption_degrades_to_a_drop():
    """A flip inside the class name (here the R of ReadTag) leaves a name
    no package decodes, as does a class the port lacks: both drop."""
    ref = importlib.import_module("dds_tpu.core.messages")
    port = importlib.import_module("dds_tpu_torch.core.messages")
    with pytest.raises(KeyError):
        port.loads(ref.dumps(ref.TelemetryAck(1, True)))

    async def go(pkg):
        m = mods(pkg)
        net, got = sink_net(m)
        net.set_link("a", "sink", m.chaos.LinkFaults(corrupt=1.0))
        msg = m.M.ReadTag("k", 1)
        at = m.M.dumps(msg).index(b"ReadTag")
        net._rng.randrange = lambda n: at  # the flip lands on "R"
        net.send("a", "sink", msg)
        await net.quiesce()
        return got, net.trace

    got, trace = equal_in_both(go)
    assert got == [] and [e[4] for e in trace] == ["corrupt_undecodable"]


# ---------------------------------------------------------------- partitions


def boxes_net(m, names=("a", "b")):
    net = m.chaos.ChaosNet(m.net.InMemoryNet(), seed=0)
    boxes = {n: [] for n in names}
    for name in names:
        async def h(sender, msg, _name=name):
            boxes[_name].append(msg.nonce)
        net.register(name, h)
    return net, boxes


def test_symmetric_partition_blocks_both_directions_and_heals_twin():
    async def go(pkg):
        m = mods(pkg)
        net, boxes = boxes_net(m)
        p = net.partition(["a"])
        net.send("a", "b", m.M.ReadTag("k", 1))
        net.send("b", "a", m.M.ReadTag("k", 2))
        await net.quiesce()
        cut = {k: list(v) for k, v in boxes.items()}
        p.heal()
        net.send("a", "b", m.M.ReadTag("k", 3))
        net.send("b", "a", m.M.ReadTag("k", 4))
        await net.quiesce()
        return cut, boxes, net.trace

    cut, healed, trace = equal_in_both(go)
    assert cut == {"a": [], "b": []} and healed == {"a": [4], "b": [3]}
    assert [e[4] for e in trace] == ["cut a=['a']", "partition_drop", "partition_drop",
                                     "heal"]


def test_asymmetric_partition_blocks_one_direction_only_twin():
    async def go(pkg):
        m = mods(pkg)
        net, boxes = boxes_net(m)
        net.partition(["a"], ["b"], symmetric=False)
        net.send("a", "b", m.M.ReadTag("k", 1))  # a -> b cut
        net.send("b", "a", m.M.ReadTag("k", 2))  # b -> a flows
        await net.quiesce()
        return boxes

    assert equal_in_both(go) == {"a": [2], "b": []}


def test_timed_partition_heals_itself_twin():
    async def go(pkg):
        m = mods(pkg)
        net, boxes = boxes_net(m, ("b",))
        net.partition(["a"], duration=0.05)
        net.send("a", "b", m.M.ReadTag("k", 1))
        await asyncio.sleep(0.08)
        net.send("a", "b", m.M.ReadTag("k", 2))
        await net.quiesce()
        return boxes["b"], [e[4] for e in net.trace]

    assert equal_in_both(go) == ([2], ["cut a=['a']", "partition_drop", "heal"])


def test_partition_matches_bare_names_on_hostport_addresses_twin():
    for pkg in PACKAGES:
        m = mods(pkg)
        p = m.chaos.ChaosNet(m.net.InMemoryNet()).partition(["replica-1"])
        assert p.blocks("10.0.0.1:2552/replica-1", "10.0.0.2:2552/replica-2")
        assert p.blocks("10.0.0.2:2552/replica-2", "10.0.0.1:2552/replica-1")
        assert not p.blocks("10.0.0.2:2552/replica-2", "10.0.0.2:2552/replica-3")


def test_link_resolution_order_pair_dest_region_default_twin():
    """pair > dest > region pair > default, in both packages."""
    for pkg in PACKAGES:
        m = mods(pkg)
        LF = m.chaos.LinkFaults
        net = m.chaos.ChaosNet(m.net.InMemoryNet())
        net.default_faults = d = LF(drop=0.1)
        net.set_regions({"h:1/a": "eu", "b": "us", "c": "us"})
        net.set_region_link("eu", "us", r := LF(drop=0.2))
        assert net.region_of("x:9/a") == "eu" and net.region_members("us") == ["b", "c"]
        assert net._faults_for("a", "b") is r and net._faults_for("b", "a") is d
        net.set_dest("b", dst := LF(drop=0.3))
        assert net._faults_for("a", "b") is dst
        net.set_pair("a", "b", pair := LF(drop=0.4))
        assert net._faults_for("a", "b") is pair and net._faults_for("b", "a") is pair
        assert net.region_partition("us").blocks("b", "a")
        with pytest.raises(ValueError):
            net.region_partition("ap")
        net.heal_all()
        assert net._faults_for("a", "b") == LF() and not net.partitions


def test_chaos_events_reach_the_tracer_and_metrics_twin():
    async def go(pkg):
        m = mods(pkg)
        tracer = importlib.import_module(f"{pkg}.utils.trace").tracer
        metrics = importlib.import_module(f"{pkg}.obs.metrics").metrics
        tracer.reset()
        metrics.reset()
        net, _ = sink_net(m)
        net.set_link("a", "sink", m.chaos.LinkFaults(drop=1.0))
        net.send("a", "sink", m.M.ReadTag("k", 1))
        await net.quiesce()
        events = [(e.name, e.meta) for e in tracer.events() if e.name.startswith("chaos.")]
        series = [ln for ln in metrics.render().splitlines()
                  if ln.startswith("dds_chaos_events_total")]
        return events, series

    events, series = equal_in_both(go)
    assert events == [("chaos.drop", {"src": "a", "dest": "sink", "msg": "ReadTag",
                                      "action": "drop"})]
    assert series == ['dds_chaos_events_total{action="drop"} 1']


# ------------------------------------------------------------------- Nemesis


def test_parse_attack_knows_the_nemesis_attacks_twin():
    for pkg in PACKAGES:
        parse = importlib.import_module(f"{pkg}.malicious.trudy").parse_attack
        for name in ("partition", "delay", "flood", "heal"):
            assert parse(name).value == name
        with pytest.raises(ValueError, match="crash|byzantine|partition"):
            parse("emp")


def test_nemesis_partition_delay_flood_heal_twin():
    async def go(pkg):
        m = mods(pkg)
        net = m.chaos.ChaosNet(m.net.InMemoryNet(), seed=0)
        seen = []

        async def h(sender, msg):
            seen.append(m.M.dumps(msg))

        net.register("replica-0", h)
        nem = m.trudy.Nemesis(net, ["replica-0"], max_faults=1, rng=random.Random(1),
                              delay=0.01, flood_messages=5)
        out = {"partition": nem.trigger("partition")}
        out["blocks"] = bool(net.partitions) and net.partitions[0].blocks("replica-0", "x")
        out["delay"] = nem.trigger("delay")
        out["link"] = dataclasses.astuple(net.links["replica-0"])
        out["flood_cut"] = nem.trigger("flood")
        await net.quiesce()
        out["seen_cut"] = len(seen)  # replica-0 is isolated: the junk is cut
        out["heal"] = nem.trigger("heal")
        out["healed"] = (not net.partitions, not net.links)
        out["flood"] = nem.trigger("flood")
        await net.quiesce()
        out["seen"] = seen
        out["trace"] = net.trace
        return out

    out = equal_in_both(go)
    assert out["partition"] == ["replica-0"] and out["blocks"]
    assert out["link"] == (0.0, 0.01, 0.02, 0.0, 0.0, 0.0)
    assert out["seen_cut"] == 0 and out["heal"] == [] and out["healed"] == (True, True)
    assert len(out["seen"]) == 5
    port_M = mods("dds_tpu_torch").M
    assert all(isinstance(port_M.loads(x), port_M.Envelope) for x in out["seen"])


def test_nemesis_refuses_network_attacks_on_plain_transport_twin():
    for pkg in PACKAGES:
        m = mods(pkg)
        nem = m.trudy.Nemesis(m.net.InMemoryNet(), ["r0"], rng=random.Random(0))
        for attack in ("partition", "delay", "heal"):
            with pytest.raises(TypeError):
                nem.trigger(attack)
        trudy = m.trudy.Trudy(m.net.InMemoryNet(), ["r0"], rng=random.Random(0))
        with pytest.raises(ValueError, match="Nemesis"):
            trudy.trigger("flood")


# --------------------------------------- breaker integration (quorum client)


def test_timeouts_trip_breaker_not_permanent_suspicion_twin():
    """A partitioned proxy opens its coordinator's breaker but earns it no
    suspicion strike; after heal and the breaker's reset the same replica
    coordinates again."""

    async def go(pkg):
        clock = asyncio.get_running_loop().time
        c = Cluster(pkg, seed=9, clock=clock)
        retry = c.m.retry
        c.client.cfg.request_timeout = 0.1
        for b in c.client.breakers.values():
            b.reset_timeout = 0.15
        c.client.replicas.reset(["replica-0"])  # force the coordinator pick
        p = c.net.partition(["proxy-0"])
        for _ in range(3):
            with pytest.raises(asyncio.TimeoutError):
                await c.client.fetch_set("K")
        tripped = c.client.breakers["replica-0"].state
        strikes = c.client.replicas._strikes["replica-0"]
        trusted = c.client.replicas.get_trusted()
        p.heal()
        await asyncio.sleep(0.2)  # past the reset: a half-open probe
        value = await c.client.fetch_set("K")
        return (tripped == retry.CircuitBreaker.OPEN, strikes, trusted, value,
                c.client.breakers["replica-0"].state == retry.CircuitBreaker.CLOSED,
                c.net.trace)

    with seeded(9):
        out = equal_in_both(go)
    assert out[:5] == (True, 0, ["replica-0"], None, True)


# ------------------------------------- REST graceful degradation end-to-end


async def chaos_rest_stack(pkg: str, **proxy_kw):
    """The reference's REST stack over a ChaosNet (seed 77): 4 replicas,
    quorum 3, a 0.12 s request timeout and a 0.8 s budget (`proxy_kw`
    overrides ProxyConfig fields)."""
    m = mods(pkg)
    server_mod = importlib.import_module(f"{pkg}.http.server")
    net = m.chaos.ChaosNet(m.net.InMemoryNet(), seed=77)
    rcfg = m.rep.ReplicaConfig(quorum_size=3)
    addrs = [f"replica-{i}" for i in range(4)]
    replicas = {a: m.rep.BFTABDNode(a, addrs, "supervisor", net, rcfg) for a in addrs}
    abd = m.qc.AbdClient("proxy-0", net, addrs,
                         m.qc.AbdClientConfig(request_timeout=0.12, quorum_size=3,
                                              breaker_reset=0.15))
    abd.replicas._rng = random.Random(7)
    kw = {"device": "cpu", "crypto_backend": "cpu"} if pkg == "dds_tpu_torch" else {}
    kw = {"request_budget": 0.8, **kw, **proxy_kw}
    server = server_mod.DDSRestServer(abd, server_mod.ProxyConfig(
        host="127.0.0.1", port=0, retry_backoff=0.02, retry_max_delay=0.1,
        retry_after_hint=1.0, **kw))
    await server.start()
    return net, server, replicas


def test_rest_returns_503_with_retry_after_under_full_partition_then_heals_twin():
    """A GET and a PUT while every replica is unreachable answer 503 with
    Retry-After within the budget, /health reads degraded, and the same
    server serves again after heal, in both packages with the same
    statuses and bodies."""

    async def go(pkg):
        mini = importlib.import_module(f"{pkg}.http.miniserver")
        net, server, _ = await chaos_rest_stack(pkg)
        port = server.cfg.port
        seen = []

        async def call(method, target, obj=None):
            body = json.dumps(obj).encode() if obj is not None else None
            t0 = time.monotonic()
            status, headers, data = await mini.http_request_full(
                "127.0.0.1", port, method, target, body)
            return status, headers, data, time.monotonic() - t0

        try:
            status, _, body, _ = await call("POST", "/PutSet", {"contents": ["a", "b"]})
            seen.append((status, body))
            key = body.decode()
            p = net.partition(["proxy-0"])  # the proxy cut off from every replica
            for method, target, obj in (("GET", f"/GetSet/{key}", None),
                                        ("POST", "/PutSet", {"contents": ["x"]})):
                status, headers, body, took = await call(method, target, obj)
                assert took < 3 * server.cfg.request_budget, took
                seen.append((status, int(headers["retry-after"]) >= 1))
            for r in server.abd.replicas.get_all():
                for _ in range(server.abd.cfg.breaker_threshold):
                    server.abd._breaker(r).record_failure()
            status, headers, body, _ = await call("GET", "/health")
            health = json.loads(body)
            seen.append((status, health["status"],
                         health["reachable_replicas"] < health["quorum_size"],
                         "retry-after" in headers))
            p.heal()
            await asyncio.sleep(0.2)
            status, _, body, _ = await call("GET", f"/GetSet/{key}")
            seen.append((status, json.loads(body)))
            status, _, body, _ = await call("GET", "/health")
            health = json.loads(body)
            seen.append((status, health["status"], health["active_replicas"]))
        finally:
            await server.stop()
            await net.stop()
        return seen

    seen = equal_in_both(go, virtual=False)
    assert seen[1:] == [(503, True), (503, True), (503, "degraded", True, True),
                        (200, {"contents": ["a", "b"]}), (200, "ok", 4)]


def test_an_exhausted_attempt_cap_answers_503_not_500():
    """With `retry_attempts` set, the last timed-out attempt of a partitioned
    GetSet ends the request before its budget. The port answers 503 with
    Retry-After, as for an exhausted budget; the reference lets the
    TimeoutError through and answers 500 (ROADMAP §C 13)."""

    async def go(pkg):
        mini = importlib.import_module(f"{pkg}.http.miniserver")
        net, server, _ = await chaos_rest_stack(pkg, request_budget=5.0, retry_attempts=1)
        try:
            status, _, body = await mini.http_request_full(
                "127.0.0.1", server.cfg.port, "POST", "/PutSet",
                json.dumps({"contents": ["a"]}).encode())
            assert status == 200
            net.partition(["proxy-0"])
            t0 = time.monotonic()
            status, headers, _ = await mini.http_request_full(
                "127.0.0.1", server.cfg.port, "GET", f"/GetSet/{body.decode()}")
            return status, headers.get("retry-after"), time.monotonic() - t0
        finally:
            await server.stop()
            await net.stop()

    out = both(go, virtual=False)
    assert out["dds_tpu"][:2] == (500, None)
    status, retry_after, took = out["dds_tpu_torch"]
    assert status == 503 and int(retry_after) >= 1 and took < 5.0


def test_health_route_reports_ok_on_a_healthy_chaos_stack_twin():
    async def go(pkg):
        mini = importlib.import_module(f"{pkg}.http.miniserver")
        net, server, _ = await chaos_rest_stack(pkg)
        try:
            status, body = await mini.http_request("127.0.0.1", server.cfg.port, "GET",
                                                   "/health")
            health = json.loads(body)
            return status, {k: health[k] for k in ("status", "active_replicas",
                                                   "quorum_size", "breakers")}
        finally:
            await server.stop()

    assert equal_in_both(go, virtual=False) == (
        200, {"status": "ok", "active_replicas": 4, "quorum_size": 3, "breakers": {}})


# ---------------------------------------------------------------- the codec


def one_of_each(M) -> list:
    """One instance of every message class the port has, in the
    reference's or the port's `M`, nested and byte-valued fields set."""
    tag = M.ABDTag(7, "replica-2")
    sig = bytes(range(32))
    return [
        M.IRead("k"), M.IWrite("k", [1, "a", None]), M.IWrite("k", None),
        M.IReadReply("k", ["x"], tag), M.IWriteReply("k", tag),
        M.Envelope(M.IWrite("k", ["v", 2]), 12345, sig, epoch=3),
        M.ReadTag("k", 9), M.TagReply(tag, "k", ["v"], sig, 10),
        M.Write(tag, "k", None, sig, 11), M.WriteAck("k", 12), M.Read("k", 13),
        M.ReadReply(tag, "k", [{"__msg__": "IRead", "key": "x"}], sig, 14),
        M.ReadTagBatch(("a", "b"), 15, sig, b"\x01\x02", 2),
        M.TagBatchReply((tag, M.ABDTag(1, "r")), "d", sig, 16, False, b"fp"),
        M.Suspect("replica-1", 17), M.Awake(),
        M.State({"k": {"tag": [1, "r"], "value": None}}, [1, 2]),
        M.Sleep({"k": {"tag": [1, "r"], "value": ["v"]}}, [3]), M.Complying(), M.Kill(),
        M.Redeploy("replica-3"), M.Redeployed("replica-3"), M.RequestReplicas(),
        M.ActiveReplicas(["replica-0", "replica-1"]), M.Compromise(), M.Crash(),
        M.StateDigestRequest(18), M.StateDigest({"k": [1, "r", "ab"]}, 19, sig),
        M.SleepBegin([["r", {}, 1, "00"]], 4, 2, 2, [5]),
        M.StateChunk(4, 0, {"k": {"tag": [1, "r"], "value": None}}, kind="migrate"),
        M.MerkleRootRequest(20), M.MerkleRoot("root", 3, 21, sig),
        M.MerkleBucketRequest(22), M.MerkleBuckets(["aa", "bb"], 23, sig),
        M.MerkleKeysRequest([1, 2], 24), M.MerkleKeys({"k": [1, "r", "d"]}, 25, sig),
        M.RepairRequest(["k"], 26), M.RepairReply({"k": {"sig": "00"}}, 27),
        M.WrongShard("k", 2, 28, sig),
        M.ShardMigrateBegin([["r", {"k": [1, "r", "d"]}, 29, "00"]], 30, 2, 2, 3),
        M.ShardMigrateAck(30, 5, 1),
    ]


def test_dumps_is_byte_equal_to_the_reference_for_every_class():
    ref = importlib.import_module("dds_tpu.core.messages")
    port = importlib.import_module("dds_tpu_torch.core.messages")
    made = one_of_each(port)
    assert {type(x).__name__ for x in made} == set(port._TYPES)
    assert set(port._TYPES) <= set(ref._TYPES)
    for p, r in zip(made, one_of_each(ref)):
        assert port.dumps(p) == ref.dumps(r), type(p).__name__
        assert port.loads(port.dumps(p)) == p
        assert port.loads(ref.dumps(r)) == p
        assert ref.loads(port.dumps(p)) == r
    # a column value shaped like a message stays an opaque list
    rr = made[11]
    assert port.loads(port.dumps(rr)).value == [{"__msg__": "IRead", "key": "x"}]


# ------------------------------------------- a parked message's trace context


def reorder_audit(pkg: str, seed: int, n_ops: int = 120):
    """Quorum reads and writes over 8 keys through 2 % reordering on every
    link, with the package's Watchtower on its tracer: its verdicts, the
    fault trace and every op's answer."""

    async def go():
        wt = importlib.import_module(f"{pkg}.obs.watchtower").watchtower
        tracer = importlib.import_module(f"{pkg}.utils.trace").tracer
        tracer.reset()
        wt.reset()
        wt.configure(quorum_size=5, n_replicas=7, check_quorum=True)
        wt.attach(tracer)
        try:
            clock = asyncio.get_running_loop().time
            c = Cluster(pkg, seed=seed, clock=clock, request_timeout=0.25)
            c.net.default_faults = c.m.chaos.LinkFaults(reorder=0.02)
            retry = c.m.retry
            rng = random.Random(seed)
            policy = retry.RetryPolicy(base=0.01, max_delay=0.08)
            answers = []
            for i in range(n_ops):
                key = f"k{rng.randrange(8)}"
                dl = retry.Deadline(15.0, clock=clock)
                if rng.random() < 0.5:
                    op = (lambda k=key, v=[i], d=dl: c.client.write_set(k, v, deadline=d))
                else:
                    op = (lambda k=key, d=dl: c.client.fetch_set(k, deadline=d))
                answers.append(await retry.retry_deadline(op, dl, policy, rng=rng))
            await c.net.quiesce()
            await asyncio.sleep(1.0)
            return sorted(v.invariant for v in wt.verdicts()), list(c.net.trace), answers
        finally:
            wt.detach()
            wt.reset()

    with seeded(seed):
        return run_virtual(go())


def test_a_released_parked_message_keeps_its_senders_trace():
    """A parked message released behind the link's next message is
    delivered under its own sender's context in the port. The reference
    delivers it under the releasing send's, so the receiver's spans move to
    another trace and its Watchtower flags quorum_intersection on reads
    whose quorums were whole: under the same seeded schedule the fault
    trace and every answer are equal, and only the reference has verdicts."""
    ref = reorder_audit("dds_tpu", 1)
    port = reorder_audit("dds_tpu_torch", 1)
    assert port[1] == ref[1] and port[2] == ref[2]
    assert "released_reordered" in {e[4] for e in port[1]}
    assert ref[0] and set(ref[0]) == {"quorum_intersection"}
    assert port[0] == []


def test_a_parked_message_is_delivered_in_its_senders_context():
    async def go():
        m = mods("dds_tpu_torch")
        ctxm = importlib.import_module("dds_tpu_torch.obs.context")
        net, _ = sink_net(m)
        seen = []

        async def handler(sender, msg):
            seen.append((msg.nonce, ctxm.current().trace_id))

        net.register("sink", handler)
        net.set_link("a", "sink", m.chaos.LinkFaults(reorder=1.0))
        for nonce, trace in ((1, "first"), (2, "second")):
            token = ctxm.attach(ctxm.SpanContext(trace, "span"))
            try:
                net.send("a", "sink", m.M.ReadTag("k", nonce))
            finally:
                ctxm.detach(token)
        await net.quiesce()
        return seen

    assert run_virtual(go()) == [(2, "second"), (1, "first")]
