"""The port's Atlas geo plane (`dds_tpu_torch/geo`, the region labels of
`shard/shardmap.py`, the lease gate of `core/replica.py`, the read-local
path of `core/quorum_client.py`, the geo Constellation of
`shard/fabric.py`) against the reference's.

Each in-process case of `tests/test_geo.py` runs in both packages from
the same seeds and, where time matters, an injected clock, and the two
must agree exactly: WAN presets and spec tables, the retry profiles, the
ChaosNet region matrix (precedence, the one-way partition with a timed
heal, the seeded fault trace), signed region labels and their wire dict,
the lease table's grants, revocations, expiry and forgery (equal tokens),
the quorum gate's decisions, the read-local single hop, lease safety, the
holder-death stall bound, the Watchtower's three lease verdicts,
Helmsman's `region_down` takeover, placement modes, the region-preferring
standby, the seeded anti-entropy pairing and the sentry's geo records.
Then `configs/geo/wan_soak.toml`: the port's `launch` accepts it,
and both packages launch it on `cpu` with the same region census, signed
map wire dict and SumAll answer; `convert.shardmap_*` carries a signed,
labelled map across both ways; and a short port-only region-death drill.
The twin of the reference's full drill is `slow`, as its twin is. The
`gpu` cases fold a geo SumAll on the card and hold it against the plain
path bit for bit.
"""

import asyncio
import dataclasses
import importlib
import json
import pathlib
import random
import time
import types

import pytest

pytestmark = pytest.mark.geo

PKGS = ("dds_tpu", "dds_tpu_torch")
SECRET = b"intranet-abd-secret"
R3 = ["r0", "r1", "r2"]
ROOT = pathlib.Path(__file__).resolve().parent.parent
N2 = ((1 << 61) - 1) ** 2


def mods(pkg: str):
    """The geo-relevant modules of `pkg`, by short name."""
    names = {
        "M": "core.messages", "chaos": "core.chaos", "net": "core.transport",
        "qc": "core.quorum_client", "ae": "core.antientropy",
        "fleet": "fleet", "wan": "geo.wan", "lease": "geo.lease",
        "metrics": "obs.metrics", "wt": "obs.watchtower", "shard": "shard",
        "config": "utils.config", "retry": "utils.retry", "trace": "utils.trace",
        "run": "run", "mini": "http.miniserver",
    }
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()})


def lin():
    """`tests/test_torch_linearizability.py` (its virtual clock and the
    atomic-register checker), imported when a CPU case needs it: the card's
    tests run with `--noconftest`, where the `tests` package is not on the
    path."""
    return importlib.import_module("tests.test_torch_linearizability")


def run_virtual(coro):
    return lin().run_virtual(coro)


def both(fn, virtual: bool = False, bound: float = 60.0) -> dict:
    """`fn(pkg)` (a coroutine function) in each package: {pkg: result}."""
    if virtual:
        return {pkg: run_virtual(fn(pkg)) for pkg in PKGS}
    return {pkg: asyncio.run(asyncio.wait_for(fn(pkg), bound)) for pkg in PKGS}


def twin(fn, virtual: bool = False, bound: float = 60.0):
    out = both(fn, virtual, bound)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    return out["dds_tpu_torch"]


def sync_twin(fn):
    ref, port = fn("dds_tpu"), fn("dds_tpu_torch")
    assert port == ref
    return port


def metric_sum(m, name, **match):
    """Sum a counter family over every label set matching `match`."""
    fam = m.metrics.metrics._families.get(name)
    if fam is None:
        return 0.0
    total = 0.0
    for key, v in fam.samples.items():
        labels = dict(key)
        if all(labels.get(k) == want for k, want in match.items()):
            total += v
    return total


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def geo_constellation(m, S=2, net=None, seed=7, regions=R3, placement="span",
                      lease_ttl=0.0, client_region="", **kw):
    net = net or m.net.InMemoryNet()
    kw.setdefault("n_active", 3)
    kw.setdefault("n_sentinent", 0)
    kw.setdefault("quorum", 2)
    const = m.shard.build_constellation(
        net, shard_count=S, vnodes_per_group=8, seed=seed,
        regions=list(regions), placement=placement,
        lease_ttl=lease_ttl, client_region=client_region, **kw,
    )
    return const, net


def faults(f) -> dict:
    return dataclasses.asdict(f)


def raises(fn) -> str:
    """The exception type `fn()` raises ("" when none)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is the observation
        return type(e).__name__
    return ""


# ------------------------------------------------------- WAN profile loader


def test_wan_presets_scale_one_way_delay_twin():
    def go(pkg):
        wan = mods(pkg).wan
        f = wan.preset_faults("wan-200")
        assert f.delay == pytest.approx(0.100) and f.jitter == pytest.approx(0.020)
        scaled = wan.preset_faults("wan-300", scale=0.02)
        assert scaled.delay == pytest.approx(0.003)
        return (faults(f), faults(scaled), sorted(wan.WAN_PRESETS.items()),
                raises(lambda: wan.preset_faults("wan-9000")))

    assert sync_twin(go)[-1] == "ValueError"


def test_wan_spec_tables_ms_keys_and_rejection_twin():
    def go(pkg):
        wan = mods(pkg).wan
        f = wan.faults_from_spec({"delay-ms": 120, "jitter-ms": 18, "drop": 0.01})
        assert (f.delay, f.jitter, f.drop) == (pytest.approx(0.120),
                                               pytest.approx(0.018), 0.01)
        g = wan.faults_from_spec({"preset": "wan-100", "drop": 0.2}, scale=0.5)
        assert g.delay == pytest.approx(0.025) and g.drop == 0.2
        h = wan.faults_from_spec({"delay_ms": 7, "jitter": 0.5, "duplicate": 0.1,
                                  "reorder": 0.2, "corrupt": 0.3})
        return (faults(f), faults(g), faults(h),
                raises(lambda: wan.faults_from_spec({"delay-ms": 10, "latency": 3})),
                raises(lambda: wan.faults_from_spec(42)))

    assert sync_twin(go)[-2:] == ("ValueError", "ValueError")


def test_wan_profile_pairs_and_mesh_twin():
    def go(pkg):
        wan = mods(pkg).wan
        prof = wan.parse_profiles({"eu<->us": "wan-100", "us->ap": {"delay-ms": 5}})
        assert set(prof) == {("eu", "us"), ("us", "eu"), ("us", "ap")}
        mesh = wan.mesh(R3, "wan-100")
        assert set(mesh) == {"r0<->r1", "r0<->r2", "r1<->r2"}
        assert wan.parse_profiles(mesh)[("r2", "r0")].delay == pytest.approx(0.05)
        return ({k: faults(v) for k, v in sorted(prof.items())}, mesh,
                raises(lambda: wan.parse_profiles({"eu/us": "wan-100"})))

    assert sync_twin(go)[-1] == "ValueError"


def test_retry_profiles_derive_deadlines_from_rtt_twin():
    def go(pkg):
        rc = mods(pkg).config.RetryConfig(profiles={
            "eu": {"rtt-ms": 100},
            "ap": {"rtt-ms": 200, "request-budget": 9.0},
            "us": {"retry-backoff": 0.05},
        })
        eu, ap = rc.overrides_for("eu"), rc.overrides_for("ap")
        assert eu["retry_backoff"] == pytest.approx(0.2)
        assert eu["request_budget"] == pytest.approx(2.4)
        assert ap["request_budget"] == 9.0
        bad = mods(pkg).config.RetryConfig(profiles={"eu": {"budget": 1}})
        return (eu, ap, rc.overrides_for("us"), rc.overrides_for("nowhere"),
                raises(lambda: bad.overrides_for("eu")))

    assert sync_twin(go)[-1] == "ValueError"


# --------------------------------------------------- ChaosNet region matrix


def _region_net(m, seed=3):
    net = m.chaos.ChaosNet(m.net.InMemoryNet(), seed=seed)
    got = []

    async def handler(sender, msg):
        got.append((sender, msg.nonce))

    for name in ("a0", "a1", "b0"):
        net.register(name, handler)
    net.set_regions({"a0": "A", "a1": "A", "b0": "B"})
    return net, got


def test_region_link_matrix_and_precedence_twin():
    async def go(pkg):
        m = mods(pkg)
        net, got = _region_net(m)
        net.set_region_link("A", "B", m.chaos.LinkFaults(drop=1.0))
        net.send("a0", "b0", m.M.ReadTag("k", 1))   # region matrix: dropped
        net.send("a0", "a1", m.M.ReadTag("k", 2))   # intra-region: clean
        net.send("b0", "a0", m.M.ReadTag("k", 3))   # no B->A entry: clean
        await net.quiesce()
        first = [n for _, n in got]
        # a surgical per-link override beats the blanket WAN matrix
        net.set_link("a0", "b0", m.chaos.LinkFaults())
        net.send("a0", "b0", m.M.ReadTag("k", 4))
        await net.quiesce()
        return (first, [n for _, n in got], net.region_of("a1"),
                net.region_members("A"), raises(lambda: net.region_partition("pacific")),
                list(net.trace))

    first, after, region, members, err, _ = twin(go, virtual=True)
    assert (first, after, region, members, err) == (
        [2, 3], [2, 3, 4], "A", ["a0", "a1"], "ValueError")


def test_one_way_region_partition_with_timed_heal_twin():
    async def go(pkg):
        m = mods(pkg)
        net, got = _region_net(m)
        # asymmetric: B still HEARS the world but cannot answer
        net.region_partition("B", symmetric=False, duration=0.05)
        net.send("b0", "a0", m.M.ReadTag("k", 1))   # leaving B: cut
        net.send("a0", "b0", m.M.ReadTag("k", 2))   # into B: delivered
        await net.quiesce()
        cut = [n for _, n in got]
        await asyncio.sleep(0.08)                    # the timed heal fires
        net.send("b0", "a0", m.M.ReadTag("k", 3))
        await net.quiesce()
        return cut, [n for _, n in got], list(net.trace)

    cut, healed, trace = twin(go, virtual=True)
    assert cut == [2] and healed == [2, 3]
    assert [r for r in trace if r[4] == "partition_drop"]
    assert [r for r in trace if r[3] == "partition" and r[4] == "heal"]


async def _wan_schedule(pkg, seed):
    """A fixed send schedule through a lossy WAN matrix and a one-way
    region partition: the trace is a function of the seed."""
    m = mods(pkg)
    net, got = _region_net(m, seed=seed)
    m.wan.apply_profiles(net, {"A<->B": {"preset": "wan-100", "drop": 0.3}},
                         scale=0.01)
    p = None
    for i in range(40):
        if i == 20:
            p = net.region_partition("B", symmetric=False)
        src, dst = ("a0", "b0") if i % 2 else ("b0", "a0")
        net.send(src, dst, m.M.ReadTag(f"k{i}", i))
    await net.quiesce()
    p.heal()
    return list(net.trace), got


def test_wan_fault_trace_is_seeded_deterministic_twin():
    t1, _ = twin(lambda pkg: _wan_schedule(pkg, 11), virtual=True)
    t3, _ = twin(lambda pkg: _wan_schedule(pkg, 12), virtual=True)
    assert t1 == run_virtual(_wan_schedule("dds_tpu_torch", 11))[0]
    assert t1 != t3
    # the cut was one-way: only traffic LEAVING B partition-drops
    cut = [(r[1], r[2]) for r in t1 if r[4] == "partition_drop"]
    assert cut and all(src == "b0" for src, _ in cut)


# ------------------------------------------------- region-labeled ShardMap


def test_shardmap_region_labels_signed_and_wire_compat_twin():
    def go(pkg):
        ShardMap = mods(pkg).shard.ShardMap
        m = ShardMap.build(["s0", "s1"], 8, regions={"s0": "r0", "s1": "r1"}).sign(SECRET)
        assert m.verify(SECRET)
        assert m.region_of("s0") == "r0" and m.region_of("s9") == ""
        back = ShardMap.from_wire(m.to_wire())
        assert back.verify(SECRET) and back.region_of("s1") == "r1"
        # labels follow the map through its lifecycle
        split, merged, relabeled = m.split("s0", "s2"), m.merge("s1"), m.relabel("s0", "s7")
        assert split.region_of("s2") == "r0" and merged.region_of("s1") == ""
        assert relabeled.region_of("s7") == "r0"
        moved = m.with_regions({"s0": "ap", "s1": "eu"})
        assert not moved.verify(SECRET) and moved.sign(SECRET).verify(SECRET)
        plain = ShardMap.build(["s0", "s1"], 8).sign(SECRET)
        assert "regions" not in plain.to_wire()
        assert ShardMap.from_wire(plain.to_wire()).verify(SECRET)
        return (m.to_wire(), split.sign(SECRET).to_wire(), merged.sign(SECRET).to_wire(),
                relabeled.sign(SECRET).to_wire(), moved.sign(SECRET).to_wire(),
                plain.to_wire())

    wires = sync_twin(go)
    # each package verifies the other's signed maps, labelled or not
    for pkg in PKGS:
        ShardMap = mods(pkg).shard.ShardMap
        assert all(ShardMap.from_wire(w).verify(SECRET) for w in wires)


# --------------------------------------------------------- LeaseTable unit


def test_lease_table_grant_revoke_expire_and_forgery_twin():
    def go(pkg):
        clk = _Clock()
        t = mods(pkg).lease.LeaseTable("s0", SECRET, clock=clk)
        obs = []
        lease = t.grant("r0", "s0-replica-0", ttl=5.0)
        assert lease.expires == pytest.approx(clk.t + 5.0)
        obs += [dataclasses.astuple(lease), t.valid("r0", "s0-replica-0", lease.token),
                sorted(t.holders()), t.held_by("s0-replica-0"), t.held_by("s0-replica-1"),
                t.census()]
        # forged or mismatched tokens never validate
        obs += [t.valid("r0", "s0-replica-0", "f" * len(lease.token)),
                t.valid("r1", "s0-replica-0", lease.token),
                t.valid("r0", "s0-replica-1", lease.token)]
        # a renewal replaces the grant; the OLD token dies with it
        renewed = t.grant("r0", "s0-replica-0", ttl=5.0)
        obs += [renewed.token, t.valid("r0", "s0-replica-0", lease.token)]
        # revocation is immediate
        obs += [t.revoke("r0"), t.valid("r0", "s0-replica-0", renewed.token),
                sorted(t.holders()), t.revoke("r0")]
        # expiry is lazy on the table clock
        gone = t.grant("r0", "s0-replica-0", ttl=5.0)
        clk.t += 5.1
        obs += [gone.token, t.valid("r0", "s0-replica-0", gone.token),
                t.active("r0"), sorted(t.holders()), t.census()]
        return obs

    obs = sync_twin(go)
    assert obs[1:6] == [True, ["s0-replica-0"], True, False,
                        {"r0": {"replica": "s0-replica-0", "remaining": 5.0}}]
    assert obs[6:9] == [False, False, False]
    assert obs[9] != obs[0][3] and obs[10] is False
    assert obs[11:15] == [True, False, [], False]
    assert obs[16:] == [False, None, [], {}]


def test_quorum_gate_is_pinned_on_active_holders_twin():
    async def go(pkg):
        m = mods(pkg)
        const, _ = geo_constellation(m, S=1, lease_ttl=5.0, client_region="r0")
        try:
            g = const.groups[0]
            node = next(iter(g.replicas.values()))
            clk = _Clock()
            g.lease_table.clock = clk
            others = {"s0-replica-1", "s0-replica-2"}
            out = [node._quorum_met(others)]            # no leases: plain >= q
            g.lease_table.grant("r0", "s0-replica-0", ttl=5.0)
            out += [node._quorum_met(others),           # holder missing
                    node._quorum_met(others | {"s0-replica-0"}),
                    node._quorum_met({"s0-replica-0"})]  # holder, below q
            g.lease_table.revoke("r0")
            out.append(node._quorum_met(others))        # unpinned again
            g.lease_table.grant("r0", "s0-replica-0", ttl=5.0)
            clk.t += 5.1                                # TTL bounds the stall
            out.append(node._quorum_met(others))
            return out
        finally:
            await const.stop()

    assert twin(go) == [True, False, True, False, True, True]


# ------------------------------------------------- read-local lease reads


def test_read_local_lease_serves_in_region_single_hop_twin():
    async def go(pkg):
        m = mods(pkg)
        const, net = geo_constellation(m, S=2, lease_ttl=5.0, client_region="r0")
        sent = []
        real_send = net.send

        def counting_send(src, dst, msg):
            sent.append((src, dst, type(msg).__name__))
            real_send(src, dst, msg)

        net.send = counting_send
        try:
            r = const.router
            served0 = metric_sum(m, "dds_geo_local_reads_total", result="served")
            await r.write_set("atlas-key", ["v1"])
            first = await r.fetch_set("atlas-key")
            g = const.group(r.owner("atlas-key"))
            holders = sorted(g.lease_table.holders())
            state = g.client.lease_state()
            # a warm lease read is ONE hop out and one back
            del sent[:]
            warm = await r.fetch_set("atlas-key")
            hops = sorted(sent)
            served = metric_sum(m, "dds_geo_local_reads_total", result="served") - served0
            # freshness through the pinned quorum
            await r.write_set("atlas-key", ["v2"])
            fresh = await r.fetch_set("atlas-key")
            row = r.shards_health()[g.gid]
            return (g.gid, first, warm, fresh, holders, state["region"],
                    state["replica"] in g.lease_table.holders(), served >= 2, hops,
                    row["region"] == g.home_region, row["lease"]["region"],
                    row["lease"]["replica"])
        finally:
            net.send = real_send
            await const.stop()

    out = twin(go)
    gid, first, warm, fresh, holders, region, holding, served, hops = out[:9]
    assert (first, warm, fresh) == (["v1"], ["v1"], ["v2"])
    assert holders == [f"{gid}-replica-0"] and region == "r0" and holding and served
    assert hops == [(f"{gid}-proxy", f"{gid}-replica-0", "LocalRead"),
                    (f"{gid}-replica-0", f"{gid}-proxy", "LocalReadReply")]
    assert out[9:] == (True, "r0", f"{gid}-replica-0")


def test_lease_safety_revoked_or_expired_never_serves_stale_twin():
    """Seeded: acked writes interleaved with revocations and expiries;
    every read returns exactly the last acked write, because a revoked or
    expired lease degrades to the full quorum path."""
    async def one_seed(m, seed):
        const, _ = geo_constellation(m, S=1, seed=seed, lease_ttl=50.0,
                                     client_region="r0")
        g = const.groups[0]
        clk = _Clock()
        g.lease_table.clock = clk
        g.client._now = clk
        rng = random.Random(seed)
        last: dict = {}
        reads, refusals = [], 0
        try:
            for i in range(36):
                clk.t += 0.6
                key = f"k{rng.randrange(3)}"
                roll = rng.random()
                if roll < 0.55:
                    value = [f"s{seed}-{i}"]
                    await g.client.write_set(key, value)
                    last[key] = value
                elif roll < 0.75 and g.lease_table.active("r0"):
                    g.lease_table.revoke("r0")
                    refusals += 1
                elif roll < 0.85:
                    clk.t += 60.0             # past both TTL and session
                got = await g.client.fetch_set(key)
                assert got == last.get(key), (seed, i, key, got, last.get(key))
                reads.append((key, got))
        finally:
            await const.stop()
        return reads, refusals

    async def go(pkg):
        m = mods(pkg)
        before = metric_sum(m, "dds_geo_local_reads_total")
        fallbacks = metric_sum(m, "dds_geo_local_read_fallbacks_total")
        out = [await one_seed(m, seed) for seed in (101, 202, 303)]
        return (out, metric_sum(m, "dds_geo_local_reads_total") > before,
                metric_sum(m, "dds_geo_local_read_fallbacks_total") > fallbacks)

    out, local, fell_back = twin(go)
    assert sum(refusals for _, refusals in out) > 0 and local and fell_back


def test_holder_death_stalls_quorums_at_most_one_ttl_twin():
    async def go(pkg):
        m = mods(pkg)
        net = m.chaos.ChaosNet(m.net.InMemoryNet(), seed=5)
        const, _ = geo_constellation(
            m, S=1, net=net, lease_ttl=0.6, client_region="r0",
            abd_cfg=m.qc.AbdClientConfig(quorum_size=2, request_timeout=0.25),
        )
        try:
            g = const.groups[0]
            await g.client.write_set("k", ["v0"])
            first = await g.client.fetch_set("k")
            holder = next(iter(g.lease_table.holders()))
            p = net.partition([holder])
            t0 = time.monotonic()
            dl = m.retry.Deadline(6.0)
            await m.retry.retry_deadline(
                lambda: g.client.write_set("k", ["v1"], deadline=dl),
                dl, m.retry.RetryPolicy(base=0.05, multiplier=2.0, max_delay=0.2),
                rng=random.Random(1), retry_on=(Exception,),
            )
            elapsed = time.monotonic() - t0
            p.heal()
            # the rejoined ex-holder missed the write; one anti-entropy pull
            # repairs it, after which a freshly granted lease serves it
            peer = next(e for e in g.all_replicas() if e != holder)
            await g.replicas[holder].antientropy.sync_once(peer)
            return first, holder, 0.2 < elapsed < 4.0, await g.client.fetch_set("k")
        finally:
            await const.stop()
            await net.quiesce()

    assert twin(go) == (["v0"], "s0-replica-0", True, ["v1"])


def test_a_dead_holder_keeps_the_references_lease_target_and_the_port_moves_it():
    """ROADMAP §C 18, repaired in the port only. A group of 6 replicas, two
    in the client's region r0; the lease holder crashes. Every read still
    answers the acknowledged value in both packages. The reference's
    client keeps asking the crashed holder for the lease (its first
    in-region trusted replica), so no lease comes back; the port counts
    the lease-plane timeouts against the holder's breaker and, once it
    opens, takes the lease from the region's other replica."""
    async def go(pkg):
        m = mods(pkg)
        const, net = geo_constellation(
            m, S=1, n_active=6, quorum=4, lease_ttl=0.6, client_region="r0",
            abd_cfg=m.qc.AbdClientConfig(quorum_size=4, request_timeout=0.25,
                                         local_read_timeout=0.2, breaker_threshold=1),
        )
        try:
            g = const.groups[0]
            rng = random.Random(2)

            async def read():
                dl = m.retry.Deadline(6.0)
                return await m.retry.retry_deadline(
                    lambda: g.client.fetch_set("k", deadline=dl), dl,
                    m.retry.RetryPolicy(base=0.05, multiplier=2.0, max_delay=0.2),
                    rng=rng, retry_on=(Exception,))

            await g.client.write_set("k", ["v0"])
            reads = [await read()]
            holder = g.client.lease_state()["replica"]
            net.send("trudy", holder, m.M.Crash())
            for _ in range(4):
                await asyncio.sleep(0.55)  # past the grant backoff
                reads.append(await read())
            state = g.client.lease_state()
            return (holder, reads, state["replica"] if state else None,
                    sorted(g.lease_table.holders()))
        finally:
            await const.stop()
            await net.quiesce()

    out = both(go)
    ref, port = out["dds_tpu"], out["dds_tpu_torch"]
    assert ref[:2] == port[:2] == ("s0-replica-0", [["v0"]] * 5)
    assert ref[2:] == (None, [])
    assert port[2:] == ("s0-replica-3", ["s0-replica-3"])


def test_concurrent_reads_share_one_grant_in_the_port_and_refuse_each_other_in_the_reference():
    """ROADMAP §C 19, repaired in the port only. Eight reads start at once
    on a client with no lease session. Every grant mints a new token and
    kills the last, so the reference's eight grant rounds leave all but
    the last reader's token refused and those reads on the quorum path;
    the port's reads share one grant round and are all served locally.
    Every read answers its acknowledged value in both."""
    async def go(pkg):
        m = mods(pkg)
        const, net = geo_constellation(m, S=1, lease_ttl=5.0, client_region="r0")
        sent = []
        real_send = net.send

        def counting_send(src, dst, msg):
            sent.append(type(msg).__name__)
            real_send(src, dst, msg)

        try:
            g = const.groups[0]
            keys = [f"k{i}" for i in range(8)]
            for k in keys:
                await g.client.write_set(k, [k])
            net.send = counting_send
            refused = metric_sum(m, "dds_geo_local_read_fallbacks_total", reason="refused")
            served = metric_sum(m, "dds_geo_local_reads_total", result="served")
            reads = await asyncio.gather(*(g.client.fetch_set(k) for k in keys))
            return (reads == [[k] for k in keys], sent.count("LeaseRequest"),
                    metric_sum(m, "dds_geo_local_read_fallbacks_total", reason="refused")
                    - refused,
                    metric_sum(m, "dds_geo_local_reads_total", result="served") - served)
        finally:
            net.send = real_send
            await const.stop()

    out = both(go)
    assert out["dds_tpu"] == (True, 8, 7.0, 1.0)
    assert out["dds_tpu_torch"] == (True, 1, 0.0, 8.0)


# ------------------------------------------------- Watchtower lease audit


def _lease_verdicts(pkg, lease_lookup, script):
    m = mods(pkg)
    wt = m.wt.Watchtower(quorum_size=2, n_replicas=3)
    wt.configure(lease_lookup=lease_lookup)
    t = m.trace.Tracer()
    wt.attach(t)

    def commit_write(key, seq, tid):
        reps = [f"replica-{i}" for i in range(3)]
        with t.span("http.write"):
            with t.span("abd.write", coordinator="replica-0", ok=True,
                        op="write", key=key, seq=seq, tag_id=tid):
                for r in reps[:2]:
                    with t.span("replica.handle", replica=r, msg="ReadTag", key=key):
                        pass
                for r in reps[:2]:
                    with t.span("replica.handle", replica=r, msg="Write", key=key):
                        pass

    def lease_read(key, seq, tid, replica):
        with t.span("http.read"):
            with t.span("abd.fetch", ok=True, op="read", key=key, seq=seq,
                        tag_id=tid, lease=True, replica=replica):
                pass

    script(commit_write, lease_read)
    return sorted(v.invariant for v in wt.verdicts())


def test_watchtower_accepts_clean_lease_read_twin():
    def script(write, read):
        write("k", 1, "replica-0")
        read("k", 1, "replica-0", replica="replica-1")

    assert sync_twin(lambda pkg: _lease_verdicts(
        pkg, lambda r: r == "replica-1", script)) == []


def test_watchtower_flags_lease_read_by_non_holder_twin():
    def script(write, read):
        write("k", 1, "replica-0")
        read("k", 1, "replica-0", replica="replica-2")  # forged

    assert sync_twin(lambda pkg: _lease_verdicts(
        pkg, lambda r: r == "replica-1", script)) == ["lease_intersection"]


def test_watchtower_files_stale_lease_read_as_lease_staleness_twin():
    def script(write, read):
        write("k", 1, "replica-0")
        write("k", 2, "replica-0")
        read("k", 1, "replica-0", replica="replica-1")  # trails seq 2

    invariants = set(sync_twin(lambda pkg: _lease_verdicts(pkg, lambda r: True, script)))
    assert "lease_staleness" in invariants
    assert not invariants & {"read_sees_latest", "tag_monotonicity", "quorum_intersection"}


# ------------------------------------------- Helmsman region-death logic


def test_helmsman_declares_region_down_and_promotes_with_label_twin():
    async def go(pkg):
        m = mods(pkg)
        clock = _Clock()
        census = {"s0": 50, "s1": 50, "s2": 50}
        ages = {"s0": 0.1, "s1": 0.1, "s2": 0.1}
        regions = {"s0": "r0", "s1": "r0", "s2": "r2"}
        promoted = []

        async def promote(gid):
            promoted.append(gid)

        hm = m.fleet.Helmsman(
            load_census=lambda: dict(census), slo_alerts=lambda: [],
            shed_level=lambda: 0, source_ages=lambda: dict(ages),
            split=lambda g: None, merge=lambda g: None, promote=promote,
            moved_bytes=lambda: 0, reshard_busy=lambda: False,
            regions=lambda: dict(regions), clock=clock,
            heartbeat_timeout=5.0, cooldown=30.0, min_ops=10_000,
        )
        before = metric_sum(m, "dds_helmsman_region_down_total", region="r2")
        steps = [await hm.step()]            # learn the census
        clock.t += 60
        ages["s0"] = 99.0                    # a process crash in a LIVE region
        steps.append(await hm.step())
        crash_only = not any(r["action"] == "region_down" for r in hm.history)
        clock.t += 120
        ages["s0"], ages["s2"] = 0.1, 99.0   # the r2-homed group ages out
        steps.append(await hm.step())
        counted = metric_sum(m, "dds_helmsman_region_down_total", region="r2") - before
        ages["s2"] = 0.1                     # heal: fresh heartbeats
        await hm.step()
        return (steps, promoted, crash_only, [dict(r) for r in hm.history],
                counted, sorted(hm._regions_down))

    steps, promoted, crash_only, history, counted, down_now = twin(go)
    assert steps[1:] == ["promote", "promote"] and promoted == ["s0", "s2"] and crash_only
    down = [r for r in history if r["action"] == "region_down"]
    assert down and down[0]["region"] == "r2" and down[0]["groups"] == ["s2"]
    take = [r for r in history if r["action"] == "promote"][-1]
    assert take["dead"] == "s2" and take["region"] == "r2"
    assert counted == 1 and down_now == []


# --------------------------------- placement, census, standby preference


def test_placement_modes_census_and_signed_homes_twin():
    async def go(pkg):
        m = mods(pkg)
        const, net = geo_constellation(m, S=3, placement={"s2": "home"})
        try:
            smap = const.manager.current()
            labels = const.regions_of_endpoints()
            return ({g.gid: g.home_region for g in const.groups},
                    {g.gid: g.region_census() for g in const.groups},
                    {g.gid: g.replica_regions for g in const.groups},
                    smap.verify(SECRET), smap.to_wire(), labels)
        finally:
            await const.stop()

    homes, census, placed, verified, wire, labels = twin(go)
    assert homes == {"s0": "r0", "s1": "r1", "s2": "r2"} and verified
    assert census["s0"] == {"r0": 1, "r1": 1, "r2": 1} and census["s2"] == {"r2": 3}
    assert wire["regions"] == [["s0", "r0"], ["s1", "r1"], ["s2", "r2"]]
    assert labels["s2-supervisor"] == "r2" and labels["s0-proxy"] == "r0"
    assert all(labels[e] in R3 for e in placed["s0"])


def test_promotion_prefers_standby_homed_in_dead_groups_region_twin():
    async def go(pkg):
        m = mods(pkg)
        const, _ = geo_constellation(m, S=3, placement={"s2": "home"})
        extra = []
        try:
            sb_r0 = const._acquire_standby(prefer_region="r0")
            sb_r1 = const._acquire_standby(prefer_region="r1")
            homes = (sb_r0.gid, sb_r0.home_region, sb_r1.gid, sb_r1.home_region)
            extra += [sb_r0, sb_r1]
            const.standbys.extend([sb_r0, sb_r1])
            by_region = const._acquire_standby(prefer_region="r1") is sb_r1
            const.standbys.insert(1, sb_r1)
            fallback = const._acquire_standby(prefer_region="r9") is sb_r0
            const.standbys.clear()
            dead = const.group("s2")
            reborn = await const.promote("s2")
            extra.append(dead)
            key = next(f"K{i}" for i in range(200)
                       if const.router.owner(f"K{i}") == reborn.gid)
            await const.router.write_set(key, ["post-takeover"])
            return (homes, by_region, fallback, reborn.gid, reborn.home_region,
                    const.manager.current().to_wire(), "s2" in const.gids, key,
                    await const.router.fetch_set(key))
        finally:
            await const.stop()
            for g in extra:
                if g not in const.standbys:
                    await g.stop()

    out = twin(go)
    assert out[0][1::2] == ("r0", "r1") and out[1] and out[2]
    assert out[4] == "r2" and [out[3], "r2"] in out[5]["regions"] and not out[6]
    assert out[8] == ["post-takeover"]


# ------------------------------------------- anti-entropy cross-region


def test_antientropy_cross_region_peer_bias_is_seeded_twin():
    regions = {"s0-replica-0": "r0", "s0-replica-1": "r0",
               "s0-replica-2": "r1", "s0-replica-3": "r2"}
    peers = ["s0-replica-1", "s0-replica-2", "s0-replica-3"]

    def go(pkg):
        AntiEntropy = mods(pkg).ae.AntiEntropy
        node = types.SimpleNamespace(addr="s0-replica-0", name="s0-replica-0")

        def picks(bias, seed=9, n=24):
            ae = AntiEntropy(node)
            ae.configure(rng=random.Random(seed), regions=regions,
                         cross_region_bias=bias)
            return [ae._pick_peer(peers) for _ in range(n)]

        ae = AntiEntropy(node)
        ae.configure(rng=random.Random(9))
        return (picks(1.0), picks(0.0), picks(0.5), picks(0.5, seed=10),
                [ae._pick_peer(peers) for _ in range(8)])

    always, never, mixed, other_seed, unaware = sync_twin(go)
    assert all(cross and regions[p] != "r0" for p, cross in always)
    assert all(not cross and p == "s0-replica-1" for p, cross in never)
    assert {c for _, c in mixed} == {True, False} and mixed != other_seed
    assert all(not cross for _, cross in unaware)


# ----------------------------------------------------------------- sentry


def test_sentry_check_parses_geo_records_twin(tmp_path):
    from benchmarks.sentry import _check_geo_records
    from dds_tpu_torch.obs.sentry import check_geo_records

    bench = tmp_path / "benchmarks"
    bench.mkdir()
    good = {"metric": "geo latency", "value": 2.41, "unit": "x", "vs_baseline": 2.41,
            "detail": {"local_p95_ms": 4.1, "quorum_p95_ms": 104.2, "reads": 400,
                       "leased_reads": 310, "fallbacks": 24, "revoked_mid_run": True,
                       "stale_reads": 0, "wan_preset": "wan-100"}}

    def both_check(rows):
        (bench / "results.json").write_text(json.dumps(rows))
        out = []
        for check in (_check_geo_records, check_geo_records):
            try:
                out.append(check(str(tmp_path)))
            except ValueError:
                out.append("ValueError")
        assert out[0] == out[1]
        return out[1]

    assert both_check([good]) == {"rows": 1}
    for broken in (
        dict(good, value=-1),
        dict(good, detail=dict(good["detail"], stale_reads=1)),
        dict(good, detail=dict(good["detail"], revoked_mid_run=False)),
        dict(good, detail=dict(good["detail"], leased_reads=None)),
        dict(good, detail={"local_p95_ms": 1.0}),
        dict(good, detail=dict(good["detail"], wan_preset="lan")),
    ):
        assert both_check([good, broken]) == "ValueError"
    assert both_check([{"metric": "autoscale goodput", "value": -1}]) == {"rows": 0}
    (bench / "results.json").write_text("{not json")
    with pytest.raises(ValueError):
        check_geo_records(str(tmp_path))


# ---------------------------------------------- configs/geo/wan_soak.toml


def wan_soak(pkg):
    cfg = mods(pkg).config.DDSConfig.load(ROOT / "configs" / "geo" / "wan_soak.toml")
    cfg.proxy.port = 0
    if pkg == "dds_tpu_torch":
        cfg.proxy.device = "cpu"
    return cfg


def test_wan_soak_toml_is_a_plane_the_port_serves():
    from tests.test_torch_config import launch_accepts

    cfg = wan_soak("dds_tpu_torch")
    assert cfg.geo.enabled and cfg.chaos.profiles and cfg.attacks.chaos_enabled
    assert launch_accepts(cfg)


def test_wan_soak_toml_launches_in_both_with_the_same_census_map_and_sumall():
    """The file as it stands on `cpu` (an OS-assigned port): 3 span groups
    of 6 replicas, 2 in each region, the eu proxy's leases, the WAN matrix
    at scale 1.0. Both packages give the same census, signed map wire dict
    and WAN links, and the same SumAll over 24 PutSets."""
    rng = random.Random(22)
    vals = [rng.randrange(2, N2) for _ in range(24)]

    async def go(pkg):
        m = mods(pkg)
        dep = await m.run.launch(wan_soak(pkg))
        try:
            const, port = dep.constellation, dep.server.cfg.port

            async def put(v):
                st, body = await m.mini.http_request(
                    "127.0.0.1", port, "POST", "/PutSet",
                    json.dumps({"contents": [str(v)]}).encode(), timeout=30)
                assert st == 200, body
                return body.decode()

            keys = await asyncio.gather(*(put(v) for v in vals))
            st, body = await m.mini.http_request(
                "127.0.0.1", port, "GET", f"/SumAll?position=0&nsqr={N2}", timeout=60)
            st_h, health = await m.mini.http_request("127.0.0.1", port, "GET", "/health")
            health = json.loads(health)
            links = {k: faults(f) for k, f in sorted(dep.net.region_links.items())}
            return ({g.gid: g.region_census() for g in const.groups},
                    const.manager.current().to_wire(), links, sorted(keys), st,
                    int(json.loads(body)["result"]), health["region"],
                    {g: ("region" in s, "lease" in s) for g, s in health["shards"].items()},
                    {g.gid: g.home_region for g in const.groups})
        finally:
            await dep.stop()

    out = twin(go, bound=120.0)
    census, wire, links, _, status, result, region, rows, homes = out
    want = 1
    for v in vals:
        want = want * v % N2
    assert census == {g: {"ap": 2, "eu": 2, "us": 2} for g in ("s0", "s1", "s2")}
    assert wire["regions"] == [["s0", "eu"], ["s1", "us"], ["s2", "ap"]]
    assert links[("eu", "us")]["delay"] == pytest.approx(0.05)
    assert links[("ap", "us")]["drop"] == 0.005
    assert status == 200 and result == want and region == "eu"
    assert rows == {g: (True, True) for g in ("s0", "s1", "s2")}


def test_shardmap_crosses_between_packages_with_its_signature():
    from dds_tpu.shard import ShardMap as RefMap
    from dds_tpu_torch.convert import shardmap_from_reference, shardmap_to_reference
    from dds_tpu_torch.shard import ShardMap

    for regions in ({"s0": "eu", "s1": "us", "s2": "ap"}, None):
        ref = RefMap.build(["s0", "s1", "s2"], 16, regions=regions).split("s0", "s3") \
            .sign(SECRET)
        port = shardmap_from_reference(ref.to_wire(), SECRET)
        assert port.verify(SECRET) and port.to_wire() == ref.to_wire()
        assert port.region_of("s3") == ref.region_of("s3")
        assert all(port.owner(f"k{i}") == ref.owner(f"k{i}") for i in range(200))
        moved = port.relabel("s2", "s4").sign(SECRET)
        back = RefMap.from_wire(shardmap_to_reference(moved))
        assert back.verify(SECRET) and back.region_of("s4") == moved.region_of("s4")
        assert back.to_wire() == moved.to_wire()
    forged = RefMap.build(["s0", "s1"], 8, regions={"s0": "eu", "s1": "us"}).sign(SECRET)
    wire = dict(forged.to_wire(), regions=[["s0", "ap"], ["s1", "us"]])
    with pytest.raises(ValueError):
        shardmap_from_reference(wire, SECRET)
    with pytest.raises(ValueError):
        shardmap_from_reference(forged.to_wire(), b"another-secret")
    assert not ShardMap.from_wire(wire).verify(SECRET)


# ------------------------------------------------------- region-death drills


async def region_death_drill(pkg: str, *, S: int, scale: float, lease_ttl: float,
                             keys_cap: int, warm_s: float, post_s: float) -> dict:
    """A seeded 3-region fleet of S groups of 6 replicas (quorum 4) under
    the WAN mesh at `scale` loses region r2 mid-load: writers and a reader
    on span groups, a prober on the r2-homed group, Helmsman promoting.
    Returns what the drill saw; the callers assert on it."""
    m = mods(pkg)
    net = m.chaos.ChaosNet(m.net.InMemoryNet(), seed=0xA71A5)
    const, _ = geo_constellation(
        m, S=S, net=net, seed=13, placement={"s2": "home"},
        lease_ttl=lease_ttl, client_region="r0", n_active=6, quorum=4,
        abd_cfg=m.qc.AbdClientConfig(quorum_size=4, request_timeout=0.4),
    )
    m.wan.apply_profiles(net, m.wan.mesh(R3, "wan-100"), scale=scale)
    r = const.router
    doomed = const.group("s2")
    Deadline, RetryPolicy, retry_deadline = (m.retry.Deadline, m.retry.RetryPolicy,
                                             m.retry.retry_deadline)

    def owned_by(gid):
        return next(k for i in range(400) if r.owner(k := f"K{i}") == gid)

    span_gids = [g for g in const.gids if g != "s2"]
    wkeys = [owned_by(g) for g in span_gids]
    doom_pool = [k for i in range(2000) if r.owner(k := f"D{i}") == "s2"][:keys_cap]
    counts: dict = {}
    last_ok: dict = {}
    recs = {k: [] for k in wkeys}
    stop = asyncio.Event()
    policy = RetryPolicy(base=0.02, multiplier=2.0, max_delay=0.15)

    def mark(gid):
        last_ok[gid] = time.monotonic()

    def record(key, kind, value, t0):
        recs[key].append({"kind": kind, "value": value, "start": t0,
                          "end": time.monotonic()})

    async def writer(key, wid):
        w_rng, i = random.Random(40 + wid), 0
        while not stop.is_set():
            value, i = [f"w{wid}-{i}"], i + 1
            gid = r.owner(key)
            counts[gid] = counts.get(gid, 0) + 1
            t0 = time.monotonic()
            dl = Deadline(6.0)
            await retry_deadline(lambda: r.write_set(key, value, deadline=dl),
                                 dl, policy, rng=w_rng, retry_on=(Exception,))
            record(key, "write", value[0], t0)
            mark(gid)
            await asyncio.sleep(w_rng.uniform(0.01, 0.04))

    async def reader():
        r_rng = random.Random(77)
        while not stop.is_set():
            key = wkeys[r_rng.randrange(len(wkeys))]
            gid = r.owner(key)
            counts[gid] = counts.get(gid, 0) + 1
            t0 = time.monotonic()
            dl = Deadline(6.0)
            got = await retry_deadline(lambda: r.fetch_set(key, deadline=dl),
                                       dl, policy, rng=r_rng, retry_on=(Exception,))
            record(key, "read", got[0] if got else None, t0)
            mark(gid)
            await asyncio.sleep(r_rng.uniform(0.005, 0.02))

    doom_acks: list = []

    async def doom_prober():
        idx = 0
        while not stop.is_set() and idx < len(doom_pool):
            key, idx = doom_pool[idx], idx + 1
            gid = r.owner(key)
            counts[gid] = counts.get(gid, 0) + 1
            try:
                value = [f"beat-{idx}"]
                await r.write_set(key, value, deadline=Deadline(0.5))
                doom_acks.append((key, value))
                mark(gid)
            except Exception:  # noqa: BLE001 - a failed beat is the signal
                pass
            await asyncio.sleep(0.12)

    hm = m.fleet.Helmsman(
        load_census=lambda: dict(counts), slo_alerts=lambda: [],
        shed_level=lambda: 0,
        source_ages=lambda: {g: time.monotonic() - t for g, t in last_ok.items()
                             if g in set(const.gids)},
        split=const.split, merge=const.merge, promote=const.promote,
        moved_bytes=lambda: 0, reshard_busy=lambda: False,
        regions=lambda: {g.gid: g.home_region for g in const.groups if g.home_region},
        heartbeat_timeout=0.9, cooldown=10.0, min_ops=10_000,
    )
    hm.pinned = True

    async def steer():
        while not stop.is_set():
            await hm.step()
            await asyncio.sleep(0.08)

    wt = m.wt.Watchtower(quorum_size=4, n_replicas=6)
    wt.configure(
        group_geometry={f"s{i}": (4, 6) for i in range(10)},
        lease_lookup=lambda name: any(
            g.lease_table is not None and g.lease_table.held_by(name)
            for g in const.groups),
    )
    wt.attach(m.trace.tracer)
    out: dict = {}
    partition = None
    try:
        tasks = [asyncio.ensure_future(t) for t in (
            *(writer(k, i) for i, k in enumerate(wkeys)), reader(), doom_prober(), steer())]
        await asyncio.sleep(warm_s)
        out["leased_before_cut"] = all(const.group(g).lease_table.holders()
                                       for g in span_gids)
        partition = net.region_partition("r2", symmetric=True)
        t_cut = time.monotonic()
        while "s2" in const.gids:
            await asyncio.sleep(0.05)
        out["takeover_s"] = time.monotonic() - t_cut
        reborn = next(g for g in const.groups if g.home_region == "r2" and g.gid != "s2")
        n0 = len(doom_acks)
        while len(doom_acks) <= n0:
            await asyncio.sleep(0.05)
        await asyncio.sleep(post_s)
        stop.set()
        await asyncio.gather(*tasks)
        partition.heal()
        out["wan_kept"] = bool(net.region_links)
        repaired, converged = 0, []
        for g in const.groups:
            healthy = next(e for e, reg in g.replica_regions.items() if reg == "r0")
            for e, reg in g.replica_regions.items():
                if reg == "r2":
                    repaired += await g.replicas[e].antientropy.sync_once(healthy)
            converged.append(len({n.merkle.root() for n in g.replicas.values()}) == 1)
        out["repaired"], out["converged"] = repaired, all(converged)
        lost = []
        for key in wkeys:
            writes = [o for o in recs[key] if o["kind"] == "write"]
            t0 = time.monotonic()
            final = await r.fetch_set(key)
            record(key, "read", final[0] if final else None, t0)
            if not writes or final != [writes[-1]["value"]]:
                lost.append(key)
            lin().check_atomic_register(recs[key])
        out["lost"] = lost
        dkey, dvalue = doom_acks[-1]
        out["reborn_owns_last_beat"] = r.owner(dkey) == reborn.gid
        out["last_beat_durable"] = await r.fetch_set(dkey) == dvalue
        out["reborn_home"] = reborn.home_region
        out["history"] = [row for row in hm.history
                          if row["action"] in ("region_down", "promote", "split", "merge")]
        out["invariants"] = sorted({v.invariant for v in wt.verdicts()})
        out["writes"] = sum(1 for k in wkeys for o in recs[k] if o["kind"] == "write")
    finally:
        wt.detach()
        if partition is not None:
            partition.heal()
        stop.set()
        await const.stop()
        await doomed.stop()
        await net.quiesce()
    return out


def check_drill(out: dict) -> None:
    assert out["leased_before_cut"] and out["wan_kept"]
    assert out["repaired"] > 0 and out["converged"]
    assert out["lost"] == [] and out["writes"] > 0
    assert out["reborn_owns_last_beat"] and out["last_beat_durable"]
    assert out["reborn_home"] == "r2"
    actions = [row["action"] for row in out["history"]]
    down = [row for row in out["history"] if row["action"] == "region_down"]
    assert down and down[0]["region"] == "r2"
    take = next(row for row in out["history"]
                if row["action"] == "promote" and row["dead"] == "s2")
    assert take["region"] == "r2"
    assert "split" not in actions and "merge" not in actions
    assert set(out["invariants"]) <= {"lease_staleness"}, out["invariants"]


def test_short_region_death_drill_in_the_port():
    """The port alone: 3 groups of 6 replicas (quorum 4), two of them span
    groups, the WAN mesh at scale 0.02, at most 64 prober keys, under its
    own 60 s limit. Zero acked writes lost on the span groups, each span
    key's history linearizable, the r2-homed group promoted with its
    label, anti-entropy converging every group after the heal, and only
    the documented lease-window verdicts."""
    out = asyncio.run(asyncio.wait_for(region_death_drill(
        "dds_tpu_torch", S=3, scale=0.02, lease_ttl=1.5, keys_cap=64,
        warm_s=0.7, post_s=0.2), 60.0))
    check_drill(out)


@pytest.mark.slow
def test_region_death_drill_zero_loss_and_only_lease_verdicts_twin():
    """The twin of the reference's full drill: 4 groups, the same drill in
    both packages, each held to the reference's acceptance (the drill
    runs on the wall clock, so what is compared is the outcome)."""
    outs = both(lambda pkg: region_death_drill(
        pkg, S=4, scale=0.02, lease_ttl=1.5, keys_cap=120, warm_s=0.7, post_s=0.4),
        bound=120.0)
    for out in outs.values():
        check_drill(out)
    assert outs["dds_tpu_torch"]["reborn_home"] == outs["dds_tpu"]["reborn_home"]


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return torch.device("cuda")


@pytest.mark.gpu
def test_geo_sumall_folds_on_the_card_as_the_plain_path(cuda):
    """wan_soak.toml on the `cuda` backend (the WAN at scale 0.02 and the
    device fold from the first row, `min_device_batch = 0`): a SumAll over
    Paillier-2048 rows scatters one B1 fold a group on the card, exact
    against the Python-int fold and decrypting to the total, with the
    launch formula of a scattered SumAll; each group's operands folded on
    the card equal their plain-path fold bit for bit."""
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.models.backend import CpuBackend, get_backend
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.run import launch

    key = bench_paillier_key(2048)
    pk, n2 = key.public, key.public.nsquare
    rng = random.Random(23)
    plain = [rng.randrange(1 << 30) for _ in range(96)]
    cts = pk.encrypt_batch(plain, get_backend("cuda", device="cuda"), min_batch=1)
    cfg = wan_soak("dds_tpu_torch")
    cfg.proxy.crypto_backend, cfg.proxy.device = "cuda", "cuda"
    cfg.proxy.min_device_batch = 0
    cfg.chaos.scale = 0.02

    async def go():
        dep = await launch(cfg)
        try:
            port = dep.server.cfg.port
            sem = asyncio.Semaphore(32)

            async def put(c):
                async with sem:
                    st, _ = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                               json.dumps({"contents": [str(c)]}).encode())
                    assert st == 200

            await asyncio.gather(*(put(c) for c in cts))
            torch_sync()
            before = mont_cuda.LAUNCHES["mont_mul"].value
            st, body = await http_request("127.0.0.1", port, "GET",
                                          f"/SumAll?position=0&nsqr={n2}", timeout=120)
            torch_sync()
            launched = mont_cuda.LAUNCHES["mont_mul"].value - before
            groups = [ops for _, ops in dep.server._owner_memo[-1]]
            return st, int(json.loads(body)["result"]), launched, groups
        finally:
            await dep.stop()

    def torch_sync():
        import torch

        torch.cuda.synchronize()

    st, result, launched, groups = asyncio.run(go())
    want = 1
    for c in cts:
        want = want * c % n2
    assert st == 200 and result == want and key.decrypt(result) == sum(plain)
    assert len(groups) == 3 and sum(len(g) for g in groups) == len(cts)
    assert launched == sum(mont_cuda.fold_launches(len(g)) for g in groups)
    card, host = get_backend("cuda", device="cuda"), CpuBackend()
    for ops in groups:
        assert card.modmul_fold(ops, n2) == host.modmul_fold(ops, n2)
