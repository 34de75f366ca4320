"""The Watchtower auditor in the port against the reference's, and the
port's quorum spans that it audits.

- The synthetic traces of the reference's `tests/test_watchtower.py`
  (clean and dropped-ack quorums, the intersection bound, the read fast
  path, tag monotonicity across traces, duplicate mints, forward tags,
  read-sees-latest, breaker and suspicion legality, repair convergence)
  are recorded once, and the same records are fed to a
  `dds_tpu.obs.watchtower.Watchtower` and a
  `dds_tpu_torch.obs.watchtower.Watchtower`: equal verdicts (invariant,
  trace and detail) and stats.
- The port's `abd.fetch` / `abd.write` spans carry the reference's audit
  record: one seeded PutSet, GetSet and overwrite sequence on a 4-replica
  stack of each package records equal `(name, op, key, seq, tag_id, ok)`
  tuples.
- A coordinator holding the proxy MAC key that answers a read with a
  forged stale tag, and one that acknowledges a write without running a
  quorum, on a 7-replica stack of each package: the same verdicts
  (tag_monotonicity and quorum_intersection on the forged read,
  quorum_intersection on the unquorumed write); the honest schedule
  audits clean.
- `launch` configures and attaches the process-wide auditor, `stop`
  detaches it; a clean run of the port's default deployment audits its
  ops with no violation; a Trudy byzantine run of one seed in each
  package gives the same `(invariant, key)` multiset: empty in both, since
  Trudy's replicas break no committed op (the client rejects their
  replies and the honest quorum carries every commit).
"""

import asyncio
import collections
import importlib
import json
import random
import time

import pytest

BOUND = 60.0
R7 = [f"replica-{i}" for i in range(7)]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def bounded(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND))


# ------------------------------------------------------ synthetic traces


def commit_op(t, name, key, seq, tid, read_replicas=(), write_replicas=(),
              coordinator="replica-0", op=None):
    """One committed quorum op: root -> abd span (ok, tagged) ->
    replica.handle children per phase (the reference test's shape)."""
    with t.span(f"http.{name}"):
        with t.span("abd.write" if name == "write" else "abd.fetch",
                    coordinator=coordinator, ok=True,
                    op=op or ("write" if name == "write" else "read"),
                    key=key, seq=seq, tag_id=tid):
            for r in read_replicas:
                with t.span("replica.handle", replica=r,
                            msg="ReadTag" if name == "write" else "Read", key=key):
                    pass
            for r in write_replicas:
                with t.span("replica.handle", replica=r, msg="Write", key=key):
                    pass


def _clean_write(t):
    commit_op(t, "write", "k1", 1, "replica-0", read_replicas=R7[:5], write_replicas=R7[1:6])


def _dropped_ack(t):
    commit_op(t, "write", "k1", 1, "replica-0", read_replicas=R7[:5], write_replicas=R7[:2])


def _intersection(t):
    extra = [f"replica-{i}" for i in range(7, 10)]
    commit_op(t, "write", "k1", 1, "replica-0", read_replicas=R7[:5],
              write_replicas=R7[3:5] + extra)


def _read_fast_path(t):
    commit_op(t, "read", "k1", 1, "replica-0", read_replicas=R7[:5])


def _stale_tag(t):
    commit_op(t, "write", "k", 2, "replica-1")
    time.sleep(0.005)
    commit_op(t, "read", "k", 1, "replica-0")


def _duplicate_mint(t):
    commit_op(t, "write", "k", 3, "replica-1")
    time.sleep(0.005)
    commit_op(t, "write", "k", 3, "replica-1")


def _forward_tags(t):
    commit_op(t, "write", "k", 1, "replica-0")
    time.sleep(0.002)
    commit_op(t, "write", "k", 2, "replica-1")
    time.sleep(0.002)
    commit_op(t, "read", "k", 2, "replica-1")
    commit_op(t, "write", "other", 1, "replica-0")


def _read_sees_latest(t):
    with t.span("http.GET.agg"):
        with t.span("abd.write", coordinator="replica-0", ok=True, op="write",
                    key="k", seq=5, tag_id="replica-0"):
            pass
        time.sleep(0.005)
        with t.span("abd.fetch", coordinator="replica-1", ok=True, op="read",
                    key="k", seq=4, tag_id="replica-1"):
            pass


def _breakers(t):
    t.event("breaker.open", target="replica-1")
    t.event("breaker.half_open", target="replica-1")
    t.event("breaker.closed", target="replica-1")
    t.event("breaker.half_open", target="replica-2")


def _suspicion(t):
    for _ in range(3):
        t.event("abd.coordinator_violation", node="replica-3")
    time.sleep(0.005)
    commit_op(t, "read", "k", 1, "replica-0", coordinator="replica-3")


def _repair(t):
    with t.span("antientropy.sync", replica="replica-0"):
        t.event("audit.repair", replica="replica-0", peer="replica-1",
                key="good", src_seq=4, src_id="a", seq=4, tag_id="a")
        t.event("audit.repair", replica="replica-0", peer="replica-1",
                key="bad", src_seq=9, src_id="z", seq=3, tag_id="a")


# (case, records' writer, check_quorum, the reference's expected invariants)
CASES = [
    ("clean_write", _clean_write, True, []),
    ("dropped_ack", _dropped_ack, True, ["quorum_intersection"]),
    ("intersection_bound", _intersection, True, ["quorum_intersection"]),
    ("read_fast_path", _read_fast_path, True, []),
    ("tag_monotonicity", _stale_tag, False, ["tag_monotonicity"]),
    ("duplicate_mint", _duplicate_mint, False, ["tag_monotonicity"]),
    ("forward_tags", _forward_tags, False, []),
    ("read_sees_latest", _read_sees_latest, False, ["read_sees_latest"]),
    ("breaker_legality", _breakers, True, ["breaker_legality"]),
    ("suspicion_legality", _suspicion, False, ["suspicion_legality"]),
    ("repair_convergence", _repair, True, ["repair_convergence"]),
]


@pytest.mark.parametrize("case,write,check_quorum,expected", CASES,
                         ids=[c[0] for c in CASES])
def test_synthetic_traces_give_the_reference_verdicts(case, write, check_quorum, expected):
    from dds_tpu.utils.trace import Tracer

    records = []
    t = Tracer()
    t.subscribe(records.append)
    write(t)
    out = {}
    for pkg in ("dds_tpu", "dds_tpu_torch"):
        wt = mod(pkg, "obs.watchtower").Watchtower(quorum_size=5, n_replicas=7,
                                                   check_quorum=check_quorum)
        for rec in records:
            wt.on_record(rec)
        stats = wt.stats()
        out[pkg] = ([(v.invariant, v.trace_id, v.detail) for v in wt.verdicts()],
                    {k: stats[k] for k in ("traces_audited", "ops_audited",
                                           "pending_traces", "violations")})
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    verdicts, stats = out["dds_tpu_torch"]
    assert [v[0] for v in verdicts] == expected
    if case == "dropped_ack":
        assert any("write_phase=2<5" in p for p in verdicts[0][2]["problems"])
    if case == "intersection_bound":
        assert any("intersection=2<3" in p for p in verdicts[0][2]["problems"])
    if case == "clean_write":
        assert (stats["traces_audited"], stats["ops_audited"]) == (1, 1)


def test_an_evicted_trace_stays_unaudited_in_the_port_and_yields_false_verdicts_in_the_reference():
    """More traces in flight than `max_traces` (an overloaded proxy: the
    chip run's tenancy flood): the oldest is evicted unaudited. Its later
    spans and root then open a fresh buffer in the reference, which audits
    the tail as a whole trace (a quorum op with no replica in its read
    phase: a false `quorum_intersection`) and evicts the next trace in
    turn; the port drops the evicted trace's tail and audits the others,
    clean."""
    from dds_tpu.utils.trace import Tracer

    def records_of(key):
        out = []
        t = Tracer()
        t.subscribe(out.append)
        commit_op(t, "read", key, 1, "replica-0", read_replicas=R7[:5])
        return out  # the replica spans, then the abd span, then the root

    a, b, c = records_of("ka"), records_of("kb"), records_of("kc")
    feed = a[:-2] + b[:-2] + c[:-2] + a[-2:] + b[-2:] + c[-2:]
    out = {}
    for pkg in ("dds_tpu", "dds_tpu_torch"):
        wt = mod(pkg, "obs.watchtower").Watchtower(quorum_size=5, n_replicas=7,
                                                   max_traces=2)
        for rec in feed:
            wt.on_record(rec)
        out[pkg] = ([(v.invariant, v.detail["key"], v.detail["problems"])
                     for v in wt.verdicts()], wt.stats()["traces_audited"])
    assert out["dds_tpu"] == ([("quorum_intersection", "ka", ["read_phase=0<5"]),
                               ("quorum_intersection", "kb", ["read_phase=0<5"])], 3)
    assert out["dds_tpu_torch"] == ([], 2)


def test_port_tracer_feeds_its_subscribers_and_guards_them():
    """The port's tracer hands each record to its subscribers after the
    append, swallows a subscriber's exception, and does not recurse into a
    subscriber that records a span of its own."""
    from dds_tpu_torch.utils.trace import Tracer

    t = Tracer()
    seen = []

    def nested(rec):
        seen.append(rec.name)
        if rec.name == "outer":
            t.record("inner", 0.0)

    def broken(rec):
        raise RuntimeError("observer fault")

    t.subscribe(nested)
    t.subscribe(broken)
    t.subscribe(nested)  # idempotent
    t.record("outer", 1.0)
    assert seen == ["outer"]
    assert [e.name for e in t.events()] == ["outer", "inner"]
    t.reset()
    t.record("after_reset", 0.0)
    assert seen == ["outer", "after_reset"]
    t.unsubscribe(nested)
    t.record("quiet", 0.0)
    assert seen == ["outer", "after_reset"]


# ------------------------------------------------------ the quorum spans


def test_abd_spans_carry_the_reference_audit_record():
    """One seeded PutSet, GetSet and overwrite sequence on a 4-replica
    in-memory stack of each package: the `abd.*` spans record equal
    (name, op, key, seq, tag_id, ok) tuples, and every committed read and
    write carries op, key, seq and tag_id."""
    def scenario(pkg):
        rep = mod(pkg, "core.replica")
        qc = mod(pkg, "core.quorum_client")
        srv = mod(pkg, "http.server")
        http = mod(pkg, "http.miniserver")
        tracer = mod(pkg, "utils.trace").tracer
        recs = []

        async def go():
            net = mod(pkg, "core.transport").InMemoryNet()
            addrs = [f"replica-{i}" for i in range(4)]
            nodes = {a: rep.BFTABDNode(a, addrs, "supervisor", net,
                                       rep.ReplicaConfig(quorum_size=3)) for a in addrs}
            abd = qc.AbdClient("proxy-0", net, addrs,
                               qc.AbdClientConfig(request_timeout=2.0, quorum_size=3))
            abd.replicas._rng = random.Random(17)
            server = srv.DDSRestServer(abd, srv.ProxyConfig(host="127.0.0.1", port=0,
                                                            crypto_backend="cpu"))
            await server.start()
            tracer.subscribe(recs.append)
            try:
                port = server.cfg.port
                rng = random.Random(5)
                keys = []
                for i in range(6):
                    row = [str(rng.getrandbits(40)), f"r{i}"]
                    _, body = await http.http_request("127.0.0.1", port, "POST", "/PutSet",
                                                      json.dumps({"contents": row}).encode())
                    keys.append(body.decode())
                for k in keys:
                    await http.http_request("127.0.0.1", port, "GET", f"/GetSet/{k}")
                for k in keys[:3]:
                    await http.http_request("127.0.0.1", port, "PUT",
                                            f"/WriteElement/{k}?position=1",
                                            json.dumps({"value": "new"}).encode())
                await http.http_request("127.0.0.1", port, "DELETE", f"/RemoveSet/{keys[4]}")
                await http.http_request("127.0.0.1", port, "GET", f"/GetSet/{keys[4]}")
                await net.quiesce()
            finally:
                tracer.unsubscribe(recs.append)
                await server.stop()
            return [(r.name, r.meta.get("op"), r.meta.get("key"), r.meta.get("seq"),
                     r.meta.get("tag_id"), r.meta.get("ok"))
                    for r in recs if r.kind == "span" and r.name in ("abd.fetch", "abd.write")]

        return bounded(go())

    ref, port = scenario("dds_tpu"), scenario("dds_tpu_torch")
    assert port == ref
    assert len(port) == 6 + 6 + 3 * 2 + 1 + 1
    assert all(op is not None and key and seq is not None and tid and ok
               for _, op, key, seq, tid, ok in port)
    writes = [t for t in port if t[0] == "abd.write"]
    assert {t[1] for t in writes} == {"write"} and len(writes) == 10


# ------------------------------------------------- forging coordinators


def forging_nodes(pkg: str):
    """The reference test's attackers, in `pkg`: a coordinator answering
    reads with a properly MAC'd forged stale (tag, value), and one
    acknowledging writes with no quorum behind them."""
    M = mod(pkg, "core.messages")
    sigs = mod(pkg, "utils.sigs")
    Node = mod(pkg, "core.replica").BFTABDNode

    def forged_read(self, sender, msg):
        match msg:
            case M.Envelope(M.IRead(key), nonce, _sig) if self.forging:
                tag = M.ABDTag(1, "forged")
                challenge = nonce + self.cfg.nonce_increment
                sig = sigs.proxy_signature(self.cfg.proxy_mac_secret, key, challenge,
                                           [["stale"], sigs.tag_payload(tag)])
                self._send(sender, M.Envelope(M.IReadReply(key, ["stale"], tag=tag),
                                              challenge, sig))
                return True
        return False

    def unquorumed_write(self, sender, msg):
        match msg:
            case M.Envelope(M.IWrite(key, _v), nonce, _sig):
                self._seq_floor += 1
                tag = M.ABDTag(self._seq_floor, self.name)
                challenge = nonce + self.cfg.nonce_increment
                sig = sigs.proxy_signature(self.cfg.proxy_mac_secret, key, challenge,
                                           sigs.tag_payload(tag))
                self._send(sender, M.Envelope(M.IWriteReply(key, tag=tag), challenge, sig))
                return True
        return False

    def attacker(hook):
        if pkg == "dds_tpu":  # the reference's handler is a coroutine
            class Attacker(Node):
                forging = True

                async def _healthy(self, sender, msg):
                    if not hook(self, sender, msg):
                        await super()._healthy(sender, msg)
        else:
            class Attacker(Node):
                forging = True

                def _healthy(self, sender, msg):
                    if not hook(self, sender, msg):
                        super()._healthy(sender, msg)
        return Attacker

    return attacker(forged_read), attacker(unquorumed_write)


def audited_cluster(pkg: str, schedule, special: int, forging: bool = True):
    """Seven replicas on `pkg`'s in-memory net, replica-6 the attacker
    (`special`: 0 the forged reader, 1 the unquorumed writer), quorum 5,
    a fresh Watchtower on `pkg`'s tracer; returns the schedule's result,
    the verdicts as (invariant, detail) without trace ids, the invariants
    of each offending trace and the traces audited."""
    rep = mod(pkg, "core.replica")
    qc = mod(pkg, "core.quorum_client")
    Watchtower = mod(pkg, "obs.watchtower").Watchtower
    tracer = mod(pkg, "utils.trace").tracer
    cls = forging_nodes(pkg)[special]

    async def go():
        net = mod(pkg, "core.transport").InMemoryNet()
        nodes = {a: (cls if a == "replica-6" else rep.BFTABDNode)(
            a, R7, "supervisor", net, rep.ReplicaConfig(quorum_size=5)) for a in R7}
        nodes["replica-6"].forging = forging
        client = qc.AbdClient("proxy-0", net, R7,
                              qc.AbdClientConfig(request_timeout=2.0, quorum_size=5))
        client.replicas._rng = random.Random(5)
        wt = Watchtower(quorum_size=5, n_replicas=7)
        wt.attach(tracer)
        try:
            out = await schedule(client)
            await net.quiesce()
        finally:
            wt.detach()
        by_trace = collections.defaultdict(set)
        for v in wt.verdicts():
            by_trace[v.trace_id].add(v.invariant)
        # trace ids are random: drop the prior op's from the details
        return (out, [(v.invariant, {k: x for k, x in v.detail.items() if k != "prior_trace"})
                      for v in wt.verdicts()],
                sorted(sorted(s) for s in by_trace.values()), wt.stats()["traces_audited"])

    return bounded(go())


async def forged_read_schedule(client):
    await client.write_set("KEY", ["v1"])
    await client.write_set("KEY", ["v2"])
    await asyncio.sleep(0.01)  # strict real-time order before the read
    value, tag, coord = await client.fetch_set_attributed(
        "KEY", exclude=tuple(a for a in R7 if a != "replica-6"))
    return value, tag.seq, coord


async def unquorumed_write_schedule(client):
    for a in R7[:6]:  # strike every other replica out of the trusted set
        for _ in range(3):
            client.replicas.increment_suspicion(a)
    await client.write_set("Q", ["v"])
    return True


def test_forged_stale_tag_yields_the_reference_verdicts():
    out = {pkg: audited_cluster(pkg, forged_read_schedule, 0)
           for pkg in ("dds_tpu", "dds_tpu_torch")}
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    result, verdicts, per_trace, _ = out["dds_tpu_torch"]
    assert result == (["stale"], 1, "replica-6")
    assert sorted(v[0] for v in verdicts) == ["quorum_intersection", "tag_monotonicity"]
    assert per_trace == [["quorum_intersection", "tag_monotonicity"]]  # one trace
    mono = dict(verdicts)["tag_monotonicity"]
    assert mono["tag"] == [1, "forged"] and mono["coordinator"] == "replica-6"


def test_identical_schedule_without_the_forgery_audits_clean():
    out = {pkg: audited_cluster(pkg, forged_read_schedule, 0, forging=False)
           for pkg in ("dds_tpu", "dds_tpu_torch")}
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    result, verdicts, _, traces = out["dds_tpu_torch"]
    assert result[0] == ["v2"] and verdicts == [] and traces >= 3


def test_unquorumed_write_yields_the_reference_verdict():
    out = {pkg: audited_cluster(pkg, unquorumed_write_schedule, 1)
           for pkg in ("dds_tpu", "dds_tpu_torch")}
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    verdicts = out["dds_tpu_torch"][1]
    assert [v[0] for v in verdicts] == ["quorum_intersection"]
    assert verdicts[0][1]["key"] == "Q"
    assert verdicts[0][1]["read_phase"] == [] and verdicts[0][1]["write_phase"] == []


# --------------------------------------------------------- deployments


def _cfg(pkg: str, **extra):
    d = {"proxy": {"crypto-backend": "cpu", "intranet-request-timeout": 1.0},
         "recovery": {"enabled": False}}
    if pkg == "dds_tpu_torch":
        d["proxy"]["device"] = "cpu"
    for section, kv in extra.items():
        d.setdefault(section, {}).update(kv)
    return mod(pkg, "utils.config").DDSConfig.from_dict(d)


def test_launch_attaches_and_stop_detaches_the_watchtower():
    """`launch` resets the process-wide auditor and configures it for the
    deployment's geometry (default.toml's: quorum 5, 9 endpoints less 2
    spares); `stop` detaches it, and with `audit-enabled = false` it is
    never attached."""
    from dds_tpu_torch.obs.watchtower import watchtower
    from dds_tpu_torch.run import launch

    topo = {"endpoints": [f"replica-{i}" for i in range(9)],
            "sentinent": ["replica-7", "replica-8"], "byz-quorum-size": 5,
            "byz-max-faults": 2}

    async def go(audit: bool):
        watchtower.reset()
        watchtower._verdicts.append("stale")
        dep = await launch(_cfg("dds_tpu_torch", replicas=topo,
                                obs={"audit-enabled": audit}))
        try:
            seen = (watchtower.attached, watchtower.quorum_size, watchtower.n_replicas,
                    watchtower.check_quorum, len(watchtower.verdicts()))
        finally:
            await dep.stop()
        return seen, watchtower.attached

    assert bounded(go(True)) == ((True, 5, 7, True, 0), False)
    seen, after = bounded(go(False))
    assert seen[0] is False and after is False
    watchtower.reset()


def test_clean_port_run_audits_with_zero_violations():
    """The port's default deployment (4 replicas, quorum 3) on the CPU:
    PutSets, GetSets, overwrites, a removal and SumAlls audit clean, with
    every op counted, and /slo's audit section says so."""
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.obs.watchtower import watchtower
    from dds_tpu_torch.run import launch

    async def go():
        dep = await launch(_cfg("dds_tpu_torch"))
        try:
            port = dep.server.cfg.port
            keys = []
            for i in range(8):
                _, b = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                          json.dumps({"contents": [str(i + 3)]}).encode())
                keys.append(b.decode())
            for k in keys:
                await http_request("127.0.0.1", port, "GET", f"/GetSet/{k}")
            for k in keys[:4]:
                await http_request("127.0.0.1", port, "PUT", f"/WriteElement/{k}?position=0",
                                   json.dumps({"value": "99"}).encode())
            await http_request("127.0.0.1", port, "DELETE", f"/RemoveSet/{keys[7]}")
            for _ in range(3):
                status, _ = await http_request("127.0.0.1", port, "GET",
                                               "/SumAll?position=0&nsqr=1000003")
                assert status == 200
            await dep.net.quiesce()
            _, body = await http_request("127.0.0.1", port, "GET", "/slo")
            return json.loads(body)["audit"], watchtower.verdicts()
        finally:
            await dep.stop()

    audit, verdicts = bounded(go())
    assert verdicts == [] and audit["violations"] == {}
    assert audit["attached"] and audit["quorum_size"] == 3 and audit["n_replicas"] == 4
    assert audit["ops_audited"] >= 8 + 8 + 8 + 1 and audit["traces_audited"] >= 22


def test_byzantine_run_gives_the_reference_verdicts():
    """Trudy, seeded alike, turns f = 2 of default.toml's 7 active
    replicas byzantine mid-run; the same PutSets, GetSets and overwrites
    follow on each package's deployment (the global `random` and the
    client's coordinator rng seeded alike; the port's replicas draw their
    forged tags from that same stream, as the reference's do). Both
    auditors report the same (invariant, key) multiset."""
    def scenario(pkg):
        run = mod(pkg, "run")
        http = mod(pkg, "http.miniserver")
        watchtower = mod(pkg, "obs.watchtower").watchtower
        topo = {"endpoints": [f"replica-{i}" for i in range(9)],
                "sentinent": ["replica-7", "replica-8"], "byz-quorum-size": 5,
                "byz-max-faults": 2}
        cfg = _cfg(pkg, replicas=topo, attacks={"enabled": True},
                   obs={"audit-enabled": True}, admission={"enabled": False},
                   proxy={"request-budget": 20.0})

        async def go():
            random.seed(23)
            watchtower.reset()
            dep = await run.launch(cfg)
            if pkg == "dds_tpu_torch":
                for node in dep.replicas.values():
                    node._rng = random
            dep.server.abd.replicas._rng = random.Random(29)
            dep.trudy._rng = random.Random(31)
            try:
                port = dep.server.cfg.port
                keys = []
                for i in range(12):
                    _, b = await http.http_request(
                        "127.0.0.1", port, "POST", "/PutSet",
                        json.dumps({"contents": [str(i), f"v{i}"]}).encode())
                    keys.append(b.decode())
                await dep.net.quiesce()
                victims = dep.trudy.trigger("byzantine")
                await dep.net.quiesce()
                statuses = []
                for k in keys:
                    s, _ = await http.http_request("127.0.0.1", port, "GET", f"/GetSet/{k}")
                    statuses.append(s)
                for k in keys[:6]:
                    s, _ = await http.http_request(
                        "127.0.0.1", port, "PUT", f"/WriteElement/{k}?position=1",
                        json.dumps({"value": "w"}).encode())
                    statuses.append(s)
                await dep.net.quiesce()
                verdicts = collections.Counter(
                    (v.invariant, v.detail.get("key")) for v in watchtower.verdicts())
                return victims, statuses, verdicts, watchtower.stats()["ops_audited"] > 0
            finally:
                await dep.stop()
                watchtower.reset()

        return bounded(go())

    ref, port = scenario("dds_tpu"), scenario("dds_tpu_torch")
    assert port[0] == ref[0] and len(port[0]) == 2
    assert port[1] == ref[1] == [200] * 18
    assert port[2] == ref[2] == collections.Counter()
    assert port[3] and ref[3]
