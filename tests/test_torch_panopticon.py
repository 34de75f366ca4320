"""Panopticon, the fleet observability plane, in the port against the
reference.

Twins of the in-process cases of `tests/test_panopticon.py`: each
scenario runs once on `dds_tpu` and once on `dds_tpu_torch` from the same
inputs and the observations (bytes, dicts, verdict sets) are compared.
The identity gauge, `record_from_dict`, the batch MAC, the shipper's
signed batches, spool drops and loose events, the collector's MAC
rejection, the cross-host forgery stitched and audited (exactly
`tag_monotonicity` and `quorum_intersection`, on the forged read's
trace), one audit a trace despite stragglers, `NullWatchtower`, the
exposition merge and parse, `fleet_metrics`, `fleet_slo`,
`fleet_incidents`; `fleet_profile` and the replay into Chronoscope
(`tests/test_chronoscope.py`), `fleet_canary` (`tests/test_heliograph.py`);
Helmsman promoting a dead group on a real collector's `source_ages`
(`tests/test_helmsman.py`'s lambda feed, here a collector that heard one
group's heartbeat and not the other's). A batch each package's shipper
signs verifies at the other's collector, and the two packages encode it
to the same frame bytes. The eviction of an in-flight stitch buffer
(ROADMAP §C 21): the reference replays the rest of an evicted trace as a
tree without its replica spans and gives false `quorum_intersection`
verdicts, the port drops it and gives none.

Marked `slow`, as their twins: the two multi-process flagships on port
processes, a `python -m dds_tpu_torch.run` proxy over two group
processes, one armed as stale-tag forgers (exactly the two verdicts on
one trace, tag `[1, "forged"]`) and one clean (no verdict).
"""

import asyncio
import importlib
import json
import os
import signal
import subprocess
import sys
import time
import types

import pytest

pytestmark = pytest.mark.obs

PKGS = ("dds_tpu", "dds_tpu_torch")
SECRET = b"panopticon-test-secret"
BOUND = 60.0
R4 = [f"s0-replica-{i}" for i in range(4)]


def mods(pkg: str):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return types.SimpleNamespace(
        pan=m("obs.panopticon"), M=m("core.messages"), wt=m("obs.watchtower"),
        trace=m("utils.trace"), ctx=m("obs.context"), metrics=m("obs.metrics"),
        chrono=m("obs.chronoscope"), helio=m("obs.heliograph"), fleet=m("fleet"),
        transport=m("core.transport"), pkg=pkg)


def twin(scenario, *args):
    """`scenario(pkg, *args)` on both packages; equal observations."""
    ref, port = (asyncio.run(asyncio.wait_for(scenario(pkg, *args), BOUND)) for pkg in PKGS)
    assert port == ref
    return port


class LoopNet:
    """The TcpNet surface the plane uses: endpoints by name, `local_addr`,
    and a fire-and-forget `send` that records every frame and delivers it
    to a registered handler."""

    def __init__(self, advertised="127.0.0.1:1"):
        self.advertised = advertised
        self.handlers = {}
        self.sent = []
        self.tasks = set()

    def local_addr(self, name: str) -> str:
        return f"{self.advertised}/{name}"

    def register(self, addr: str, handler) -> None:
        self.handlers[addr.rsplit("/", 1)[-1]] = handler

    def unregister(self, addr: str) -> None:
        self.handlers.pop(addr.rsplit("/", 1)[-1], None)

    def send(self, src: str, dest: str, msg) -> None:
        self.sent.append((src, dest, msg))
        h = self.handlers.get(dest.rsplit("/", 1)[-1])
        if h is not None:
            task = asyncio.ensure_future(h(src, msg))
            self.tasks.add(task)
            task.add_done_callback(self.tasks.discard)


def make_shipper(m, net=None, **kw):
    net = net if net is not None else LoopNet("127.0.0.1:71")
    tracer, reg = m.trace.Tracer(), m.metrics.Registry()
    kw.setdefault("collector", "127.0.0.1:70")
    kw.setdefault("secret", SECRET)
    kw.setdefault("host", "127.0.0.1:71")
    kw.setdefault("role", "group:s0")
    kw.setdefault("shard", "s0")
    kw.setdefault("flush_interval", 0.01)
    sh = m.pan.SpanShipper(net, tracer=tracer, registry=reg, **kw)
    return sh, net, tracer, reg


def make_collector(m, wt=None, **kw):
    net = LoopNet("127.0.0.1:70")
    wt = wt if wt is not None else m.wt.Watchtower(quorum_size=3, n_replicas=4)
    tracer, reg = m.trace.Tracer(), m.metrics.Registry()
    kw.setdefault("secret", SECRET)
    kw.setdefault("host", "127.0.0.1:70")
    kw.setdefault("stitch_window", 0.05)
    if m.pkg == "dds_tpu_torch":
        kw.setdefault("flush_interval", 0.01)  # make_shipper's
    col = m.pan.FleetCollector(net, watchtower=wt, tracer=tracer, registry=reg, **kw)
    return col, net, wt, tracer, reg


def make_batch(m, trees, *, host="ghost", role="group:s0", shard="s0", seq=1,
               incidents=(), metrics_text="", slo=None, dropped=0, secret=SECRET,
               region="", ts=None):
    """A signed batch, stamped `ts` (by default now, as a shipper stamps
    it)."""
    slo = slo if slo is not None else {}
    incidents = list(incidents)
    ts = time.time() if ts is None else ts
    mac = m.pan.batch_mac(secret, host, role, shard, seq, ts, trees, incidents,
                          metrics_text, slo, dropped, region)
    return m.M.TelemetryBatch(host=host, role=role, shard=shard, seq=seq, ts=ts,
                              spans=trees, incidents=incidents, metrics_text=metrics_text,
                              slo=slo, dropped=dropped, mac=mac, region=region)


async def heartbeat_past_the_window(m, col, seq, host="ghost"):
    """Sleep past the stitch window, deliver the source's next heartbeat
    and replay: the port replays a root once every live source has
    delivered a batch a flush interval after its due time (ROADMAP §C 22),
    the reference a stitch window after the root."""
    await asyncio.sleep(0.07)
    await col.handle(f"{host}/panopticon-ship", make_batch(m, [], host=host, seq=seq))
    col._replay_due()


def verdict_view(verdicts, ids: dict) -> list:
    """Verdicts as comparable tuples: the trace id replaced by the name
    `ids` gives it (random ids differ between the packages' runs)."""
    def detail(d):
        if "prior_trace" in d:
            d = {**d, "prior_trace": ids.get(d["prior_trace"], "?")}
        return json.dumps(d, sort_keys=True, default=str)

    return sorted((v.invariant, ids.get(v.trace_id, "?"), detail(v.detail)) for v in verdicts)


# ------------------------------------------------------- identity and wire


def test_process_info_gauge_twin():
    async def go(pkg):
        m = mods(pkg)
        out = []
        for kw in ({"role": "group:s0", "shard": "s0"}, {"role": "proxy"},
                   {"role": "group:s1", "shard": "s1", "region": "eu"}):
            reg = m.metrics.Registry()
            m.pan.process_info(reg, **kw)
            (labels, value), = m.pan.parse_samples(reg.render(), "dds_process_info")
            assert float(labels.pop("start_ts")) > 0
            assert labels.pop("pid") == str(os.getpid())
            out.append((labels, value))
        return out

    out = twin(go)
    assert out[1][0]["shard"] == "-" and out[2][0]["region"] == "eu"


def test_launch_identity_is_the_process_info_gauge():
    """`run.publish_identity` publishes the gauge through `process_info`:
    one function, the same series."""
    from dds_tpu_torch.obs.flight import flight
    from dds_tpu_torch.obs.metrics import metrics
    from dds_tpu_torch.obs.panopticon import parse_samples
    from dds_tpu_torch.run import publish_identity
    from dds_tpu_torch.utils.config import DDSConfig

    cfg = DDSConfig()
    cfg.fabric.region = "ap"
    before = dict(flight.identity)
    try:
        publish_identity(cfg, "group:s3", host="127.0.0.1:9", shard="s3")
        identity = dict(flight.identity)
    finally:
        flight.identity = before  # process-wide: hand it back
    mine = [lab for lab, _ in parse_samples(metrics.render(), "dds_process_info")
            if lab["role"] == "group:s3"]
    assert mine and mine[0]["shard"] == "s3" and mine[0]["region"] == "ap"
    assert identity == {"host": "127.0.0.1:9", "role": "group:s3", "shard": "s3",
                        "region": "ap"}


def test_record_from_dict_roundtrips_and_survives_garbage_twin():
    async def go(pkg):
        m = mods(pkg)
        t = m.trace.Tracer()
        with t.span("abd.fetch", key="K"):
            pass
        d = m.trace.Tracer.event_dict(t.events()[0])
        rec = m.pan.record_from_dict(d)
        assert isinstance(rec, m.trace.SpanRecord)
        out = [(rec.name, rec.meta, rec.trace_id == d["trace_id"], rec.parent_id, rec.kind)]
        for bad in ({}, {"name": "x"}, {"ts": None, "name": "x"}, {"ts": "junk", "name": "x"},
                    {"ts": 1.0, "name": "x", "meta": ["not-a-dict"]},
                    {"ts": "2.5", "name": 7, "dur_ms": "3", "kind": "event",
                     "trace_id": "t", "span_id": "s", "parent_id": "p"}):
            r = m.pan.record_from_dict(bad)
            out.append(None if r is None else (r.ts, r.name, r.dur_ms, r.meta, r.trace_id,
                                               r.span_id, r.parent_id, r.kind))
        return out

    twin(go)


def test_batch_mac_is_payload_sensitive_and_equal_bytes_twin():
    async def go(pkg):
        m = mods(pkg)
        args = ("h", "group:s0", "s0", 1, 2.0, [["x"]], [], "m", {}, 0)
        base = m.pan.batch_mac(SECRET, *args)
        assert base == m.pan.batch_mac(SECRET, *args)
        return [base.hex(), m.pan.batch_mac(b"other-key", *args).hex(),
                m.pan.batch_mac(SECRET, "h", "group:s0", "s0", 1, 2.0, [["y"]], [], "m", {},
                                0).hex(),
                m.pan.batch_mac(SECRET, *args, region="eu").hex()]

    macs = twin(go)
    assert len(set(macs)) == 4


def test_a_batch_each_package_signs_verifies_at_the_other_collector():
    """A shipper of either package ships a span tree; the frame encodes to
    the same bytes in both packages and the other package's collector
    accepts it (ack ok, the source known, the tree stitched onto a local
    root); a tampered frame is refused by both."""

    async def ship(pkg):
        m = mods(pkg)
        sh, net, t, _ = make_shipper(m, region="eu")
        t.subscribe(sh.on_record)
        root = m.ctx.child(None)
        tok = m.ctx.attach(m.ctx.child(root))
        try:
            with t.span("replica.handle", replica="s0-replica-1", msg="Read", key="K"):
                pass
        finally:
            m.ctx.detach(tok)
        t.unsubscribe(sh.on_record)
        await asyncio.sleep(0.03)
        await sh._flush_once()
        (_, _, batch), = net.sent
        return batch, root

    async def collect(pkg, batch, root):
        m = mods(pkg)
        col, net, wt, t, reg = make_collector(m)
        t.subscribe(col.on_record)
        # the batch through the other package's codec into this one's
        frame = m.M.loads(mods(PKGS[1 - PKGS.index(pkg)]).M.dumps(batch))
        await col.handle("127.0.0.1:71/panopticon-ship", frame)
        await asyncio.sleep(0)
        t.record("http.GET.GetSet", 1.0, _ctx=m.ctx.SpanContext(root.trace_id, root.span_id,
                                                                 None))
        await heartbeat_past_the_window(m, col, frame.seq + 1, host="127.0.0.1:71")
        tampered = m.M.TelemetryBatch(**{**vars(frame), "dropped": frame.dropped + 1})
        await col.handle("127.0.0.1:71/panopticon-ship", tampered)
        t.unsubscribe(col.on_record)
        return ([(a.ok, a.error) for _, _, a in net.sent], col.stats(),
                reg.value("dds_fleet_collect_rejected_total", reason="mac"))

    async def go():
        out = {}
        for pkg in PKGS:
            batch, root = await ship(pkg)
            other = PKGS[1 - PKGS.index(pkg)]
            b_other = mods(other).M.loads(mods(pkg).M.dumps(batch))
            assert mods(other).M.dumps(b_other) == mods(pkg).M.dumps(batch)
            assert b_other.region == "eu"
            out[pkg] = await collect(other, batch, root)
        return out

    out = asyncio.run(asyncio.wait_for(go(), BOUND))
    for acks, stats, rejected in out.values():
        assert acks == [(True, ""), (True, ""), (False, "bad mac")]
        assert stats["sources"] == ["127.0.0.1:71"] and stats["traces_stitched"] == 1
        assert rejected == 1


# ------------------------------------------------------------------ shipper


def test_shipper_ships_quiesced_trees_as_signed_batches_twin():
    async def go(pkg):
        m = mods(pkg)
        sh, net, t, reg = make_shipper(m)
        t.subscribe(sh.on_record)
        with t.span("replica.handle", replica="s0-replica-1", msg="Read", key="K"):
            pass
        t.unsubscribe(sh.on_record)
        await asyncio.sleep(0.03)
        await sh._flush_once()
        src, dest, batch = net.sent[0]
        obs = [len(net.sent), src, dest, type(batch).__name__,
               (batch.host, batch.role, batch.shard, batch.seq, batch.dropped),
               [d["name"] for tree in batch.spans for d in tree],
               batch.mac == m.pan.batch_mac(SECRET, batch.host, batch.role, batch.shard,
                                            batch.seq, batch.ts, batch.spans,
                                            batch.incidents, batch.metrics_text, batch.slo,
                                            batch.dropped)]
        await sh._flush_once()  # nothing new, the heartbeat not due: no frame
        obs.append(len(net.sent))
        sh._last_ship = 0.0  # the heartbeat due: an empty liveness batch
        await sh._flush_once()
        obs += [len(net.sent), net.sent[1][2].spans,
                "dds_fleet_ship_batches_total" in net.sent[1][2].metrics_text,
                sh.stats()]
        return obs

    twin(go)


def test_shipper_spool_overflow_drops_oldest_and_accounts_twin():
    async def go(pkg):
        m = mods(pkg)
        sh, net, t, reg = make_shipper(m, spool_max=2, batch_max=1)
        t.subscribe(sh.on_record)
        for i in range(4):
            with t.span(f"op{i}"):
                pass
        t.unsubscribe(sh.on_record)
        obs = [sh.stats()["active_traces"]]
        await asyncio.sleep(0.03)
        trees = sh._collect_quiesced()
        obs += [[[d["name"] for d in tree] for tree in trees], sh.stats(),
                reg.value("dds_fleet_ship_dropped_total", reason="spool_overflow")]
        await sh.handle("c", m.M.TelemetryAck(seq=9, ok=False, error="bad mac"))
        await sh.handle("c", m.M.TelemetryAck(seq=10, ok=True))
        obs += [sh.stats(), reg.value("dds_fleet_ship_dropped_total", reason="rejected"),
                reg.value("dds_fleet_ship_acked_total")]
        return obs

    obs = twin(go)
    assert obs[2]["dropped"] == 2 and obs[4]["dropped"] == 3


def test_shipper_ships_breaker_events_and_ignores_other_loose_records_twin():
    async def go(pkg):
        m = mods(pkg)
        sh, net, t, reg = make_shipper(m)
        t.subscribe(sh.on_record)
        t.event("breaker.open", target="s0-replica-2")
        t.record("cache.miss", 0.0, _kind="event")
        t.event("abd.coordinator_violation", node="s0-replica-3")
        t.unsubscribe(sh.on_record)
        await asyncio.sleep(0.03)
        await sh._flush_once()
        (_, _, batch), = net.sent
        return [[(d["name"], d.get("meta")) for d in tree] for tree in batch.spans]

    assert twin(go) == [[("breaker.open", {"target": "s0-replica-2"}),
                         ("abd.coordinator_violation", {"node": "s0-replica-3"})]]


def test_shipper_tails_the_flight_index_twin(tmp_path):
    async def go(pkg):
        m = mods(pkg)
        d = tmp_path / pkg
        d.mkdir()
        sh, net, t, reg = make_shipper(m, flight_dir=str(d))
        idx = d / "index.jsonl"
        idx.write_text(json.dumps({"trace_id": "aa", "reason": "audit"}) + "\nnot json\n")
        await sh._flush_once()
        with open(idx, "a") as f:
            f.write(json.dumps({"reason": "panic"}) + "\n")
        await sh._flush_once()
        idx.write_text(json.dumps({"reason": "pruned"}) + "\n")  # rewritten: re-tail
        await sh._flush_once()
        return [b.incidents for _, _, b in net.sent]

    assert twin(go) == [[{"trace_id": "aa", "reason": "audit"}], [{"reason": "panic"}],
                        [{"reason": "pruned"}]]


# ---------------------------------------------------------------- collector


def test_collector_rejects_a_bad_mac_with_an_ack_and_a_counter_twin():
    async def go(pkg):
        m = mods(pkg)
        col, net, wt, t, reg = make_collector(m)
        await col.handle("g:1/panopticon-ship", make_batch(m, [], secret=b"wrong-secret"))
        obs = [col.stats(), reg.value("dds_fleet_collect_rejected_total", reason="mac")]
        (_, dest, ack), = net.sent
        obs.append((dest, type(ack).__name__, ack.ok, ack.error, ack.seq))
        await col.handle("g:1/panopticon-ship", make_batch(m, [], seq=2))
        obs += [col.stats(), net.sent[-1][2].ok, reg.value("dds_fleet_collect_batches_total",
                                                           host="ghost")]
        return obs

    obs = twin(go)
    assert obs[0]["sources"] == [] and obs[3]["sources"] == ["ghost"]


def commit(m, t, name, key, seq, tag_id, coordinator="s0-replica-0"):
    """The proxy's half of a cross-host op: the root http span and the
    quorum client's committed abd span; returns the abd span's context."""
    out = {}
    with t.span(f"http.{name}"):
        with t.span("abd.write" if name == "write" else "abd.fetch",
                    coordinator=coordinator, ok=True,
                    op="write" if name == "write" else "read",
                    key=key, seq=seq, tag_id=tag_id):
            out["abd"] = m.ctx.current()
    return out["abd"]


def remote_handlers(ctx, phases, key="K"):
    """Shipped replica.handle spans (a group process's vantage), children
    of the proxy's abd span through the propagated context."""
    return [
        {"ts": time.time(), "name": "replica.handle", "dur_ms": 0.3, "kind": "span",
         "trace_id": ctx.trace_id, "span_id": os.urandom(8).hex(), "parent_id": ctx.span_id,
         "meta": {"replica": replica, "msg": msg, "key": key}}
        for msg, replica in phases
    ]


HONEST = [("ReadTag", r) for r in R4[:3]] + [("Write", r) for r in R4[:3]]


def test_collector_stitches_a_cross_host_trace_and_audits_the_forgery_twin():
    """Two honest cross-host writes (their handler spans arrive in
    batches), then a read committing a forged stale tag no remote process
    vouches for: exactly tag_monotonicity and quorum_intersection, both on
    the forged read's trace."""

    async def go(pkg):
        m = mods(pkg)
        col, net, wt, t, reg = make_collector(m)
        t.subscribe(col.on_record)
        ids = {}
        for seq in (1, 2):
            ctx = commit(m, t, "write", "K", seq, "s0-replica-0")
            ids[ctx.trace_id] = f"write{seq}"
            await col.handle("g/panopticon-ship",
                             make_batch(m, [remote_handlers(ctx, HONEST)], seq=2 * seq - 1))
            await heartbeat_past_the_window(m, col, 2 * seq)
            await asyncio.sleep(0.005)
        clean = (wt.verdicts(), col.stats()["traces_stitched"])
        ctx = commit(m, t, "read", "K", 1, "forged", coordinator="s0-replica-3")
        ids[ctx.trace_id] = "forged"
        # the group's heartbeat after the read: no span of it to ship
        await heartbeat_past_the_window(m, col, 5)
        t.unsubscribe(col.on_record)
        return clean, verdict_view(wt.verdicts(), ids), col.stats()["traces_stitched"]

    clean, verdicts, stitched = twin(go)
    assert clean == ([], 2) and stitched == 3
    assert [(inv, tid) for inv, tid, _ in verdicts] == [("quorum_intersection", "forged"),
                                                         ("tag_monotonicity", "forged")]
    assert json.loads(verdicts[1][2])["tag"] == [1, "forged"]


def test_collector_audits_each_trace_once_despite_stragglers_twin():
    async def go(pkg):
        m = mods(pkg)
        col, net, wt, t, reg = make_collector(m)
        t.subscribe(col.on_record)
        ctx = commit(m, t, "write", "K", 1, "s0-replica-0")
        tree = remote_handlers(ctx, HONEST)
        await col.handle("g/panopticon-ship", make_batch(m, [tree], seq=1))
        await heartbeat_past_the_window(m, col, 2)
        first = col.stats()
        await col.handle("g/panopticon-ship", make_batch(m, [tree[:1]], seq=3))
        await asyncio.sleep(0.06)
        col._replay_due()
        t.unsubscribe(col.on_record)
        return first, col.stats(), [v.invariant for v in wt.verdicts()], wt.stats()

    first, after, verdicts, stats = twin(go)
    assert first["traces_stitched"] == after["traces_stitched"] == 1
    assert after["pending_traces"] == 0 and verdicts == []


def test_null_watchtower_sinks_replays_twin():
    async def go(pkg):
        m = mods(pkg)
        sink = m.pan.NullWatchtower()
        col, net, _, t, reg = make_collector(m, wt=sink)
        t.subscribe(col.on_record)
        commit(m, t, "read", "K", 1, "forged")
        await asyncio.sleep(0.06)
        col._replay_due()
        t.unsubscribe(col.on_record)
        return col.stats()["traces_stitched"], sink.verdicts(), col.fleet_incidents()

    assert twin(go)[:2] == (1, [])


def test_rootless_traces_leave_after_the_grace_unaudited_twin():
    async def go(pkg):
        m = mods(pkg)
        col, net, wt, t, reg = make_collector(m)
        ctx = m.ctx.child(None)
        await col.handle("g/panopticon-ship",
                         make_batch(m, [remote_handlers(ctx, HONEST)], seq=1))
        col._replay_due()
        pending = col.stats()["pending_traces"]
        for buf in col._traces.values():
            buf["first"] -= 9.0  # past max(8 x stitch window, 8 s)
        col._replay_due()
        return pending, col.stats(), wt.stats()["traces_audited"]

    assert twin(go)[0] == 1


def test_evicted_stitch_buffer_gives_no_false_verdict():
    """ROADMAP §C 21. `MAX_TRACES = 2`; three read traces whose replica
    spans (a full read quorum each) arrive before any proxy span, then
    each trace's abd span and root. The reference evicts the first trace's
    buffer, opens fresh buffers for the rest of each evicted trace and
    replays them as trees without their replica spans: false
    `quorum_intersection` verdicts. The port drops the rest of an evicted
    trace and audits the others whole: no verdict."""

    async def go(pkg):
        m = mods(pkg)
        col, net, wt, t, reg = make_collector(m)
        col.MAX_TRACES = 2
        t.subscribe(col.on_record)
        roots = [m.ctx.child(None) for _ in range(3)]
        abds = [m.ctx.child(r) for r in roots]
        for i, a in enumerate(abds):
            tree = [{"ts": time.time(), "name": "replica.handle", "dur_ms": 0.3,
                     "kind": "span", "trace_id": a.trace_id,
                     "span_id": f"{i:02x}{j:014x}", "parent_id": a.span_id,
                     "meta": {"replica": r, "msg": "Read", "key": f"K{i}"}}
                    for j, r in enumerate(R4[:3])]
            await col.handle("g/panopticon-ship", make_batch(m, [tree], seq=i + 1))
        for i, (r, a) in enumerate(zip(roots, abds)):
            t.record("abd.fetch", 1.0, _ctx=a, coordinator="s0-replica-0", ok=True, op="read",
                     key=f"K{i}", seq=1, tag_id="s0-replica-0")
            t.record("http.GET.GetSet", 2.0, _ctx=r)
        await heartbeat_past_the_window(m, col, 4)
        t.unsubscribe(col.on_record)
        ids = {r.trace_id: f"read{i}" for i, r in enumerate(roots)}
        return (verdict_view(wt.verdicts(), ids), col.stats()["traces_stitched"],
                reg.value("dds_fleet_collect_evicted_total"))

    ref = asyncio.run(asyncio.wait_for(go("dds_tpu"), BOUND))
    port = asyncio.run(asyncio.wait_for(go("dds_tpu_torch"), BOUND))
    # the reference: quorum_intersection with an empty read phase on the
    # traces whose replica spans it evicted
    assert ref[0] and {inv for inv, _, _ in ref[0]} == {"quorum_intersection"}
    assert all(json.loads(d)["read_phase"] == [] for _, _, d in ref[0])
    # the port: the evicted trace unaudited, the two others whole and clean
    assert port == ([], 2, 1.0)


def test_a_late_group_loses_its_spans_to_the_window_in_the_reference_not_the_port():
    """ROADMAP §C 22, the collector's half. A write's root completes while
    its group's last batch was collected before it; a stitch window later
    the reference replays the tree without the group's handler spans (a
    false `quorum_intersection`), and when they arrive they are a
    straggler of an audited trace. The port holds the root until the
    group has delivered a batch a flush interval past the root's due
    time, then audits the whole tree: no verdict."""

    async def go(pkg):
        m = mods(pkg)
        col, net, wt, t, reg = make_collector(m)
        t.subscribe(col.on_record)
        # the group's heartbeat, collected before the write
        await col.handle("g/panopticon-ship", make_batch(m, [], seq=1))
        ctx = commit(m, t, "write", "K", 1, "s0-replica-0")
        await asyncio.sleep(0.07)  # past the stitch window
        col._replay_due()
        early = col.stats()["traces_stitched"]
        # the group's spans of the write, late
        await col.handle("g/panopticon-ship",
                         make_batch(m, [remote_handlers(ctx, HONEST)], seq=2))
        await asyncio.sleep(0.01)
        col._replay_due()
        t.unsubscribe(col.on_record)
        return early, col.stats()["traces_stitched"], \
            verdict_view(wt.verdicts(), {ctx.trace_id: "write"})

    ref = asyncio.run(asyncio.wait_for(go("dds_tpu"), BOUND))
    port = asyncio.run(asyncio.wait_for(go("dds_tpu_torch"), BOUND))
    assert ref[:2] == (1, 1)
    assert [(inv, tid) for inv, tid, _ in ref[2]] == [("quorum_intersection", "write")]
    assert json.loads(ref[2][0][2])["problems"] == ["read_phase=0<3", "write_phase=0<3"]
    assert port == (0, 1, [])


@pytest.mark.parametrize("skew", [2.0, -2.0])
def test_the_hold_reads_the_collectors_clock_not_a_skewed_shippers(skew):
    """ROADMAP §C 22 across hosts: the group host's wall clock runs `skew`
    seconds off the proxy's, and stamps every batch it ships. A fast clock
    must not release a root before the group's spans arrive (a false
    `quorum_intersection`), nor a slow one hold it for the 8 s grace: the
    hold reads only the collector's own monotonic clock."""

    async def go():
        m = mods("dds_tpu_torch")
        col, net, wt, t, reg = make_collector(m)
        t.subscribe(col.on_record)
        await col.handle("g/panopticon-ship", make_batch(m, [], seq=1, ts=time.time() + skew))
        ctx = commit(m, t, "write", "K", 1, "s0-replica-0")
        await asyncio.sleep(0.07)  # past the stitch window, the group silent
        col._replay_due()
        held = col.stats()["traces_stitched"]
        await col.handle("g/panopticon-ship",
                         make_batch(m, [remote_handlers(ctx, HONEST)], seq=2,
                                    ts=time.time() + skew))
        col._replay_due()
        t.unsubscribe(col.on_record)
        return held, col.stats()["traces_stitched"], [v.invariant for v in wt.verdicts()]

    assert asyncio.run(asyncio.wait_for(go(), BOUND)) == (0, 1, [])


def test_collector_buffers_spans_recorded_on_worker_threads():
    """The proxy's folds record `kernel.*` spans on worker threads while
    the loop replays: 32 threads open 100 traces each (two spans and the
    root) as fast as they can while the loop scans the full buffers
    without pause, and every trace is stitched or evicted exactly once."""
    from dds_tpu_torch.obs import context as ctxm

    async def go():
        m = mods("dds_tpu_torch")
        # a long window: the buffers stay full while the loop iterates them
        col, net, wt, t, reg = make_collector(m, wt=m.pan.NullWatchtower(), stitch_window=60.0)
        t.subscribe(col.on_record)

        def traces(n):
            for _ in range(n):
                root = ctxm.child(None)
                tok = ctxm.attach(root)
                try:
                    for i in range(2):
                        with t.span("kernel.mont_mul", i=i):
                            pass
                finally:
                    ctxm.detach(tok)
                t.record("http.GET.SumAll", 1.0, _ctx=root)

        async def replayer(stop):
            while not stop.is_set():
                col._replay_due()
                await asyncio.sleep(0)

        stop = asyncio.Event()
        task = asyncio.ensure_future(replayer(stop))
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)  # switch threads as often as possible
        try:
            await asyncio.gather(*(asyncio.to_thread(traces, 100) for _ in range(32)))
        finally:
            sys.setswitchinterval(interval)
            stop.set()
        await task
        for buf in col._traces.values():
            buf["due"] = 0.0
        col._replay_due()
        t.unsubscribe(col.on_record)
        return col.stats(), reg.value("dds_fleet_collect_evicted_total") or 0

    stats, evicted = asyncio.run(asyncio.wait_for(go(), BOUND))
    assert stats["pending_traces"] == 0
    assert stats["traces_stitched"] + evicted == 3200


# --------------------------------------------------------------- federation


def test_merge_expositions_relabels_and_emits_headers_once_twin():
    src_a = ("# HELP dds_requests_total requests\n# TYPE dds_requests_total counter\n"
             'dds_requests_total{route="GetSet"} 3\n')
    src_b = ("# HELP dds_requests_total requests\n# TYPE dds_requests_total counter\n"
             "dds_requests_total 5\n# TYPE dds_lat histogram\n"
             'dds_lat_bucket{le="+Inf"} 2\ndds_lat_sum 0.25\ndds_lat_count 2\n')

    async def go(pkg):
        return mods(pkg).pan.merge_expositions([
            {"labels": {"host": "h1", "role": "proxy"}, "text": src_a},
            {"labels": {"host": "h2", "role": "group:s0", "shard": "s0"}, "text": src_b},
        ])

    doc = twin(go)
    assert doc.count("# TYPE dds_requests_total counter") == 1
    assert 'dds_lat_sum{host="h2",role="group:s0",shard="s0"} 0.25' in doc


def test_parse_samples_reads_labelled_and_bare_series_twin():
    async def go(pkg):
        m = mods(pkg)
        reg = m.metrics.Registry()
        reg.set("dds_resident_rows", 42, shard="s0")
        reg.set("dds_resident_rows", 7, shard="s1")
        reg.set("dds_admission_shed_level", 2)
        text = reg.render()
        return [m.pan.parse_samples(text, n) for n in
                ("dds_resident_rows", "dds_admission_shed_level", "dds_absent_series")]

    rows, shed, absent = twin(go)
    assert sorted(v for _, v in rows) == [7.0, 42.0] and shed == [({}, 2.0)] and absent == []


def test_fleet_metrics_labels_every_source_and_marks_staleness_twin():
    def no_ages(doc):
        return [ln for ln in doc.splitlines() if not ln.startswith("dds_fleet_source_age")]

    async def go(pkg):
        m = mods(pkg)
        col, net, wt, t, reg = make_collector(m, staleness=5.0)
        reg.set("dds_up", 1)
        await col.handle("g/panopticon-ship", make_batch(
            m, [], host="10.0.0.7:7100", role="group:s0", shard="s0", region="eu",
            metrics_text="# TYPE dds_up gauge\ndds_up 1\n", dropped=3))
        col.sample_gauges()
        fresh = no_ages(col.fleet_metrics())
        col._sources["10.0.0.7:7100"]["mono"] -= 60.0
        doc = col.fleet_metrics()
        ages = {a["host"]: v > 59.0 for a, v in
                m.pan.parse_samples(doc, "dds_fleet_source_age_seconds")}
        return fresh, no_ages(doc), ages, col.source_ages().keys() == {"s0"}, \
            col.source_regions()

    fresh, stale, ages, shard_keyed, regions = twin(go)
    assert 'dds_up{host="10.0.0.7:7100",role="group:s0",shard="s0",region="eu"} 1' in fresh
    assert 'dds_fleet_source_stale{host="10.0.0.7:7100",role="group:s0"} 1' in stale
    assert ages == {"127.0.0.1:70": False, "10.0.0.7:7100": True}
    assert shard_keyed and regions == {"s0": "eu"}


def test_fleet_slo_rolls_up_worst_of_and_sum_of_burn_twin():
    def slo_for(total, bad, burn):
        return {"routes": {"GetSet": {"objective": 0.99, "class": "interactive",
                                      "windows": {"5m": {"total": total, "bad": bad,
                                                         "burn_rate": burn}}}}}

    async def go(pkg):
        m = mods(pkg)
        col, net, wt, t, reg = make_collector(m)
        await col.handle("a/s", make_batch(
            m, [], host="hA", role="group:s0", shard="s0", slo=slo_for(100, 2, 2.0),
            metrics_text=('dds_resident_rows{shard="s0"} 10\n'
                          'dds_resident_bytes{shard="s0"} 4096\n'
                          "dds_admission_shed_level 1\n")))
        await col.handle("b/s", make_batch(
            m, [], host="hB", role="group:s1", shard="s1", slo=slo_for(300, 0, 0.5),
            metrics_text='dds_resident_rows{shard="s1"} 7\ndds_admission_shed_level 3\n'))
        rep = col.fleet_slo()
        for h in rep["hosts"].values():
            h["age_s"] = 0.0
        return rep

    rep = twin(go)
    w = rep["fleet"]["routes"]["GetSet"]["windows"]["5m"]
    assert (w["total"], w["bad"], w["burn_rate_worst"], w["burn_rate_sum_of"]) == \
        (400, 2, 2.0, 0.5)
    assert rep["fleet"]["shed_level_max"] == 3.0


def test_fleet_incidents_correlate_by_trace_id_twin():
    async def go(pkg):
        m = mods(pkg)
        col, net, wt, t, reg = make_collector(m)
        await col.handle("a/s", make_batch(
            m, [], host="hA", role="group:s0", shard="s0",
            incidents=[{"trace_id": "aa11", "reason": "audit"}, {"reason": "panic"}]))
        await col.handle("b/s", make_batch(
            m, [], host="hB", role="group:s1", shard="s1",
            incidents=[{"trace_id": "aa11", "reason": "audit"}, "not-a-dict"]))
        return col.fleet_incidents(), col.fleet_incidents("aa11")

    rep, only = twin(go)
    assert rep["count"] == 3 and [e["host"] for e in rep["by_trace"]["aa11"]] == ["hA", "hB"]
    assert only["count"] == 2 and set(only["by_trace"]) == {"aa11"}


def pipe_text(route, stage, p95, wall=50.0, cov=0.97):
    return "\n".join([f'dds_pipe_wall_p95_ms{{route="{route}"}} {wall}',
                      f'dds_pipe_coverage{{route="{route}"}} {cov}',
                      f'dds_pipe_stage_p95_ms{{route="{route}",stage="{stage}"}} {p95}', ""])


def test_fleet_profile_rolls_up_the_max_across_hosts_twin():
    async def go(pkg):
        m = mods(pkg)
        reg = m.metrics.Registry()
        reg.set("dds_pipe_wall_p95_ms", 50.0, route="http.POST.PutSet")
        reg.set("dds_pipe_coverage", 0.99, route="http.POST.PutSet")
        reg.set("dds_pipe_stage_p95_ms", 12.0, route="http.POST.PutSet", stage="quorum-rtt")
        col = m.pan.FleetCollector(LoopNet(), secret=b"s", host="proxy-0", registry=reg,
                                   watchtower=types.SimpleNamespace(on_record=lambda r: None))
        col._sources["group-1"] = {
            "role": "group", "shard": "s0", "ts": 0.0, "region": "eu",
            "mono": time.monotonic(), "seq": 1, "slo": {}, "dropped": 0,
            "metrics_text": pipe_text("http.POST.PutSet", "replica-apply", 30.0)}
        fp = col.fleet_profile()
        for h in fp["hosts"].values():
            h["age_s"] = 0.0
        return fp

    fp = twin(go)
    assert fp["fleet"]["top"] == {"route": "http.POST.PutSet", "stage": "replica-apply",
                                  "p95_ms": 30.0, "host": "group-1"}


def test_collector_replay_feeds_the_profiler_a_stitched_tree_twin():
    async def go(pkg):
        m = mods(pkg)
        S = m.trace.SpanRecord
        col = m.pan.FleetCollector(LoopNet(), secret=b"s", host="proxy-0",
                                   registry=m.metrics.Registry(),
                                   watchtower=types.SimpleNamespace(on_record=lambda r: None),
                                   stitch_window=0.0)
        cs = m.chrono.Chronoscope(registry=m.metrics.Registry(), slow_ms=1e9)
        col.profiler = cs
        col._buffer(S(0.01, "abd.write", 80.0, {}, "tz", "c", "r"), local=True)
        col._buffer(S(0.02, "replica.handle", 40.0, {}, "tz", "h", "c"), local=False)
        col._buffer(S(0.0, "http.POST.PutSet", 100.0, {}, "tz", "r", None), local=True)
        col._replay_due()
        route = cs.profile()["routes"]["http.POST.PutSet"]
        return route["count"], sorted(route["stages"])

    count, stages = twin(go)
    assert count == 1 and "replica-apply" in stages


def test_fleet_canary_rolls_up_the_worst_verdict_and_exemplars_twin():
    async def go(pkg):
        m = mods(pkg)

        def ledger(kind, verdict, trace_id, region=""):
            led = m.helio.CanaryLedger(registry=m.metrics.Registry())
            led.record(m.helio.ProbeResult(kind, verdict, 0.01, trace_id, region=region))
            reg = m.metrics.Registry()
            led.export_gauges(reg)
            return reg.render()

        col = m.pan.FleetCollector(LoopNet(), secret=b"s", host="proxy-1",
                                   watchtower=m.wt.Watchtower(), registry=m.metrics.Registry())
        now = time.monotonic()
        for host, text, region in (("host-a", ledger("sum", "ok", "t-a"), "east"),
                                   ("host-b", ledger("sum", "wrong_answer", "t-b", "west"),
                                    "west")):
            col._sources[host] = {"mono": now, "role": "group", "shard": f"g-{host[-1]}",
                                  "region": region, "metrics_text": text, "slo": {},
                                  "dropped": 0}
        body = col.fleet_canary()
        for h in body["hosts"].values():
            h["age_s"] = 0.0
            for k in h["kinds"].values():
                k.pop("last_ok_age_s", None)
        return body

    body = twin(go)
    assert body["fleet"]["kinds"]["sum"] == {"worst": "wrong_answer", "hosts": 2}
    (f,) = body["fleet"]["failures"]
    assert (f["host"], f["trace_id"], f["verdict"]) == ("host-b", "t-b", "wrong_answer")


def test_helmsman_promotes_the_dead_group_a_real_collector_reports_twin():
    """A collector that heard s0's heartbeat now and s1's 40 s ago: its
    `source_ages` drives a pinned Helmsman to promote s1, in both
    packages."""

    async def go(pkg):
        m = mods(pkg)
        col, net, wt, t, reg = make_collector(m)
        for gid in ("s0", "s1"):
            await col.handle(f"{gid}/panopticon-ship", make_batch(
                m, [], host=f"10.0.0.{gid[1]}:7101", role=f"group:{gid}", shard=gid))
        col._sources["10.0.0.1:7101"]["mono"] -= 40.0
        actions = []

        async def act(kind, gid):
            actions.append((kind, gid))

        clock = types.SimpleNamespace(t=1000.0)
        hm = m.fleet.Helmsman(
            load_census=lambda: {"s0": 50, "s1": 50}, slo_alerts=lambda: [],
            shed_level=lambda: 0, source_ages=col.source_ages,
            regions=col.source_regions, split=lambda g: act("split", g),
            merge=lambda g: act("merge", g), promote=lambda g: act("promote", g),
            moved_bytes=lambda: 0, reshard_busy=lambda: False, clock=lambda: clock.t,
            heartbeat_timeout=15.0, cooldown=10.0)
        hm.pin()
        first = await hm.step()
        clock.t += 5
        second = await hm.step()
        return first, second, actions, sorted(col.source_ages())

    assert twin(go) == ("promote", None, [("promote", "s1")], ["s0", "s1"])


# ------------------------------------ flagships: real OS processes (slow)


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def key_owned_by(gid: str) -> tuple[list, str]:
    """(contents, key) of a PutSet whose key the epoch-1 map (S = 2, 16
    vnodes a group) gives to `gid`."""
    from dds_tpu_torch.shard.shardmap import ShardMap
    from dds_tpu_torch.utils import sigs

    smap = ShardMap.build(["s0", "s1"], 16)
    for i in range(4096):
        contents = [f"panopticon-{i}"]
        key = sigs.key_from_set(contents)
        if smap.owner(key) == gid:
            return contents, key
    raise AssertionError("no key hashed into the target group")


def fleet_files(tmp_path, attack: bool) -> tuple[dict, int]:
    """Two group processes and a proxy of the port on loopback, every
    group shipping to the proxy's collector (flush 0.1 s), the proxy
    auditing with quorum checks on (stitch window 1.5 s); with `attack`
    s0's replicas forge stale reads."""
    t_ports = [free_port() for _ in range(3)]
    s_ports = [free_port() for _ in range(2)]
    rest = free_port()
    groups = "\n".join(f's{i} = "127.0.0.1:{p}"' for i, p in enumerate(t_ports[:2]))
    bootstrap = json.dumps([f"127.0.0.1:{p}" for p in s_ports])
    common = ["[shard]", "enabled = true", "count = 2", "vnodes-per-group = 16",
              "replicas-per-group = 4", "sentinent-per-group = 1", "quorum-size = 3",
              "max-faults = 1", "", "[recovery]", "enabled = false", "",
              "[proxy]", 'host = "127.0.0.1"', f"port = {rest}", 'crypto-backend = "cpu"',
              'device = "cpu"', ""]
    files = {}
    for name, role, t_port, s_port in (("group0", "group:0", t_ports[0], s_ports[0]),
                                       ("group1", "group:1", t_ports[1], s_ports[1]),
                                       ("proxy", "proxy", t_ports[2], 0)):
        fleet = (['[obs.fleet]', "enabled = true", "stitch-window = 1.5"] if role == "proxy"
                 else ["[obs.fleet]", "enabled = true",
                       f'collector = "127.0.0.1:{t_ports[2]}"', "flush-interval = 0.1"])
        attack_s = (["[attacks]", "enabled = true", 'type = "stale_tag"', ""]
                    if attack and name == "group0" else [])
        text = common + ["[transport]", 'kind = "tcp"', 'host = "127.0.0.1"',
                         f"port = {t_port}", "", "[fabric]", f'role = "{role}"',
                         f"status-port = {s_port}", f"bootstrap = {bootstrap}",
                         "gossip-wait = 2.0", "", "[fabric.groups]", groups, ""] \
            + attack_s + fleet + [""]
        files[name] = tmp_path / f"{name}.toml"
        files[name].write_text("\n".join(text))
    return files, rest


def forged_fleet_schedule(tmp_path, attack: bool):
    """Two PutSets of one s0-owned set, then one GetSet, through a port
    proxy process over two port group processes; returns (the read's
    contents, the /fleet/incidents body, the /fleet/metrics text)."""
    from dds_tpu_torch.http.miniserver import http_request

    files, port = fleet_files(tmp_path, attack)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    contents, key = key_owned_by("s0")
    procs = {}
    for name, path in files.items():
        log = open(tmp_path / f"{name}.log", "w")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "dds_tpu_torch.run", "--config", str(path), "--serve",
             "--ops", "0", "--device", "cpu", "--backend", "cpu"],
            cwd=root, stdout=log, stderr=subprocess.STDOUT)

    async def go():
        for _ in range(600):
            try:
                st, _ = await http_request("127.0.0.1", port, "GET", "/shards", timeout=2.0)
                if st == 200:
                    break
            except (OSError, asyncio.TimeoutError):
                pass
            await asyncio.sleep(0.2)
        for _ in range(2):  # same contents, same key: two commits on it
            for _ in range(100):  # 503 until the groups' quorums answer
                st, body = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                              json.dumps({"contents": contents}).encode(),
                                              timeout=30.0)
                if st != 503:
                    break
                await asyncio.sleep(0.2)
            assert st == 200 and body.decode() == key, (st, body)
            await asyncio.sleep(0.05)
        st, body = await http_request("127.0.0.1", port, "GET", f"/GetSet/{key}",
                                      timeout=30.0)
        assert st == 200, body
        value = json.loads(body)["contents"]
        await asyncio.sleep(4.0)  # the groups ship, the collector replays
        st, body = await http_request("127.0.0.1", port, "GET", "/fleet/incidents",
                                      timeout=10.0)
        assert st == 200
        st, mbody = await http_request("127.0.0.1", port, "GET", "/fleet/metrics",
                                       timeout=10.0)
        assert st == 200
        return value, json.loads(body), mbody.decode()

    try:
        return asyncio.run(asyncio.wait_for(go(), 240.0))
    finally:
        for p in procs.values():
            p.send_signal(signal.SIGINT)
        for p in procs.values():
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=15)


@pytest.mark.slow
@pytest.mark.multihost
def test_flagship_cross_host_stale_tag_forgery_is_caught_on_port_processes(tmp_path):
    value, report, mtext = forged_fleet_schedule(tmp_path, attack=True)
    assert value == ["stale"]
    by_inv = {v["invariant"]: v for v in report["verdicts"]}
    assert set(by_inv) == {"tag_monotonicity", "quorum_intersection"}, report["verdicts"]
    assert by_inv["tag_monotonicity"]["detail"]["tag"] == [1, "forged"]
    tid = by_inv["tag_monotonicity"]["trace_id"]
    assert tid and by_inv["quorum_intersection"]["trace_id"] == tid
    assert 'role="group:s0"' in mtext and 'role="group:s1"' in mtext
    assert 'role="proxy"' in mtext and "dds_fleet_source_age_seconds" in mtext


@pytest.mark.slow
@pytest.mark.multihost
def test_flagship_clean_fleet_schedule_is_verdict_free_on_port_processes(tmp_path):
    contents, _ = key_owned_by("s0")
    value, report, mtext = forged_fleet_schedule(tmp_path, attack=False)
    assert value == contents
    assert report["verdicts"] == [], report["verdicts"]
    assert 'role="group:s0"' in mtext and 'role="proxy"' in mtext


def test_a_flush_drains_the_spool_in_the_port_and_ships_one_batch_in_the_reference():
    """ROADMAP §C 22. Ten quiesced traces, `batch_max = 4`: one flush of
    the reference ships one batch of four and keeps six spooled, so a
    group process shipping more than `batch_max / flush_interval` trees a
    second falls further behind every flush, past the collector's stitch
    window; one flush of the port ships them all, four to a batch."""

    async def go(pkg):
        m = mods(pkg)
        sh, net, t, reg = make_shipper(m, batch_max=4)
        t.subscribe(sh.on_record)
        for i in range(10):
            with t.span(f"op{i}"):
                pass
        t.unsubscribe(sh.on_record)
        await asyncio.sleep(0.03)
        await sh._flush_once()
        batches = [b for _, _, b in net.sent]
        return ([[d["name"] for tree in b.spans for d in tree] for b in batches],
                [b.seq for b in batches], sh.stats()["spooled_trees"])

    ref = asyncio.run(asyncio.wait_for(go("dds_tpu"), BOUND))
    port = asyncio.run(asyncio.wait_for(go("dds_tpu_torch"), BOUND))
    names = [f"op{i}" for i in range(10)]
    assert ref == ([names[:4]], [1], 6)
    assert port == ([names[:4], names[4:8], names[8:]], [1, 2, 3], 0)
