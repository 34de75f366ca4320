"""Chronoscope in the port against the reference's, exactly.

The same synthetic span records (each package's own `SpanRecord`) go to
`dds_tpu.obs.chronoscope` and `dds_tpu_torch.obs.chronoscope`: `classify`
over the taxonomy, `critical_path` on a linear chain, a parallel fan-out,
staggered siblings, orphans with and without adoption, unusable roots and
unknown spans, then a `Chronoscope` fed through `on_record` and
`ingest_tree` (routes, stages, exemplars, replica subtrees, the folded
text, the gauges) and `note_usage`/`tenant_usage` up to and past its
cardinality bounds; each answer equal in both. Then the REST edge: a
port stack with tenancy attributes each tenant's requests, and `launch`
attaches the process-wide profiler that `stop` detaches and resets.
"""

import asyncio
import importlib
import json

import pytest

def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def records(pkg: str, spec) -> list:
    """Each package's SpanRecords from (name, start, end, span_id,
    parent_id, trace_id, kind, meta) tuples; ts is the end instant."""
    SR = mod(pkg, "utils.trace").SpanRecord
    return [SR(ts=end, name=name, dur_ms=(end - start) * 1e3, meta=dict(meta),
               trace_id=tid, span_id=sid, parent_id=pid, kind=kind)
            for name, start, end, sid, pid, tid, kind, meta in spec]


def S(name, start, end, sid, pid=None, tid="t1", kind="span", **meta):
    return (name, start, end, sid, pid, tid, kind, meta)


def twin(scenario):
    ref = scenario("dds_tpu")
    port = scenario("dds_tpu_torch")
    assert port == ref
    return port


NAMES = ("proxy.admission", "proxy.coalesce_wait", "net.serialize", "abd.verify",
         "abd.write", "abd.read_quorum", "abd.read_tags", "abd.fetch", "ingest.queue_wait",
         "ingest.h2d", "tier.promote", "tier.demote", "tier.cold_read", "replica.handle",
         "antientropy.sync", "kernel.foldmany.compile", "kernel.foldmany.dispatch",
         "kernel.foldmany.execute", "kernel.store.reduce.execute", "proxy.fold",
         "proxy.resident_fold", "proxy.scatter_fold", "proxy.coalesced_fold",
         "proxy.fetch_stored", "proxy.search_eval", "http.POST.PutSet", "http.GET.SumAll",
         "supervisor.recover", "analytics.matvec", "totally.unknown")


def test_classify_twin():
    out = twin(lambda pkg: (mod(pkg, "obs.chronoscope").STAGES,
                            [mod(pkg, "obs.chronoscope").classify(n) for n in NAMES]))
    stages, classes = out
    assert set(classes) <= set(stages)
    got = dict(zip(NAMES, classes))
    assert got["abd.verify"] == "hmac-verify" and got["abd.write"] == "quorum-rtt"
    assert got["kernel.foldmany.compile"] == "trace-compile"
    assert got["proxy.resident_fold"] == "dispatch"
    assert got["totally.unknown"] == got["supervisor.recover"] == "other"


CASES = {
    "linear": ([S("replica.handle", 0.020, 0.060, "c2", "c1"),
                S("abd.write", 0.010, 0.090, "c1", "r"),
                S("http.POST.PutSet", 0.000, 0.100, "r")], {}),
    "fanout": ([S("abd.write", 0.010, 0.090, "slow", "r", coordinator="replica-1"),
                S("abd.write", 0.010, 0.050, "fast", "r", coordinator="replica-2"),
                S("http.POST.PutSet", 0.000, 0.100, "r")], {}),
    "staggered": ([S("abd.read_quorum", 0.000, 0.060, "a", "r"),
                   S("abd.write", 0.040, 0.100, "b", "r"),
                   S("http.POST.PutSet", 0.000, 0.100, "r")], {}),
    "orphan": ([S("replica.handle", 0.050, 0.150, "x", "ghost"),
                S("http.POST.PutSet", 0.000, 0.100, "r")], {}),
    "orphan_kept_out": ([S("replica.handle", 0.050, 0.150, "x", "ghost"),
                         S("http.POST.PutSet", 0.000, 0.100, "r")],
                        {"orphans_to_root": False}),
    "unknown": ([S("totally.unknown", 0.000, 0.080, "u", "r"),
                 S("http.POST.PutSet", 0.000, 0.100, "r")], {}),
    "events": ([S("abd.write", 0.010, 0.090, "c", "r"),
                S("retry", 0.05, 0.05, "e1", "c", kind="event", attempt=2),
                S("http.GET.SumAll", 0.000, 0.100, "r")], {}),
    "subtree": ([S("replica.handle", 0.020, 0.060, "h", "c"),
                 S("abd.write", 0.010, 0.090, "c", "r"),
                 S("http.POST.PutSet", 0.000, 0.100, "r")], {"root_span_id": "h",
                                                             "orphans_to_root": False}),
    "empty": ([], {}),
    "missing_root": ([S("abd.write", 0.0, 0.1, "c", "gone")], {"root_span_id": "nope"}),
    "zero_root": ([S("http.GET.Health", 0.5, 0.5, "r")], {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_critical_path_twin(case):
    spec, kw = CASES[case]
    res = twin(lambda pkg: mod(pkg, "obs.chronoscope").critical_path(records(pkg, spec), **kw))
    if case in ("empty", "missing_root", "zero_root"):
        assert res is None
        return
    assert sum(res["stages"].values()) == pytest.approx(res["wall_ms"], abs=0.05)
    if case == "linear":
        assert res["stages"] == {"response": 20.0, "quorum-rtt": 40.0, "replica-apply": 40.0}
    if case == "unknown":
        assert res["coverage"] == pytest.approx(0.2)


def feed(pkg: str, cs, tid: str, wall: float, extra=()) -> None:
    for rec in records(pkg, [S("abd.write", 0.01, wall - 0.01, f"{tid}-c", f"{tid}-r",
                               tid=tid), *extra,
                             S("http.POST.PutSet", 0.0, wall, f"{tid}-r", tid=tid)]):
        cs.on_record(rec)


def test_chronoscope_routes_exemplars_folded_and_gauges_twin():
    def scenario(pkg):
        C = mod(pkg, "obs.chronoscope")
        reg = mod(pkg, "obs.metrics").Registry()
        cs = C.Chronoscope(registry=reg, exemplars=2, slow_ms=1e9)
        for i, wall in enumerate((0.010, 0.200, 0.020, 0.150, 0.030)):
            feed(pkg, cs, f"t{i}", wall)
        # a replica subtree lands first, then its trace's root
        feed(pkg, cs, "t9", 0.1, [S("replica.handle", 0.02, 0.06, "h", "t9-c", tid="t9")])
        cs.ingest_tree(records(pkg, [S("replica.handle", 0.02, 0.06, "h2", "c2", tid="s"),
                                     S("abd.write", 0.01, 0.09, "c2", "r2", tid="s"),
                                     S("http.GET.SumAll", 0.0, 0.1, "r2", tid="s")]))
        cs.export_gauges(reg)
        stats = cs.stats()
        return cs.profile(), cs.folded(), reg.render(), stats

    prof, folded, text, stats = twin(scenario)
    rs = prof["routes"]["http.POST.PutSet"]
    assert rs["count"] == 6 and rs["top_stage"] == "quorum-rtt"
    assert [e["wall_ms"] for e in rs["exemplars"]] == [200.0, 150.0]
    assert prof["routes"]["replica.handle"]["count"] == 2
    assert "http.POST.PutSet;quorum-rtt" in folded
    assert 'dds_pipe_stage_p95_ms{route="http.GET.SumAll",stage="quorum-rtt"}' in text
    assert stats["traces_profiled"] == 9 and not stats["attached"]


def test_tenant_usage_and_its_bounds_twin():
    def scenario(pkg):
        C = mod(pkg, "obs.chronoscope")
        reg = mod(pkg, "obs.metrics").Registry()
        cs = C.Chronoscope(registry=reg)
        cs.MAX_TENANTS = 4
        cs.MAX_TENANT_ROUTES = 3
        plan = [("gold", "SumAll", 0.25), ("gold", "GetSet", 0.001), ("gold", "GetSet", 0.002),
                ("lead", "PutSet", 0.01), ("gold", "PutSet", 0.003), ("gold", "Range", 0.5),
                ("", "GetSet", 1.0), ("t2", "GetSet", 0.1), ("t3", "GetSet", 0.1),
                ("t4", "SumAll", 0.2), ("t5", "SumAll", 0.3), ("gold", "SumAll", 0.125)]
        for t, route, dur in plan:
            cs.note_usage(t, route, dur)
        cs.export_gauges(reg)
        usage = cs.tenant_usage()
        cs.reset()
        return usage, cs.tenant_usage(), reg.render()

    usage, after_reset, text = twin(scenario)
    assert set(usage) == {"gold", "lead", "t2", "t3", "overflow"}
    assert usage["gold"] == {"requests": 6, "seconds": 0.881,
                             "top_routes": {"GetSet": 2, "SumAll": 2, "PutSet": 1}}
    assert usage["overflow"]["requests"] == 2  # t4 and t5, past MAX_TENANTS
    assert after_reset == {}
    assert 'dds_tenant_usage_requests{tenant="gold"} 6' in text


def test_disabled_by_env_twin(monkeypatch):
    monkeypatch.setenv("DDS_OBS_PIPE", "0")

    def scenario(pkg):
        C = mod(pkg, "obs.chronoscope")
        cs = C.Chronoscope(registry=mod(pkg, "obs.metrics").Registry())
        feed(pkg, cs, "t0", 0.1)
        cs.note_usage("gold", "GetSet", 1.0)
        return cs.enabled, cs.profile()["routes"], cs.tenant_usage()

    assert twin(scenario) == (False, {}, {})


def test_rest_edge_attributes_usage_per_tenant_and_launch_attaches():
    """A port stack with tenancy: the edge feeds every served request of a
    tenant to the process-wide profiler (not the canary's); `launch`
    attaches it to the tracer, `stop` detaches and resets it."""
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.obs.chronoscope import chronoscope
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig

    cfg = DDSConfig.from_dict({"proxy": {"device": "cpu", "crypto-backend": "cpu"},
                               "tenancy": {"enabled": True}})

    async def go():
        dep = await launch(cfg)
        port = dep.server.cfg.port
        try:
            attached = chronoscope.stats()["attached"]
            _, key = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                        json.dumps({"contents": ["5"]}).encode(),
                                        headers={"x-dds-tenant": "alice"})
            for _ in range(3):
                await http_request("127.0.0.1", port, "GET", f"/GetSet/{key.decode()}",
                                   headers={"x-dds-tenant": "alice"})
            await http_request("127.0.0.1", port, "GET", "/SumAll?position=0",
                               headers={"x-dds-tenant": "bob"})
            await http_request("127.0.0.1", port, "GET", "/SumAll?position=0",
                               headers={"x-dds-tenant": "__heliograph__"})
            usage = chronoscope.tenant_usage()
            routes = chronoscope.profile()["routes"]
        finally:
            await dep.stop()
        return attached, usage, routes, chronoscope.stats()

    attached, usage, routes, after = asyncio.run(asyncio.wait_for(go(), 60))
    assert attached
    assert set(usage) == {"alice", "bob"}
    assert usage["alice"]["requests"] == 4 and usage["bob"]["requests"] == 1
    assert usage["alice"]["top_routes"]["GetSet"] == 3 and usage["alice"]["seconds"] > 0
    assert "http.GET.GetSet" in routes
    assert not after["attached"] and after["traces_profiled"] == 0
