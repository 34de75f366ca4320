"""The SLO engine in the port against the reference's, exactly.

The same observations on the same fake clock go through
`dds_tpu.obs.slo.SloEngine` and `dds_tpu_torch.obs.slo.SloEngine`: equal
`report()`, `alerts()`, `burns()`, tenant attribution (with the overflow
fold) and `dds_slo_*` gauges (each package's own registry, equal text),
the per-route overrides of `configs/default.toml` through `from_obs`, the
reporting taxonomy, and the burn alert driving each package's Bulwark
ratchet alike. Then `GET /slo` on the port's stack: the same requests give
the reference stack's per-route counts and objectives, the audit and
admission sections ride along, the `dds_slo_*` gauges reach /metrics, and
`slo-route = false` answers 404.
"""

import asyncio
import importlib
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
BOUND = 60.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def twin(scenario):
    ref = scenario("dds_tpu")
    port = scenario("dds_tpu_torch")
    assert port == ref
    return port


def engine(pkg: str, clk, **kw):
    S = mod(pkg, "obs.slo")
    kw.setdefault("default", S.RouteSlo(objective=0.9, latency_ms=100.0))
    kw.setdefault("windows", (60.0, 600.0))
    return S, S.SloEngine(clock=lambda: clk[0], **kw)


def test_burn_math_windows_and_alerts_twin():
    def scenario(pkg):
        clk = [0.0]
        _, eng = engine(pkg, clk, burn_alert=2.0)
        for _ in range(8):
            eng.observe("GetSet", 200, 0.010)
        eng.observe("GetSet", 200, 0.500)
        eng.observe("GetSet", 503, 0.010)
        eng.observe("GetSet", 404, 0.010)
        out = [eng.report(), eng.alerts(), eng.burns()]
        for _ in range(10):
            eng.observe("GetSet", 503, 0.010)
        out += [eng.report(), eng.alerts(), eng.burns()]
        clk[0] = 120.0
        out += [eng.report(), eng.alerts(), eng.burns()]
        return out

    out = twin(scenario)
    w = out[0]["routes"]["GetSet"]["windows"]["60s"]
    assert (w["total"], w["bad"], w["bad_latency"], w["bad_error"]) == (11, 2, 1, 1)
    assert w["burn_rate"] == pytest.approx((2 / 11) / 0.1, abs=1e-3)
    assert out[1] == [] and out[4] == ["GetSet"]
    assert out[3]["routes"]["GetSet"]["alert"] is True
    assert out[6]["routes"]["GetSet"]["windows"]["60s"]["total"] == 0
    assert out[6]["routes"]["GetSet"]["windows"]["600s"]["total"] == 21
    assert out[7] == [] and out[8]["GetSet"][0] == 0.0


def test_per_route_overrides_and_gauges_twin():
    def scenario(pkg):
        clk = [0.0]
        S, eng = engine(pkg, clk, default=None,
                        routes={"SumAll": mod(pkg, "obs.slo").RouteSlo(0.95, 1000.0)})
        eng.observe("SumAll", 200, 0.5)
        eng.observe("GetSet", 200, 0.5)
        eng.observe("GetSet", 500, 0.001)
        reg = mod(pkg, "obs.metrics").Registry()
        eng.export_gauges(reg)
        return eng.report(), reg.render()

    report, text = twin(scenario)
    assert report["routes"]["SumAll"]["objective"] == 0.95
    assert report["routes"]["SumAll"]["windows"]["60s"]["bad"] == 0
    assert report["routes"]["GetSet"]["windows"]["60s"]["bad"] == 2
    assert 'dds_slo_objective{route="SumAll"} 0.95' in text
    assert "# TYPE dds_slo_burn_rate gauge" in text and "# HELP dds_slo_burn_rate" in text


def test_tenant_attribution_and_overflow_twin():
    def scenario(pkg):
        clk = [0.0]
        _, eng = engine(pkg, clk, max_tenants=2)
        for i, t in enumerate(["a", "b", "c", "d", "a", None]):
            eng.observe("PutSet", 503 if i % 2 else 200, 0.01, tenant=t)
        reg = mod(pkg, "obs.metrics").Registry()
        eng.export_gauges(reg)
        return eng.tenant_burns(), eng.tenant_report(), eng.report()["tenants"], reg.render()

    burns, report, section, text = twin(scenario)
    assert sorted(burns) == ["a", "b", "overflow"]
    assert report["overflow"]["60s"]["total"] == 2
    assert section == report and 'dds_slo_tenant_burn_rate{tenant="overflow"}' in text


def test_slo_class_taxonomy_twin():
    routes = ["SumAll", "MultAll", "Sum", "Mult", "MatVec", "WeightedSum", "GroupBySum",
              "SearchEq", "OrderLS", "Range", "SearchEntryAND", "GetSet", "PutSet",
              "IsElement", "health", "slo", "metrics", "nope", ""]
    out = twin(lambda pkg: [mod(pkg, "obs.slo").slo_class(r) for r in routes])
    assert out[:4] == ["aggregate"] * 4 and out[-1] == "other"


def test_from_obs_of_default_toml_twin():
    def scenario(pkg):
        cfg = mod(pkg, "utils.config").DDSConfig.load(ROOT / "configs" / "default.toml")
        eng = mod(pkg, "obs.slo").SloEngine.from_obs(cfg.obs)

        def slo(r):
            return r.objective, r.latency_ms

        return (slo(eng.default), {k: slo(v) for k, v in eng.routes.items()}, eng.windows,
                eng.burn_alert, eng.bin_s)

    default, routes, windows, alert, bin_s = twin(scenario)
    assert default == (0.99, 250.0) and routes["SumAll"] == (0.95, 1000.0)
    assert routes["SearchEq"] == (0.97, 500.0) and windows == (300.0, 3600.0)
    assert alert == 14.4 and bin_s == 5.0


def test_burn_alert_drives_the_shed_ratchet_twin():
    """SumAll answering 503s at its objective's edge: the alert fires in
    both windows and the Bulwark controller fed by `alerts` sheds
    aggregates, then steps back down once the windows forget."""
    def scenario(pkg):
        clk = [0.0]
        S, eng = engine(pkg, clk, default=mod(pkg, "obs.slo").RouteSlo(0.99, 250.0),
                        windows=(10.0, 20.0),
                        routes={"SumAll": mod(pkg, "obs.slo").RouteSlo(0.95, 1000.0)})
        A = mod(pkg, "core.admission")
        ctl = A.AdmissionController(rates={}, eval_interval=1.0, shed_hold=3,
                                    max_shed_level=2, alerts=eng.alerts,
                                    clock=lambda: clk[0])
        levels = []
        for sec in range(40):
            clk[0] = float(sec)
            if sec < 8:
                for _ in range(4):
                    eng.observe("SumAll", 503, 0.01)
                eng.observe("GetSet", 200, 0.01)
            levels.append(ctl.evaluate())
        return levels, [(t["to"], t["reason"]) for t in ctl.transitions]

    levels, transitions = twin(scenario)
    assert max(levels) >= 1 and levels[-1] == 0
    assert transitions[0] == (1, "slo_burn")


# ------------------------------------------------------------ GET /slo


def _cfg(pkg: str, **obs):
    d = {"proxy": {"crypto-backend": "cpu", "intranet-request-timeout": 2.0},
         "recovery": {"enabled": False}, "obs": obs}
    if pkg == "dds_tpu_torch":
        d["proxy"]["device"] = "cpu"
    return mod(pkg, "utils.config").DDSConfig.from_dict(d)


def test_slo_route_serves_the_reference_counts_twin():
    """The same PutSets, GetSets (one a miss) and SumAll on each package's
    default deployment: equal per-route totals, objectives and classes;
    the audit summary and the admission report ride along."""
    def scenario(pkg):
        run = mod(pkg, "run")
        http = mod(pkg, "http.miniserver")
        cfg = _cfg(pkg)
        cfg.admission.enabled = True

        async def go():
            dep = await run.launch(cfg)
            try:
                port = dep.server.cfg.port
                keys = []
                for v in ("11", "13", "17"):
                    s, b = await http.http_request("127.0.0.1", port, "POST", "/PutSet",
                                                   json.dumps({"contents": [v]}).encode())
                    keys.append(b.decode())
                for k in keys + ["missing"]:
                    await http.http_request("127.0.0.1", port, "GET", f"/GetSet/{k}")
                await http.http_request("127.0.0.1", port, "GET",
                                        "/SumAll?position=0&nsqr=1000003")
                status, body = await http.http_request("127.0.0.1", port, "GET", "/slo")
                await dep.net.quiesce()
                return status, json.loads(body)
            finally:
                await dep.stop()

        status, out = asyncio.run(asyncio.wait_for(go(), BOUND))
        routes = {r: (v["objective"], v["latency_ms"], v["class"],
                      {w: x["total"] for w, x in v["windows"].items()})
                  for r, v in out["slo"]["routes"].items()}
        return (status, out["slo"]["windows_s"], routes, sorted(out),
                sorted(out["audit"]), out["admission"]["shed_level"])

    status, windows, routes, sections, audit, level = twin(scenario)
    assert status == 200 and sections == ["admission", "audit", "slo"]
    assert routes["PutSet"] == (0.99, 250.0, "point", {"300s": 3, "3600s": 3})
    assert routes["GetSet"][3] == {"300s": 4, "3600s": 4}
    assert routes["SumAll"][2] == "aggregate" and "violations" in audit and level == 0


def test_slo_gauges_reach_metrics_and_the_route_can_be_turned_off():
    run = mod("dds_tpu_torch", "run")
    from dds_tpu_torch.http.miniserver import http_request

    async def go(slo_route: bool):
        dep = await run.launch(_cfg("dds_tpu_torch", **{"slo-route": slo_route}))
        try:
            port = dep.server.cfg.port
            await http_request("127.0.0.1", port, "POST", "/PutSet",
                               json.dumps({"contents": ["5"]}).encode())
            slo, _ = await http_request("127.0.0.1", port, "GET", "/slo")
            _, body = await http_request("127.0.0.1", port, "GET", "/metrics")
            return slo, body.decode()
        finally:
            await dep.stop()

    slo, text = asyncio.run(asyncio.wait_for(go(True), BOUND))
    assert slo == 200
    for family in ('dds_slo_burn_rate{route="PutSet",window="300s"}',
                   'dds_slo_objective{route="PutSet"} 0.99',
                   'dds_slo_error_budget_remaining{route="PutSet"}',
                   "dds_audit_traces_audited", "dds_audit_pending_traces"):
        assert family in text, family
    slo, _ = asyncio.run(asyncio.wait_for(go(False), BOUND))
    assert slo == 404
