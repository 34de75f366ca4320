"""Bulwark admission control in the port against the reference's, exactly.

Every unit case of the reference's `tests/test_admission.py` (token-bucket
math, priority classes, the shed ratchet and its hysteresis, the breaker
census, tenant buckets, metered and flight-recorded transitions, the
storage layer's fast-fail, the adaptive coalescing window) runs on
`dds_tpu.core.admission` and `dds_tpu_torch.core.admission` alike, one
fake clock each started at the same instant, and both must give the same
decisions, levels and Retry-After values; the reference's expected values
are asserted on top. Then the REST edge on a 4-replica in-memory stack of
each package (`crypto-backend = "cpu"`): 429 with the refill ETA, budgets
separated by the tenant header, a 400 for a malformed header, the exempt
routes during a full shed, Retry-After from a breaker ETA, the adaptive
window wired in, the fast-fail 503, the canary tenant's own bucket, and
the controller `launch` builds from `configs/default.toml`.
"""

import asyncio
import contextlib
import importlib
import json
import pathlib
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKGS = ("dds_tpu", "dds_tpu_torch")
BOUND = 60.0  # seconds: every async case's asyncio.wait_for


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def bounded(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND))


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def twin(scenario):
    """Run `scenario(admission_module)` on both packages; the port's
    observations must equal the reference's."""
    ref = scenario(mod("dds_tpu", "core.admission"))
    port = scenario(mod("dds_tpu_torch", "core.admission"))
    assert port == ref
    return port


# ------------------------------------------------------ token-bucket math


def test_token_bucket_burst_refill_and_eta_twin():
    def scenario(A):
        clk = FakeClock()
        b = A.TokenBucket(rate=2.0, burst=4.0, clock=clk)
        out = [[b.try_acquire() for _ in range(5)], b.refill_eta()]
        clk.advance(0.5)
        out += [b.try_acquire(), b.try_acquire()]
        clk.advance(3600.0)
        out.append(b.tokens)
        for _ in range(4):
            b.try_acquire()
        out.append(b.refill_eta(3.0))
        return out

    out = twin(scenario)
    assert out[0] == [True] * 4 + [False]
    assert out[1] == pytest.approx(0.5)
    assert out[2:4] == [True, False]
    assert out[4] == pytest.approx(4.0)
    assert out[5] == pytest.approx(1.5)


def test_token_bucket_zero_rate_never_refills_twin():
    def scenario(A):
        clk = FakeClock()
        b = A.TokenBucket(rate=0.0, burst=1.0, clock=clk)
        first = b.try_acquire()
        clk.advance(1e6)
        return first, b.try_acquire(), b.refill_eta()

    assert twin(scenario) == (True, False, float("inf"))


ROUTES = ("GetSet", "PutSet", "RemoveSet", "AddElement", "ReadElement", "WriteElement",
          "IsElement", "Sum", "Mult", "SumAll", "MultAll", "OrderLS", "OrderSL", "Range",
          "SearchEq", "SearchNEq", "SearchGt", "SearchGtEq", "SearchLt", "SearchLtEq",
          "SearchEntry", "SearchEntryOR", "SearchEntryAND", "MatVec", "WeightedSum",
          "GroupBySum", "_sync", "NoSuchRoute", "health", "slo", "")


def test_route_priority_classes_and_overrides_twin():
    overrides = {"SearchEq": "background", "SumAll": "bogus", "GetSet": "aggregate"}

    def scenario(A):
        return (A.CLASSES, [A.route_class(r) for r in ROUTES],
                [A.route_class(r, overrides) for r in ROUTES])

    classes, plain, over = twin(scenario)
    named = dict(zip(ROUTES, (classes[i] for i in plain)))
    assert named["GetSet"] == named["PutSet"] == "interactive"
    assert named["SumAll"] == named["MatVec"] == "aggregate"
    assert named["_sync"] == named["NoSuchRoute"] == "background"
    named = dict(zip(ROUTES, (classes[i] for i in over)))
    assert named["SearchEq"] == "background"
    assert named["SumAll"] == "aggregate"  # a junk override is ignored
    assert named["GetSet"] == "aggregate"


# ------------------------------------------------- shed ratchet/hysteresis


def _controller(A, clk, **kw):
    state = {"alerts": set(), "breakers": (0, [])}
    kw.setdefault("rates", {})  # unthrottled: these cases isolate shedding
    c = A.AdmissionController(
        eval_interval=1.0, shed_hold=3, max_shed_level=kw.pop("max_shed_level", 3),
        alerts=lambda: state["alerts"], breakers=lambda: state["breakers"],
        clock=clk, **kw,
    )
    return c, state


def verdict(d) -> tuple:
    return (d.admitted, d.status, d.retry_after, d.reason, d.klass)


def test_shed_ratchet_sheds_lowest_class_first_twin():
    def scenario(A):
        clk = FakeClock()
        c, state = _controller(A, clk)
        out = [verdict(c.decide("_sync"))]
        state["alerts"] = {"GetSet"}
        for _ in range(4):
            clk.advance(1.0)
            out.append(c.evaluate())
        for level in (1, 2, 3):
            c2, _ = _controller(A, FakeClock())
            c2.shed_level = level
            out.append([verdict(c2.decide(r)) for r in ("GetSet", "SumAll", "_sync")])
        return out

    out = twin(scenario)
    assert out[0][0] and out[1:5] == [1, 2, 3, 3]
    admitted = [[v[0] for v in level] for level in out[5:]]
    assert admitted == [[True, True, False], [True, False, False], [False, False, False]]
    assert all(v[1] == 503 for level in out[5:] for v in level if not v[0])


def test_unshed_hysteresis_steps_down_one_level_per_hold_twin():
    def scenario(A):
        clk = FakeClock()
        c, state = _controller(A, clk)
        levels = []

        def step(alerts, n=1):
            state["alerts"] = alerts
            for _ in range(n):
                clk.advance(1.0)
                levels.append(c.evaluate())

        step({"SumAll"}, 2)
        step(set(), 2)
        step({"GetSet"})
        step(set(), 9)
        return levels, [(t["from"], t["to"], t["direction"], t["reason"])
                        for t in c.transitions]

    levels, transitions = twin(scenario)
    assert levels == [1, 2, 2, 2, 3, 3, 3, 2, 2, 2, 1, 1, 1, 0]
    assert transitions[-1] == (1, 0, "unshed", "recovered")


def test_shed_class_burn_does_not_latch_the_ratchet_twin():
    def scenario(A):
        clk = FakeClock()
        c, state = _controller(A, clk)
        state["alerts"] = {"_sync"}
        levels = []
        for _ in range(4):
            clk.advance(1.0)
            levels.append(c.evaluate())
        return levels

    assert twin(scenario) == [1, 1, 1, 0]


def test_breaker_census_triggers_shed_and_retry_after_twin():
    def scenario(A):
        clk = FakeClock()
        c, state = _controller(A, clk)
        state["breakers"] = (4, [3.2, 5.0])
        clk.advance(1.0)
        out = [c.evaluate(), verdict(c.decide("_sync"))]
        state["breakers"] = (4, [])
        state["alerts"] = {"GetSet"}
        out.append(verdict(c.decide("_sync")))
        return out

    level, shed, cadence = twin(scenario)
    assert level == 1 and shed[:2] == (False, 503)
    assert shed[2] == pytest.approx(3.2)
    assert cadence[2] == pytest.approx(3.0)  # eval_interval x shed_hold


def test_tenant_token_buckets_isolate_the_hot_tenant_twin():
    def scenario(A):
        clk = FakeClock()
        c = A.AdmissionController(rates={"interactive": (1.0, 2.0)}, clock=clk,
                                  eval_interval=1e9)
        out = [verdict(c.decide("GetSet", tenant="hot")) for _ in range(3)]
        out.append(verdict(c.decide("GetSet", tenant="cold")))
        clk.advance(1.0)
        out.append(verdict(c.decide("GetSet", tenant="hot")))
        return out

    out = twin(scenario)
    assert [v[0] for v in out] == [True, True, False, True, True]
    assert out[2][1] == 429 and out[2][2] == pytest.approx(1.0)


def test_transitions_are_metered_and_flight_recorded_twin(tmp_path):
    def scenario(A):
        pkg = A.__name__.split(".")[0]
        flight = mod(pkg, "obs.flight").flight
        metrics = mod(pkg, "obs.metrics").metrics
        d = tmp_path / pkg
        before = {k: metrics.value("dds_admission_transitions_total", direction=k,
                                   reason=r) or 0
                  for k, r in (("shed", "slo_burn"), ("unshed", "recovered"))}
        clk = FakeClock()
        flight.configure(dir=str(d), min_interval=0.0)
        try:
            c, state = _controller(A, clk)
            state["alerts"] = {"GetSet"}
            clk.advance(1.0)
            c.evaluate()
            state["alerts"] = set()
            for _ in range(3):
                clk.advance(1.0)
                c.evaluate()
        finally:
            flight.configure(dir="")
        kinds = [json.loads(ln)["kind"] for ln in (d / "index.jsonl").read_text().splitlines()]
        after = {k: metrics.value("dds_admission_transitions_total", direction=k,
                                  reason=r) or 0
                 for k, r in (("shed", "slo_burn"), ("unshed", "recovered"))}
        return (c.shed_level, [t["direction"] for t in c.transitions], kinds,
                {k: after[k] - before[k] for k in after})

    assert twin(scenario) == (0, ["shed", "unshed"], ["admission_shed", "admission_unshed"],
                              {"shed": 1, "unshed": 1})


def test_subscribe_delivers_the_current_shed_and_each_transition_twin():
    def scenario(A):
        clk = FakeClock()
        c, state = _controller(A, clk)
        state["alerts"] = {"GetSet"}
        clk.advance(1.0)
        c.evaluate()
        seen = []
        c.subscribe(lambda rec: seen.append((rec["from"], rec["to"], rec["reason"])))
        clk.advance(1.0)
        c.evaluate()
        return seen, c.report()

    seen, report = twin(scenario)
    assert seen == [(1, 1, "subscribed mid-shed"), (1, 2, "slo_burn")]
    assert report["shedding"] == ["aggregate", "background"]


# ------------------------------------------------- storage-layer fast-fail


def _open_all_breakers(pkg: str, abd, reset: float):
    CircuitBreaker = mod(pkg, "utils.retry").CircuitBreaker
    for n in abd.replicas.get_trusted():
        b = abd.breakers[n] = CircuitBreaker(3, reset, name=n)
        for _ in range(3):
            b.record_failure()
        assert not b.allow()


@pytest.mark.parametrize("pkg", PKGS)
def test_fast_fail_when_no_probe_fits_the_budget(pkg):
    qc = mod(pkg, "core.quorum_client")
    errors = mod(pkg, "core.errors")
    Deadline = mod(pkg, "utils.retry").Deadline
    metrics = mod(pkg, "obs.metrics").metrics

    async def go():
        net = mod(pkg, "core.transport").InMemoryNet()
        abd = qc.AbdClient("proxy-ff", net, ["r0", "r1"],
                           qc.AbdClientConfig(request_timeout=5.0, quorum_size=2))
        _open_all_breakers(pkg, abd, reset=60.0)
        dl = Deadline(0.5)
        t0 = time.perf_counter()
        with pytest.raises(errors.AllBreakersOpenError) as ei:
            await abd.fetch_set("k", deadline=dl)
        assert time.perf_counter() - t0 < 0.1
        assert ei.value.eta > dl.remaining() and ei.value.targets == 2
        with pytest.raises(errors.AllBreakersOpenError):
            await abd.read_tags(["k"], deadline=dl)
        assert (metrics.value("dds_fast_fail_total", op="fetch") or 0) >= 1

    bounded(go())


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("flag", [True, False])
def test_no_fast_fail_while_a_probe_fits_or_when_disabled(pkg, flag):
    """A half-open probe inside the budget (or fast-fail off) lets the
    degraded try proceed: it times out against unregistered endpoints."""
    qc = mod(pkg, "core.quorum_client")
    Deadline = mod(pkg, "utils.retry").Deadline

    async def go():
        net = mod(pkg, "core.transport").InMemoryNet()
        abd = qc.AbdClient("proxy-ff2", net, ["r0", "r1"],
                           qc.AbdClientConfig(request_timeout=0.05,
                                              fast_fail_all_open=flag))
        _open_all_breakers(pkg, abd, reset=0.2 if flag else 60.0)
        with pytest.raises(asyncio.TimeoutError):
            await abd.fetch_set("k", deadline=Deadline(1.0 if flag else 0.5))

    bounded(go())


# ------------------------------------------------------ adaptive coalescing


def test_adaptive_coalescer_fills_under_load_and_snaps_when_idle_twin():
    def scenario(A):
        clk = FakeClock()
        c = A.AdaptiveCoalescer(base_window=0.002, max_window=0.02, target_folds=8.0,
                                clock=clk)
        out = [c.window()]
        for _ in range(5000):
            clk.advance(0.001)
            c.note_fold()
        out += [c.rate(), c.window(), c.stats()]
        c2 = A.AdaptiveCoalescer(0.002, 0.02, target_folds=8.0, clock=clk)
        for _ in range(200):
            clk.advance(0.01)
            c2.note_fold()
        out.append(c2.window())
        clk.advance(30.0)
        out += [c.window(), c2.window()]
        return out

    idle, rate, loaded, stats, clamped, snap1, snap2 = twin(scenario)
    assert idle == pytest.approx(0.002)
    assert rate == pytest.approx(1000.0, rel=0.05)
    assert loaded == pytest.approx(0.008, rel=0.05)
    assert stats["folds"] == 5000
    assert clamped == pytest.approx(0.02)
    assert snap1 == snap2 == pytest.approx(0.002)


def test_from_config_of_default_toml_equals_the_reference():
    """The controller and window `launch` builds from default.toml's
    [admission]: equal rates, knobs, report and decisions."""
    def scenario(pkg):
        A = mod(pkg, "core.admission")
        cfg = mod(pkg, "utils.config").DDSConfig.load(ROOT / "configs" / "default.toml")
        clk = FakeClock()
        c = A.AdmissionController.from_config(cfg.admission, clock=clk)
        out = [c.rates, c.eval_interval, c.shed_hold, c.max_shed_level,
               c.breaker_shed_fraction, c.tenant_header, c.report()]
        out.append([verdict(c.decide("SumAll")) for _ in range(130)][-3:])
        return out

    ref, port = scenario("dds_tpu"), scenario("dds_tpu_torch")
    assert port == ref
    assert port[0]["aggregate"] == (64.0, 128.0)
    assert [v[1] for v in port[-1]] == [200, 429, 429]


# ------------------------------------------------------------ REST surface


@contextlib.asynccontextmanager
async def admission_stack(pkg: str, acfg=None, n=4, quorum=3, crypto_backend="cpu",
                          **proxy_kw):
    rep = mod(pkg, "core.replica")
    qc = mod(pkg, "core.quorum_client")
    srv = mod(pkg, "http.server")
    net = mod(pkg, "core.transport").InMemoryNet()
    rcfg = rep.ReplicaConfig(quorum_size=quorum)
    addrs = [f"replica-{i}" for i in range(n)]
    replicas = {a: rep.BFTABDNode(a, addrs, "supervisor", net, rcfg) for a in addrs}
    abd = qc.AbdClient("proxy-0", net, addrs,
                       qc.AbdClientConfig(request_timeout=2.0, quorum_size=quorum))
    server = srv.DDSRestServer(abd, srv.ProxyConfig(
        host="127.0.0.1", port=0, crypto_backend=crypto_backend, admission=acfg,
        **proxy_kw))
    await server.start()
    try:
        yield server, replicas
    finally:
        await server.stop()
        await net.quiesce()


def admission_cfg(pkg: str, **kw):
    return mod(pkg, "utils.config").AdmissionConfig(enabled=True, eval_interval=1e9, **kw)


def rest_twin(scenario):
    """`scenario(pkg)` on both packages' stacks; equal results."""
    ref = bounded(scenario("dds_tpu"))
    port = bounded(scenario("dds_tpu_torch"))
    assert port == ref
    return port


def test_throttle_answers_429_with_refill_retry_after_twin():
    async def scenario(pkg):
        http = mod(pkg, "http.miniserver")
        metrics = mod(pkg, "obs.metrics").metrics
        before = metrics.value("dds_admission_requests_total", outcome="throttled",
                               **{"class": "aggregate"}) or 0
        acfg = admission_cfg(pkg, aggregate_rate=0.5, aggregate_burst=1.0)
        async with admission_stack(pkg, acfg) as (server, _):
            port = server.cfg.port
            put, _ = await http.http_request(
                "127.0.0.1", port, "POST", "/PutSet",
                json.dumps({"contents": ["12345"]}).encode())
            first, _ = await http.http_request("127.0.0.1", port, "GET",
                                               "/SumAll?position=0&nsqr=77")
            t0 = time.perf_counter()
            status, headers, body = await http.http_request_full(
                "127.0.0.1", port, "GET", "/SumAll?position=0&nsqr=77")
            fast = time.perf_counter() - t0 < 0.2
        after = metrics.value("dds_admission_requests_total", outcome="throttled",
                              **{"class": "aggregate"}) or 0
        return put, first, status, headers["retry-after"], body, fast, after - before

    assert rest_twin(scenario) == (200, 200, 429, "2",
                                   b"admission rejected (tenant 'default' over aggregate rate)",
                                   True, 1)


def test_tenant_header_separates_budgets_and_rejects_malformed_ids_twin():
    async def scenario(pkg):
        http = mod(pkg, "http.miniserver")
        acfg = admission_cfg(pkg, interactive_rate=0.1, interactive_burst=1.0)
        async with admission_stack(pkg, acfg) as (server, _):
            async def get(tenant):
                status, _, body = await http.http_request_full(
                    "127.0.0.1", server.cfg.port, "GET", "/GetSet/deadbeef",
                    headers={"x-dds-tenant": tenant})
                return status, body

            return [await get("alice"), await get("alice"), await get("bob"),
                    await get("bad tenant"), await get("_hidden"), await get("x" * 65),
                    await get("")]

    out = rest_twin(scenario)
    assert [s for s, _ in out] == [404, 429, 404, 400, 400, 400, 404]
    assert json.loads(out[3][1]) == {"error": "invalid tenant header",
                                     "reason": "must match [A-Za-z0-9][A-Za-z0-9._-]*"}


def test_observability_routes_answer_during_a_full_shed_twin():
    async def scenario(pkg):
        http = mod(pkg, "http.miniserver")
        async with admission_stack(pkg, admission_cfg(pkg, max_shed_level=3)) as (server, _):
            server.admission.shed_level = 3
            port = server.cfg.port
            shed, headers, body = await http.http_request_full(
                "127.0.0.1", port, "GET", "/GetSet/abc")
            hs, hbody = await http.http_request("127.0.0.1", port, "GET", "/health")
            ms, mbody = await http.http_request("127.0.0.1", port, "GET", "/metrics")
            ss, sbody = await http.http_request("127.0.0.1", port, "GET", "/slo")
            report = json.loads(sbody)["admission"]
            return (shed, int(headers["retry-after"]) >= 1, body, hs,
                    json.loads(hbody)["status"], ms,
                    "dds_admission_shed_level 3" in mbody.decode(), ss,
                    report["shed_level"], report["shedding"])

    out = rest_twin(scenario)
    assert out == (503, True, b"admission rejected (shedding interactive (level 3))", 200,
                   "ok", 200, True, 200, 3, ["interactive", "aggregate", "background"])


def test_degraded_retry_after_derived_from_breaker_eta_twin():
    async def scenario(pkg):
        async with admission_stack(pkg, None) as (server, _):
            out = [server.admission is None]
            server.abd.breaker_census = lambda: (4, [3.2, 9.0])
            out.append(server._unavailable("quorum down").headers["Retry-After"])
            out.append(server._unavailable("quorum down", eta=1.4).headers["Retry-After"])
            server.abd.breaker_census = lambda: (4, [])
            resp = server._unavailable("quorum down")
            out += [resp.headers["Retry-After"], resp.status, resp.body]
            return out

    assert rest_twin(scenario) == [True, "4", "2", "1", 503, b"service unavailable: quorum down"]


def test_fast_fail_answers_503_at_the_edge_with_the_probe_eta_twin():
    """Every coordinator's breaker open, the probes past the budget: the
    request fails at once with a 503 whose Retry-After is the nearest
    probe's, not the config hint."""
    async def scenario(pkg):
        http = mod(pkg, "http.miniserver")
        async with admission_stack(pkg, admission_cfg(pkg), request_budget=2.0) as (server, _):
            _open_all_breakers(pkg, server.abd, reset=30.0)
            t0 = time.perf_counter()
            status, headers, body = await http.http_request_full(
                "127.0.0.1", server.cfg.port, "GET", "/GetSet/abc")
            return (status, 25 <= int(headers["retry-after"]) <= 30,
                    body.startswith(b"service unavailable"), time.perf_counter() - t0 < 1.0)

    assert rest_twin(scenario) == (503, True, True, True)


def test_server_wires_adaptive_window_twin():
    async def scenario(pkg):
        out = []
        acfg = admission_cfg(pkg, adaptive_coalesce=True, coalesce_max_window=0.05)
        async with admission_stack(pkg, acfg) as (server, _):
            out += [server._coalescer is not None, server._coalesce_window(),
                    server.cfg.coalesce_window, server._coalescer.max_window]
        async with admission_stack(pkg, None) as (server, _):
            out += [server._coalescer is None, server._coalesce_window()]
        async with admission_stack(pkg, admission_cfg(pkg, adaptive_coalesce=False)) as (
                server, _):
            out.append(server._coalescer is None)
        return out

    assert rest_twin(scenario) == [True, 0.002, 0.002, 0.05, True, 0.002, True]


def test_folds_feed_the_adaptive_window():
    """On the port's cuda backend (its plain path on the CPU), every fold
    arrival is noted: concurrent small SumAlls answer exactly, and folds
    queued behind a running one drain after the adaptive window, which
    lies between the base and the cap."""
    from dds_tpu_torch.http.miniserver import http_request

    async def go():
        async with admission_stack("dds_tpu_torch", admission_cfg("dds_tpu_torch"),
                                   crypto_backend="cuda", device="cpu",
                                   min_device_batch=64) as (server, _):
            port = server.cfg.port
            nsq = 1000003 * 1000003
            for v in (3, 5, 7, 11):
                status, _ = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                               json.dumps({"contents": [str(v)]}).encode())
                assert status == 200
            got = await asyncio.gather(*(http_request(
                "127.0.0.1", port, "GET", f"/SumAll?position=0&nsqr={nsq}") for _ in range(8)))
            windows = []
            real = server._coalesce_window

            def recorded():
                windows.append(real())
                return windows[-1]

            server._coalesce_window = recorded
            # the first fold runs on a worker thread; the seven behind it see
            # it in flight and queue for the drain
            folds = await asyncio.gather(*(server._fold([2, 3, i], nsq) for i in range(8)))
            return got, folds, windows, server._coalescer.stats()

    got, folds, windows, stats = bounded(go())
    assert all(s == 200 and int(json.loads(b)["result"]) == 3 * 5 * 7 * 11 for s, b in got)
    assert folds == [6 * i for i in range(8)]
    assert stats["folds"] == 16
    assert windows and all(0.002 <= w <= 0.02 for w in windows)


def test_canary_tenant_passes_its_own_rate_bounded_bucket_twin():
    """The reserved canary id bypasses the tenant buckets (even a full
    shed) through the carve-out sized by [heliograph] rate/burst."""
    async def scenario(pkg):
        http = mod(pkg, "http.miniserver")
        hcfg = mod(pkg, "utils.config").HeliographConfig(rate=0.01, burst=2.0)
        async with admission_stack(pkg, admission_cfg(pkg, max_shed_level=3),
                                   heliograph=hcfg) as (server, _):
            server.admission.shed_level = 3
            out = []
            for _ in range(3):
                status, headers, body = await http.http_request_full(
                    "127.0.0.1", server.cfg.port, "GET", "/GetSet/abc",
                    headers={"x-dds-tenant": "__heliograph__"})
                out.append((status, headers.get("retry-after"), body))
            return out

    out = rest_twin(scenario)
    assert [s for s, _, _ in out] == [404, 404, 429]
    assert out[2][1] == "100" and out[2][2] == b"canary rate bound exceeded"
