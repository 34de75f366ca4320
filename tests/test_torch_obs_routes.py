"""The observability routes of `configs/default.toml` in the port against
the reference's, exactly.

Both packages launch `configs/default.toml` with `[proxy] port = 0` (the
port also with `device` and `crypto-backend` on the CPU) and answer
`GET /profile`, `/profile?fmt=folded`, `/canary`, `POST /_sync` with an
empty keyset, `/_trace` with `debug` off and on, `/health` and `/metrics`
with the same statuses and the same keys; `/canary` and `/health`'s
`canary` section are equal bodies. Fed the same span records, each
package's process-wide Chronoscope serves the same `/profile`, the same
folded text and the same `dds_pipe_*` series through the route. A
`POST /_sync` joins its keys to the aggregate key set in both, and the
tracer's named counters reach `/_trace` alike.
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


def twin(scenario, *args):
    """`scenario(pkg, *args)` on both packages, each under its own event
    loop and time bound; equal observations."""
    ref = asyncio.run(asyncio.wait_for(scenario("dds_tpu", *args), BOUND))
    port = asyncio.run(asyncio.wait_for(scenario("dds_tpu_torch", *args), BOUND))
    assert port == ref
    return port


def default_toml(pkg: str, debug: bool = False):
    cfg = mod(pkg, "utils.config").DDSConfig.load(ROOT / "configs" / "default.toml")
    cfg.proxy.port = 0
    cfg.debug = debug
    if pkg == "dds_tpu_torch":
        cfg.proxy.device = "cpu"
        cfg.proxy.crypto_backend = "cpu"
    return cfg


async def request(pkg: str, port: int, method: str, target: str, obj=None):
    http = mod(pkg, "http.miniserver")
    body = json.dumps(obj).encode() if obj is not None else None
    return await http.http_request("127.0.0.1", port, method, target, body, timeout=10.0)


def shape(data: bytes):
    """The keys of a JSON object body, or the body's kind."""
    try:
        obj = json.loads(data)
    except ValueError:
        return "text" if data else "empty"
    return sorted(obj) if isinstance(obj, dict) else type(obj).__name__


ROUTES = (("GET", "/profile", None), ("GET", "/profile?fmt=folded", None),
          ("GET", "/canary", None), ("POST", "/_sync", {"keyset": []}),
          ("GET", "/_trace", None), ("GET", "/health", None), ("GET", "/metrics", None))


@pytest.mark.parametrize("debug", [False, True], ids=["debug-off", "debug-on"])
def test_default_toml_serves_the_reference_obs_routes(debug, monkeypatch):
    """Each route's status and keys; `/_trace` answers 404 with `debug`
    off and 200 with the reference's three keys with it on."""
    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)

    async def scenario(pkg):
        dep = await mod(pkg, "run").launch(default_toml(pkg, debug))
        try:
            port = dep.server.cfg.port
            out = {}
            for method, target, obj in ROUTES:
                status, data = await request(pkg, port, method, target, obj)
                out[f"{method} {target}"] = (status, shape(data))
                if target in ("/canary", "/health"):
                    body = json.loads(data)
                    out[f"{target} canary"] = body if target == "/canary" else body["canary"]
            return out
        finally:
            await dep.stop()

    out = twin(scenario)
    assert out["GET /canary"][0] == 200 and out["/canary canary"] == {"enabled": False}
    assert out["/health canary"] == {"status": "disabled"}
    assert out["POST /_sync"] == (204, "empty")
    assert out["GET /profile"][0] == 200 and "routes" in out["GET /profile"][1]
    assert out["GET /profile?fmt=folded"][0] == 200
    assert out["GET /_trace"] == ((200, ["counters", "spans", "stored_keys"]) if debug
                                  else (404, "empty"))


def test_trace_route_flag_reaches_the_proxy_as_in_the_reference(monkeypatch):
    """`trace_route_enabled = debug or [obs] trace-route`, and
    `profile_route_enabled` on by default, in both packages."""
    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)

    async def scenario(pkg):
        flags = []
        for debug, route in ((False, False), (True, False), (False, True)):
            cfg = default_toml(pkg, debug)
            cfg.obs.trace_route = route
            dep = await mod(pkg, "run").launch(cfg)
            try:
                flags.append((dep.server.cfg.trace_route_enabled,
                              dep.server.cfg.profile_route_enabled))
            finally:
                await dep.stop()
        return flags

    assert twin(scenario) == [(False, True), (True, True), (True, True)]


def spans(pkg: str) -> list:
    """Two SumAll traces and a PutSet trace as each package's SpanRecords."""
    SR = mod(pkg, "utils.trace").SpanRecord
    spec = []
    for t, wall in (("a", 0.120), ("b", 0.040)):
        spec += [("abd.read_tags", 0.002, 0.012, f"{t}2", f"{t}1", t, {}),
                 ("proxy.fetch_stored", 0.001, 0.020, f"{t}1", f"{t}0", t, {}),
                 ("proxy.fold", 0.020, wall - 0.005, f"{t}3", f"{t}0", t, {"k": 8}),
                 ("http.GET.SumAll", 0.0, wall, f"{t}0", None, t, {})]
    spec += [("replica.handle", 0.003, 0.009, "p2", "p1", "p", {"replica": "replica-0"}),
             ("abd.write", 0.001, 0.011, "p1", "p0", "p", {}),
             ("http.POST.PutSet", 0.0, 0.015, "p0", None, "p", {})]
    return [SR(ts=end, name=name, dur_ms=(end - start) * 1e3, meta=dict(meta),
               trace_id=tid, span_id=sid, parent_id=pid, kind="span")
            for name, start, end, sid, pid, tid, meta in spec]


def test_the_same_span_feed_serves_the_same_profile(monkeypatch):
    """After launch, each package's Chronoscope is detached from the live
    tracer, reset and fed the same records: `/profile`, the folded text
    and the `dds_pipe_*` series of `/metrics` are equal."""
    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    monkeypatch.delenv("DDS_OBS_PIPE", raising=False)

    async def scenario(pkg):
        chronoscope = mod(pkg, "obs.chronoscope").chronoscope
        dep = await mod(pkg, "run").launch(default_toml(pkg))
        try:
            port = dep.server.cfg.port
            chronoscope.detach()
            chronoscope.reset()
            # gauges the live feed exported before the detach go too
            mod(pkg, "obs.metrics").metrics.reset()
            chronoscope.ingest_tree(spans(pkg))
            _, prof = await request(pkg, port, "GET", "/profile")
            _, folded = await request(pkg, port, "GET", "/profile?fmt=folded")
            _, text = await request(pkg, port, "GET", "/metrics")
            pipe = sorted(ln for ln in text.decode().splitlines()
                          if ln.startswith("dds_pipe_"))
            return json.loads(prof), folded.decode(), pipe
        finally:
            await dep.stop()

    prof, folded, pipe = twin(scenario)
    assert prof["routes"]["http.GET.SumAll"]["count"] == 2
    assert prof["routes"]["http.POST.PutSet"]["count"] == 1
    assert "http.GET.SumAll;" in folded and pipe


def test_sync_push_joins_the_key_set_and_counters_reach_trace(monkeypatch):
    """`POST /_sync` adds its keys to the aggregate key set (a repeated key
    once, a malformed body 400) and `/_trace` serves the tracer's counters
    and the store size, equal in both packages."""
    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)

    async def scenario(pkg):
        tracer = mod(pkg, "utils.trace").tracer
        dep = await mod(pkg, "run").launch(default_toml(pkg, debug=True))
        try:
            port = dep.server.cfg.port
            statuses = []
            for obj in ({"keyset": ["k1", "k2"]}, {"keyset": ["k2", "k3"]}, {"keys": []}):
                statuses.append((await request(pkg, port, "POST", "/_sync", obj))[0])
            tracer.count("abd.suspect")
            tracer.count("abd.suspect", 2)
            _, data = await request(pkg, port, "GET", "/_trace")
            body = json.loads(data)
            return (statuses, sorted(dep.server.stored_keys), body["stored_keys"],
                    body["counters"].get("abd.suspect"))
        finally:
            await dep.stop()

    assert twin(scenario) == ([204, 204, 400], ["k1", "k2", "k3"], 3, 3)
