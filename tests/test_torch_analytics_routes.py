"""Prism's REST routes on the port's proxy against the reference's.

Both stacks boot the north-star topology (4 BFT-ABD replicas, quorum 3,
f = 1, in-memory transport) as tests/test_torch_routes.py boots them; the
port folds on `CudaBackend(device="cpu", min_device_batch=0)`, so every
request runs `fold_weighted` on the plain PyTorch path, in each
DDS_KARATSUBA family; the reference on its `cpu` backend (the host loop).
The same seeded Paillier rows (512-bit bench key, so n^2 has L = 64 limbs,
where the Karatsuba shape rule holds) go into both through `POST /PutSet`,
then both take the same requests: MatVec with a zero row, a signed
MatVec (full-width n - |w| exponents), a signed WeightedSum, GroupBySum,
and the reference's 400 / 404 / 413 cases (row cap, width mismatch,
non-integer weights, a non-square or missing nsqr, a matrix sent to
WeightedSum, an oversized body, a negative or absent position, a group
naming an unknown key, no records). Every status and body must be equal,
and the port's results must decrypt to W @ x. Also: one MatVec through
the resident plane's `rows_for`, the routes switched off, the
`dds_analytics_*` series, and the `[analytics]` section. Exact equality
throughout.
"""

import asyncio
import dataclasses
import json

import numpy as np
import pytest

from dds_tpu.http.miniserver import http_request as ref_http
from dds_tpu.obs.metrics import metrics as ref_metrics
from dds_tpu.run import launch as ref_launch
from dds_tpu.utils.config import AnalyticsConfig as RefAnalyticsConfig
from dds_tpu.utils.config import DDSConfig as RefConfig
from dds_tpu_torch.bench_key import bench_paillier_key
from dds_tpu_torch.http.miniserver import http_request
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.resident.plane import ResidentPlane
from dds_tpu_torch.run import launch
from dds_tpu_torch.utils import sigs
from dds_tpu_torch.utils.config import AnalyticsConfig, DDSConfig
from dds_tpu_torch.utils.trace import tracer

N = 6
MAX_ROWS, MAX_BYTES = 4, 4096
KEY = bench_paillier_key(512)


def make_rows(seed: int = 5):
    """N two-column rows (a Paillier ciphertext at position 0, a string at
    1) and the plaintexts."""
    rng = np.random.default_rng(seed)
    pk = KEY.public
    xs = [int(x) for x in rng.integers(0, 1 << 20, size=N)]
    blinds = [pk.blind(int(rng.integers(2, 1 << 62))) for _ in range(N)]
    return [[str(pk.encrypt(x, rn=b)), f"tag-{i}"] for i, (x, b) in enumerate(zip(xs, blinds))], xs


def ref_config(**analytics) -> RefConfig:
    rcfg = RefConfig()
    rcfg.replicas.endpoints = [f"replica-{i}" for i in range(4)]
    rcfg.replicas.sentinent = []
    rcfg.replicas.byz_quorum_size = 3
    rcfg.replicas.byz_max_faults = 1
    rcfg.recovery.enabled = False
    rcfg.proxy.port = 0
    rcfg.proxy.crypto_backend = "cpu"
    rcfg.analytics = dataclasses.replace(rcfg.analytics, **analytics)
    return rcfg


def port_config(**analytics) -> DDSConfig:
    cfg = DDSConfig()
    cfg.proxy.device = "cpu"
    cfg.proxy.min_device_batch = 0
    cfg.analytics = dataclasses.replace(cfg.analytics, **analytics)
    return cfg


LIMITS = dict(max_rows=MAX_ROWS, max_request_bytes=MAX_BYTES)
WEIGHTED_SUM_ROW = [1, -1, 2, 0, -3, "7"]


def request_weights() -> tuple[list, list]:
    """MatVec's rows: 3 of 16-bit weights (one zero weight, one all-zero
    row), and 2 signed ones (full-width n - |w| exponents)."""
    rng = np.random.default_rng(6)
    unsigned = [[int(w) for w in rng.integers(0, 1 << 16, size=N)] for _ in range(3)]
    unsigned[0][1] = 0
    unsigned[2] = [0] * N
    signed = [[int(w) for w in rng.integers(-50, 50, size=N)] for _ in range(2)]
    return unsigned, signed


async def drive(port: int, request, rows) -> list:
    """The request sequence; [(label, status, body)] in order."""
    out = []
    nsqr = KEY.public.nsquare

    async def call(label, target, obj=None, raw=None):
        body = raw if raw is not None else json.dumps(obj).encode()
        status, resp = await request("127.0.0.1", port, "POST", target, body)
        out.append((label, status, resp))
        return status, resp

    mv = f"/MatVec?position=0&nsqr={nsqr}"
    await call("empty", mv, {"weights": [[1]]})
    keys = []
    for r in rows:
        status, k = await request("127.0.0.1", port, "POST", "/PutSet",
                                  json.dumps({"contents": r}).encode())
        assert status == 200
        keys.append(k.decode())
    keys.sort()
    unsigned, signed = request_weights()
    await call("matvec", mv, {"weights": unsigned})
    await call("matvec-signed", mv, {"weights": signed})
    await call("weighted-sum", f"/WeightedSum?position=0&nsqr={nsqr}",
               {"weights": WEIGHTED_SUM_ROW})
    await call("groupby", f"/GroupBySum?position=0&nsqr={nsqr}",
               {"groups": {"evens": keys[0::2], "odds": keys[1::2], "none": []}})
    await call("groupby-unknown", f"/GroupBySum?position=0&nsqr={nsqr}",
               {"groups": {"g": [keys[0], "NOT-A-KEY"]}})
    await call("groupby-too-many", f"/GroupBySum?position=0&nsqr={nsqr}",
               {"groups": {f"g{i}": [keys[i]] for i in range(MAX_ROWS + 1)}})
    await call("row-cap", mv, {"weights": [[1] * N] * (MAX_ROWS + 1)})
    await call("width", mv, {"weights": [[1] * (N + 1)]})
    for i, bad in enumerate(([[True] + [1] * (N - 1)], [["x"] + [1] * (N - 1)],
                             [[1.5] + [1] * (N - 1)], [], [1] * N, {})):
        await call(f"bad-weights-{i}", mv, {"weights": bad})
    await call("not-json-object", mv, "nope")
    await call("not-json", mv, raw=b"{")
    await call("nsqr-not-square", f"/MatVec?position=0&nsqr={nsqr + 1}", {"weights": [[1] * N]})
    await call("nsqr-not-int", "/MatVec?position=0&nsqr=abc", {"weights": [[1] * N]})
    await call("nsqr-missing", "/MatVec?position=0", {"weights": [[1] * N]})
    await call("weighted-sum-matrix", f"/WeightedSum?position=0&nsqr={nsqr}",
               {"weights": [[1] * N]})
    await call("too-large", mv, raw=b"x" * (MAX_BYTES + 1))
    await call("position-negative", f"/MatVec?position=-1&nsqr={nsqr}", {"weights": [[1] * N]})
    await call("position-missing", f"/MatVec?nsqr={nsqr}", {"weights": [[1] * N]})
    await call("no-column", f"/MatVec?position=5&nsqr={nsqr}", {"weights": [[1] * N]})
    await call("weighted-sum-other-column", f"/WeightedSum?position=1&nsqr={nsqr}",
               {"weights": [1] * N})
    return out


async def run_port(cfg, rows, check=None) -> list:
    dep = await launch(cfg)
    try:
        out = await drive(dep.server.cfg.port, http_request, rows)
        if check is not None:
            check(dep.server)
        return out
    finally:
        await dep.stop()


async def run_ref(rcfg, rows) -> list:
    rdep = await ref_launch(rcfg)
    try:
        return await drive(rdep.server.cfg.port,
                           lambda h, p, m, t, b=None: ref_http(h, p, m, t, b), rows)
    finally:
        await rdep.stop()


@pytest.fixture(scope="module")
def reference():
    rows, xs = make_rows()
    return rows, xs, asyncio.run(run_ref(ref_config(**LIMITS), rows))


def _answers(out) -> dict:
    return {lb: (s, b) for lb, s, b in out}


def _decrypted(out, xs, rows) -> dict:
    """Each 200 answer's results, decrypted and signed, keyed by label."""
    x_of = {sigs.key_from_set(r): x for r, x in zip(rows, xs)}
    got = {}
    for lb, status, body in out:
        if status != 200:
            continue
        d = json.loads(body)
        res = d["result"]
        if isinstance(res, dict):
            got[lb] = {g: KEY.decrypt_signed(int(c)) for g, c in res.items()}
        else:
            col = [x_of[k] for k in d["keys"]]
            vals = res if isinstance(res, list) else [res]
            got[lb] = (col, [KEY.decrypt_signed(int(c)) for c in vals])
    return got


@pytest.mark.parametrize("mode", ["0", "1", "2"])
def test_analytics_routes_answer_as_the_reference(reference, monkeypatch, mode):
    rows, xs, ref = reference
    monkeypatch.setenv("DDS_KARATSUBA", mode)
    tracer.reset()
    port = asyncio.run(run_port(port_config(**LIMITS), rows))
    spans = tracer.summary()
    assert [(lb, s) for lb, s, _ in port] == [(lb, s) for lb, s, _ in ref]
    for (lb, _, body), (_, _, rbody) in zip(port, ref):
        assert body == rbody, lb
    status = {lb: s for lb, s, _ in port}
    assert [lb for lb, s in status.items() if s == 200] == [
        "matvec", "matvec-signed", "weighted-sum", "groupby"]
    assert [lb for lb, s in status.items() if s == 404] == ["empty", "no-column"]
    assert status["too-large"] == 413
    assert all(s == 400 for lb, s in status.items()
               if lb not in ("matvec", "matvec-signed", "weighted-sum", "groupby",
                             "empty", "no-column", "too-large")), status
    # every 200 answer ran the weighted fold (min_device_batch 0)
    assert spans["kernel.fold_weighted.execute"]["count"] == 4
    assert spans["analytics.matvec"]["count"] == 4

    # the port's answers decrypt to W @ x over the echoed key order
    got = _decrypted(port, xs, rows)
    body = {lb: b for lb, _, b in port}
    col, vals = got["matvec"]
    unsigned, signed = request_weights()
    assert vals == [sum(w * x for w, x in zip(r, col)) for r in unsigned]
    assert vals[2] == 0 and json.loads(body["matvec"])["result"][2] == "1"
    col, vals = got["matvec-signed"]
    assert vals == [sum(w * x for w, x in zip(r, col)) for r in signed]
    col, vals = got["weighted-sum"]
    assert vals == [sum(int(w) * x for w, x in zip(WEIGHTED_SUM_ROW, col))]
    x_of = {sigs.key_from_set(r): x for r, x in zip(rows, xs)}
    keys = sorted(x_of)
    assert got["groupby"] == {"evens": sum(x_of[k] for k in keys[0::2]),
                              "odds": sum(x_of[k] for k in keys[1::2]), "none": 0}


def test_matvec_through_the_resident_plane(reference, monkeypatch):
    """With `[resident]` on, the MatVec operands gather from the pool
    through `rows_for`, once a request; the answers equal the reference
    stack's (without a plane)."""
    rows, xs, ref = reference
    monkeypatch.delenv("DDS_KARATSUBA", raising=False)
    gathers = []
    real = ResidentPlane.rows_for

    def spy(self, gid, modulus, cs, tenant=""):
        got = real(self, gid, modulus, cs, tenant)
        gathers.append((gid, len(cs), None if got is None else tuple(got.shape)))
        return got

    monkeypatch.setattr(ResidentPlane, "rows_for", spy)
    cfg = port_config(**LIMITS)
    cfg.resident.enabled = True
    cfg.resident.initial_rows = 4
    pools = {}
    port = asyncio.run(run_port(
        cfg, rows, check=lambda s: pools.update(s._resident.pool("", KEY.public.nsquare).stats())))
    assert _answers(port) == _answers(ref)
    assert gathers == [("", N, (N, 64))] * 4
    assert pools["rows"] == N and pools["hit_ratio"] > 0  # later gathers hit the pool


def test_disabled_routes_answer_as_the_reference():
    rows, _ = make_rows()

    async def go():
        outs = []
        for start, cfg in ((ref_launch, ref_config(enabled=False)),
                           (launch, port_config(enabled=False))):
            dep = await start(cfg)
            try:
                req = ref_http if start is ref_launch else http_request
                port = dep.server.cfg.port
                st, _ = await req("127.0.0.1", port, "POST", "/PutSet",
                                  json.dumps({"contents": rows[0]}).encode())
                assert st == 200
                assert dep.server.prism is None
                outs.append([await req("127.0.0.1", port, "POST",
                                       f"/{r}?position=0&nsqr={KEY.public.nsquare}",
                                       json.dumps({"weights": [[1]]}).encode())
                             for r in ("MatVec", "WeightedSum", "GroupBySum")])
            finally:
                await dep.stop()
        return outs

    ref, port = asyncio.run(go())
    assert port == ref and all(s == 404 for s, _ in port)


def test_analytics_series_count_as_the_reference(reference):
    """The same requests leave the same `dds_analytics_*` counter and
    histogram counts in both packages' registries."""
    rows, _, _ = reference

    def snapshot(reg) -> dict:
        text = reg.render()
        return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                for ln in text.splitlines()
                if ln.startswith("dds_analytics_") and "_seconds" not in ln}

    ref_metrics.reset()
    metrics.reset()
    asyncio.run(run_ref(ref_config(**LIMITS), rows))
    asyncio.run(run_port(port_config(**LIMITS), rows))
    got, want = snapshot(metrics), snapshot(ref_metrics)
    assert got == want
    assert got['dds_analytics_requests_total{route="MatVec"}'] == 2
    assert got['dds_analytics_requests_total{route="GroupBySum"}'] == 1
    assert got['dds_analytics_requests_total{route="WeightedSum"}'] == 1
    assert got["dds_analytics_rows_count"] == 4
    text = metrics.render()
    assert "dds_analytics_matvec_seconds_count 4" in text
    assert 'dds_analytics_cols_bucket{le="8"} 4' in text


def test_analytics_section_as_the_reference(monkeypatch):
    assert [(f.name, f.default) for f in dataclasses.fields(AnalyticsConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(RefAnalyticsConfig)]
    data = {"analytics": {"enabled": False, "max-rows": 7, "max-request-bytes": 9}}
    assert dataclasses.asdict(DDSConfig.from_dict(data).analytics) == dataclasses.asdict(
        RefConfig.from_dict(data).analytics)
    monkeypatch.setenv("DDS_ANALYTICS_MAX_ROWS", "0")

    async def boot(start, cfg):
        dep = await start(cfg)
        await dep.stop()

    for start, cfg in ((ref_launch, ref_config()), (launch, port_config())):
        with pytest.raises(ValueError, match="DDS_ANALYTICS_MAX_ROWS"):
            asyncio.run(boot(start, cfg))
