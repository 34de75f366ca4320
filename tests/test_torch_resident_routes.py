"""The proxy with `[resident]`, and with `[resident]` and `[storage]`,
against the reference's, and the two config sections against theirs.

Both stacks boot the north-star topology (4 BFT-ABD replicas, quorum 3,
f = 1, in-memory transport) with the resident plane on (`min-fold` 1, so
every modular aggregate goes through it); the port folds on
`CudaBackend(device="cpu")` (the kernels' plain PyTorch paths) or on its
`cpu` backend (the portable plane on `[proxy] device`, the CPU here:
the reference's default device for host backends), the reference on its
`cpu` backend (its portable plane). The
same seeded rows go into both through `POST /PutSet`, then the same
request sequence: SumAll and MultAll (twice each, so the second pass
serves resident rows), writes through AddElement, WriteElement and PutSet
after the pools exist, the aggregates again, a RemoveSet and the
aggregates once more. Every status and body must be equal, and the port's
aggregates must decrypt to the plaintexts' fold. With `[storage]` the
pools are smaller than the rows, so folds split into resident and
streamed legs and overflow demotes to the warm and cold tiers (segment
log in `tmp_path`), with no reset. Exact equality throughout. A host
backend's resident and search planes follow `[proxy] device`: the CPU for
`cpu`, and `cuda` without a card raises at construction.
"""

import asyncio
import dataclasses
import json
import pathlib
import tomllib

import numpy as np
import pytest
import torch

from dds_tpu.http.miniserver import http_request as ref_http
from dds_tpu.run import launch as ref_launch
from dds_tpu.utils.config import DDSConfig as RefConfig
from dds_tpu.utils.config import ResidentConfig as RefResidentConfig
from dds_tpu.utils.config import StorageConfig as RefStorageConfig
from dds_tpu_torch.bench_key import bench_paillier_key
from dds_tpu_torch.http.miniserver import http_request
from dds_tpu_torch.models.keys import HEKeys
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.run import launch
from dds_tpu_torch.utils.config import DDSConfig, ResidentConfig, SearchConfig, StorageConfig


@pytest.fixture(autouse=True)
def reset_reference_audit():
    """The reference's `launch` attaches its process-wide Watchtower without
    a reset, so the verdicts these twins leave there (the same rows written
    by launch after launch read as duplicate mints, or a drill's wrong
    answer) would reach a later test of the worker that reads
    `watchtower.verdicts()`. Reset it, and the port's, after each test."""
    yield
    from dds_tpu.obs.watchtower import watchtower
    from dds_tpu_torch.obs.watchtower import watchtower as port_watchtower

    watchtower.reset()
    port_watchtower.reset()

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 20
PSSE_POS, MSE_POS = 0, 1


@pytest.fixture(scope="module")
def keys():
    return dataclasses.replace(HEKeys.generate(512, 1024), psse=bench_paillier_key(512))


def make_rows(keys, seed: int = 3):
    """N two-column rows (Paillier, RSA-1024) and their plaintexts."""
    rng = np.random.default_rng(seed)
    pk = keys.psse.public
    blinds = [pk.blind(int(rng.integers(2, 1 << 62))) for _ in range(4)]
    plain = [(int(rng.integers(1, 1 << 20)), int(rng.integers(2, 1 << 16))) for _ in range(N + 2)]
    rows = [[str(pk.encrypt(a, rn=blinds[i % 4])), str(keys.mse.public.encrypt(b))]
            for i, (a, b) in enumerate(plain)]
    return rows, plain


def planes(cfg, tmp: pathlib.Path | None, max_rows: int):
    """Turn on `[resident]` (min-fold 1) and, with `tmp`, `[storage]` in
    `cfg` (either package's DDSConfig: the sections share their fields)."""
    cfg.resident.enabled = True
    cfg.resident.min_fold = 1
    cfg.resident.initial_rows = 4
    cfg.resident.max_rows = max_rows
    if tmp is not None:
        cfg.storage.enabled = True
        cfg.storage.dir = str(tmp)
        cfg.storage.warm_bytes = 2048  # 8 rows of n^2 at L = 64
        cfg.storage.chunk_rows = 8
    return cfg


def ref_config(tmp, max_rows) -> RefConfig:
    rcfg = RefConfig()
    rcfg.replicas.endpoints = [f"replica-{i}" for i in range(4)]
    rcfg.replicas.sentinent = []
    rcfg.replicas.byz_quorum_size = 3
    rcfg.replicas.byz_max_faults = 1
    rcfg.recovery.enabled = False
    rcfg.proxy.port = 0
    rcfg.proxy.crypto_backend = "cpu"
    return planes(rcfg, tmp, max_rows)


def port_config(tmp, max_rows, backend) -> DDSConfig:
    cfg = DDSConfig()
    cfg.proxy.crypto_backend = backend
    cfg.proxy.device = "cpu"
    cfg.proxy.min_device_batch = 0
    return planes(cfg, tmp, max_rows)


async def drive(dep, request, rows, keys, ingest) -> list:
    """The request sequence; [(label, status, body)] in order. `ingest`
    awaits the proxy's write-ingest drain (and checks the port's pools)."""
    port = dep.server.cfg.port
    out = []

    async def call(label, method, target, obj=None):
        body = json.dumps(obj).encode() if obj is not None else None
        status, resp = await request("127.0.0.1", port, method, target, body)
        out.append((label, status, resp))
        return status, resp

    nsqr, n = keys.psse.public.nsquare, keys.mse.n
    stored = []
    for i, r in enumerate(rows[:N]):
        _, k = await call(f"put{i}", "POST", "/PutSet", {"contents": r})
        stored.append(k.decode())
    sumall = f"/SumAll?position={PSSE_POS}&nsqr={nsqr}"
    multall = f"/MultAll?position={MSE_POS}&pubkey={n}"
    for rnd in range(2):
        await call(f"sumall{rnd}", "GET", sumall)
        await call(f"multall{rnd}", "GET", multall)
    # writes after the pools exist: ingested off the request path
    await call("add", "PUT", f"/AddElement/{stored[0]}", {"value": rows[N][PSSE_POS]})
    await call("write", "PUT", f"/WriteElement/{stored[1]}?position={PSSE_POS}",
               {"value": rows[N + 1][PSSE_POS]})
    _, k = await call("put-new", "POST", "/PutSet", {"contents": rows[N]})
    await ingest(dep)
    await call("sumall-after-writes", "GET", sumall)
    await call("multall-after-writes", "GET", multall)
    await call("remove", "DELETE", f"/RemoveSet/{k.decode()}")
    await call("sumall-after-remove", "GET", sumall)
    await call("multall-after-remove", "GET", multall)
    return out


def _result(out, label) -> int:
    (body,) = [b for lb, _, b in out if lb == label]
    return int(json.loads(body)["result"])


async def ref_ingest(dep):
    task = dep.server._ingest_task
    if task is not None:
        await task


def port_ingest(marks: dict):
    """The writes queue their ingest on the proxy's drain task, not on the
    requests: wait for it; the queue is then empty, and `marks` keeps the
    rows the pools had ingested on the fold path so far."""

    async def ingest(dep):
        plane = dep.server._resident
        assert dep.server._ingest_task is not None
        await dep.server._ingest_task
        assert plane.pending_ingest() == 0
        marks["fold_ingested"] = sum(p._served[1] for p in plane._pools.values())

    return ingest


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
@pytest.mark.parametrize("tiered", [False, True], ids=["resident", "resident+storage"])
def test_aggregates_through_the_planes_answer_as_the_reference(keys, tmp_path, backend, tiered):
    rows, plain = make_rows(keys)
    max_rows = 8 if tiered else 64

    async def go():
        dep = await launch(port_config(tmp_path / "port" if tiered else None, max_rows,
                                       backend))
        marks = {}
        try:
            port = await drive(dep, lambda h, p, m, t, b=None: http_request(h, p, m, t, b),
                               rows, keys, port_ingest(marks))
            plane, stratum = dep.server._resident, dep.server._stratum
            served = sum(p._served[1] for p in plane._pools.values())
            state = {
                "device": plane.device.type,
                "pools": len(plane._pools),
                "resets": plane.stats()["resets"],
                "tiered": stratum is not None,
                "tier_stats": stratum.stats() if stratum is not None else None,
                "pressure": dep.server.tier_pressure(),
                # rows the aggregates after the writes ingested on the
                # fold path (the writes themselves were ingested already)
                "fold_ingest_after_writes": served - marks["fold_ingested"],
            }
        finally:
            await dep.stop()
        rdep = await ref_launch(ref_config(tmp_path / "ref" if tiered else None, max_rows))
        try:
            assert (rdep.server._stratum is not None) == tiered
            ref = await drive(rdep, lambda h, p, m, t, b=None: ref_http(h, p, m, t, b),
                              rows, keys, ref_ingest)
        finally:
            await rdep.stop()
        return port, ref, state

    port, ref, state = asyncio.run(go())
    assert [(lb, s) for lb, s, _ in port] == [(lb, s) for lb, s, _ in ref]
    for (lb, _, body), (_, _, rbody) in zip(port, ref):
        assert body == rbody, lb
    assert state["device"] == "cpu" and state["pools"] == 2  # n^2 and the RSA n
    assert state["tiered"] == tiered and state["resets"] == 0
    if tiered:
        tiers = state["tier_stats"]
        assert tiers["tiers"]["cold"]["rows"] > 0 and tiers["demotions"] > 0
        assert tiers["hits"]["warm"] + tiers["hits"]["cold"] > 0
        assert 0.0 < state["pressure"] <= 1.0
    else:
        assert state["pressure"] == 0.0
    psse, mse = keys.psse, keys.mse
    full = plain[:N]
    total = sum(a for a, _ in full)
    prod = 1
    for _, b in full:
        prod = prod * b % mse.n
    for rnd in range(2):
        assert psse.decrypt(_result(port, f"sumall{rnd}")) == total
        assert mse.decrypt(_result(port, f"multall{rnd}")) == prod
    # AddElement appended to record 0 (not the PSSE column), WriteElement
    # replaced record 1's PSSE column, PutSet added a record
    after = total - full[1][0] + plain[N + 1][0] + plain[N][0]
    assert psse.decrypt(_result(port, "sumall-after-writes")) == after
    assert mse.decrypt(_result(port, "multall-after-writes")) == prod * plain[N][1] % mse.n
    assert psse.decrypt(_result(port, "sumall-after-remove")) == after - plain[N][0]
    assert mse.decrypt(_result(port, "multall-after-remove")) == prod
    if not tiered:  # every operand of the post-write SumAll was resident
        assert state["fold_ingest_after_writes"] == 0


def test_first_aggregate_after_a_write_ingests_nothing(keys):
    """A PutSet after the pool exists is ingested by the drain task: the
    queue empties, the row is resident, and the next SumAll's fold path
    ingests 0 rows (the pool's served counters and the
    dds_resident_ingest_total{path="fold"} counter do not move)."""
    rows, plain = make_rows(keys, seed=5)
    nsqr = keys.psse.public.nsquare

    async def go():
        dep = await launch(port_config(None, 64, "cuda"))
        try:
            port = dep.server.cfg.port
            for r in rows[:8]:
                st, _ = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                           json.dumps({"contents": r}).encode())
                assert st == 200
            target = f"/SumAll?position={PSSE_POS}&nsqr={nsqr}"
            st, _ = await http_request("127.0.0.1", port, "GET", target)
            assert st == 200  # the pool for n^2 exists now
            plane = dep.server._resident
            pool = plane.pool("", nsqr)
            before_rows = pool.resident
            st, _ = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                       json.dumps({"contents": rows[8]}).encode())
            assert st == 200
            assert dep.server._ingest_task is not None
            await dep.server._ingest_task
            assert plane.pending_ingest() == 0
            assert pool.resident == before_rows + 2  # both numeric columns
            ingested = pool._served[1]
            fold_metric = metrics.value("dds_resident_ingest_total", shard="-",
                                        path="fold") or 0
            st, body = await http_request("127.0.0.1", port, "GET", target)
            assert st == 200
            assert pool._served[1] == ingested
            assert (metrics.value("dds_resident_ingest_total", shard="-", path="fold")
                    or 0) == fold_metric
            return int(json.loads(body)["result"])
        finally:
            await dep.stop()

    result = asyncio.run(go())
    assert keys.psse.decrypt(result) == sum(a for a, _ in plain[:9])


def test_storage_without_resident_builds_no_stratum(tmp_path):
    """The reference builds no Stratum when `[storage]` is on and
    `[resident]` off, and refuses nothing: neither does the port."""

    async def go():
        cfg = port_config(tmp_path / "port", 8, "cuda")
        cfg.resident.enabled = False
        dep = await launch(cfg)
        try:
            port = (dep.server._resident, dep.server._stratum, dep.server.tier_pressure())
        finally:
            await dep.stop()
        rcfg = ref_config(tmp_path / "ref", 8)
        rcfg.resident.enabled = False
        rdep = await ref_launch(rcfg)
        try:
            ref = (rdep.server._resident, rdep.server._stratum, rdep.server.tier_pressure())
        finally:
            await rdep.stop()
        return port, ref

    assert asyncio.run(go()) == ((None, None, 0.0), (None, None, 0.0))
    assert not (tmp_path / "port").exists() and not (tmp_path / "ref").exists()


def test_stratum_toml_sections_parse_as_the_reference():
    data = tomllib.loads((ROOT / "configs" / "stratum.toml").read_text())
    sections = {"resident": data["resident"], "storage": data["storage"]}
    port, ref = DDSConfig.from_dict(sections), RefConfig.from_dict(sections)
    for name in sections:
        assert dataclasses.asdict(getattr(port, name)) == dataclasses.asdict(getattr(ref, name))
    assert port.resident.enabled and port.storage.enabled and port.resident.max_rows == 4096
    assert dataclasses.asdict(ResidentConfig()) == dataclasses.asdict(RefResidentConfig())
    assert dataclasses.asdict(StorageConfig()) == dataclasses.asdict(RefStorageConfig())
    with pytest.raises(ValueError, match="unknown config key"):
        DDSConfig.from_dict({"storage": {"warm-megabytes": 1}})


def test_search_plane_still_refuses(monkeypatch):
    """The search plane is ported, so `[search]` beside `[resident]` boots;
    what it still refuses is a hidden host copy: it builds on the
    backend's device, like the resident plane, and on `cuda` without a
    card it raises instead of building on the CPU."""
    from dds_tpu_torch.search import SearchPlane

    cfg = port_config(None, 64, "cuda")
    cfg.search.enabled = True

    async def boot():
        dep = await launch(cfg)
        try:
            s = dep.server
            return s._search.device, s._resident.device, s.backend.device
        finally:
            await dep.stop()

    assert asyncio.run(boot()) == (torch.device("cpu"),) * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchPlane(device="cuda")


def test_no_hidden_cpu_plane(monkeypatch):
    """With the `cuda` backend the plane is the backend's own, on the
    backend's device; a `cuda` proxy on a host without a card refuses to
    start instead of building a plane on the CPU."""

    async def boot(cfg):
        dep = await launch(cfg)
        try:
            server = dep.server
            return (server._resident.device, server.backend.device,
                    server._resident.pool("", 7 * 11 * 13)._buf.device)
        finally:
            await dep.stop()

    plane_dev, backend_dev, buf_dev = asyncio.run(boot(port_config(None, 64, "cuda")))
    assert plane_dev == backend_dev == buf_dev == torch.device("cpu")
    cfg = port_config(None, 64, "cuda")
    cfg.proxy.device = "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(launch(cfg))


def _host_backend_server(device: str):
    """A `crypto-backend = "cpu"` proxy with [resident] and [search] on
    `device` (the server alone: the planes are built at construction)."""
    from dds_tpu_torch.core.quorum_client import AbdClient, AbdClientConfig
    from dds_tpu_torch.core.transport import InMemoryNet
    from dds_tpu_torch.http.server import DDSRestServer, ProxyConfig

    abd = AbdClient("proxy-0", InMemoryNet(), ["replica-0"], AbdClientConfig())
    return DDSRestServer(abd, ProxyConfig(
        crypto_backend="cpu", device=device,
        resident=ResidentConfig(enabled=True, initial_rows=4, max_rows=64),
        search=SearchConfig(enabled=True)))


def test_host_backend_planes_follow_the_proxy_device():
    """A host crypto backend builds its portable resident plane and its
    search plane on `[proxy] device`, the reference's default device: on
    `cpu` both planes are on the CPU."""
    server = _host_backend_server("cpu")
    assert server.backend.name == "cpu"
    assert server._resident.device == server._search.device == torch.device("cpu")


def test_host_backend_planes_on_cuda_refuse_without_a_card(monkeypatch):
    """The same proxy with `device = "cuda"` on a host without a card
    raises at construction instead of quietly building CPU planes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _host_backend_server("cuda")
    with pytest.raises(RuntimeError, match="ResidentPlane: no CUDA device"):
        from dds_tpu_torch.resident import ResidentPlane

        ResidentPlane(device="cuda")
