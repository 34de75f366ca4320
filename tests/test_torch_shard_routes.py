"""The port's sharded proxy against the reference's, at the REST edge.

Three shapes of `tests/test_shard.py`, each on both packages:

- S = 4 against S = 1 over the SAME Paillier-512 ciphertexts, bit for
  bit: SumAll through the scatter path (one fold a group, merged by
  `combine_partials`), SumAll through the resident plane's fused S-group
  fold, and Prism's MatVec (one weighted fold a group, merged row by row);
  the port folds on `CudaBackend(device="cpu")` (the kernels' plain
  versions), the reference on its `cpu` backend, and every answer of both
  packages is the same integer;
- `/shards` (the signed map, the groups, the epoch as ETag and the 304 on
  `If-None-Match`), `/health`'s shard sections and `/metrics`' `dds_shard_*`
  series, equal;
- `launch` of `configs/sharded.toml` and `configs/stratum.toml` (port 0,
  the CPU device, Stratum's directory under `tmp_path`): every data route
  of `tests/test_torch_routes.py`'s sequence gives the same status and
  body, and every other route of both route tables the same status,
  `POST /_reshard` (404: `[fabric] admin-routes` is off in both files)
  included.
"""

import asyncio
import importlib
import json

import numpy as np
import pytest

from tests.test_torch_routes import drive, keys, make_rows  # noqa: F401 (fixture)

SECRET = b"intranet-abd-secret"
BOUND = 120.0
K_ROWS = 24


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def fresh_watchtowers():
    """Both packages' process-wide auditors reset after each test: the
    reference's launch configures its auditor without a reset, so the tag
    history of this test's keys ("nope" among them) would reach a later
    deployment's audit in this process."""
    yield
    for pkg in ("dds_tpu", "dds_tpu_torch"):
        mod(pkg, "obs.watchtower").watchtower.reset()


@pytest.fixture(scope="module")
def paillier():
    """One Paillier-512 key, the reference's, for both packages."""
    return mod("dds_tpu", "models.paillier").PaillierKey.generate(512)


def seeded_ciphertexts(key, n: int, seed: int) -> tuple[list[int], list[int]]:
    rng = np.random.default_rng(seed)
    ms = [int(x) for x in rng.integers(1, 1 << 20, n)]
    rs = [int(x) for x in rng.integers(2, 1 << 62, n)]
    return [key.public.encrypt(m, r=r) for m, r in zip(ms, rs)], ms


def proxy_config(pkg: str, resident: bool):
    srv, cfgm = mod(pkg, "http.server"), mod(pkg, "utils.config")
    kw = {}
    if resident:
        kw["resident"] = cfgm.ResidentConfig(enabled=True, min_fold=1, initial_rows=16,
                                             max_rows=256)
    if pkg == "dds_tpu_torch":
        # the kernels' plain versions on the CPU, below the device crossover
        # for a group's fold so concurrent group folds share fold_many
        kw.update(crypto_backend="cuda", device="cpu", min_device_batch=16)
    else:
        kw.update(crypto_backend="cpu")
    return srv.ProxyConfig(host="127.0.0.1", port=0, **kw)


async def serve_sharded(pkg: str, S: int, cts: list[int], nsqr: int, weights, resident: bool):
    """A Constellation of `S` groups behind each package's proxy: the rows
    PutSet, then SumAll and MatVec; what came back and how it was folded."""
    http = mod(pkg, "http.miniserver").http_request
    net = mod(pkg, "core.transport").InMemoryNet()
    const = mod(pkg, "shard").build_constellation(
        net, shard_count=S, vnodes_per_group=8, seed=3, n_active=4, n_sentinent=0, quorum=3)
    server = mod(pkg, "http.server").DDSRestServer(const.router, proxy_config(pkg, resident))
    seen = {"scatter": 0, "resident_parts": [], "prism_parts": []}
    orig_scatter = server._shard_operands

    def scatter_spy(pairs, pos):
        out = orig_scatter(pairs, pos)
        if len(out) > 1:
            seen["scatter"] += 1
        return out

    server._shard_operands = scatter_spy
    if server._resident is not None:
        fold = server._resident.fold_groups

        def fold_spy(parts, modulus, tenant=""):
            seen["resident_parts"].append(sorted(len(ops) for _, ops in parts))
            return fold(parts, modulus, tenant)

        server._resident.fold_groups = fold_spy
    orig_partition = server.prism._partition

    def partition_spy(keys):
        parts = orig_partition(keys)
        seen["prism_parts"].append(len(parts))
        return parts

    server.prism._partition = partition_spy
    await server.start()
    port = server.cfg.port
    try:
        for c in cts:
            st, _ = await http("127.0.0.1", port, "POST", "/PutSet",
                               json.dumps({"contents": [str(c)]}).encode(), timeout=10.0)
            assert st == 200
        groups = len(const.router.partition_keys(sorted(server.stored_keys)))
        st, body = await http("127.0.0.1", port, "GET", f"/SumAll?position=0&nsqr={nsqr}",
                              timeout=30.0)
        assert st == 200, body
        total = int(json.loads(body)["result"])
        st, body = await http("127.0.0.1", port, "POST", f"/MatVec?position=0&nsqr={nsqr}",
                              json.dumps({"weights": weights}).encode(), timeout=30.0)
        assert st == 200, body
        matvec = json.loads(body)
        return total, matvec, groups, seen
    finally:
        await server.stop()
        await const.stop()


@pytest.mark.parametrize("path", ["scatter", "resident"])
def test_four_groups_fold_bit_for_bit_as_one_twin(paillier, path):
    cts, ms = seeded_ciphertexts(paillier, K_ROWS, 21)
    nsqr = paillier.public.nsquare
    rng = np.random.default_rng(22)
    weights = [[int(w) for w in rng.integers(-40, 1 << 12, K_ROWS)] for _ in range(3)]
    resident = path == "resident"
    out = {}
    for pkg in ("dds_tpu", "dds_tpu_torch"):
        for S in (1, 4):
            out[pkg, S] = asyncio.run(asyncio.wait_for(
                serve_sharded(pkg, S, cts, nsqr, weights, resident), BOUND))
    expected = 1
    for c in cts:
        expected = expected * c % nsqr
    answers = {k: (total, mv) for k, (total, mv, _, _) in out.items()}
    assert len({json.dumps([t, mv], sort_keys=True) for t, mv in answers.values()}) == 1
    total, mv = answers["dds_tpu_torch", 4]
    assert total == expected and paillier.decrypt(total) == sum(ms)
    assert sorted(mv["keys"]) == mv["keys"] and len(mv["keys"]) == K_ROWS
    for pkg in ("dds_tpu", "dds_tpu_torch"):
        _, _, groups, seen = out[pkg, 4]
        assert groups == 4  # the sample really spans the four groups
        assert seen["prism_parts"] == [4]
        if resident:
            assert seen["resident_parts"] and len(seen["resident_parts"][0]) == 4
            assert seen["scatter"] == 0
        else:
            assert seen["scatter"] == 1
        _, _, groups1, seen1 = out[pkg, 1]
        assert groups1 == 1 and seen1["scatter"] == 0 and seen1["prism_parts"] == [1]
    # weight j scales column j of the echoed (sorted) key order: each row
    # decrypts to its weighted sum
    from dds_tpu_torch.utils import sigs

    x_by_key = {sigs.key_from_set([str(c)]): m for c, m in zip(cts, ms)}
    col = [x_by_key[k] for k in mv["keys"]]
    n = paillier.public.n
    for row, enc in zip(weights, mv["result"]):
        assert paillier.decrypt(int(enc)) == sum(w * x for w, x in zip(row, col)) % n


def test_shards_health_and_metrics_answer_as_the_reference():
    async def go(pkg):
        http = mod(pkg, "http.miniserver").http_request
        net = mod(pkg, "core.transport").InMemoryNet()
        const = mod(pkg, "shard").build_constellation(
            net, shard_count=2, vnodes_per_group=8, seed=3, n_active=4, n_sentinent=0,
            quorum=3)
        srv = mod(pkg, "http.server")
        server = srv.DDSRestServer(const.router, srv.ProxyConfig(port=0, crypto_backend="cpu"))
        await server.start()
        port = server.cfg.port
        try:
            for i in range(6):
                st, _ = await http("127.0.0.1", port, "POST", "/PutSet",
                                   json.dumps({"contents": [str(i), "x"]}).encode())
                assert st == 200
            st, headers, raw = await mod(pkg, "http.miniserver").http_request_full(
                "127.0.0.1", port, "GET", "/shards")
            shards = json.loads(raw)
            etag = headers.get("etag")
            cond, cond_headers, _ = await mod(pkg, "http.miniserver").http_request_full(
                "127.0.0.1", port, "GET", "/shards", headers={"If-None-Match": etag})
            stale, _, _ = await mod(pkg, "http.miniserver").http_request_full(
                "127.0.0.1", port, "GET", "/shards", headers={"If-None-Match": '"7"'})
            hst, hbody = await http("127.0.0.1", port, "GET", "/health")
            health = json.loads(hbody)
            mst, mbody = await http("127.0.0.1", port, "GET", "/metrics")
            series = sorted(ln for ln in mbody.decode().splitlines()
                            if ln.startswith(("dds_shard_epoch", "dds_shard_groups",
                                              "dds_shard_keys", "dds_shard_reshard_state")))
            verified = mod(pkg, "shard").ShardMap.from_wire(shards["map"]).verify(SECRET)
            return (st, shards, etag, cond, cond_headers.get("etag"), stale, verified, hst,
                    {k: health[k] for k in ("status", "active_replicas", "reachable_replicas",
                                            "quorum_size", "stored_keys", "shards",
                                            "shard_epoch", "reshard_state")},
                    mst, series)
        finally:
            await server.stop()
            await const.stop()

    ref = asyncio.run(asyncio.wait_for(go("dds_tpu"), BOUND))
    port = asyncio.run(asyncio.wait_for(go("dds_tpu_torch"), BOUND))
    assert port == ref
    st, shards, etag, cond, cond_etag, stale, verified, hst, health, mst, series = port
    assert st == 200 and etag == '"1"' and cond == 304 and cond_etag == '"1"' and stale == 200
    assert verified and shards["state"] == "stable" and set(shards["groups"]) == {"s0", "s1"}
    assert hst == 200 and health["status"] == "ok" and health["shard_epoch"] == 1
    assert set(health["shards"]) == {"s0", "s1"} and health["reshard_state"] == "stable"
    assert mst == 200 and [ln.split()[-1] for ln in series
                           if ln.startswith("dds_shard_groups")] in (["2"], ["2.0"])


# every route of both packages' route tables beyond the data routes
# `drive` sweeps: (label, method, target, body)
OPERATOR_ROUTES = [
    ("health", "GET", "/health", None), ("metrics", "GET", "/metrics", None),
    ("slo", "GET", "/slo", None), ("profile", "GET", "/profile", None),
    ("profile-folded", "GET", "/profile?fmt=folded", None), ("canary", "GET", "/canary", None),
    ("trace", "GET", "/_trace", None), ("sync-push", "POST", "/_sync", {"keyset": []}),
    ("sync-pull", "GET", "/_sync", None), ("shards", "GET", "/shards", None),
    ("reshard", "POST", "/_reshard", {"source": "s0"}),
    ("reshard-merge", "POST", "/_reshard", {"source": "s1", "action": "merge"}),
    ("helmsman", "POST", "/_helmsman", {}), ("fleet", "GET", "/fleet/metrics", None),
]


@pytest.mark.parametrize("name", ["sharded.toml", "stratum.toml"])
def test_launch_serves_every_route_as_the_reference(name, keys, tmp_path, monkeypatch):  # noqa: F811
    import pathlib

    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    monkeypatch.delenv("DDS_KARATSUBA", raising=False)
    root = pathlib.Path(__file__).resolve().parent.parent
    rows, _ = make_rows(keys)
    nsqr = keys.psse.public.nsquare

    async def go(pkg):
        cfg = mod(pkg, "utils.config").DDSConfig.load(root / "configs" / name)
        cfg.proxy.port = 0
        cfg.storage.dir = str(tmp_path / pkg / "stratum")
        if pkg == "dds_tpu_torch":
            cfg.proxy.device = "cpu"
        http = mod(pkg, "http.miniserver").http_request
        dep = await mod(pkg, "run").launch(cfg)
        try:
            port = dep.server.cfg.port
            data = await drive(port, lambda h, p, m, t, b=None: http(h, p, m, t, b, timeout=60.0),
                               rows, keys)
            ops = []
            # the MatVec spans the 23 rows holding position 2 after drive's
            # RemoveSet
            for label, method, target, obj in OPERATOR_ROUTES + [
                    ("matvec", "POST", f"/MatVec?position=2&nsqr={nsqr}",
                     {"weights": [[1] * (K_ROWS - 1), [2] * (K_ROWS - 1)]})]:
                body = json.dumps(obj).encode() if obj is not None else None
                st, resp = await http("127.0.0.1", port, method, target, body, timeout=60.0)
                ops.append((label, st, resp if label == "matvec" else None))
            groups = len(dep.constellation.groups)
            return data, ops, groups
        finally:
            await dep.stop()

    ref = asyncio.run(asyncio.wait_for(go("dds_tpu"), BOUND))
    port = asyncio.run(asyncio.wait_for(go("dds_tpu_torch"), BOUND))
    (data, ops, groups), (rdata, rops, rgroups) = port, ref
    assert [(lb, s) for lb, s, _ in data] == [(lb, s) for lb, s, _ in rdata]
    for (lb, _, body), (_, _, rbody) in zip(data, rdata):
        assert body == rbody, lb
    assert ops == rops
    status = {lb: s for lb, s, _ in ops}
    assert groups == rgroups == (4 if name == "sharded.toml" else 2)
    assert status["shards"] == 200 and status["health"] == 200 and status["matvec"] == 200
    assert status["reshard"] == status["reshard-merge"] == 404
    assert status["helmsman"] == status["fleet"] == status["sync-pull"] == 404
