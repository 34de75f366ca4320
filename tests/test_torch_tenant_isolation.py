"""Bastion tenancy at the port's REST edge against the reference's, exactly.

Both packages' 4-replica in-memory stacks (`crypto-backend = "cpu"`) take
the same header and request sequence over the same seeded Paillier-512
ciphertexts and must answer with equal statuses and bodies: the 400 for a
malformed header, the typed 403 for another tenant's key (GetSet,
RemoveSet, a PutSet replaying another tenant's content, every keyed
route), the default tenant, tenant-scoped SumAll, Order, Search and
MatVec, equal `/health` `tenants` sections and `/metrics` series, and
equal weighted-fair and burn-shed decisions on one fake clock. Two
tenants' folds over one modulus still share one `fold_many` dispatch.
The shred drill (rotate, re-encrypt, shred mid-traffic, the Watchtower at
zero verdicts) runs on `launch` of each package, the port's keyring
carried across by `convert`, with both packages' flight recorders'
per-kind rate-limit stamps cleared before and after it (`fresh_flight`):
the reference's keyring files its rotate and shred through `dds_tpu`'s
process-wide recorder, and a stamp left there suppressed the next drill's
incidents within a second, in either order; the two drills run back to
back in one process, in both orders. The canary repair: with tenancy off the
canary tenant's rows never enter another tenant's aggregate, search or
analytics answer, nor theirs the canary's; the parent port folded all of
them.
"""

import asyncio
import contextlib
import importlib
import json
import math
import pathlib

import numpy as np
import pytest

from dds_tpu_torch import convert

BOUND = 60.0
CANARY = "__heliograph__"


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def bounded(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND))


def rest_twin(scenario):
    """`scenario(pkg)` on both packages; equal observations."""
    ref = bounded(scenario("dds_tpu"))
    port = bounded(scenario("dds_tpu_torch"))
    assert port == ref
    return port


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@contextlib.contextmanager
def cleared_flight_stamps():
    """Both packages' process-wide flight recorders with no kind stamped,
    before and after the body: each recorder rate-limits a kind to one
    incident a `min_interval` (1 s by default), so a stamp left by one drill
    would suppress the next drill's incidents, and its index."""
    recorders = [mod(pkg, "obs.flight").flight for pkg in ("dds_tpu", "dds_tpu_torch")]
    for r in recorders:
        r._last.clear()
    try:
        yield
    finally:
        for r in recorders:
            r._last.clear()


@pytest.fixture
def fresh_flight():
    with cleared_flight_stamps():
        yield


@pytest.fixture(scope="module")
def key():
    """One Paillier-512 key, the reference's, for both packages."""
    return mod("dds_tpu", "models.paillier").PaillierKey.generate(512)


def seeded_rows(key, n: int, seed: int) -> tuple[list[list[str]], list[int]]:
    """`n` records [Enc(m), m % 97, "det-<m % 3>"] from a seeded numpy
    generator: column 0 folds, 1 orders, 2 matches; and the plaintexts."""
    rng = np.random.default_rng(seed)
    ms = [int(x) for x in rng.integers(1, 1 << 20, n)]
    rs = [int(x) for x in rng.integers(2, 1 << 62, n)]
    rows = [[str(key.public.encrypt(m, r=r)), str(m % 97), f"det-{m % 3}"]
            for m, r in zip(ms, rs)]
    return rows, ms


@contextlib.asynccontextmanager
async def stack(pkg: str, tenancy: bool = True, acfg=None, slo=None, n=4, quorum=3,
                **proxy_kw):
    rep = mod(pkg, "core.replica")
    qc = mod(pkg, "core.quorum_client")
    srv = mod(pkg, "http.server")
    cfgm = mod(pkg, "utils.config")
    net = mod(pkg, "core.transport").InMemoryNet()
    rcfg = rep.ReplicaConfig(quorum_size=quorum)
    addrs = [f"replica-{i}" for i in range(n)]
    replicas = {a: rep.BFTABDNode(a, addrs, "supervisor", net, rcfg) for a in addrs}
    abd = qc.AbdClient("proxy-0", net, addrs,
                       qc.AbdClientConfig(request_timeout=2.0, quorum_size=quorum))
    if tenancy:
        proxy_kw["tenancy"] = cfgm.TenancyConfig(enabled=True)
    server = srv.DDSRestServer(abd, srv.ProxyConfig(
        host="127.0.0.1", port=0, crypto_backend="cpu", admission=acfg, **proxy_kw),
        slo=slo)
    await server.start()
    try:
        yield server
    finally:
        await server.stop()
        await net.quiesce()


async def call(pkg: str, server, method: str, target: str, tenant=None, obj=None):
    """(status, parsed JSON body or raw text) of one request."""
    http = mod(pkg, "http.miniserver")
    body = json.dumps(obj).encode() if obj is not None else None
    status, data = await http.http_request(
        "127.0.0.1", server.cfg.port, method, target, body,
        headers={"x-dds-tenant": tenant} if tenant else None, timeout=10.0)
    try:
        return status, json.loads(data)
    except ValueError:
        return status, data.decode()


async def put(pkg, server, row, tenant=None):
    status, key = await call(pkg, server, "POST", "/PutSet", tenant, {"contents": row})
    assert status == 200, key
    return key


# ------------------------------------------------ the canary repair (A.1)


def test_canary_rows_stay_out_of_every_other_tenants_answers_twin(key):
    """Tenancy off: 3 rows with no header and 2 with the canary tenant's.
    The default SumAll, the canary SumAll, a SearchEq, an OrderLS and a
    MatVec (whose weight row must match the visible column count) answer
    as the reference does, before and after a RemoveSet of one canary
    key. The parent port folded all five rows into both SumAlls."""
    rows, ms = seeded_rows(key, 5, seed=1501)
    n2 = key.nsquare

    async def bodies(pkg, server, visible: dict) -> list:
        out = []
        for tenant in (None, CANARY):
            w = [[1] * visible[tenant]]
            out += [
                await call(pkg, server, "GET", f"/SumAll?position=0&nsqr={n2}", tenant),
                await call(pkg, server, "POST", "/SearchEq?position=2", tenant,
                           {"value": "det-1"}),
                await call(pkg, server, "GET", "/OrderLS?position=1", tenant),
                await call(pkg, server, "POST", f"/MatVec?position=0&nsqr={n2}", tenant,
                           {"weights": w}),
            ]
        return out

    async def scenario(pkg):
        async with stack(pkg, tenancy=False) as server:
            keys = [await put(pkg, server, r) for r in rows[:3]]
            canary = [await put(pkg, server, r, CANARY) for r in rows[3:]]
            before = await bodies(pkg, server, {None: 3, CANARY: 2})
            removed = await call(pkg, server, "DELETE", f"/RemoveSet/{canary[0]}", CANARY)
            after = await bodies(pkg, server, {None: 3, CANARY: 1})
            return keys, canary, before, removed, after

    keys, canary, before, removed, after = rest_twin(scenario)
    assert removed[0] == 200
    default_sum = key.decrypt(int(before[0][1]["result"]))
    canary_sum = key.decrypt(int(before[4][1]["result"]))
    assert (default_sum, canary_sum) == (sum(ms[:3]), sum(ms[3:]))
    assert set(before[2][1]["keyset"]) == set(keys)
    assert set(before[6][1]["keyset"]) == set(canary)
    assert key.decrypt(int(after[4][1]["result"])) == ms[4]
    assert after[:4] == before[:4]  # the default tenant never saw the removed row


def test_tenant_pairs_keeps_the_list_identity_without_canary_keys():
    """The reference's identity rule: tenancy off and no canary key, the
    view is the same list object (the operand and column memos key on
    it); a canary key makes a filtered copy, memoized per tenant."""
    srv = mod("dds_tpu_torch", "http.server")
    server = srv.DDSRestServer(object.__new__(mod("dds_tpu_torch",
                                                  "core.quorum_client").AbdClient),
                               srv.ProxyConfig(crypto_backend="cpu"))
    pairs = [("a", ["1"]), ("b", ["2"])]
    assert server._tenant_pairs(pairs) is pairs
    token = srv._REQ_TENANT.set(CANARY)
    try:
        server._note_owner("b")
        assert server._tenant_pairs(pairs) == [("b", ["2"])]
        assert server._tenant_pairs(pairs) is server._tenant_pairs(pairs)
    finally:
        srv._REQ_TENANT.reset(token)
    assert server._tenant_pairs(pairs) == [("a", ["1"])]
    assert server._tenant_stored_keys() == []


# --------------------------------------------------- the edge, tenancy on


def test_malformed_header_and_default_tenant_twin(key):
    rows, _ = seeded_rows(key, 2, seed=1502)

    async def scenario(pkg):
        async with stack(pkg) as server:
            out = [await call(pkg, server, "GET", "/health", bad)
                   for bad in ("no spaces", "-lead", 'quo"te', "a" * 70)]
            k = await put(pkg, server, rows[0])  # no header: the default tenant
            out += [await call(pkg, server, "GET", f"/GetSet/{k}"),
                    await call(pkg, server, "GET", f"/GetSet/{k}", "default"),
                    await call(pkg, server, "GET", f"/GetSet/{k}", "alice")]
            return out

    out = rest_twin(scenario)
    assert [s for s, _ in out[:4]] == [400] * 4
    assert out[0][1]["error"] == "invalid tenant header"
    assert [s for s, _ in out[4:]] == [200, 200, 403]


def test_cross_tenant_keyed_routes_answer_typed_403_twin(key):
    """Every keyed route refuses another tenant's key with the typed body
    and counts it; a PutSet of content another tenant owns is refused;
    the owner's record is untouched."""
    rows, _ = seeded_rows(key, 2, seed=1503)
    n2 = key.nsquare

    async def scenario(pkg):
        metrics = mod(pkg, "obs.metrics").metrics
        before = metrics.value("dds_tenant_denied_total", tenant="bob") or 0
        async with stack(pkg) as server:
            k = await put(pkg, server, rows[0], "alice")
            k2 = await put(pkg, server, rows[1], "alice")
            out = [
                await call(pkg, server, "GET", f"/GetSet/{k}", "bob"),
                await call(pkg, server, "POST", "/PutSet", "bob", {"contents": rows[0]}),
                await call(pkg, server, "PUT", f"/AddElement/{k}", "bob", {"value": "9"}),
                await call(pkg, server, "GET", f"/ReadElement/{k}?position=0", "bob"),
                await call(pkg, server, "PUT", f"/WriteElement/{k}?position=0", "bob",
                           {"value": "9"}),
                await call(pkg, server, "POST", f"/IsElement/{k}", "bob", {"value": "9"}),
                await call(pkg, server, "GET",
                           f"/Sum?key1={k}&key2={k2}&position=0&nsqr={n2}", "bob"),
                await call(pkg, server, "DELETE", f"/RemoveSet/{k}", "bob"),
                await call(pkg, server, "GET", f"/GetSet/{k}", "alice"),
                await call(pkg, server, "GET",
                           f"/Sum?key1={k}&key2={k2}&position=0&nsqr={n2}", "alice"),
                await call(pkg, server, "DELETE", f"/RemoveSet/{k}", "alice"),
                await call(pkg, server, "GET", f"/GetSet/{k}", "bob"),
            ]
        after = metrics.value("dds_tenant_denied_total", tenant="bob") or 0
        return k, out, after - before

    k, out, denied = rest_twin(scenario)
    assert [s for s, _ in out] == [403] * 8 + [200, 200, 200, 404]
    assert out[0][1] == {"error": "cross-tenant access denied", "tenant": "bob", "key": k}
    assert denied == 8


def test_aggregates_order_search_and_matvec_are_tenant_scoped_twin(key):
    rows, ms = seeded_rows(key, 5, seed=1504)
    n2 = key.nsquare
    owners = ["alice", "alice", "bob", "bob", None]

    async def scenario(pkg):
        async with stack(pkg) as server:
            keys = [await put(pkg, server, r, t) for r, t in zip(rows, owners)]
            out = []
            for tenant, n in (("alice", 2), ("bob", 2), (None, 1), ("carol", 0)):
                out += [
                    await call(pkg, server, "GET", f"/SumAll?position=0&nsqr={n2}", tenant),
                    await call(pkg, server, "GET", "/SumAll?position=1", tenant),
                    await call(pkg, server, "GET", "/OrderLS?position=1", tenant),
                    await call(pkg, server, "GET", "/OrderSL?position=1&limit=1", tenant),
                    await call(pkg, server, "POST", "/SearchGt?position=1", tenant,
                               {"value": "10"}),
                    await call(pkg, server, "POST", "/SearchEntryOR", tenant,
                               {"value1": "det-0", "value2": "det-1", "value3": "det-2"}),
                    await call(pkg, server, "POST", f"/MatVec?position=0&nsqr={n2}", tenant,
                               {"weights": [[1] * max(n, 1)]}),
                ]
            health = await call(pkg, server, "GET", "/health")
            return keys, out, health[1]["tenants"]

    keys, out, tenants = rest_twin(scenario)
    assert key.decrypt(int(out[0][1]["result"])) == ms[0] + ms[1]
    assert key.decrypt(int(out[7][1]["result"])) == ms[2] + ms[3]
    assert key.decrypt(int(out[14][1]["result"])) == ms[4]
    assert set(out[2][1]["keyset"]) == set(keys[:2])
    assert set(out[9][1]["keyset"]) == set(keys[2:4])
    assert out[21][0] == 404  # a tenant with no rows folds nothing
    assert tenants == {"owned_keys": 5, "shed": []}


def test_health_metrics_and_slo_expose_the_tenant_surfaces_twin(key):
    rows, _ = seeded_rows(key, 3, seed=1505)

    async def scenario(pkg):
        acfg = mod(pkg, "utils.config").AdmissionConfig(enabled=True, eval_interval=1e9)
        async with stack(pkg, acfg=acfg) as server:
            k = await put(pkg, server, rows[0], "alice")
            await put(pkg, server, rows[1], "bob")
            await put(pkg, server, rows[2], CANARY)
            denied = await call(pkg, server, "GET", f"/GetSet/{k}", "bob")
            health = await call(pkg, server, "GET", "/health")
            status, text = await call(pkg, server, "GET", "/metrics")
            slo = await call(pkg, server, "GET", "/slo")
            lines = sorted(ln for ln in text.splitlines()
                           if ln.startswith(('dds_tenant_stored_keys{tenant="alice"}',
                                             'dds_tenant_stored_keys{tenant="bob"}',
                                             f'dds_tenant_stored_keys{{tenant="{CANARY}"}}')))
            return (denied[0], health[0], health[1]["tenants"], status, lines,
                    sorted(slo[1]["slo"]["tenants"]))

    out = rest_twin(scenario)
    assert out[:4] == (403, 200, {"owned_keys": 3, "shed": []}, 200)
    assert out[4] == ['dds_tenant_stored_keys{tenant="alice"} 1',
                      'dds_tenant_stored_keys{tenant="bob"} 1']
    assert out[5] == ["alice", "bob", "default"]  # the canary is never observed


def test_weighted_fair_and_burn_shed_decisions_at_the_edge_twin(key):
    """[tenancy.weights] gold = 3: under contention of the aggregate
    class (8/s, burst 8) each tenant's refill contracts to its weight
    share; a tenant whose SumAlls fail (modulus 0: a 500) owns the
    window's bad outcomes and, with the SumAll alert firing, sheds itself
    (429 "burn-driven") while the fleet ratchet holds and the quiet tenant
    passes. One fake clock drives the SLO engine and the controller."""
    rows, _ = seeded_rows(key, 4, seed=1506)

    async def scenario(pkg):
        A = mod(pkg, "core.admission")
        cfgm = mod(pkg, "utils.config")
        clk = FakeClock()
        state = {"alerts": set()}
        acfg = cfgm.AdmissionConfig(enabled=True, eval_interval=1.0,
                                    aggregate_rate=8.0, aggregate_burst=8.0)
        tcfg = cfgm.TenancyConfig(enabled=True, weights={"gold": 3.0})
        slo = mod(pkg, "obs.slo").SloEngine(clock=clk)
        async with stack(pkg, acfg=acfg, slo=slo) as server:
            for task in server._tasks:  # the real-time heartbeat: the fake clock rules
                task.cancel()
            server.admission = A.AdmissionController.from_config(
                acfg, alerts=lambda: state["alerts"], breakers=server._breaker_census,
                clock=clk, tenancy=tcfg)
            for row, t in zip(rows, ("gold", "lead", "noisy", "quiet")):
                await put(pkg, server, row, t)
            fair = []
            for _ in range(12):
                for t in ("gold", "lead"):
                    fair.append((await call(pkg, server, "GET", "/SumAll?position=1", t))[0])
            clk.advance(1.0)
            server.admission.evaluate()
            rates = (server.admission._bucket("gold", 1).rate,
                     server.admission._bucket("lead", 1).rate)
            clk.advance(10.0)
            server.admission.evaluate()  # demand gone: the full class rate again
            burn = [(await call(pkg, server, "GET", "/SumAll?position=1&nsqr=0", "noisy"))[0]
                    for _ in range(6)]
            burn.append((await call(pkg, server, "GET", "/SumAll?position=1", "quiet"))[0])
            state["alerts"] = {"SumAll"}
            clk.advance(1.0)
            server.admission.evaluate()
            shed = server.admission.shed_tenants()
            after = [await call(pkg, server, "GET", "/SumAll?position=1", t)
                     for t in ("noisy", "quiet")]
            after.append(await call(pkg, server, "GET", "/GetSet/nokey", "noisy"))
            health = await call(pkg, server, "GET", "/health")
            return (fair, rates, burn, shed, server.admission.shed_level, after,
                    health[1]["tenants"], server.admission.tenant_transitions)

    out = rest_twin(scenario)
    fair, rates, burn, shed, level, after, tenants, transitions = out
    assert fair.count(429) == 8  # each tenant's burst of 8, then its empty bucket
    assert rates == (pytest.approx(6.0), pytest.approx(2.0))
    assert burn == [500] * 6 + [200]
    assert shed == ["noisy"] and level == 0
    assert after[0][0] == 429 and "burn-driven" in after[0][1]
    assert [s for s, _ in after[1:]] == [200, 404]
    assert tenants == {"owned_keys": 4, "shed": ["noisy"]}
    assert [t["direction"] for t in transitions] == ["shed"]


# ------------------------------------- isolation keeps the fold coalescing


class FoldManyBackend:
    """A host fold with a device-batch crossover that records every fused
    dispatch."""

    name = "stub-foldmany"
    min_device_batch = 4  # alice (2) and bob (3) alone stay below; fused >= it

    def __init__(self):
        self.many_calls: list[list[int]] = []

    def modmul(self, a, b, modulus):
        return a * b % modulus

    def modmul_fold(self, ops, modulus):
        out = 1
        for o in ops:
            out = out * o % modulus
        return out

    def modmul_fold_many(self, folds, modulus):
        self.many_calls.append(sorted(len(f) for f in folds))
        return [self.modmul_fold(f, modulus) for f in folds]


def test_two_tenants_same_modulus_folds_share_one_fold_many_twin():
    """Tenancy scopes the operands, not the batching: two tenants' folds
    over one modulus coalesce into a single `modmul_fold_many` dispatch
    (`_fold_pending` is keyed by the modulus alone), each answered with
    its own tenant's fold."""
    M = (1 << 64) + 13
    a_vals, b_vals = [3, 5], [7, 11, 13]

    async def scenario(pkg):
        tracer = mod(pkg, "utils.trace").tracer
        async with stack(pkg, coalesce_window=0.05) as server:
            for v in a_vals:
                await put(pkg, server, [str(v)], "alice")
            for v in b_vals:
                await put(pkg, server, [str(v)], "bob")
            stub = server.backend = FoldManyBackend()
            tracer.reset()
            server._folds_inflight += 1  # both folds take the window
            try:
                res = await asyncio.gather(
                    call(pkg, server, "GET", f"/SumAll?position=0&nsqr={M}", "alice"),
                    call(pkg, server, "GET", f"/SumAll?position=0&nsqr={M}", "bob"))
            finally:
                server._folds_inflight -= 1
            spans = sorted((e.meta.get("batch"), e.meta.get("k"))
                           for e in tracer.events("proxy.coalesced_fold"))
            return res, stub.many_calls, spans

    res, many, spans = rest_twin(scenario)
    assert res == [(200, {"result": str(math.prod(a_vals) % M)}),
                   (200, {"result": str(math.prod(b_vals) % M)})]
    assert many == [[2, 3]]
    assert spans == [(2, 2), (2, 3)]


def test_each_tenant_folds_under_its_own_modulus_in_its_own_group():
    """Two tenants, two keys: their concurrent SumAlls wait in two
    `_fold_pending` groups, one a modulus, and each answers its own fold."""
    M1, M2 = (1 << 64) + 13, (1 << 65) + 27

    async def go():
        async with stack("dds_tpu_torch", coalesce_window=0.05) as server:
            for v in (3, 5):
                await put("dds_tpu_torch", server, [str(v)], "alice")
            for v in (7, 11):
                await put("dds_tpu_torch", server, [str(v)], "bob")
            stub = server.backend = FoldManyBackend()
            stub.min_device_batch = 3
            seen = []
            real = server._dispatch_fold_group

            async def spy(modulus, group):
                seen.append((modulus, len(group)))
                await real(modulus, group)

            server._dispatch_fold_group = spy
            server._folds_inflight += 1
            try:
                res = await asyncio.gather(
                    call("dds_tpu_torch", server, "GET", f"/SumAll?position=0&nsqr={M1}",
                         "alice"),
                    call("dds_tpu_torch", server, "GET", f"/SumAll?position=0&nsqr={M2}",
                         "bob"))
            finally:
                server._folds_inflight -= 1
            return res, sorted(seen), stub.many_calls

    res, seen, many = bounded(go())
    assert res == [(200, {"result": str(15 % M1)}), (200, {"result": str(77 % M2)})]
    assert seen == [(M1, 1), (M2, 1)] and many == []


# --------------------------------------------------------- the shred drill


def drill_cfg(pkg: str, flight_dir: str):
    cfg = mod(pkg, "utils.config").DDSConfig()
    cfg.replicas.endpoints = [f"replica-{i}" for i in range(4)]
    cfg.replicas.sentinent = []
    cfg.replicas.byz_quorum_size = 3
    cfg.replicas.byz_max_faults = 1
    cfg.proxy.port = 0
    cfg.proxy.crypto_backend = "cpu"
    if pkg == "dds_tpu_torch":
        cfg.proxy.device = "cpu"
    cfg.recovery.enabled = False
    cfg.recovery.anti_entropy_enabled = False
    cfg.obs.audit_enabled = True
    cfg.obs.flight_dir = flight_dir
    cfg.tenancy.enabled = True
    return cfg


def ref_keyring_from(epochs: dict, shredded: set, clock):
    """A reference `TenantKeyring` holding the epochs `convert` exports."""
    ten = mod("dds_tpu", "models.tenancy")
    HEKeys = mod("dds_tpu", "models.keys").HEKeys
    kr = ten.TenantKeyring(paillier_bits=512, rsa_bits=512, grace=300.0, clock=clock)
    for tenant, eps in epochs.items():
        kr._domains[tenant] = ten._TenantDomain(
            epochs=[ten.KeyEpoch(v, HEKeys.from_json(b), c, g) for v, b, c, g in eps],
            rotations=eps[0][0] - 1)
    for tenant in shredded:
        kr._domains[tenant] = ten._TenantDomain(shredded_at=clock())
    return kr


def test_shred_drill_survivors_exact_zero_verdicts_twin(tmp_path, fresh_flight):
    shred_drill_twin(tmp_path)


def shred_drill_twin(tmp_path):
    """The reference's chaos drill on `launch` of each package, the port's
    keyring carried across from the reference's: rotate one tenant, re-
    encrypt a row and decrypt it under epoch 2, shred it mid-traffic; the
    survivors' reads and SumAlls stay exact, the shredded tenant's rows
    are still served as ciphertexts and every access to its keys raises
    TenantShredded; the Watchtower audits to zero verdicts and the flight
    recorder holds the rotation and the shred."""
    plains = {"alice": [3, 14, 15], "bob": [92, 65], "victim": [35, 89, 79]}
    clk = FakeClock()
    seed_kr = mod("dds_tpu_torch", "models.tenancy").TenantKeyring(
        paillier_bits=512, rsa_bits=512, grace=300.0, clock=clk)
    for t in plains:
        seed_kr.keys_for(t)
    exported = convert.keyring_to_reference(seed_kr)
    rng = np.random.default_rng(1507)
    blinds = {t: [int(x) for x in rng.integers(2, 1 << 62, len(v))] for t, v in plains.items()}

    async def scenario(pkg):
        ten = mod(pkg, "models.tenancy")
        kr = (ref_keyring_from(*exported, clock=clk) if pkg == "dds_tpu" else
              convert.keyring_from_reference(*exported, paillier_bits=512, rsa_bits=512,
                                             grace=300.0, clock=clk))
        flight = mod(pkg, "obs.flight").flight
        watchtower = mod(pkg, "obs.watchtower").watchtower
        flight_dir = str(tmp_path / pkg)
        dep = await mod(pkg, "run").launch(drill_cfg(pkg, flight_dir))
        server = dep.server
        log = []
        try:
            stored = {}
            for tenant, values in plains.items():
                pk = kr.keys_for(tenant).psse.public
                stored[tenant] = []
                for m, r in zip(values, blinds[tenant]):
                    ct = pk.encrypt(m, r=r)
                    k = await put(pkg, server, [str(ct)], tenant)
                    stored[tenant].append((k, ct, kr.version(tenant)))

            async def churn(tenant):
                for k, ct, _ in stored[tenant]:
                    status, body = await call(pkg, server, "GET", f"/GetSet/{k}", tenant)
                    log.append((tenant, status, body["contents"] == [str(ct)]))

            async def fold(tenant):
                n2 = kr.keys_for(tenant).psse.nsquare
                status, body = await call(pkg, server, "GET",
                                          f"/SumAll?position=0&nsqr={n2}", tenant)
                return status, kr.decrypt(tenant, int(body["result"]))

            await asyncio.gather(churn("alice"), churn("bob"), churn("victim"))
            version = kr.rotate("victim")
            k0, ct0, v0 = stored["victim"][0]
            ct_new, v_new, migrated = kr.reencrypt("victim", ct0, v0)
            moved = (version, v_new, migrated, kr.decrypt("victim", ct_new, v_new))
            await asyncio.gather(churn("alice"), churn("victim"), churn("bob"))
            summary = kr.shred("victim")
            await asyncio.gather(churn("alice"), churn("bob"))
            folds = [await fold(t) for t in ("alice", "bob")]
            _, ct_v, v_v = stored["victim"][1]
            served = await call(pkg, server, "GET", f"/GetSet/{stored['victim'][1][0]}",
                                "victim")
            refused = []
            for attempt in (lambda: kr.decrypt("victim", ct_v, v_v),
                            lambda: kr.decrypt("victim", ct_new, v_new),
                            lambda: kr.encrypt("victim", 1),
                            lambda: kr.keys_for("victim")):
                try:
                    attempt()
                    refused.append(None)
                except ten.TenantShredded as e:
                    refused.append(e.tenant)
            verdicts = watchtower.verdicts()
        finally:
            await dep.stop()
            flight.configure(dir="")
        index = pathlib.Path(flight_dir) / "index.jsonl"
        kinds = sorted({json.loads(ln)["kind"] for ln in index.read_text().splitlines()})
        return (log, moved, summary, folds, served[1]["contents"] == [str(ct_v)], refused,
                verdicts, kinds, kr.stats())

    log, moved, summary, folds, served, refused, verdicts, kinds, stats = rest_twin(scenario)
    assert all(s == 200 and ok for _, s, ok in log) and len(log) == 21
    assert moved == (2, 2, True, plains["victim"][0])
    assert summary == {"tenant": "victim", "already": False, "epochs_scrubbed": 2}
    assert folds == [(200, sum(plains["alice"])), (200, sum(plains["bob"]))]
    assert served and refused == ["victim"] * 4
    assert verdicts == []
    assert {"tenant_rotate", "tenant_shred"} <= set(kinds)
    assert stats["shredded"] == 1 and stats["tenants"] == 3


@pytest.mark.parametrize("order", ["twin-first", "reference-first"])
def test_shred_drills_back_to_back_in_one_process(order, tmp_path, fresh_flight):
    """The twin drill and the reference's own drill
    (`tests/test_tenant_isolation.py`) one after the other in this process,
    in either order, within the recorders' 1 s rate limit: each files its
    rotate and shred and passes. Only the twin clears the stamps around
    itself; the reference's drill runs as the suite runs it."""
    from tests.test_tenant_isolation import (
        test_shred_chaos_drill_other_tenants_linearizable_zero_verdicts as reference_drill)

    (tmp_path / "ref").mkdir()
    (tmp_path / "twin").mkdir()

    def twin():
        with cleared_flight_stamps():
            shred_drill_twin(tmp_path / "twin")

    steps = [twin, lambda: reference_drill(tmp_path / "ref")]
    for step in (steps if order == "twin-first" else steps[::-1]):
        step()
