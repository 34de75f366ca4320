"""Heliograph and its canary client in the port against the reference's,
exactly (`tests/test_heliograph.py` is the map of cases).

Every scenario runs once on `dds_tpu` and once on `dds_tpu_torch`, with
the same pinned inputs, and must observe the same: one fake clock, one
seeded rng, a scripted probe client or a real `CanaryClient` over the
same keys (the reference's `HEKeys`, carried across by `convert`), the
same salt and the same ciphertexts (each row encrypted once, by the
reference, and served to both clients). The cases: `parse_canary_targets`,
`next_delay`, `classify`, the ledger's report, `/health` section, gauges,
exemplar rotation and region streaks, `probe_once`'s SLO and Watchtower
feed and its failure modes, `run_cycle`'s populate failure,
`seed_ciphertext_corruption`'s flipped bytes, `CanaryClient`'s rows and
expectations with AES on and off, and on each package's 4-replica
in-memory stack the golden transactions (all five kinds correct, the
canary's rows out of a user's SumAll and search), the corruption drill
(`wrong_answer` and a `canary_wrong_answer` verdict with the exemplar
trace id), the canary bucket's rate bound and the `/health` section of a
stopped prober.
"""

import asyncio
import contextlib
import importlib
import json
import random

import pytest

from dds_tpu_torch import convert

BOUND = 60.0
CANARY = "__heliograph__"


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def twin(scenario, *args):
    ref, port = scenario("dds_tpu", *args), scenario("dds_tpu_torch", *args)
    assert port == ref
    return port


def atwin(scenario, *args):
    """An async scenario on both packages, each under its own loop."""
    return twin(lambda pkg, *a: asyncio.run(asyncio.wait_for(scenario(pkg, *a), BOUND)),
                *args)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class ScriptClient:
    """A stand-in for CanaryClient: `script[kind]` is a ProbeCheck to
    return or an exception to raise; `tick` advances the clock inside a
    probe (drives `slow`)."""

    population = 2

    def __init__(self, pkg: str, clock=None):
        self.check = mod(pkg, "clt.canary").ProbeCheck
        self.script: dict = {}
        self.clock = clock
        self.tick = 0.0
        self._n = 0

    def mint_trace(self) -> str:
        self._n += 1
        return f"trace-{self._n:04d}"

    async def populate(self, target, trace_id=None):
        return None

    async def probe(self, kind, target, trace_id, cycle=0):
        if self.clock is not None and self.tick:
            self.clock.advance(self.tick)
        action = self.script.get(kind, self.check(True, 200))
        if isinstance(action, Exception):
            raise action
        return action


class SloRecorder:
    def __init__(self):
        self.seen = []

    def observe(self, route, status, dur_s, tenant=None):
        self.seen.append((route, status, dur_s))


def helio(pkg: str, clock=None, client=None, seed=7, **kw):
    """Each package's Heliograph on a fake clock, a seeded rng, a scripted
    client, a recording SLO engine and its own Watchtower."""
    cfg = {"enabled": True, "cadence": 5.0, "jitter": 0.5, "deadline": 2.0,
           "slow_ms": 250.0, **kw}
    clock = clock or FakeClock()
    client = client if client is not None else ScriptClient(pkg, clock)
    slo, wt = SloRecorder(), mod(pkg, "obs.watchtower").Watchtower()
    H = mod(pkg, "obs.heliograph")
    target = mod(pkg, "clt.canary").CanaryTarget("127.0.0.1", 1, region="east")
    h = H.Heliograph(mod(pkg, "utils.config").HeliographConfig(**cfg), [target],
                     slo=slo, watchtower=wt, clock=clock, rng=random.Random(seed),
                     client=client)
    return h, clock, client, slo, wt


def verdicts(wt) -> list:
    return [(v.invariant, v.trace_id, v.detail) for v in wt.verdicts()]


def unport(obj, port: int):
    """`obj` with this stack's OS-assigned port written as PORT."""
    return json.loads(json.dumps(obj).replace(f":{port}", ":PORT"))


# ------------------------------------------------------- targets, cadence


@pytest.mark.parametrize("entries", [
    ["10.0.0.1:9000", "west=10.0.0.2:9001", "nope", "x:notaport"],
    ["east=proxy-east:8080", "west=proxy-west:8080"],
    ["a=b=c:1", ":80", "h:", "[::1]:443", "eu-1=h.example:65535"],
    [],
])
def test_parse_canary_targets_twin(entries):
    def scenario(pkg):
        targets, bad = mod(pkg, "clt.canary").parse_canary_targets(entries)
        return [(t.host, t.port, t.region, t.label) for t in targets], bad

    twin(scenario)


def test_next_delay_and_classify_twin():
    def scenario(pkg):
        out = {}
        for seed, cadence, jitter in ((42, 5.0, 0.5), (7, 0.25, 1.0), (1, 0.0, 1.0),
                                      (3, 2.0, 0.0), (9, 1.0, 7.0)):
            h, *_ = helio(pkg, seed=seed, cadence=cadence, jitter=jitter)
            out[(seed, cadence, jitter)] = [h.next_delay() for _ in range(100)]
        h, *_ = helio(pkg, slow_ms=250.0)
        out["classify"] = [h.classify(c, s, lat) for c in (True, False)
                           for s in (0, 200, 403, 429, 503)
                           for lat in (0.0, 0.01, 0.25, 0.2501, 2.0)]
        out["stale_after"] = h.stale_after()
        return out

    out = twin(scenario)
    assert all(2.5 <= d <= 7.5 for d in out[(42, 5.0, 0.5)])
    assert min(out[(1, 0.0, 1.0)]) >= 0.05


# ------------------------------------------------------------------ ledger


def results(pkg: str):
    """A fixed sequence of ProbeResults across kinds, verdicts and
    regions, with the clock advances between them."""
    PR = mod(pkg, "obs.heliograph").ProbeResult
    seq = [("sum", "ok", "t-1", "", 0.01, {}, 5),
           ("sum", "wrong_answer", "t-2", "", 0.02, {"expected": 46, "observed": 47}, 5),
           ("putget", "ok", "t-3", "", 0.03, {}, 1),
           ("mult", "slow", "t-4", "east", 0.3, {}, 1),
           ("search", "unreachable", "t-5", "west", 2.0, {"error": "TimeoutError"}, 1),
           ("putget", "unreachable", "t-6", "west", 0.0,
            {"phase": "populate", "error": "x" * 300}, 1),
           ("matvec", "unreachable", "t-7", "west", 0.0, {}, 2),
           ("sum", "unreachable", "t-8", "east", 0.0, {}, 1),
           ("sum", "ok", "t-9", "", 0.01, {}, 3)]
    for kind, verdict, trace, region, lat, detail, dt in seq:
        yield PR(kind, verdict, lat, trace, target=f"{region or 'local'}:1",
                 region=region, detail=detail), dt


def test_ledger_report_health_gauges_and_streaks_twin():
    def scenario(pkg):
        clk = FakeClock()
        reg = mod(pkg, "obs.metrics").Registry()
        led = mod(pkg, "obs.heliograph").CanaryLedger(clock=clk, registry=reg,
                                                      unreachable_streak=3, history=4)
        out = [led.health_section(True, 15.0), led.health_section(False, 15.0),
               led.last_age(), led.report()]
        for r, dt in results(pkg):
            led.record(r)
            out.append((led.unreachable_regions(), led.health_section(True, 15.0)))
            clk.advance(dt)
        gauges = mod(pkg, "obs.metrics").Registry()
        led.export_gauges(gauges)
        out += [led.report(), led.last_age(), led.last("sum").trace_id,
                led.health_section(True, 2.0), reg.render(), gauges.render(),
                [r.trace_id for r in led._results]]
        return out

    out = twin(scenario)
    rep = out[-7]
    assert rep["region_streaks"] == {"east": 1, "west": 3}
    assert rep["unreachable_regions"] == ["west"]
    assert rep["kinds"]["sum"]["last_failure"]["verdict"] == "unreachable"
    assert out[-1] == ["t-6", "t-7", "t-8", "t-9"]  # history bound


def test_ledger_exemplar_rotation_never_accretes_series_twin():
    def scenario(pkg):
        H = mod(pkg, "obs.heliograph")
        Reg = mod(pkg, "obs.metrics").Registry
        led, reg = H.CanaryLedger(clock=FakeClock(), registry=Reg()), Reg()
        out = []
        for trace in ("t-old", "t-new", "t-newer"):
            led.record(H.ProbeResult("sum", "wrong_answer", 0.01, trace))
            led.export_gauges(reg)
            out.append(reg.render())
        return out

    out = twin(scenario)
    assert "t-old" not in out[-1] and "t-newer" in out[-1]


# ---------------------------------------------------------------- the prober


def test_probe_once_feeds_slo_and_watchtower_twin():
    async def scenario(pkg):
        h, clock, client, slo, wt = helio(pkg)
        target = h.targets[0]
        out = [(await h.probe_once("sum", target)).verdict]
        client.script["sum"] = client.check(False, 200, {"expected": 46, "observed": 47})
        bad = await h.probe_once("sum", target)
        client.script["mult"] = client.check(False, 503, {})
        await h.probe_once("mult", target)
        out += [bad.verdict, bad.trace_id, slo.seen, verdicts(wt),
                h.ledger.report(), h.report(), h.health_section()]
        return out

    out = atwin(scenario)
    assert out[1] == "wrong_answer" and out[3][1][:2] == ("canary.sum", 500)
    assert out[4] == [("canary_wrong_answer", out[2],
                       {"probe": "sum", "target": "127.0.0.1:1", "region": "east",
                        "expected": "46", "observed": "47"})]


def test_probe_once_maps_failure_modes_to_verdicts_twin():
    async def scenario(pkg):
        h, clock, client, slo, wt = helio(pkg, deadline=0.05)
        target = h.targets[0]
        out = []
        for exc in (ConnectionRefusedError("edge down"), OSError("no route"),
                    asyncio.TimeoutError(), ValueError("garbled body"),
                    KeyError("result")):
            client.script["sum"] = exc
            r = await h.probe_once("sum", target)
            out.append((r.verdict, r.detail))
        client.script["mult"] = client.check(True, 200)
        client.tick = 0.5  # past slow_ms, still correct
        out.append((await h.probe_once("mult", target)).verdict)

        async def hang(kind, target, trace_id, cycle=0):
            await asyncio.sleep(10)

        client.probe = hang
        out.append((await h.probe_once("search", target)).verdict)
        return out + [slo.seen, verdicts(wt)]

    out = atwin(scenario)
    assert [v for v, _ in out[:5]] == ["unreachable", "unreachable", "unreachable",
                                       "wrong_answer", "wrong_answer"]
    assert out[5] == "slow" and out[6] == "unreachable"


def test_run_cycle_populate_failure_and_streak_twin():
    async def scenario(pkg):
        h, clock, client, slo, wt = helio(pkg, unreachable_streak=3)

        async def broken_populate(target, trace_id=None):
            raise ConnectionRefusedError("no edge")

        client.populate = broken_populate
        out = []
        for _ in range(3):
            await h.run_cycle(h.targets[0])
            last = h.ledger.last("putget")
            out.append((last.verdict, last.detail, h.unreachable_regions()))
        return out + [h.ledger.report(), slo.seen]

    out = atwin(scenario)
    assert out[2][2] == {"east"} and out[0][1]["phase"] == "populate"


# ------------------------------------------------------------------- drill


class Node:
    """A replica's store as the drill sees it."""

    def __init__(self, repository: dict):
        self.repository = dict(repository)

    def _store(self, key, tag, value):
        self.repository[key] = (tag, value)


def test_seed_ciphertext_corruption_flips_the_same_bytes_twin():
    store = {"k": ((3, "replica-0"), ["12", "abc", "99", "x"]),
             "gone": ((1, "replica-1"), None),
             "short": ((2, "replica-2"), ["1"])}

    def scenario(pkg):
        fn = mod(pkg, "obs.heliograph").seed_ciphertext_corruption
        out = []
        for key, pos in (("k", 2), ("k", 1), ("k", 0), ("missing", 2), ("gone", 2),
                         ("short", 2)):
            nodes = {f"replica-{i}": Node(store) for i in range(3)}
            nodes["replica-3"] = Node({})
            n = fn(nodes, key, position=pos)
            out.append((n, [nd.repository.get(key) for nd in nodes.values()]))
        nodes = [Node(store), Node(store)]  # a list of replicas works too
        out.append((fn(nodes, "k"), [nd.repository["k"] for nd in nodes]))
        return out

    out = twin(scenario)
    assert out[0][0] == 3 and out[0][1][0] == ((3, "replica-0"), ["12", "abc", "100", "x"])
    assert out[1][1][0][1][1] == "abc\x00" and [n for n, _ in out[3:6]] == [0, 0, 0]


# -------------------------------------------- the client, keys pinned


class SeededSecrets:
    """A stand-in for the `secrets` module that draws from a seeded rng."""

    def __init__(self, seed):
        self._rng = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self._rng.randrange(n)

    def randbits(self, k: int) -> int:
        return self._rng.getrandbits(k)

    def token_bytes(self, n: int) -> bytes:
        return self._rng.randbytes(n)


@contextlib.contextmanager
def seeded_secrets(seed):
    """The reference's key generation and encryption draw from `seed`, and
    its DJN base is minted afresh: the same inputs give the same keys and
    ciphertexts, and so the same content-addressed row keys, in every run
    and whatever ran before in the process. The aggregate cache audit
    samples from the sorted keys, so which rows it audits depends on them."""
    mods = [mod("dds_tpu", f"models.{m}") for m in ("keys", "primes", "paillier", "rand")]
    paillier = mods[2]
    saved, b0 = [m.secrets for m in mods], paillier._B0_CACHE
    fake = SeededSecrets(seed)
    for m in mods:
        m.secrets = fake
    paillier._B0_CACHE = {}
    try:
        yield
    finally:
        for m, s in zip(mods, saved):
            m.secrets = s
        paillier._B0_CACHE = b0


@pytest.fixture(scope="module")
def keys_json():
    """One small key family, the reference's, for both packages."""
    with seeded_secrets("keys"):
        return mod("dds_tpu", "models.keys").HEKeys.generate(256, 512).to_json()


def pin_salt(client, salt: str = "5a175a175a175a17") -> None:
    """The client's salt, and so its rows' blob column, fixed."""
    client.salt = salt
    client.rows = [client._row(i) for i in range(client.population)]


def provider_of(pkg: str, keys_json: str):
    keys = (mod(pkg, "models.keys").HEKeys.from_json(keys_json) if pkg == "dds_tpu"
            else convert.keys_from_reference(keys_json))
    return mod(pkg, "models.facade").HomoProvider(keys)


class Pinned:
    """A provider whose `encrypt_row` serves rows the reference encrypted
    once, so both packages store the same ciphertexts (and so the same
    content-addressed keys)."""

    table: dict = {}

    def __init__(self, provider, ref):
        self._p, self._ref = provider, ref

    def encrypt_row(self, row, until, schema):
        key = (json.dumps(row), until, tuple(schema))
        if key not in Pinned.table:
            with seeded_secrets(json.dumps(key)):
                Pinned.table[key] = self._ref.encrypt_row(row, until, schema)
        return list(Pinned.table[key])

    def __getattr__(self, name):
        return getattr(self._p, name)


@pytest.fixture
def pinned(monkeypatch, keys_json):
    """Clients with a fixed salt and trace ids, AES as the test asks, and
    pinned rows."""
    ref = provider_of("dds_tpu", keys_json)
    Pinned.table = {}

    def client_of(pkg: str, aes: bool = True, population: int = 2):
        C = mod(pkg, "clt.canary")
        monkeypatch.setattr(C, "aes_available", lambda: aes)
        client = C.CanaryClient(Pinned(provider_of(pkg, keys_json), ref),
                                population=population)
        pin_salt(client)
        n = iter(range(1, 1000))
        client.mint_trace = lambda: f"probe-{next(n):03d}"
        return client

    return client_of


@pytest.mark.parametrize("aes", [True, False], ids=["aes", "no-aes"])
@pytest.mark.parametrize("population", [1, 4, 5])
def test_canary_client_rows_and_expectations_twin(pinned, aes, population):
    def scenario(pkg):
        c = pinned(pkg, aes, population)
        return (c.schema, c.population, c.rows, c.expected_sum, c.expected_product,
                c.salt, c.timeout)

    schema, pop, rows, total, product, *_ = twin(scenario)
    assert pop == max(2, population) and len(rows) == pop
    assert ("Plain" in schema) == (not aes) and total == sum(10 + i for i in range(pop))


@contextlib.asynccontextmanager
async def canary_stack(pkg: str, **proxy_kw):
    """Each package's 4-replica in-memory stack on the host backend."""
    rep = mod(pkg, "core.replica")
    qc = mod(pkg, "core.quorum_client")
    srv = mod(pkg, "http.server")
    net = mod(pkg, "core.transport").InMemoryNet()
    rcfg = rep.ReplicaConfig(quorum_size=3)
    addrs = [f"replica-{i}" for i in range(4)]
    replicas = {a: rep.BFTABDNode(a, addrs, "supervisor", net, rcfg) for a in addrs}
    abd = qc.AbdClient("proxy-0", net, addrs,
                       qc.AbdClientConfig(request_timeout=2.0, quorum_size=3))
    server = srv.DDSRestServer(abd, srv.ProxyConfig(
        host="127.0.0.1", port=0, crypto_backend="cpu", **proxy_kw),
        slo=mod(pkg, "obs.slo").SloEngine())
    await server.start()
    try:
        yield server, replicas
    finally:
        await server.stop()
        await net.quiesce()


async def req(pkg, server, method, target, obj=None, tenant=None):
    http = mod(pkg, "http.miniserver")
    body = json.dumps(obj).encode() if obj is not None else None
    return await http.http_request("127.0.0.1", server.cfg.port, method, target, body,
                                   headers={"x-dds-tenant": tenant} if tenant else None,
                                   timeout=10.0)


USER_ROWS = [[500, "user-0", 1000, 5, "a", "b", "c", "blob-0"],
             [501, "user-1", 2000, 7, "a", "b", "c", "blob-1"]]


@pytest.mark.parametrize("aes", [True, False], ids=["aes", "no-aes"])
def test_golden_transactions_on_a_stack_twin(pinned, aes):
    """Populate, a user's rows through the same edge, every probe kind
    correct against the canary's rows alone over two cycles, the user's
    SumAll and search without them."""

    async def scenario(pkg):
        random.seed(16)  # the aggregate cache audit's samples
        async with canary_stack(pkg) as (server, _):
            client = pinned(pkg, aes, population=2)
            C = mod(pkg, "clt.canary")
            target = C.CanaryTarget("127.0.0.1", server.cfg.port)
            await client.populate(target, client.mint_trace())
            out = {"keys": client.keys}
            for row in USER_ROWS:
                enc = client.provider.encrypt_row(row, 8, client.schema)
                out.setdefault("user_puts", []).append(
                    (await req(pkg, server, "POST", "/PutSet", {"contents": enc}))[0])
            checks = []
            for cycle in range(2):
                for kind in C.PROBE_KINDS:
                    c = await client.probe(kind, target, client.mint_trace(), cycle=cycle)
                    checks.append((kind, c.correct, c.status, c.detail))
            out["checks"] = checks
            nsqr = client.provider.keys.psse.public.nsquare
            status, body = await req(pkg, server, "GET", f"/SumAll?position=2&nsqr={nsqr}")
            out["user_sum"] = (status, client.provider.decrypt(
                json.loads(body)["result"], "PSSE"))
            che = client.provider.encrypt("canary-0", client.schema[1])
            status, body = await req(pkg, server, "POST", "/SearchEq?position=1",
                                     {"value": che})
            out["user_search"] = (status, json.loads(body)["keyset"])
            return out

    out = atwin(scenario)
    assert all(ok and status == 200 for _, ok, status, _ in out["checks"]), out["checks"]
    assert out["user_puts"] == [200, 200] and out["user_sum"] == (200, 3000)
    assert out["user_search"] == (200, [])


async def drill(pkg: str, client, users: int = 0) -> dict:
    """The reference's drill on a stack holding the canary's rows and
    `users` user rows: a green sum probe, the corruption of the canary's
    first PSSE ciphertext on every replica, a GetSet of it, the next sum
    probe."""
    random.seed(16)  # the aggregate cache audit's samples
    async with canary_stack(pkg) as (server, replicas):
        C, H = mod(pkg, "clt.canary"), mod(pkg, "obs.heliograph")
        target = C.CanaryTarget("127.0.0.1", server.cfg.port)
        wt = mod(pkg, "obs.watchtower").Watchtower()
        h = H.Heliograph(mod(pkg, "utils.config").HeliographConfig(enabled=True), [target],
                         watchtower=wt, client=client, clock=FakeClock(),
                         rng=random.Random(1))
        await client.populate(target, client.mint_trace())
        for i in range(users):
            enc = client.provider.encrypt_row([i, f"u{i}", i, 3, "a", "b", "c", f"b{i}"], 8,
                                              client.schema)
            await req(pkg, server, "POST", "/PutSet", {"contents": enc})
        green = await h.probe_once("sum", target)
        mutated = H.seed_ciphertext_corruption(replicas, client.keys[0], 2)
        getset = (await req(pkg, server, "GET", f"/GetSet/{client.keys[0]}"))[0]
        red = await h.probe_once("sum", target)
        return unport({"green": green.verdict, "mutated": mutated, "getset": getset,
                       "red": [red.verdict, red.trace_id, red.detail],
                       "verdicts": verdicts(wt), "report": h.ledger.report()},
                      server.cfg.port)


@pytest.mark.parametrize("aes", [True, False], ids=["aes", "no-aes"])
def test_the_corruption_drill_twin(pinned, aes):
    """On the canary's own rows (the reference's drill store): the
    corrupted row still reads 200, the next sum probe reads
    `wrong_answer` and files one `canary_wrong_answer` verdict carrying
    its trace id, which /canary's report names."""
    out = atwin(lambda pkg: drill(pkg, pinned(pkg, aes, population=2)))
    (verdict, trace, detail), wt = out["red"], out["verdicts"]
    assert (out["green"], verdict, out["mutated"], out["getset"]) == (
        "ok", "wrong_answer", 4, 200)
    assert int(detail["observed"]) != int(detail["expected"]) == 21
    assert [(v[0], v[1]) for v in wt] == [("canary_wrong_answer", trace)]
    assert wt[0][2]["target"] == "127.0.0.1:PORT"
    assert out["report"]["kinds"]["sum"]["last_failure"]["trace_id"] == trace


def test_a_warm_aggregate_cache_masks_the_drill_in_both(pinned):
    """A finding in both packages, not repaired: the drill keeps the tag,
    so with user rows in the proxy's tag-validated cache the corrupted
    canary row is served from the cache (the right bytes) until the
    cache audit's two samples of every cached key land on it; the sum
    probe after the corruption reads `ok` here, in both."""
    out = atwin(lambda pkg: drill(pkg, pinned(pkg, population=2), users=30))
    assert (out["green"], out["red"][0], out["mutated"]) == ("ok", "ok", 4)
    assert out["verdicts"] == []


def test_canary_bucket_rate_bound_and_stopped_prober_health_twin():
    """A frozen canary bucket answers 429 past its tokens (counted in
    dds_canary_throttled_total) while /health stays reachable; a wired but
    stopped prober's /health section reads "disabled" and /canary serves
    its report."""

    async def scenario(pkg):
        metrics = mod(pkg, "obs.metrics").metrics
        async with canary_stack(pkg) as (server, _):
            out = [json.loads((await req(pkg, server, "GET", "/health"))[1])["canary"]]
            server._canary_bucket.rate = 0.0
            server._canary_bucket._tokens = 2.0
            before = metrics.value("dds_canary_throttled_total", route="GetSet") or 0
            out.append([(await req(pkg, server, "GET", "/GetSet/nokey", tenant=CANARY))[0]
                        for _ in range(6)])
            out.append((metrics.value("dds_canary_throttled_total", route="GetSet") or 0)
                       - before)
            out.append((await req(pkg, server, "GET", "/health", tenant=CANARY))[0])
            h, *_ = helio(pkg)
            server.heliograph = h
            _, health = await req(pkg, server, "GET", "/health")
            _, canary = await req(pkg, server, "GET", "/canary")
            server.heliograph = None
            out += [json.loads(health)["canary"], json.loads(canary)]
            return out

    out = atwin(scenario)
    assert out[0] == {"status": "disabled"} and out[1].count(429) == 4 and out[2] == 4
    assert out[3] == 200 and out[4] == {"status": "disabled"}
    assert out[5]["enabled"] is True and out[5]["cycles"] == 0
