"""`configs/heliograph.toml` launched by each package, exactly alike.

Both packages launch the file as it stands on the CPU (`[proxy] port =
0`; the port also with `device` and `crypto-backend` on the CPU), with
the same failing transport for its `east` and `west` targets (a
resolver that knows neither name: no lookup leaves the host), the
prober's loop held idle and its cycles driven by the test in the loop's
own order (loopback, east, west, ...) on one fake clock and one seeded
rng, with the same keys, salt, trace ids and ciphertexts. The verdicts by
kind and target, the `/canary` report, `/health`'s canary section, the
`dds_canary_*` series of `/metrics`, the `canary.<kind>` streams of
`/slo` and `unreachable_regions()` are equal, east and west reaching
their streak of 3. The drill then corrupts the canary's first PSSE
ciphertext on every replica: within three loopback cycles (a cached row
is served until the cache audit samples it) the sum probe reads
`wrong_answer`, and the process-wide Watchtower holds only
`canary_wrong_answer` verdicts, one with `/canary`'s exemplar trace id,
in both. A user's SumAll over its own rows through the same edge excludes
the canary's, and `stop` leaves no prober task behind.
"""

import asyncio
import importlib
import json
import pathlib
import random
import socket

import pytest

from dds_tpu_torch import convert

ROOT = pathlib.Path(__file__).resolve().parent.parent
BOUND = 90.0
UNRESOLVED = ("proxy-east", "proxy-west")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class FakeClock:
    def __init__(self, t: float = 5000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def keys_json():
    return mod("dds_tpu", "models.keys").HEKeys.generate(256, 512).to_json()


class Pinned:
    """A provider whose rows are the reference's encryptions, once each."""

    def __init__(self, provider, ref, table: dict):
        self._p, self._ref, self._table = provider, ref, table

    def encrypt_row(self, row, until, schema):
        key = (json.dumps(row), until, tuple(schema))
        if key not in self._table:
            self._table[key] = self._ref.encrypt_row(row, until, schema)
        return list(self._table[key])

    def __getattr__(self, name):
        return getattr(self._p, name)


@pytest.fixture
def pinned_launch(monkeypatch, keys_json):
    """`launch(pkg)` boots heliograph.toml with the idle prober loop and
    the failing transport, then pins the prober's client, clock and rng."""
    ref_provider = mod("dds_tpu", "models.facade").HomoProvider(
        mod("dds_tpu", "models.keys").HEKeys.from_json(keys_json))
    table: dict = {}
    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)

    async def idle(self):
        await asyncio.Event().wait()

    def launch_for(pkg: str):
        C, H = mod(pkg, "clt.canary"), mod(pkg, "obs.heliograph")
        real = C.http_request

        async def transport(host, port, *a, **kw):
            if host in UNRESOLVED:
                raise socket.gaierror(socket.EAI_NONAME, "Name or service not known")
            return await real(host, port, *a, **kw)

        monkeypatch.setattr(C, "http_request", transport)
        monkeypatch.setattr(H.Heliograph, "_run", idle)

        async def launch():
            cfg = mod(pkg, "utils.config").DDSConfig.load(ROOT / "configs" / "heliograph.toml")
            cfg.proxy.port = 0
            if pkg == "dds_tpu_torch":
                cfg.proxy.device = "cpu"
                cfg.proxy.crypto_backend = "cpu"
            dep = await mod(pkg, "run").launch(cfg)
            h = dep.server.heliograph
            keys = (mod(pkg, "models.keys").HEKeys.from_json(keys_json) if pkg == "dds_tpu"
                    else convert.keys_from_reference(keys_json))
            provider = Pinned(mod(pkg, "models.facade").HomoProvider(keys), ref_provider, table)
            h.client = C.CanaryClient(provider, population=cfg.heliograph.population,
                                      timeout=cfg.heliograph.deadline)
            h.client.salt = "5a175a175a175a17"
            h.client.rows = [h.client._row(i) for i in range(h.client.population)]
            n = iter(range(1, 10_000))
            h.client.mint_trace = lambda: f"probe-{next(n):04d}"
            clock = FakeClock()
            h.clock = h.ledger._clock = clock
            h.rng = random.Random(16)
            return dep, h, clock

        return launch

    return launch_for


async def cycle(h, clock, target=None) -> None:
    """One turn of the prober's loop: the next target (or `target`), then
    the jittered sleep on the fake clock."""
    await h.run_cycle(target or h.targets[h.cycles % len(h.targets)])
    h.cycles += 1
    clock.advance(h.next_delay())


def unport(obj, port: int):
    return json.loads(json.dumps(obj).replace(f":{port}", ":PORT"))


async def get(pkg: str, port: int, target: str, obj=None, method=None, tenant=None):
    http = mod(pkg, "http.miniserver")
    body = json.dumps(obj).encode() if obj is not None else None
    return await http.http_request(
        "127.0.0.1", port, method or ("POST" if obj is not None else "GET"), target, body,
        headers={"x-dds-tenant": tenant} if tenant else None, timeout=10.0)


def test_heliograph_toml_verdicts_reports_streaks_and_drill_twin(pinned_launch):
    async def scenario(pkg):
        random.seed(16)  # the aggregate cache audit's samples
        mod(pkg, "obs.metrics").metrics.reset()  # series of earlier tests in the process
        watchtower = mod(pkg, "obs.watchtower").watchtower
        # the audit ledger of earlier tests in the process: the reference's
        # launch configures the process-wide auditor without a reset, and a
        # key's tag history from another deployment (drive's "nope") reads
        # as a tag_monotonicity violation here
        watchtower.reset()
        dep, h, clock = await pinned_launch(pkg)()
        port = dep.server.cfg.port
        out = {"targets": [(t.label, t.region) for t in h.targets], "cycles": []}
        try:
            for _ in range(9):
                await cycle(h, clock)
                out["cycles"].append(sorted(
                    (k, r.target, r.verdict) for k, r in h.ledger._last.items()))
            out["regions"] = sorted(h.unreachable_regions())
            _, canary = await get(pkg, port, "/canary")
            _, health = await get(pkg, port, "/health")
            _, text = await get(pkg, port, "/metrics")
            _, slo = await get(pkg, port, "/slo")
            out["canary"] = json.loads(canary)
            out["health"] = json.loads(health)["canary"]
            out["series"] = sorted({ln.split("{")[0].split(" ")[0]
                                    for ln in text.decode().splitlines()
                                    if ln.startswith("dds_canary_")})
            out["slo"] = sorted(r for r in json.loads(slo)["slo"]["routes"]
                                if r.startswith("canary."))
            # the drill on the canary's first PSSE ciphertext
            H = mod(pkg, "obs.heliograph")
            out["mutated"] = H.seed_ciphertext_corruption(dep.replicas, h.client.keys[0], 2)
            # loopback cycles until the sum probe reads it: a cached row is
            # served until the cache audit samples it (at most 3 here)
            for n in range(1, 4):
                await cycle(h, clock, h.targets[0])
                if h.ledger.last("sum").verdict == "wrong_answer":
                    break
            out["drill"] = [n, h.ledger.last("sum").verdict]
            _, canary = await get(pkg, port, "/canary")
            out["canary_after"] = json.loads(canary)
            await dep.net.quiesce()
            out["violations"] = [(v.invariant, v.trace_id, v.detail)
                                 for v in watchtower.verdicts()]
            # a user's rows through the same edge: its SumAll folds them alone
            p = h.client.provider
            rows = [[7 + i, f"user-{i}", 1000 * (i + 1), 5, "a", "b", "c", f"blob-{i}"]
                    for i in range(3)]
            for row in rows:
                await get(pkg, port, "/PutSet",
                          {"contents": p.encrypt_row(row, 8, h.client.schema)})
            status, body = await get(
                pkg, port, f"/SumAll?position=2&nsqr={p.keys.psse.public.nsquare}")
            out["user_sum"] = (status, p.decrypt(json.loads(body)["result"], "PSSE"))
        finally:
            await dep.stop()
        task_mod = mod(pkg, "utils.tasks")
        out["leaked"] = [t.get_name() for t in getattr(task_mod, "_TASKS", set())
                         if not t.done() and t.get_name() == "heliograph"]
        return unport(out, port)

    ref = asyncio.run(asyncio.wait_for(scenario("dds_tpu"), BOUND))
    port = asyncio.run(asyncio.wait_for(scenario("dds_tpu_torch"), BOUND))
    assert port == ref
    assert port["regions"] == ["east", "west"]
    assert port["canary"]["region_streaks"] == {"east": 3, "west": 3}
    assert port["cycles"][0] == [[k, "127.0.0.1:PORT", "ok"]
                                 for k in ("matvec", "mult", "putget", "search", "sum")]
    assert port["health"]["status"] == "failing"  # putget's last verdict: west unreachable
    assert port["series"] == ["dds_canary_exemplar", "dds_canary_last_ok_age_seconds",
                              "dds_canary_probe_seconds_bucket",
                              "dds_canary_probe_seconds_count",
                              "dds_canary_probe_seconds_sum", "dds_canary_probes_total",
                              "dds_canary_region_unreachable", "dds_canary_verdict"]
    assert port["slo"] == [f"canary.{k}" for k in ("matvec", "mult", "putget", "search",
                                                   "sum")]
    assert port["mutated"] == 4 and port["drill"][1] == "wrong_answer"
    trace = port["canary_after"]["kinds"]["sum"]["last_failure"]["trace_id"]
    # one kind of violation: the sum probe's, and the matvec probe's over
    # the same corrupted row
    assert {v[0] for v in port["violations"]} == {"canary_wrong_answer"}
    assert trace in [v[1] for v in port["violations"] if v[2]["probe"] == "sum"]
    assert port["user_sum"] == [200, 6000] and port["leaked"] == []
