"""The port's supervisor, spares and byzantine replicas against the
reference's (`dds_tpu/core/supervisor.py`, `replica.py`).

Each case builds the same in-process cluster in both packages — 7 active
replicas, 2 sentinent spares, quorum 5, the supervisor's `_rng` and the
client's coordinator rng seeded alike — drives the same operations, and
holds the port to the reference exactly: equal membership lists, equal
repositories (tags and values), equal client answers. The cases twin the
reference's own (`tests/test_core.py`: byzantine minority and coordinator,
suspicion quorum, recovery preserving data, the proactive loop, the
freshest half, a dead spare, concurrent suspects), and the seeded
scenario: compromise one replica, let the suspicion quorum recover it,
compare everything after `wait_recovery_idle`; a crashed replica
redeployed; then the quorum client's circuit breakers (the state machine
on a stepped clock, timeouts tripping one, the all-open fast-fail) and
`ActiveReplicas` taken from the supervisor only. Every case is bounded by
`asyncio.wait_for`.
"""

import asyncio
import importlib
import random

import pytest

PACKAGES = ("dds_tpu", "dds_tpu_torch")
BOUND = 30.0  # seconds: every case's asyncio.wait_for


def mods(pkg: str):
    class _M:
        pass

    m = _M()
    m.M = importlib.import_module(f"{pkg}.core.messages")
    m.errors = importlib.import_module(f"{pkg}.core.errors")
    m.qc = importlib.import_module(f"{pkg}.core.quorum_client")
    m.rep = importlib.import_module(f"{pkg}.core.replica")
    m.sup = importlib.import_module(f"{pkg}.core.supervisor")
    m.net = importlib.import_module(f"{pkg}.core.transport")
    m.sigs = importlib.import_module(f"{pkg}.utils.sigs")
    return m


class Cluster:
    """n active replicas + spares, a supervisor and one client, the
    reference's test cluster in either package."""

    def __init__(self, pkg: str, n_active=7, n_sentinent=2, quorum=5,
                 proactive=False, sup_seed=3, client_seed=7):
        m = self.m = mods(pkg)
        self.net = m.net.InMemoryNet()
        self.rcfg = m.rep.ReplicaConfig(quorum_size=quorum)
        all_addrs = [f"replica-{i}" for i in range(n_active + n_sentinent)]
        self.active = all_addrs[:n_active]
        self.sentinent = all_addrs[n_active:]
        self.replicas = {
            a: m.rep.BFTABDNode(a, all_addrs, "supervisor", self.net, self.rcfg)
            for a in all_addrs
        }
        for a in self.sentinent:
            self.replicas[a].behavior = "sentinent"
        self.supervisor = m.sup.BFTSupervisor(
            "supervisor", self.active, self.sentinent, self.net,
            m.sup.SupervisorConfig(
                quorum_size=quorum,
                proactive_recovery_enabled=proactive,
                proactive_recovery_warmup=0.05,
                proactive_recovery_interval=0.1,
                sentinent_awake_timeout=0.5,
                crashed_recovery_timeout=2.0,
            ),
            redeploy=self._redeploy,
            rng=random.Random(sup_seed),
        )
        self.client = m.qc.AbdClient(
            "proxy-0", self.net, self.active,
            m.qc.AbdClientConfig(request_timeout=1.0, quorum_size=quorum),
        )
        self.client.replicas._rng = random.Random(client_seed)

    async def _redeploy(self, endpoint):
        self.replicas[endpoint] = self.m.rep.BFTABDNode(
            endpoint, list(self.replicas), "supervisor", self.net, self.rcfg
        )

    async def write(self, value):
        key = self.m.sigs.key_from_set(value)
        await self.client.write_set(key, value)
        return key

    def view(self) -> dict:
        """Everything the twins compare: membership, behaviours, and each
        replica's repository as plain tuples."""
        return {
            "active": [a for a, _ in self.supervisor.active],
            "sentinent": list(self.supervisor.sentinent),
            "behavior": {a: r.behavior for a, r in self.replicas.items()},
            "repos": {a: {k: ((t.seq, t.id), v) for k, (t, v) in r.repository.items()}
                      for a, r in self.replicas.items()},
        }


def both(fn):
    """Run the async scenario `fn(pkg)` in each package, bounded; returns
    {pkg: result}."""
    return {pkg: asyncio.run(asyncio.wait_for(fn(pkg), BOUND)) for pkg in PACKAGES}


def rows(n: int, seed: int) -> list:
    rng = random.Random(seed)
    return [[i, f"v-{rng.randrange(10 ** 6)}", rng.randrange(1 << 40)] for i in range(n)]


# ------------------------------------------------------ reference-case twins


def test_byzantine_minority_tolerated_twin():
    async def go(pkg):
        c = Cluster(pkg)
        victims = ["replica-5", "replica-6"]
        for v in victims:
            c.net.send("trudy", v, c.m.M.Compromise())
        await c.net.quiesce()
        c.client.replicas.reset([a for a in c.active if a not in victims])
        key = await c.write([7, "x"])
        got = await c.client.fetch_set(key)
        await c.net.quiesce()
        return got, c.view()["behavior"]

    out = both(go)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    assert out["dds_tpu_torch"][0] == [7, "x"]
    assert out["dds_tpu_torch"][1]["replica-5"] == "byzantine"


def test_byzantine_coordinator_detected_twin():
    async def go(pkg):
        c = Cluster(pkg)
        c.client.replicas.reset(["replica-0"])  # force coordinator choice
        c.net.send("trudy", "replica-0", c.m.M.Compromise())
        await c.net.quiesce()
        with pytest.raises((c.m.errors.ByzantineError, asyncio.TimeoutError)) as e:
            await c.client.fetch_set("ANYKEY")
        return type(e.value).__name__, c.client.replicas.suspicions()["replica-0"]

    out = both(go)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    assert out["dds_tpu_torch"][1] >= 1


def test_suspicion_quorum_triggers_recovery_twin():
    async def go(pkg):
        c = Cluster(pkg)
        for i in range(5):
            c.net.send(f"replica-{i}", "supervisor",
                       c.m.M.Suspect("replica-6", c.m.sigs.generate_nonce()))
        await c.net.quiesce()
        assert await c.supervisor.wait_recovery_idle(5.0)
        await c.net.quiesce()
        return c.view()

    out = both(go)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    view = out["dds_tpu_torch"]
    assert "replica-6" in view["sentinent"] and "replica-6" not in view["active"]
    assert len(view["active"]) == 7 and view["behavior"]["replica-6"] == "sentinent"


def test_recovery_preserves_data_twin():
    async def go(pkg):
        c = Cluster(pkg)
        key = await c.write([9, "persist"])
        await c.net.quiesce()
        await c.supervisor.recover("replica-0")
        await c.net.quiesce()
        got = await c.client.fetch_set(key)
        await c.net.quiesce()
        return got, c.view()

    out = both(go)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    got, view = out["dds_tpu_torch"]
    assert got == [9, "persist"]
    assert [v for _, v in view["repos"]["replica-0"].values()] == [[9, "persist"]]


def test_proactive_recovery_loop_twin():
    """Timer-driven, so the swap count depends on the clock: both packages
    must preserve the membership sizes and swap at least once."""

    async def go(pkg):
        c = Cluster(pkg, proactive=True)
        c.supervisor.start()
        await asyncio.sleep(0.4)
        await c.supervisor.stop()
        await c.net.quiesce()
        return c.view()

    out = both(go)
    for view in out.values():
        assert len(view["active"]) == 7 and len(view["sentinent"]) == 2
        assert view["active"] != [f"replica-{i}" for i in range(7)]


def test_request_replicas_returns_freshest_half_twin():
    async def go(pkg):
        c = Cluster(pkg)
        got = []

        async def catcher(sender, msg):
            got.append(msg)

        c.net.register("observer", catcher)
        c.net.send("observer", "supervisor", c.m.M.RequestReplicas())
        await c.net.quiesce()
        return type(got[0]).__name__, got[0].replicas

    out = both(go)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    assert out["dds_tpu_torch"] == ("ActiveReplicas", ["replica-6", "replica-5", "replica-4"])


def test_dead_spare_deprioritized_and_next_spare_used_twin():
    async def go(pkg):
        c = Cluster(pkg)
        c.supervisor.cfg.sentinent_awake_timeout = 0.2
        c.net.unregister("replica-7")  # cannot Awake
        c.supervisor._rng.choice = lambda seq: sorted(seq)[0]
        await c.supervisor.recover("replica-0")
        first = c.view()
        strikes = dict(c.supervisor._strikes)
        await c.supervisor.recover(first["active"][0])
        return first, strikes, c.view(), dict(c.supervisor._strikes)

    out = both(go)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    first, strikes, later, strikes2 = out["dds_tpu_torch"]
    assert "replica-7" in first["sentinent"] and strikes == {"replica-7": 1}
    assert "replica-8" in first["active"] and "replica-0" in first["sentinent"]
    assert "replica-7" in later["sentinent"] and strikes2 == {"replica-7": 1}


def test_concurrent_suspects_single_recovery_twin():
    async def go(pkg):
        c = Cluster(pkg)
        for _ in range(3):
            for i in range(7):
                c.net.send(f"replica-{i}", "supervisor",
                           c.m.M.Suspect("replica-6", c.m.sigs.generate_nonce()))
        await c.net.quiesce()
        assert await c.supervisor.wait_recovery_idle(5.0)
        await c.net.quiesce()
        view = c.view()
        await c.supervisor.recover("proxy-0")  # not an active endpoint
        return view, len(c.supervisor.active)

    out = both(go)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    view, n = out["dds_tpu_torch"]
    assert len(view["active"]) == len(set(view["active"])) == 7 == n
    assert len(view["sentinent"]) == 2


# ------------------------------------------------------------ seeded scenario


@pytest.mark.parametrize("victim,sup_seed", [("replica-2", 3), ("replica-5", 11)])
def test_seeded_compromise_scenario_equal_across_packages(victim, sup_seed):
    """7 active + 2 spares, the same seeded writes, the same replica
    compromised; the healthy replicas' suspicion votes (the reference's
    quorum of 5 distinct voters) recover it. After wait_recovery_idle the
    active and sentinent lists and every replica's repository are equal
    across the packages, and the recovered replica holds the honest
    state."""

    async def go(pkg):
        c = Cluster(pkg, sup_seed=sup_seed)
        keys = [await c.write(r) for r in rows(12, 5)]
        await c.net.quiesce()
        c.net.send("trudy", victim, c.m.M.Compromise())
        await c.net.quiesce()
        # five honest replicas catch the victim in protocol rounds
        voters = [a for a in c.active if a != victim][:5]
        for v in voters:
            c.net.send(v, "supervisor",
                       c.m.M.Suspect(victim, c.m.sigs.generate_nonce()))
        await c.net.quiesce()
        assert await c.supervisor.wait_recovery_idle(5.0)
        await c.net.quiesce()
        reads = [await c.client.fetch_set(k) for k in keys]
        await c.net.quiesce()
        return reads, c.view()

    out = both(go)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    reads, view = out["dds_tpu_torch"]
    assert reads == rows(12, 5)
    assert victim in view["sentinent"] and view["behavior"][victim] == "sentinent"
    honest = view["repos"]["replica-0" if victim != "replica-0" else "replica-1"]
    tracked = {k: e for k, e in view["repos"][victim].items() if e[1] is not None}
    assert tracked == {k: e for k, e in honest.items() if e[1] is not None}


def test_crashed_replica_redeployed_and_reseeded_twin():
    """Trudy's Crash silences a replica; recovering it times out its seed,
    redeploys a fresh node through the factory and reseeds that one."""

    async def go(pkg):
        c = Cluster(pkg)
        c.supervisor.cfg.sentinent_awake_timeout = 0.2
        keys = [await c.write(r) for r in rows(6, 9)]
        await c.net.quiesce()
        old = c.replicas["replica-1"]
        c.net.send("trudy", "replica-1", c.m.M.Crash())
        await c.net.quiesce()
        assert not c.net.has_endpoint("replica-1")
        await c.supervisor.recover("replica-1")
        await c.net.quiesce()
        assert c.replicas["replica-1"] is not old and c.net.has_endpoint("replica-1")
        reads = [await c.client.fetch_set(k) for k in keys]
        await c.net.quiesce()
        return reads, c.view()

    out = both(go)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    reads, view = out["dds_tpu_torch"]
    assert reads == rows(6, 9)
    assert "replica-1" in view["sentinent"]
    assert view["behavior"]["replica-1"] == "sentinent"


# --------------------------------------------- the quorum client's breakers


def test_circuit_breaker_state_machine_twin():
    """closed -> open after 3 failures -> half-open after the reset ->
    one success closes, one failure re-opens; the same states, ETAs and
    admissions in both packages on a stepped clock."""
    out = {}
    for pkg in PACKAGES:
        retry = importlib.import_module(f"{pkg}.utils.retry")
        now = [0.0]
        b = retry.CircuitBreaker(3, 2.0, clock=lambda: now[0], name="r0")
        trace = []
        for step, dt in (("f", 0), ("f", 0.1), ("s", 0.1), ("f", 0), ("f", 0), ("f", 0),
                         ("-", 0.5), ("-", 1.6), ("f", 0), ("-", 2.0), ("s", 0)):
            now[0] += dt
            if step == "f":
                b.record_failure()
            elif step == "s":
                b.record_success()
            trace.append((b.state, b.allow(), round(b.half_open_eta(), 6)))
        out[pkg] = trace
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    assert ("open", False, 2.0) in out["dds_tpu_torch"]
    assert out["dds_tpu_torch"][-1] == ("closed", True, 0.0)


def test_breakers_trip_on_timeouts_then_fast_fail_twin():
    """A silent coordinator's ask timeouts trip its breaker (no suspicion
    strike); once every trusted coordinator's breaker is open past the
    caller's budget the client raises AllBreakersOpenError at once."""

    async def go(pkg):
        c = Cluster(pkg)
        retry = importlib.import_module(f"{pkg}.utils.retry")
        c.client.cfg.request_timeout = 0.05
        c.client.cfg.breaker_reset = 30.0
        c.client.replicas.reset(["replica-0"])
        c.net.unregister("replica-0")
        kinds = []
        for _ in range(3):
            try:
                await c.client.fetch_set("K", deadline=retry.Deadline(1.0))
            except Exception as e:  # noqa: BLE001 - the twin compares the kinds
                kinds.append(type(e).__name__)
        with pytest.raises(c.m.errors.AllBreakersOpenError) as err:
            await c.client.fetch_set("K", deadline=retry.Deadline(1.0))
        return (kinds, c.client.breaker_states(), c.client.replicas.suspicions(),
                err.value.targets, err.value.eta > 29.0)

    out = both(go)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    kinds, states, strikes, targets, eta_ok = out["dds_tpu_torch"]
    assert kinds == ["TimeoutError"] * 3 and states == {"replica-0": "open"}
    assert strikes == {"replica-0": 0} and targets == 1 and eta_ok


def test_active_replicas_accepted_from_the_supervisor_only_twin():
    async def go(pkg):
        c = Cluster(pkg)
        c.client.cfg.supervisor = "supervisor"
        c.client.replicas.reset(["replica-0"])
        c.net.send("intruder", "proxy-0", c.m.M.ActiveReplicas(["evil-1"]))
        await c.net.quiesce()
        after_intruder = c.client.replicas.get_all()
        c.client.refresh_from("supervisor")
        await c.net.quiesce()
        return after_intruder, c.client.replicas.get_all(), c.client._preferred

    out = both(go)
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    after_intruder, merged, preferred = out["dds_tpu_torch"]
    assert after_intruder == ["replica-0"]
    assert merged == ["replica-0", "replica-6", "replica-5", "replica-4"]
    assert preferred == ["replica-6", "replica-5", "replica-4"]
