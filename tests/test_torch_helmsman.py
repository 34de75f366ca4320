"""The port's Helmsman (`dds_tpu_torch/fleet/`) and its reshape surface
against the reference's (`tests/test_helmsman.py`'s cases, twinned).

The decision tick: the same signal sequence through both packages'
`Helmsman` on one fake clock gives the same actions, step results,
history, reports, `dds_helmsman_*` values and flight records (hot-streak
split and cooldown, cold-streak merge only when calm and unshedded, the
migrated-bytes budget, pin, busy and a failed action, dead-group
promotion while pinned, `from_config`). The plan journal round-trips and
crosses between the packages, and `Rebalancer.recover` rolls a plan
interrupted before its commit back and one from its commit forward in
both. On Constellations of both packages: a merge end to end with the
warm standby reused by the next split, a takeover of a dead group onto a
standby, `POST /_reshard` (serialized, idempotent, the honest 409 with
Retry-After) with `POST /_helmsman`'s pin in /health, statuses and
bodies equal; and a group killed mid-split and mid-merge, whose plans
roll back and whose fence leases heal it, after which SumAll and
SearchEq answer as an undisturbed twin fleet does, in both packages.
"""

import asyncio
import json

import pytest

from tests.test_torch_rebalance import PKGS, SECRET, constellation, mod, recording_flight, twin


# ----------------------------------------------------------- decision tick


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class Sim:
    """The reference's hand-cranked signal/action bench, in one package:
    mutate the public fields, `await step()`, read `actions`."""

    def __init__(self, pkg: str, **kw):
        aborted = mod(pkg, "shard").ReshardAborted
        self.metrics = mod(pkg, "obs.metrics").metrics
        self.clock = Clock()
        self.census = {"s0": 0, "s1": 0}
        self.alerts, self.shed, self.ages = [], 0, {}
        self.moved, self.busy, self.fail_actions = 0, False, False
        self.actions, self.steps = [], []

        async def act(kind, gid):
            if self.fail_actions:
                raise aborted(f"injected {kind} failure")
            self.actions.append((kind, gid))
            self.moved += 1024

        kw.setdefault("hot_streak", 3)
        kw.setdefault("cold_streak", 4)
        kw.setdefault("min_ops", 20)
        kw.setdefault("cooldown", 30.0)
        kw.setdefault("max_groups", 4)
        self.hm = mod(pkg, "fleet").Helmsman(
            load_census=lambda: dict(self.census),
            slo_alerts=lambda: list(self.alerts),
            shed_level=lambda: self.shed,
            source_ages=lambda: dict(self.ages),
            split=lambda g: act("split", g),
            merge=lambda g: act("merge", g),
            promote=lambda g: act("promote", g),
            moved_bytes=lambda: self.moved,
            reshard_busy=lambda: self.busy,
            clock=self.clock,
            **kw,
        )

    def load(self, **ops):
        for gid, n in ops.items():
            self.census[gid] = self.census.get(gid, 0) + n

    async def step(self):
        got = await self.hm.step()
        self.steps.append(got)
        return got


def flight_records(directory) -> list:
    """(kind, info) of every incident filed in `directory`, in order."""
    if not directory.exists():
        return []
    out = []
    for p in sorted(directory.glob("incident-*.jsonl"), key=lambda p: p.name.split("-")[2]):
        header = json.loads(p.read_text().splitlines()[0])
        out.append((header["incident"], header["info"]))
    return out


def sim_twin(body, tmp_path, **kw):
    """`body(sim)` on a Sim of each package (the reference's assertions
    inside); the steps, actions, history, report, helmsman series and
    flight records equal."""
    outs = {}
    for pkg in PKGS:
        with recording_flight(pkg, tmp_path / pkg):
            sim = Sim(pkg, **kw)
            before = {a: sim.metrics.value("dds_helmsman_actions_total", action=a) or 0
                      for a in ACTIONS}
            asyncio.run(body(sim))
            outs[pkg] = {
                "steps": sim.steps, "actions": sim.actions,
                "history": list(sim.hm.history), "report": sim.hm.report(),
                "counted": {a: (sim.metrics.value("dds_helmsman_actions_total", action=a)
                                or 0) - n for a, n in before.items()},
                "budget_exhausted": sim.metrics.value("dds_helmsman_budget_exhausted"),
                "flight": flight_records(tmp_path / pkg),
            }
    assert outs["dds_tpu_torch"] == outs["dds_tpu"]
    return outs["dds_tpu_torch"]


ACTIONS = ("split", "split_done", "split_failed", "merge", "merge_done", "promote",
           "promote_failed", "pin", "unpin")


async def splits_hot_group_after_streak_and_cools_down(sim):
    hm = sim.hm
    sim.alerts = ["write_availability"]
    for _ in range(2):
        sim.load(s0=10, s1=90)
        sim.clock.t += 5
        assert await sim.step() is None
    sim.load(s0=10, s1=90)
    sim.clock.t += 5
    assert await sim.step() == "split"
    assert sim.actions == [("split", "s1")]
    sim.load(s0=10, s1=90)
    sim.clock.t += 5
    assert await sim.step() is None
    sim.clock.t += 40
    sim.alerts = []
    sim.load(s0=50, s1=50)
    assert await sim.step() is None
    sim.alerts = ["write_availability"]
    for _ in range(2):
        sim.load(s0=5, s1=95)
        sim.clock.t += 5
        assert await sim.step() is None
    sim.load(s0=5, s1=95)
    assert await sim.step() == "split"
    sim.clock.t += 40
    for _ in range(4):
        sim.load(s1=5)
        sim.clock.t += 5
        assert await sim.step() is None
    assert len(sim.actions) == 2 and hm.ticks == 12


async def merges_cold_group_only_when_calm_and_unshedded(sim):
    for _ in range(2):
        sim.load(s0=98, s1=2)
        sim.clock.t += 5
        assert await sim.step() is None
    sim.load(s0=98, s1=2)
    assert await sim.step() == "merge"
    assert sim.actions == [("merge", "s1")]
    sim.clock.t += 40
    sim.shed = 1
    for _ in range(5):
        sim.load(s0=98, s1=2)
        sim.clock.t += 5
        assert await sim.step() is None
    sim.shed = 0
    sim.alerts = ["latency"]
    for _ in range(5):
        sim.load(s0=98, s1=2)
        sim.clock.t += 5
        assert await sim.step() is None
    assert len(sim.actions) == 1


async def budget_pin_busy_and_failed_action(sim):
    hm = sim.hm
    sim.alerts = ["burn"]

    async def hot_tick():
        sim.load(s0=5, s1=95)
        sim.clock.t += 6
        return await sim.step()

    assert await hot_tick() == "split"
    assert await hot_tick() == "split"
    assert hm.budget_remaining() == 0
    assert await hot_tick() is None
    assert sim.metrics.value("dds_helmsman_budget_exhausted") == 1
    sim.clock.t += 200
    assert await hot_tick() == "split"
    hm.pin()
    assert await hot_tick() is None
    assert hm.report()["pinned"]
    hm.unpin()
    sim.busy = True
    assert await hot_tick() is None
    sim.busy = False
    n = len(sim.actions)
    sim.fail_actions = True
    assert await hot_tick() is None
    assert any(r["action"] == "split_failed" for r in hm.history)
    sim.fail_actions = False
    sim.load(s0=5, s1=95)
    sim.clock.t += 1
    assert await sim.step() is None
    assert len(sim.actions) == n


async def promotes_dead_group_even_when_pinned(sim):
    hm = sim.hm
    hm.pin()
    sim.load(s0=50, s1=50)
    sim.ages = {"s0": 0.2, "s1": 40.0}
    assert await sim.step() == "promote"
    assert sim.actions == [("promote", "s1")]
    sim.clock.t += 5
    assert await sim.step() is None
    sim.ages = {"ghost": 99.0}
    sim.clock.t += 60
    assert await sim.step() is None
    sim.ages = {"s0": 50.0}
    sim.fail_actions = True
    sim.clock.t += 60
    assert await sim.step() is None
    assert any(r["action"] == "promote_failed" for r in hm.history)


async def lone_group_never_merges(sim):
    sim.census = {"s0": 0}
    sim.hm._last_counts = {"s0": 0}
    sim.load(s0=100)
    sim.clock.t += 5
    assert await sim.step() is None


TICKS = [
    (splits_hot_group_after_streak_and_cools_down, {}),
    (merges_cold_group_only_when_calm_and_unshedded, {"cold_streak": 3, "hot_streak": 99}),
    (lone_group_never_merges, {"cold_streak": 1, "min_groups": 1}),
    (budget_pin_busy_and_failed_action, {"hot_streak": 1, "budget_bytes": 2000,
                                         "budget_window": 100.0, "cooldown": 5.0}),
    (promotes_dead_group_even_when_pinned, {"heartbeat_timeout": 15.0, "cooldown": 10.0}),
]


@pytest.mark.parametrize("body,kw", TICKS, ids=[b.__name__ for b, _ in TICKS])
def test_decision_tick_twin(body, kw, tmp_path):
    out = sim_twin(body, tmp_path, **kw)
    # every decision is noted once: history, counter and flight record
    assert all(kind == "helmsman" for kind, _ in out["flight"])
    assert [info["action"] for _, info in out["flight"]] == \
        [r["action"] for r in out["history"]]
    assert sum(out["counted"].values()) == len(out["history"])


def test_from_config_and_report_shape_twin():
    reports = {}
    for pkg in PKGS:
        cfg = mod(pkg, "utils.config").HelmsmanConfig(hot_streak=7, budget_bytes=123, pin=True)
        hm = mod(pkg, "fleet").Helmsman.from_config(cfg, load_census=lambda: {})
        assert hm.hot_streak == 7 and hm.budget_bytes == 123 and hm.pinned
        reports[pkg] = {k: v for k, v in hm.report().items() if k != "cooldown_remaining"}
    assert reports["dds_tpu_torch"] == reports["dds_tpu"]
    assert {"pinned", "ticks", "budget_remaining_bytes", "recent"} <= set(reports["dds_tpu"])


# ------------------------------------------------------------ plan journal


def test_plan_journal_round_trips_and_crosses_between_packages(tmp_path):
    for writer, reader in (("dds_tpu", "dds_tpu_torch"), ("dds_tpu_torch", "dds_tpu")):
        d = tmp_path / writer
        W = mod(writer, "shard.rebalance").PlanJournal
        R = mod(reader, "shard.rebalance").PlanJournal
        j = W(str(d))
        assert j.load() is None
        j.write({"kind": "split", "phase": "freeze"})
        assert R(str(d)).load() == {"kind": "split", "phase": "freeze"}
        assert (d / "reshard_plan.json").read_bytes() == (d / "reshard_plan.json").read_bytes()
        j.path.write_text("{nope")
        assert R(str(d)).load() is None  # a corrupt file warns and reads None
        R(str(d)).clear()
        assert not j.path.exists()
        mem = R(None)
        mem.write({"a": 1})
        assert mem.load() == {"a": 1}
        mem.clear()
        assert mem.load() is None
    a, b = tmp_path / "a", tmp_path / "b"
    plan = {"kind": "merge", "source": "s1", "targets": ["s0"], "phase": "stream"}
    mod("dds_tpu", "shard.rebalance").PlanJournal(str(a)).write(plan)
    mod("dds_tpu_torch", "shard.rebalance").PlanJournal(str(b)).write(plan)
    assert (a / "reshard_plan.json").read_bytes() == (b / "reshard_plan.json").read_bytes()


def journal_plan(kind, source, targets, old, new, phase):
    return {"kind": kind, "source": source, "targets": targets,
            "old": old.to_wire(), "new": new.to_wire(), "phase": phase}


@pytest.mark.parametrize("phase,writer", [("stream", "dds_tpu"), ("stream", "dds_tpu_torch"),
                                          ("commit", "dds_tpu"), ("commit", "dds_tpu_torch")])
def test_recover_resolves_an_interrupted_plan_twin(phase, writer, tmp_path):
    """A crashed controller's merge plan of s1 into s0, journaled at
    `phase` by `writer`'s package: before the commit both packages roll
    back (the old map committed everywhere, no lease), from it they roll
    forward (the new map active, the broadcast run, the row kept), the
    journal cleared either way."""
    async def go(pkg):
        d = tmp_path / f"{writer}-{phase}-{pkg}"
        const, _ = constellation(pkg, S=2, journal_dir=str(d), fence_lease=30.0)
        old = const.manager.current()
        key = next(k for k in (f"RF{i}" for i in range(64)) if old.owner(k) == "s0")
        await const.router.write_set(key, ["kept"])
        new = old.merge("s1").sign(SECRET)
        for gid in ("s0", "s1"):
            if phase == "commit":
                const.group(gid).state.install(new)
            else:
                const.group(gid).state.install(new, lease=30.0)
        mod(writer, "shard.rebalance").PlanJournal(str(d)).write(
            journal_plan("merge", "s1", ["s0"], old, new, phase))
        seen = []
        const.rebalancer.on_activate = lambda m: seen.append(m.epoch)
        action = await const.rebalancer.recover(const.group)
        out = {"action": action, "epoch": const.manager.epoch, "broadcast": seen,
               "states": [(const.group(g).state.epoch, const.group(g).state.leased)
                          for g in ("s0", "s1")],
               "journal": mod(pkg, "shard.rebalance").PlanJournal(str(d)).load(),
               "read": await const.router.fetch_set(key),
               "again": await const.rebalancer.recover(const.group)}
        await const.stop()
        return out

    out = twin(go)
    if phase == "commit":
        assert out["action"] == "rollforward" and out["epoch"] == 2 and out["broadcast"] == [2]
    else:
        assert out["action"] == "rollback" and out["epoch"] == 1 and out["broadcast"] == []
        assert out["states"] == [(1, False), (1, False)]
    assert out["journal"] is None and out["again"] is None and out["read"] == ["kept"]


# ------------------------------------------------------- live merge + reuse


def test_merge_end_to_end_and_standby_reuse_twin():
    async def go(pkg):
        const, net = constellation(pkg, S=2)
        r = const.router
        keys = [f"MRG-{i}" for i in range(24)]
        for k in keys:
            await r.write_set(k, [k])
        out = {"owners": sorted({r.owner(k) for k in keys})}
        out["receivers"] = await const.merge("s1")
        out["after_merge"] = (const.gids, [g.gid for g in const.standbys],
                              const.manager.epoch)
        out["reads"] = [await r.fetch_set(k) for k in keys]
        await net.quiesce()
        victim = const.standbys[0]
        out["victim_holds"] = sum(1 for n in victim.replicas.values() for k in keys
                                  if n.repository.get(k, (None, None))[1] is not None)
        out["moved_bytes"] = const.rebalancer.moved_bytes_total
        out["moved_keys"] = const.rebalancer.last_moved_keys
        g = await const.split("s0")
        out["after_split"] = (g.gid, [s.gid for s in const.standbys], const.manager.epoch,
                              sorted({r.owner(k) for k in keys}))
        out["reads_after"] = [await r.fetch_set(k) for k in keys]
        await const.stop()
        return out

    out = twin(go)
    assert out["receivers"] == ["s0"] and out["after_merge"] == (["s0"], ["s1"], 2)
    assert out["reads"] == [[f"MRG-{i}"] for i in range(24)] == out["reads_after"]
    assert out["victim_holds"] == 0 and out["moved_bytes"] > 0
    assert out["after_split"] == ("s1", [], 3, ["s0", "s1"])


def test_promote_relabels_a_dead_group_onto_a_standby_twin(tmp_path):
    """`Constellation.promote`, the takeover Helmsman's liveness check
    calls: the dead group's slice is relabeled (same ring positions,
    epoch + 1) onto a fresh standby that serves it from empty; the other
    groups' rows stay; `takeover` is filed."""
    async def go(pkg):
        const, net = constellation(pkg, S=2)
        r = const.router
        keys = [f"P-{i}" for i in range(16)]
        for k in keys:
            await r.write_set(k, [k])
        old = const.manager.current()
        seen = []
        const.rebalancer.on_activate = lambda m: seen.append(m.epoch)
        with recording_flight(pkg, tmp_path / pkg):
            standby = await const.promote("s1")
        new = const.manager.current()
        out = {"standby": standby.gid, "gids": const.gids, "epoch": new.epoch,
               "broadcast": seen,
               "same_ring": [p for p, _ in new.vnodes] == [p for p, _ in old.vnodes],
               "owners": {k: r.owner(k) for k in keys},
               "reads": [await r.fetch_set(k) for k in keys],
               "incidents": sorted(p.name.split("-", 3)[-1]
                                   for p in (tmp_path / pkg).glob("incident-*"))}
        await r.write_set(keys[0] + "x", ["fresh"])
        out["fresh"] = await r.fetch_set(keys[0] + "x")
        await const.stop()
        return out

    out = twin(go)
    assert out["standby"] == "s2" and out["gids"] == ["s0", "s2"] and out["epoch"] == 2
    assert out["same_ring"] and out["broadcast"] == [2]
    assert out["incidents"] == ["takeover.jsonl"] and out["fresh"] == ["fresh"]
    # s0's rows stay; the relabeled slice restarts empty
    assert all(v == [k] for k, v in zip(out["owners"], out["reads"])
               if out["owners"][k] == "s0")


# -------------------------------------------------------- hardened /_reshard


def test_reshard_route_serialized_idempotent_and_pin_override_twin():
    async def go(pkg):
        mini = mod(pkg, "http.miniserver")
        server_mod = mod(pkg, "http.server")
        const, net = constellation(pkg, S=2)
        ctl = mod(pkg, "run").ConstellationReshard(const)
        gate = asyncio.Event()
        orig_split = ctl.split

        async def gated_split(source, target=None):
            await gate.wait()
            return await orig_split(source, target)

        ctl.split = gated_split
        hm = mod(pkg, "fleet").Helmsman(load_census=lambda: {})
        kw = {"port": 0, "reshard_route_enabled": True}
        if pkg == "dds_tpu_torch":
            kw["crypto_backend"] = "cpu"
        server = server_mod.DDSRestServer(const.router, server_mod.ProxyConfig(**kw),
                                          reshard=ctl, helmsman=hm)
        await server.start()
        port = server.cfg.port
        out = []

        async def post(path, obj):
            st, hdrs, body = await mini.http_request_full(
                "127.0.0.1", port, "POST", path, json.dumps(obj).encode(), timeout=30.0)
            return st, hdrs, json.loads(body) if body[:1] == b"{" else body.decode()

        try:
            first = asyncio.ensure_future(post("/_reshard", {"source": "s1"}))
            second = asyncio.ensure_future(post("/_reshard", {"source": "s1"}))
            await asyncio.sleep(0.1)
            out.append(("in flight", first.done(), second.done()))
            st, hdrs, body = await post("/_reshard", {"action": "merge", "source": "s0"})
            out.append(("busy", st, body, int(hdrs["retry-after"]) >= 1))
            gate.set()
            (st1, _, b1), (st2, _, b2) = await asyncio.gather(first, second)
            out.append(("attached", st1, st2, b1, b2, const.manager.epoch))
            for obj in ({"source": "s1", "target": "s2"}, {"action": "merge", "source": "s2"},
                        {"action": "merge", "source": "s2"}, {"action": "explode",
                                                              "source": "s1"},
                        {"action": "split"}, {"action": "split", "source": "s9"}):
                st, _, body = await post("/_reshard", obj)
                out.append((obj, st, body))
            st, _, body = await post("/_helmsman", {"pin": True})
            out.append(("pin", st, body["pinned"]))
            st, body = await mini.http_request("127.0.0.1", port, "GET", "/health",
                                               timeout=10.0)
            out.append(("health", st, json.loads(body)["helmsman"]["pinned"]))
            st, _, body = await post("/_helmsman", {"pin": False})
            out.append(("unpin", st, body["pinned"]))
            st, _, body = await post("/_helmsman", {"pin": "yes"})
            out.append(("bad pin", st))
        finally:
            await server.stop()
            await const.stop()
        return out

    out = twin(go)
    assert out[0] == ("in flight", False, False)
    assert out[1] == ("busy", 409, {"busy": {"action": "split", "source": "s1",
                                             "target": None}, "phase": None}, True)
    assert out[2][:3] == ("attached", 200, 200) and out[2][3] == out[2][4]
    assert out[2][3]["epoch"] == 2 and sorted(out[2][3]["groups"]) == ["s0", "s1", "s2"]
    assert [o[1] for o in out[3:9]] == [200, 200, 200, 400, 400, 400]
    assert out[3][2]["idempotent"] and out[5][2]["idempotent"] and out[4][2]["epoch"] == 3
    assert out[9:] == [("pin", 200, True), ("health", 200, True), ("unpin", 200, False),
                       ("bad pin", 400)]


# ------------------------------------------------------ crash-safe reshard


def test_crash_mid_split_and_mid_merge_answers_as_an_undisturbed_twin(tmp_path):
    """`tests/test_helmsman.py`'s crash twin in both packages: a group's
    process killed at the stream phase of a split (the target) and of a
    merge (the receiver) — its replicas partitioned off, its state refusing
    installs — so each plan aborts and rolls back, the dead group's fence
    lease heals it, the journal ends empty; then SumAll and SearchEq
    answer exactly as on an undisturbed fleet A/B pair, and the same in
    both packages."""
    ref_models = mod("dds_tpu", "models")
    he = ref_models.HEKeys.generate(paillier_bits=512, rsa_bits=512)
    pk = he.psse.public
    vals = [(7, "red"), (21, "blue"), (301, "red"), (44, "green"), (5, "red"), (600, "blue")]
    rows = [[str(pk.encrypt(v)), c] for v, c in vals]

    async def go(pkg):
        mini = mod(pkg, "http.miniserver")
        server_mod = mod(pkg, "http.server")
        chaos = mod(pkg, "core.chaos")
        shard = mod(pkg, "shard")
        SearchConfig = mod(pkg, "utils.config").SearchConfig

        async def build(tag):
            net = chaos.ChaosNet(mod(pkg, "core.transport").InMemoryNet(), seed=41)
            const, _ = constellation(pkg, S=2, net=net, seed=5, manifest_timeout=0.4,
                                     ack_timeout=0.3, fence_lease=1.0,
                                     journal_dir=str(tmp_path / pkg / tag))
            kw = {"port": 0, "crypto_backend": "cpu",
                  "search": SearchConfig(enabled=True, write_ingest=True,
                                         ingest_window=0.001)}
            if pkg == "dds_tpu_torch":
                kw["device"] = "cpu"
            server = server_mod.DDSRestServer(const.router, server_mod.ProxyConfig(**kw))
            await server.start()
            for row in rows:
                st, _ = await mini.http_request(
                    "127.0.0.1", server.cfg.port, "POST", "/PutSet",
                    json.dumps({"contents": row}).encode(), timeout=10.0)
                assert st == 200
            return net, const, server

        async def results(server):
            st, body = await mini.http_request(
                "127.0.0.1", server.cfg.port, "GET", f"/SumAll?position=0&nsqr={pk.nsquare}",
                timeout=30.0)
            assert st == 200
            total = json.loads(body)["result"]
            st, body = await mini.http_request(
                "127.0.0.1", server.cfg.port, "POST", "/SearchEq?position=1",
                json.dumps({"value": "red"}).encode(), timeout=30.0)
            assert st == 200
            return total, sorted(json.loads(body)["keyset"])

        def kill_at_stream(net, reb, state, replicas):
            orig_enter, orig_install = reb._enter, state.install

            def dead_install(m, force=False, lease=0.0):
                raise RuntimeError("group process is dead")

            def spy(phase, **info):
                orig_enter(phase, **info)
                if phase == "stream":
                    net.partition(replicas)
                    state.install = dead_install

            reb._enter = spy

            def revive():
                reb._enter = orig_enter
                state.install = orig_install
                net.heal_all()

            return revive

        netA, A, srvA = await build("A")
        netB, B, srvB = await build("B")
        out = {}
        try:
            old = A.manager.current()
            revived = []
            orig_acquire = A._acquire_standby

            def acquiring(gid=None):
                g = orig_acquire(gid)
                revived.append(kill_at_stream(netA, A.rebalancer, g.state,
                                              g.all_replicas()))
                return g

            A._acquire_standby = acquiring
            try:
                with pytest.raises(shard.ReshardAborted):
                    await A.split("s1")
            finally:
                A._acquire_standby = orig_acquire
            standby = A.standbys[0]
            out["split"] = (A.manager.current() is old, A.manager.state, standby.gid,
                            standby.state.leased)
            await asyncio.sleep(1.2)
            out["split_healed"] = (standby.state.leased, standby.state.epoch)
            revived[0]()
            s0 = A.group("s0")
            revive = kill_at_stream(netA, A.rebalancer, s0.state, s0.all_replicas())
            with pytest.raises(shard.ReshardAborted):
                await A.merge("s1")
            out["merge"] = (A.manager.current() is old, A.gids, s0.state.leased)
            await asyncio.sleep(1.2)
            out["merge_healed"] = (s0.state.leased, s0.state.epoch)
            revive()
            await netA.quiesce()
            out["journal"] = mod(pkg, "shard.rebalance").PlanJournal(
                str(tmp_path / pkg / "A")).load()
            out["A"], out["B"] = await results(srvA), await results(srvB)
        finally:
            netA.heal_all()
            for s in (srvA, srvB):
                await s.stop()
            for c in (A, B):
                await c.stop()
        return out

    out = twin(go)
    assert out["split"] == (True, "stable", "s2", True) and out["split_healed"] == (False, 1)
    assert out["merge"] == (True, ["s0", "s1"], True) and out["merge_healed"] == (False, 1)
    assert out["journal"] is None and out["A"] == out["B"]
    assert he.psse.decrypt(int(out["A"][0])) == sum(v for v, _ in vals) and out["A"][1]


# ------------------------------------------------- sharded.toml, launched


def test_sharded_toml_with_admin_routes_plan_dir_and_helmsman_launches_twin(tmp_path):
    """configs/sharded.toml with `[fabric] admin-routes`, `[shard]
    plan-dir` and `[helmsman] enabled` (pinned) launched by both packages:
    the controller reports through /health, POST /_reshard merges s3 away
    and splits s0 onto the warm standby by name (epochs 2 and 3), a replay
    answers the map, the journal directory ends empty, every row reads
    back and SumAll is the product of the rows; statuses and bodies equal."""
    from tests.test_torch_config import ROOT

    n2 = ((1 << 61) - 1) ** 2
    vals = [(i * 7919 + 11) % n2 for i in range(2, 34)]

    async def go(pkg):
        mini = mod(pkg, "http.miniserver")
        cfg = mod(pkg, "utils.config").DDSConfig.load(ROOT / "configs" / "sharded.toml")
        cfg.proxy.port = 0
        if pkg == "dds_tpu_torch":
            cfg.proxy.device = "cpu"
        cfg.fabric.admin_routes = True
        cfg.shard.plan_dir = str(tmp_path / pkg)
        cfg.helmsman.enabled = True
        cfg.helmsman.pin = True
        dep = await mod(pkg, "run").launch(cfg)
        port = dep.server.cfg.port
        out = []

        async def call(method, target, obj=None):
            st, body = await mini.http_request(
                "127.0.0.1", port, method, target,
                json.dumps(obj).encode() if obj is not None else None, timeout=30.0)
            return st, body

        try:
            keys = []
            for v in vals:
                st, key = await call("POST", "/PutSet", {"contents": [str(v)]})
                assert st == 200
                keys.append(key.decode())
            st, body = await call("GET", "/health")
            hm = json.loads(body)["helmsman"]
            out.append(("health", st, hm["pinned"], hm["recent"]))
            for obj in ({"action": "merge", "source": "s3"},
                        {"action": "split", "source": "s0", "target": "s3"},
                        {"action": "split", "source": "s0", "target": "s3"}):
                st, body = await call("POST", "/_reshard", obj)
                out.append((obj["action"], st, json.loads(body)))
            st, body = await call("POST", "/_helmsman", {"pin": True})
            out.append(("pin", st, json.loads(body)["pinned"]))
            reads = []
            for k in keys:
                st, body = await call("GET", f"/GetSet/{k}")
                reads.append((st, json.loads(body)["contents"]))
            out.append(("reads", reads == [(200, [str(v)]) for v in vals]))
            st, body = await call("GET", f"/SumAll?position=0&nsqr={n2}")
            want = 1
            for v in vals:
                want = want * v % n2
            out.append(("sumall", st, int(json.loads(body)["result"]) == want))
            out.append(("plan dir", sorted(p.name for p in (tmp_path / pkg).iterdir())
                        if (tmp_path / pkg).exists() else []))
            out.append(("groups", dep.constellation.gids,
                        [g.gid for g in dep.constellation.standbys]))
        finally:
            await dep.stop()
        return out

    out = twin(go)
    assert out[0] == ("health", 200, True, [])
    assert [o[1] for o in out[1:4]] == [200, 200, 200]
    assert out[1][2]["epoch"] == 2 and out[2][2]["epoch"] == 3 and out[3][2]["idempotent"]
    assert out[4:] == [("pin", 200, True), ("reads", True), ("sumall", 200, True),
                       ("plan dir", []), ("groups", ["s0", "s1", "s2", "s3"], [])]
