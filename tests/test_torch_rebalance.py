"""The port's live resharding (`dds_tpu_torch/shard/rebalance.py`, the
replicas' migration ingest, the Constellation's reshapes) against the
reference's.

The same seeded inputs go through both packages and must give the same
answers: the two migration frames' wire bytes; a receiving replica's
`_migrate_ingest` fed reordered, duplicated and missing chunks, an entry
attested by fewer than f + 1 signers, a forged value and an entry the
receiver does not own (the same repository and the same acks), and fed a
proactive recovery's frames under the same session id in one schedule
(`StateChunk.kind` alone keeps them apart); the abort of
`tests/test_shard.py` (the old map restored, the incident filed); the
live split of `tests/test_shard.py` under a ChaosNet partition that heals
mid-reshard, on the virtual clock of `tests/test_torch_linearizability.py`
(the reference's wall-clock test races the fence, so the twin compares
the virtual run's outcomes and fault trace, not the race); and the
proxy's owner memo across a reshape, which both packages key on the
validated pairs list's identity: with no write since the last aggregate,
a SumAll after a merge or split still groups its operands by the old
owners, and its product is still exact.
"""

import asyncio
import contextlib
import importlib
import json
import random

import numpy as np
import pytest

from tests.test_torch_linearizability import (
    Recorder,
    check_atomic_register,
    run_virtual,
    seeded,
)

SECRET = b"intranet-abd-secret"
PKGS = ("dds_tpu", "dds_tpu_torch")
BOUND = 60.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def twin(scenario, virtual: bool = False):
    """`scenario(pkg)` on both packages (a fresh loop each, the virtual
    clock's with `virtual`); equal observations."""
    def once(pkg):
        if virtual:
            return run_virtual(scenario(pkg))
        return asyncio.run(asyncio.wait_for(scenario(pkg), BOUND))

    ref, port = once("dds_tpu"), once("dds_tpu_torch")
    assert port == ref
    return port


@contextlib.contextmanager
def recording_flight(pkg: str, directory):
    """The package's process-wide flight recorder filing into `directory`
    without rate limiting; handed back as found, stamps cleared."""
    flight = mod(pkg, "obs.flight").flight
    saved = (flight.dir, flight.max_incidents, flight.min_interval)
    flight._last.clear()
    flight.configure(dir=str(directory), max_incidents=64, min_interval=0.0)
    try:
        yield flight
    finally:
        flight.configure(dir=saved[0] or "", max_incidents=saved[1], min_interval=saved[2])
        flight._last.clear()


# ------------------------------------------------------------ the frames


def test_migration_frames_are_byte_equal_on_the_wire():
    frames = {}
    for pkg in PKGS:
        M = mod(pkg, "core.messages")
        begin = M.ShardMigrateBegin([["s1-replica-0", {"k": [3, "s1-replica-2", "ab"]},
                                      77, "00ff"]], 123456789, 2, 2, 4)
        ack = M.ShardMigrateAck(123456789, 17, 1)
        chunk = M.StateChunk(123456789, 1, {"k": {"tag": [3, "r"], "value": ["x"]}},
                             kind="migrate")
        for m in (begin, ack, chunk):
            assert M.loads(M.dumps(m)) == m
        frames[pkg] = [M.dumps(m) for m in (begin, ack, chunk)]
    assert frames["dds_tpu_torch"] == frames["dds_tpu"]


# ------------------------------------------------------ the ingest path


class IngestWorld:
    """A receiving replica of group s2 (fencing under the split map) and
    four source replicas of s1 holding seeded entries, in one package.
    `digests` are three sources' signed manifests (support 2 = f + 1);
    `entries` the export of source 0 with one value forged."""

    def __init__(self, pkg: str, seed: int = 5):
        self.M = M = mod(pkg, "core.messages")
        rep = mod(pkg, "core.replica")
        sm = mod(pkg, "shard.shardmap")
        sigs = mod(pkg, "utils.sigs")
        self.net = mod(pkg, "core.transport").InMemoryNet()
        self.acks = []

        async def spy(sender, msg):
            self.acks.append((sender, type(msg).__name__, *[getattr(msg, f) for f in (
                "session", "accepted", "rejected") if hasattr(msg, f)]))

        self.net.register("rebalancer", spy)
        self.net.register("s2-supervisor", spy)
        old = sm.ShardMap.build(["s0", "s1"], 8).sign(SECRET)
        new = old.split("s1", "s2").sign(SECRET)
        rcfg = rep.ReplicaConfig(quorum_size=3)
        self.node = rep.BFTABDNode("s2-replica-0", ["s2-replica-0"], "s2-supervisor",
                                   self.net, rcfg, shard=sm.ShardState("s2", new, SECRET))
        sources = [rep.BFTABDNode(f"s1-replica-{i}", [], "s1-supervisor", self.net, rcfg)
                   for i in range(4)]
        rng = np.random.default_rng(seed)
        keys = [f"K{int(x):x}" for x in rng.integers(0, 1 << 62, 400)]
        moving = [k for k in keys if old.owner(k) == "s1" and new.owner(k) == "s2"][:12]
        staying = [k for k in keys if new.owner(k) == "s1"][:2]
        self.moving, self.staying = moving, staying
        for i, k in enumerate(moving + staying):
            tag = M.ABDTag(int(rng.integers(1, 50)), f"s1-replica-{i % 4}")
            value = [f"v{i}", int(rng.integers(0, 1 << 30))]
            for n in sources[: (1 if i == 0 else 4)]:  # moving[0] on one source only
                n._store(k, tag, value)
        self.digests = []
        for j, n in enumerate(sources[:3]):
            manifest = n.merkle.manifest()
            nonce = 1000 + j
            sig = sigs.manifest_signature(SECRET, n.addr, manifest, nonce)
            self.digests.append([n.addr, manifest, nonce, sig.hex()])
        self.entries = sources[0].export_state()
        self.entries[moving[1]] = {"tag": self.entries[moving[1]]["tag"], "value": ["forged"]}
        # the receiver already holds moving[2] at a NEWER tag and moving[3]
        # at an older one: store-if-newer keeps the first, replaces the second
        t2 = self.entries[moving[2]]["tag"]
        self.node._store(moving[2], M.ABDTag(t2[0] + 5, "s2-replica-0"), ["newer"])
        self.node._store(moving[3], M.ABDTag(0, "s2-replica-0"), ["older"])
        items = sorted(self.entries.items())
        self.chunks = [dict(items[i:i + 4]) for i in range(0, len(items), 4)]

    def begin(self, session: int):
        return self.M.ShardMigrateBegin(self.digests, session, len(self.chunks), 2, 2)

    def chunk(self, session: int, seq: int, kind: str = "migrate"):
        return self.M.StateChunk(session, seq, self.chunks[seq], kind=kind)

    async def feed(self, frames) -> None:
        for sender, msg in frames:
            await self.node.handle(sender, msg)
        await self.net.quiesce()

    def repo(self) -> dict:
        return {k: ((t.seq, t.id), v) for k, (t, v) in sorted(self.node.repository.items())}


def test_migrate_ingest_reorder_dup_missing_and_rejections_twin():
    async def go(pkg):
        w = IngestWorld(pkg)
        n = len(w.chunks)
        out = {"chunks": n}
        # reordered (chunks before the header) with one chunk duplicated
        await w.feed([("rebalancer", w.chunk(11, n - 1)), ("rebalancer", w.chunk(11, 0)),
                      ("rebalancer", w.begin(11)), ("rebalancer", w.chunk(11, 0))]
                     + [("rebalancer", w.chunk(11, s)) for s in range(1, n - 1)])
        out["acks_reordered"] = list(w.acks)
        out["repo"] = w.repo()
        out["kept_newer"] = out["repo"][w.moving[2]][1] == ["newer"]
        out["replaced_older"] = out["repo"][w.moving[3]][1] != ["older"]
        out["foreign_or_unattested"] = [k in out["repo"] for k in w.staying + w.moving[:2]]
        # a session missing its last chunk never completes nor acks
        w.acks.clear()
        await w.feed([("rebalancer", w.begin(12))]
                     + [("rebalancer", w.chunk(12, s)) for s in range(n - 1)])
        out["acks_missing"] = list(w.acks)
        out["open_sessions"] = sorted(w.node._migrate_sessions)
        # bogus sessions evict the oldest first (MAX_MIGRATE_SESSIONS)
        await w.feed([("rebalancer", w.chunk(100 + s, 0)) for s in range(5)])
        out["after_flood"] = sorted(w.node._migrate_sessions)
        # a sentinent spare of the receiving group ingests too
        w.acks.clear()
        w.node.behavior = "sentinent"
        await w.feed([("rebalancer", w.begin(13))]
                     + [("rebalancer", w.chunk(13, s)) for s in range(n)])
        out["acks_sentinent"] = list(w.acks)
        out["repo_sentinent"] = w.repo()
        out["dropped"] = w.node.drop_unowned()
        out["repo_pruned"] = w.repo()
        return out

    out = twin(go)
    # 14 exported entries: one attested by a single signer, one forged, two
    # not owned by s2 — four rejections; the newer local tag survives
    assert [a[2:] for a in out["acks_reordered"]] == [(11, 10, 4)]
    assert out["acks_missing"] == [] and 12 in out["open_sessions"]
    assert 12 not in out["after_flood"] and len(out["after_flood"]) == 4
    assert [a[2:] for a in out["acks_sentinent"]] == [(13, 10, 4)]
    assert out["kept_newer"] and out["replaced_older"]
    assert out["foreign_or_unattested"] == [False, False, False, False]
    assert out["dropped"] == 0  # nothing foreign was ever installed


def test_migration_and_recovery_frames_under_one_session_id_stay_apart_twin():
    """A proactive recovery reseeds a receiving replica while a migration
    streams into it, both under session 21: the migrate chunks complete
    the migration (acked to the rebalancer), the recovery chunks the
    reseed (Complying to the supervisor, then sentinent), in both
    packages alike, whichever order the frames interleave in."""
    async def go(pkg):
        out = {}
        for order in ("migration first", "recovery first"):
            w = IngestWorld(pkg)
            n = len(w.chunks)
            mig = [("rebalancer", w.begin(21))] + [("rebalancer", w.chunk(21, s))
                                                   for s in range(n)]
            rec = [("s2-supervisor", w.M.SleepBegin(w.digests, 21, n, 2, [9]))] + [
                ("s2-supervisor", w.chunk(21, s, kind="recovery")) for s in range(n)]
            if order == "recovery first":
                mig, rec = rec, mig
            frames = [f for pair in zip(mig, rec) for f in pair]
            await w.feed(frames)
            out[order] = {"acks": list(w.acks), "behavior": w.node.behavior,
                          "repo": w.repo()}
        return out

    out = twin(go)
    for order in out.values():
        kinds = sorted(a[1] for a in order["acks"])
        assert kinds == ["Complying", "ShardMigrateAck"]
        assert order["behavior"] == "sentinent"


# ------------------------------------------------------------ the abort


def constellation(pkg: str, S: int = 2, net=None, seed: int = 7, **kw):
    net = net or mod(pkg, "core.transport").InMemoryNet()
    kw.setdefault("n_active", 4)
    kw.setdefault("n_sentinent", 0)
    kw.setdefault("quorum", 3)
    return mod(pkg, "shard").build_constellation(net, shard_count=S, vnodes_per_group=8,
                                                 seed=seed, **kw), net


def test_reshard_abort_restores_the_old_map_and_files_the_incident_twin(tmp_path):
    """`tests/test_shard.py`'s abort: the whole source group cut off, so
    no manifest quorum; the split aborts, the old map and the source's
    fencing come back, `reshard_abort` is filed and counted, and after the
    heal the old owner serves the row written before."""
    async def go(pkg):
        chaos = mod(pkg, "core.chaos")
        metrics = mod(pkg, "obs.metrics").metrics
        shard = mod(pkg, "shard")
        net = chaos.ChaosNet(mod(pkg, "core.transport").InMemoryNet(), seed=77)
        const, _ = constellation(pkg, net=net, seed=5, manifest_timeout=0.3,
                                 ack_timeout=0.5)
        aborts = metrics.value("dds_reshard_aborts_total") or 0
        with recording_flight(pkg, tmp_path / pkg):
            try:
                old = const.manager.current()
                key = next(k for k in (f"A{i}" for i in range(64)) if old.owner(k) == "s1")
                await const.router.write_set(key, ["pre"])
                net.partition([f"s1-replica-{i}" for i in range(4)])
                with pytest.raises(shard.ReshardAborted) as err:
                    await const.split("s1")
                out = {"reason": str(err.value),
                       "map_kept": const.manager.current() is old,
                       "state": const.manager.state,
                       "source_epoch": const.group("s1").state.epoch,
                       "standbys": [g.gid for g in const.standbys],
                       "gids": const.gids,
                       "aborts": (metrics.value("dds_reshard_aborts_total") or 0) - aborts,
                       "incidents": sorted(p.name.split("-", 3)[-1]
                                           for p in (tmp_path / pkg).iterdir()
                                           if "reshard_abort" in p.name)}
                net.heal_all()
                out["read"] = await const.router.fetch_set(key)
            finally:
                net.heal_all()
                await const.stop()
        return out

    out = twin(go)
    assert out["map_kept"] and out["state"] == "stable" and out["source_epoch"] == 1
    assert out["aborts"] == 1 and out["incidents"] == ["reshard_abort.jsonl"]
    assert out["standbys"] == ["s2"] and out["gids"] == ["s0", "s1"]
    assert out["read"] == ["pre"] and "manifest quorum failed" in out["reason"]


# ------------------------------------------- the live split under chaos


def pin_group(m, group, clock) -> None:
    """A group's quorum client on the loop's clock and a seeded
    coordinator choice, as the linearizability twins pin theirs."""
    client = group.client
    client.replicas._rng = random.Random(7)
    for a in group.all_replicas():
        client.breakers[a] = m.CircuitBreaker(client.cfg.breaker_threshold,
                                              client.cfg.breaker_reset, clock=clock, name=a)


async def retrying_writer(retry, router, rec, clock, key, wid, n, seed, budget=10.0):
    policy = retry.RetryPolicy(base=0.01, multiplier=2.0, max_delay=0.08)
    rng = random.Random(seed)
    committed = []
    for i in range(n):
        value = [f"w{wid}-{i}"]
        t0 = clock()
        dl = retry.Deadline(budget, clock=clock)
        await retry.retry_deadline(lambda: router.write_set(key, value, deadline=dl),
                                   dl, policy, rng=rng, retry_on=(Exception,))
        committed.append((f"w{wid}-{i}", t0))
        rec.record("write", f"w{wid}-{i}", t0)
        await asyncio.sleep(rng.uniform(0, 0.004))
    return committed


def test_live_split_under_a_partition_healing_mid_reshard_twin():
    """`tests/test_shard.py`'s flagship schedule on the virtual clock: a
    ChaosNet partition (seed 909) cuts one replica of the future group s2
    while a live split runs and heals 0.12 s later; a writer hammers a
    MOVING key and another a stable one. Both packages: the same fault
    trace, the same committed writes at the same virtual instants, the
    history linearizes, some writes start after the fence and none of
    those is ever stored in the (unpruned) source group, the new group
    holds the final value at quorum, the partitioned straggler converges
    through anti-entropy, and a per-group Watchtower reports no
    quorum-intersection violation."""
    async def go(pkg):
        with seeded(909):
            loop = asyncio.get_running_loop()
            clock = loop.time
            retry = mod(pkg, "utils.retry")
            tracer = mod(pkg, "utils.trace").tracer
            wt = mod(pkg, "obs.watchtower").Watchtower(quorum_size=3, n_replicas=4)
            wt.configure(group_geometry={g: (3, 4) for g in ("s0", "s1", "s2")})
            net = mod(pkg, "core.chaos").ChaosNet(mod(pkg, "core.transport").InMemoryNet(),
                                                  seed=909)
            const, _ = constellation(pkg, net=net, n_sentinent=1, seed=11, prune=False,
                                     ack_timeout=8.0)
            for g in const.groups:
                pin_group(retry, g, clock)
            acquire = const._acquire_standby

            def acquiring(gid=None):
                g = acquire(gid)
                pin_group(retry, g, clock)
                return g

            const._acquire_standby = acquiring
            wt.attach(tracer)
            try:
                r = const.router
                smap = const.manager.current()
                m2 = smap.split("s1", "s2")
                moving = next(k for k in (f"MOVE-{i}" for i in range(128))
                              if smap.owner(k) == "s1" and m2.owner(k) == "s2")
                stable = next(k for k in (f"STAY-{i}" for i in range(128))
                              if smap.owner(k) == "s0")
                await r.write_set(moving, ["w0--1"])
                rec = Recorder(clock)
                frozen = {"t": None}
                src_state = const.group("s1").state
                install = src_state.install

                def spy_install(m, force=False, lease=0.0):
                    install(m, force=force, lease=lease)
                    if frozen["t"] is None and m.epoch > smap.epoch:
                        frozen["t"] = clock()

                src_state.install = spy_install

                async def do_split():
                    await asyncio.sleep(0.03)
                    net.partition(["s2-replica-2"], duration=0.12)
                    await const.split("s1")

                writes, _, _ = await asyncio.gather(
                    retrying_writer(retry, r, rec, clock, moving, 0, 10, seed=21),
                    retrying_writer(retry, r, rec, clock, stable, 1, 6, seed=22),
                    do_split(),
                )
                net.heal_all()
                await net.quiesce()
                check_atomic_register([o for o in rec.ops if o["kind"] == "write"])
                final = await r.fetch_set(moving)
                post_freeze = {v for v, t in writes if t > frozen["t"]}
                stale = [n.name for n in const.group("s1").replicas.values()
                         if (n.repository.get(moving, (None, None))[1] or [None])[0]
                         in post_freeze]
                new = const.group("s2")
                await net.quiesce()
                holders = sorted(n.name for n in new.replicas.values()
                                 if n.repository.get(moving, (None, None))[1] == final)
                straggler = new.replicas["s2-replica-2"]
                missed = straggler.repository.get(moving, (None, None))[1] != final
                for donor in (e for e in new.active if e != straggler.addr):
                    await straggler.antientropy.sync_once(donor)
                return {
                    "epoch": const.manager.epoch, "final": final,
                    "writes": [(v, round(t, 9)) for v, t in writes],
                    "frozen_at": round(frozen["t"], 9),
                    "post_freeze": sorted(post_freeze), "stale_in_source": stale,
                    "holders": holders, "straggler_missed": missed,
                    "straggler_final": straggler.repository.get(moving, (None, None))[1],
                    "violations": sorted(v.invariant for v in wt.verdicts()
                                         if v.invariant == "quorum_intersection"),
                    "trace": list(net.trace),
                }
            finally:
                wt.detach()
                await const.stop()

    out = twin(go, virtual=True)
    assert out["epoch"] == 2 and out["final"] == ["w0-9"]
    assert out["post_freeze"] and not out["stale_in_source"]
    assert len(out["holders"]) >= 3 and out["straggler_final"] == ["w0-9"]
    assert out["violations"] == [] and out["trace"]


# ----------------------------------------------------- the owner memo

N2 = ((1 << 61) - 1) ** 2


def test_owner_memo_keeps_the_old_grouping_across_a_reshape_in_both():
    """Both proxies memoize the aggregate's owner partition on the
    validated pairs list's identity and the operand position, not on the
    map's epoch. A migration keeps every tag, so with no write since the
    last SumAll the pairs list survives a merge and a split, and the next
    SumAll (scattered, and on the fused resident tree) still groups its
    operands by the owners of before: the same product in both packages,
    exact, over the old groups' sizes. A write rebuilds the pairs and the
    grouping follows the active map."""
    async def go(pkg):
        const, net = constellation(pkg, S=3)
        server_mod, config, mini = (mod(pkg, "http.server"), mod(pkg, "utils.config"),
                                    mod(pkg, "http.miniserver"))
        out = []
        for resident in (False, True):
            kw = dict(port=0, crypto_backend="cpu")
            if resident:
                kw["resident"] = config.ResidentConfig(enabled=True, initial_rows=16,
                                                       max_rows=256, min_fold=1)
                if pkg == "dds_tpu_torch":
                    kw["device"] = "cpu"
            server = server_mod.DDSRestServer(const.router, server_mod.ProxyConfig(**kw))
            await server.start()
            port = server.cfg.port
            rng = random.Random(3)
            vals = [rng.randrange(2, N2) for _ in range(40)]
            want = 1
            for v in vals:
                st, _ = await mini.http_request("127.0.0.1", port, "POST", "/PutSet",
                                                json.dumps({"contents": [str(v)]}).encode())
                assert st == 200
                want = want * v % N2

            async def sumall(label):
                st, body = await mini.http_request(
                    "127.0.0.1", port, "GET", f"/SumAll?position=0&nsqr={N2}", timeout=30)
                memo = server._owner_memo
                live: dict = {}
                for k, _ in memo[0]:
                    live[const.router.owner(k)] = live.get(const.router.owner(k), 0) + 1
                out.append((resident, label, st, int(json.loads(body)["result"]) == want,
                            {g: len(ops) for g, ops in memo[2]}, live))
                return memo[0]

            merged_away, split_from = ("s1", "s2") if resident else ("s2", "s0")
            p1 = await sumall("before")
            await const.merge(merged_away)
            p2 = await sumall("after merge")
            await const.split(split_from)
            p3 = await sumall("after split")
            out.append(("pairs survived", resident, p1 is p2, p2 is p3))
            await server.stop()
        await const.stop()
        return out

    out = twin(go)
    sumalls = [o for o in out if o[0] != "pairs survived"]
    assert len(sumalls) == 6 and all(o[2] == 200 and o[3] for o in sumalls)
    for resident in (False, True):
        before, merged, split = [o for o in sumalls if o[0] is resident]
        # the memo's grouping is the first SumAll's, whatever the live owners
        assert before[4] == merged[4] == split[4] == before[5]
        assert merged[5] != merged[4] and split[5] != split[4]
        assert ("pairs survived", resident, True, True) in out
