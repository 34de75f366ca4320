"""The reference's six ChaosNet schedules (`tests/test_linearizability.py`,
the chaos suite) on the port's cluster, each twinned with the reference,
and its three fault-free-fabric workloads (concurrent writers, Trudy's
crashes and compromises mid-run, with the fixed-backoff `retry`).

Each schedule runs in both packages on the reference's test cluster (7
active replicas, 2 sentinent spares, quorum 5) over a ChaosNet with the
schedule's seed: a minority partition healing on a timer, a
quorum-breaking one, a delay storm during proactive recovery,
duplication and reordering during tag reads, lossy and corrupting
links, and Nemesis's mixed attack. Every history must pass the atomic
register checker below, and the schedule's own assertions must hold.

The twins are exact because every clock and every random draw is pinned:
both packages run on `VirtualClockLoop`, whose time moves by a fixed cost
for each callback it runs and, while nothing is ready, by the wait (a
wait of t seconds returns at once with the clock t later), so the
interleaving of tasks is a function of the code alone; the workloads'
deadlines and the quorum client's breakers read
that clock; nonces (`secrets.randbits`), the byzantine behaviour's
module `random`, the supervisor's and the coordinator choice's rngs and
the retry jitter are seeded alike. So each schedule's fault trace (the
tuples ChaosNet appends for every fault it injects), its recorded
history, its final register value and its replicas' repositories equal
the reference's, tuple for tuple. The reference runs with the port's one
repair of its coordinator (ROADMAP §C 17, `reference_reply_key_repair`).
The port's reseed pulls what its seed lacked from the peers at once
(§C 23, 24), which the reference does not, so on the schedules whose
recoveries reseed replicas (the Byzantine, nemesis and proactive ones)
the two run apart: there each history must be atomic and the port's
final value held by a quorum, and tests/test_torch_recovery.py holds the
reseed against the reference.
"""

import asyncio
import contextlib
import importlib
import itertools
import random
import secrets
import selectors

import pytest

PACKAGES = ("dds_tpu", "dds_tpu_torch")
KEY = "LINREG"
BOUND = 120.0  # virtual seconds: every schedule's asyncio.wait_for


class _VirtualSelector(selectors.DefaultSelector):
    """Polls without blocking. Each pass of the loop costs `TICK` virtual
    seconds a callback it is about to run, and a wait with nothing ready
    moves the clock by the wait instead of sleeping."""

    def __init__(self, loop):
        super().__init__()
        self._loop = loop

    def select(self, timeout=None):
        if timeout is None:  # no timer pending: only another thread can wake us
            return super().select(None)
        ready = super().select(0)
        self._loop._now += len(self._loop._ready) * TICK
        if not ready and timeout > 0:
            self._loop._now += timeout
        return ready


# virtual seconds a callback costs: the cluster's work takes time as it
# does on a host (a quorum round some milliseconds), so a schedule's
# faults land in the middle of its workload
TICK = 20e-6


class VirtualClockLoop(asyncio.SelectorEventLoop):
    """An event loop on a virtual clock that starts at 0."""

    def __init__(self):
        self._now = 0.0
        super().__init__(selector=_VirtualSelector(self))

    def time(self) -> float:
        return self._now


def run_virtual(coro):
    """Run `coro` to its end on a fresh `VirtualClockLoop`, bounded by
    BOUND virtual seconds."""
    return asyncio.run(asyncio.wait_for(coro, BOUND), loop_factory=VirtualClockLoop)


@contextlib.contextmanager
def seeded(seed: int):
    """The module `random` and `secrets.randbits` (the nonces of both
    packages' `sigs.generate_nonce`) drawn from `seed`."""
    state = random.getstate()
    real = secrets.randbits
    random.seed(seed)
    secrets.randbits = random.Random(seed + 1).getrandbits
    try:
        yield
    finally:
        secrets.randbits = real
        random.setstate(state)


def mods(pkg: str):
    class _M:
        pass

    m = _M()
    m.M = importlib.import_module(f"{pkg}.core.messages")
    m.chaos = importlib.import_module(f"{pkg}.core.chaos")
    m.net = importlib.import_module(f"{pkg}.core.transport")
    m.qc = importlib.import_module(f"{pkg}.core.quorum_client")
    m.rep = importlib.import_module(f"{pkg}.core.replica")
    m.sup = importlib.import_module(f"{pkg}.core.supervisor")
    m.retry = importlib.import_module(f"{pkg}.utils.retry")
    m.trudy = importlib.import_module(f"{pkg}.malicious.trudy")
    return m


class Cluster:
    """The reference's test cluster (`tests/test_core.py::Cluster`) in
    either package: n active replicas + spares, a supervisor with seeded
    rng, one quorum client with a seeded coordinator rng, over `net`
    (default a ChaosNet over the package's InMemoryNet)."""

    def __init__(self, pkg: str, seed: int | None = None, n_active=7, n_sentinent=2,
                 quorum=5, proactive=False, request_timeout=1.0, clock=None):
        m = self.m = mods(pkg)
        inner = m.net.InMemoryNet()
        self.net = inner if seed is None else m.chaos.ChaosNet(inner, seed=seed)
        self.rcfg = m.rep.ReplicaConfig(quorum_size=quorum)
        all_addrs = [f"replica-{i}" for i in range(n_active + n_sentinent)]
        self.active = all_addrs[:n_active]
        self.sentinent = all_addrs[n_active:]
        self.replicas = {a: m.rep.BFTABDNode(a, all_addrs, "supervisor", self.net, self.rcfg)
                         for a in all_addrs}
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
            rng=random.Random(3),
        )
        self.client = m.qc.AbdClient(
            "proxy-0", self.net, self.active,
            m.qc.AbdClientConfig(request_timeout=request_timeout, quorum_size=quorum),
        )
        self.client.replicas._rng = random.Random(7)
        if clock is not None:
            # the breakers read the loop's clock, as everything else here does
            for a in all_addrs:
                self.client.breakers[a] = m.retry.CircuitBreaker(
                    self.client.cfg.breaker_threshold, self.client.cfg.breaker_reset,
                    clock=clock, name=a)

    async def _redeploy(self, endpoint):
        self.replicas[endpoint] = self.m.rep.BFTABDNode(
            endpoint, list(self.replicas), "supervisor", self.net, self.rcfg)

    def repos(self) -> dict:
        return {a: {k: ((t.seq, t.id), v) for k, (t, v) in r.repository.items()}
                for a, r in self.replicas.items()}


class Recorder:
    def __init__(self, clock):
        self.ops = []
        self.clock = clock

    def record(self, kind, value, start):
        self.ops.append({"kind": kind, "value": value, "start": start,
                         "end": self.clock()})


def check_atomic_register(ops):
    """Assert the recorded history is consistent with an atomic register
    (the reference's conservative checks, sound and incomplete):
    1. every read's value was None or written by a write that STARTED
       before the read ENDED;
    2. no new/old inversion: once a read returns W2's value, no read that
       starts after it ends returns the value of a write W1 that ended
       before W2 started."""
    writes = {o["value"]: o for o in ops if o["kind"] == "write"}
    reads = sorted((o for o in ops if o["kind"] == "read"), key=lambda o: o["start"])
    for r in reads:
        if r["value"] is None:
            continue
        w = writes.get(r["value"])
        assert w is not None, f"read returned a never-written value {r['value']}"
        assert w["start"] <= r["end"], "read returned a value from the future"
    for r1, r2 in itertools.combinations(reads, 2):
        if r1["end"] > r2["start"]:
            continue
        if r1["value"] is None or r2["value"] is None:
            continue
        w1, w2 = writes[r1["value"]], writes[r2["value"]]
        if w2["end"] < w1["start"]:
            raise AssertionError(
                f"new/old inversion: read@{r1['start']:.4f} saw {r1['value']} "
                f"but later read@{r2['start']:.4f} saw older {r2['value']}")


def test_the_checker_rejects_an_inversion_and_a_value_from_nowhere():
    bad = [
        {"kind": "write", "value": "old", "start": 0.0, "end": 0.1},
        {"kind": "write", "value": "new", "start": 0.2, "end": 0.3},
        {"kind": "read", "value": "new", "start": 0.4, "end": 0.5},
        {"kind": "read", "value": "old", "start": 0.6, "end": 0.7},
    ]
    with pytest.raises(AssertionError, match="inversion"):
        check_atomic_register(bad)
    with pytest.raises(AssertionError, match="never-written"):
        check_atomic_register([{"kind": "read", "value": "x", "start": 0, "end": 1}])
    check_atomic_register(bad[:3])


def test_the_virtual_clock_jumps_over_waits():
    async def go():
        loop = asyncio.get_running_loop()
        await asyncio.sleep(5.0)
        t = loop.time()
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(asyncio.Event().wait(), 0.25)
        return t, loop.time()

    t, t2 = run_virtual(go())
    assert 5.0 <= t < 5.001 and 0.25 <= t2 - t < 0.251


class Schedule:
    """One chaos schedule's world in one package: the cluster, the
    recorder, the retry policy and the seeded workload loops."""

    def __init__(self, pkg: str, seed: int, request_timeout=0.25, **kw):
        loop = asyncio.get_running_loop()
        self.clock = loop.time
        self.c = Cluster(pkg, seed=seed, request_timeout=request_timeout, clock=self.clock,
                         **kw)
        self.c.client.cfg.breaker_reset = 0.15
        for b in self.c.client.breakers.values():
            b.reset_timeout = 0.15
        self.m = self.c.m
        self.net = self.c.net
        self.rec = Recorder(self.clock)
        self.policy = self.m.retry.RetryPolicy(base=0.01, multiplier=2.0, max_delay=0.08)

    def deadline(self, budget=15.0):
        return self.m.retry.Deadline(budget, clock=self.clock)

    async def writer(self, wid, n_writes, seed):
        rng = random.Random(seed)
        client = self.c.client
        for i in range(n_writes):
            value = [f"w{wid}-{i}"]
            t0 = self.clock()
            dl = self.deadline()
            await self.m.retry.retry_deadline(
                lambda: client.write_set(KEY, value, deadline=dl), dl, self.policy, rng=rng)
            self.rec.record("write", f"w{wid}-{i}", t0)
            await asyncio.sleep(rng.uniform(0, 0.002))

    async def reader(self, n_reads, seed):
        rng = random.Random(seed)
        client = self.c.client
        for _ in range(n_reads):
            t0 = self.clock()
            dl = self.deadline()
            got = await self.m.retry.retry_deadline(
                lambda: client.fetch_set(KEY, deadline=dl), dl, self.policy, rng=rng)
            self.rec.record("read", got[0] if got else None, t0)
            await asyncio.sleep(rng.uniform(0, 0.002))

    async def holders(self, expect) -> int:
        await self.net.quiesce()
        return sum(1 for r in self.c.replicas.values()
                   if r.repository.get(KEY, (None, None))[1] == expect)

    def outcome(self, **extra) -> dict:
        return {"trace": list(self.net.trace), "ops": self.rec.ops,
                "repos": self.c.repos(), **extra}


@contextlib.contextmanager
def reference_reply_key_repair():
    """The port's repair of ROADMAP §C 17 applied to the reference's
    coordinator for the twins: a TagReply or ReadReply that would join a
    quorum for another key than its request's (a corrupted frame: the ABD
    signature does not cover the key) is dropped, as
    `dds_tpu_torch/core/replica.py` drops it. Without it the reference
    writes to the corrupted key where the port does not, and the lossy,
    corrupting schedule's twins part. The reference's own behaviour is
    shown in tests/test_torch_reply_keys.py."""
    m = mods("dds_tpu")
    sigs = importlib.import_module("dds_tpu.utils.sigs")
    node = m.rep.BFTABDNode
    real = node._healthy
    phase = {m.M.TagReply: m.M.IWrite, m.M.ReadReply: m.M.IRead}

    async def healthy(self, sender, msg):
        want = phase.get(type(msg))
        if want is not None:
            req = self.outgoing.get(msg.nonce)
            if (req is not None and not req.expired and isinstance(req.call, want)
                    and msg.key != req.call.key
                    and sigs.validate_abd_signature(self.cfg.abd_mac_secret, msg.value,
                                                    msg.tag, msg.nonce, msg.signature)):
                return
        await real(self, sender, msg)

    node._healthy = healthy
    try:
        yield
    finally:
        node._healthy = real


def twins(scenario, seed: int, reseeds: bool = False) -> dict:
    """Run `scenario(pkg)` in each package on the virtual clock with the
    same seeds, the reference with the port's reply-key repair; every
    history must be atomic, and the port's outcome must equal the
    reference's unless the schedule `reseeds` replicas (the port's hole
    fill parts the traces; the caller checks the port's outcome)."""
    out = {}
    for pkg in PACKAGES:
        repair = reference_reply_key_repair() if pkg == "dds_tpu" else contextlib.nullcontext()
        with seeded(seed), repair:
            out[pkg] = run_virtual(scenario(pkg))
        check_atomic_register(out[pkg]["ops"])
    ref, port = out["dds_tpu"], out["dds_tpu_torch"]
    if not reseeds:
        assert port["trace"] == ref["trace"]
        assert port == ref
    return port


async def plain_workload(pkg: str, writers: int, n_writes: int, readers: int, n_reads: int,
                         rng_seed: int, attack=None, request_timeout=1.0) -> dict:
    """The reference's fault-free-fabric workload (`_writer`/`_reader` with
    the fixed-backoff `retry`, one shared rng) on the plain transport,
    with Trudy's `attack` = (kind, victims' seed, delay) fired mid-run."""
    loop = asyncio.get_running_loop()
    c = Cluster(pkg, request_timeout=request_timeout, clock=loop.time)
    rec = Recorder(loop.time)
    rng = random.Random(rng_seed)
    retry = c.m.retry.retry

    async def writer(wid):
        for i in range(n_writes):
            value = [f"w{wid}-{i}"]
            t0 = loop.time()
            await retry(lambda: c.client.write_set(KEY, value), 0.01, 5)
            rec.record("write", f"w{wid}-{i}", t0)
            await asyncio.sleep(rng.uniform(0, 0.002))

    async def reader():
        for _ in range(n_reads):
            t0 = loop.time()
            got = await retry(lambda: c.client.fetch_set(KEY), 0.01, 5)
            rec.record("read", got[0] if got else None, t0)
            await asyncio.sleep(rng.uniform(0, 0.002))

    victims = []

    async def attacker():
        kind, seed, delay = attack
        await asyncio.sleep(delay)
        trudy = c.m.trudy.Trudy(c.net, c.active, max_faults=2, rng=random.Random(seed))
        victims.extend(trudy.trigger(kind))

    await asyncio.gather(*(writer(w) for w in range(writers)),
                         *(reader() for _ in range(readers)),
                         *((attacker(),) if attack else ()))
    final = await c.client.fetch_set(KEY)
    await c.net.quiesce()
    holders = sum(1 for r in c.replicas.values()
                  if r.repository.get(KEY, (None, None))[1] == final)
    return {"trace": [], "ops": rec.ops, "repos": c.repos(), "final": final,
            "holders": holders, "victims": victims}


def test_concurrent_writers_atomic_register_twin():
    out = twins(lambda pkg: plain_workload(pkg, 3, 6, 2, 12, rng_seed=11), 11)
    assert out["holders"] >= 5


def test_crash_faults_mid_workload_twin():
    """Trudy crashes f = 2 replicas between writes; the properties and
    liveness hold, and the single writer's last write is final."""
    out = twins(lambda pkg: plain_workload(pkg, 1, 8, 1, 16, rng_seed=23,
                                           attack=("crash", 5, 0.01),
                                           request_timeout=0.2), 23)
    assert out["final"] == ["w0-7"] and len(out["victims"]) == 2


def test_byzantine_faults_mid_workload_twin():
    """Two replicas compromised mid-run: every read still returns only
    genuinely written values."""
    out = twins(lambda pkg: plain_workload(pkg, 2, 6, 1, 14, rng_seed=31,
                                           attack=("byzantine", 9, 0.005)), 31, reseeds=True)
    assert len(out["victims"]) == 2
    assert out["final"] in (["w0-5"], ["w1-5"]) and out["holders"] >= 5


@pytest.mark.chaos
def test_chaos_minority_partition_during_writes_twin():
    """Schedule 1: 2 of 7 partitioned mid-workload, healed on a timer."""

    async def go(pkg):
        s = Schedule(pkg, seed=101)

        async def attacker():
            await asyncio.sleep(0.01)
            s.net.partition(["replica-5", "replica-6"], duration=0.15)

        await asyncio.gather(s.writer(0, 5, seed=1), s.writer(1, 5, seed=2),
                             s.reader(10, seed=3), attacker())
        final = await s.c.client.fetch_set(KEY)
        return s.outcome(final=final, holders=await s.holders(final))

    out = twins(go, 101)
    assert out["holders"] >= 5
    assert any(e[4] == "partition_drop" for e in out["trace"])


@pytest.mark.chaos
def test_chaos_quorum_breaking_partition_stalls_then_heals_twin():
    """Schedule 2: 3 of 7 partitioned (4 < quorum): writes stall until the
    timed heal, then complete; the single writer's last write is final."""

    async def go(pkg):
        s = Schedule(pkg, seed=202, request_timeout=0.15)

        async def attacker():
            await asyncio.sleep(0.01)
            s.net.partition(["replica-0", "replica-1", "replica-2"], duration=0.3)

        await asyncio.gather(s.writer(0, 4, seed=4), s.reader(6, seed=5), attacker())
        return s.outcome(final=await s.c.client.fetch_set(KEY))

    out = twins(go, 202)
    assert out["final"] == ["w0-3"]


@pytest.mark.chaos
def test_chaos_delay_storm_during_proactive_recovery_twin():
    """Schedule 3: jittered delays on every link while proactive recovery
    swaps replicas; after heal the supervisor converges back to 7 active
    and 2 spares."""

    async def go(pkg):
        s = Schedule(pkg, seed=303, proactive=True)
        s.net.default_faults = s.m.chaos.LinkFaults(delay=0.002, jitter=0.008)
        s.c.supervisor.start()
        await asyncio.gather(s.writer(0, 6, seed=6), s.reader(10, seed=7))
        s.net.heal_all()
        idle = await s.c.supervisor.wait_recovery_idle(10.0)
        await s.c.supervisor.stop()
        await s.net.quiesce()
        final = await s.c.client.fetch_set(KEY)
        return s.outcome(idle=idle, active=[a for a, _ in s.c.supervisor.active],
                         sentinent=list(s.c.supervisor.sentinent), final=final,
                         holders=await s.holders(final))

    out = twins(go, 303, reseeds=True)
    assert out["idle"], "recovery never quiesced after heal"
    assert len(out["active"]) == len(set(out["active"])) == 7
    assert len(out["sentinent"]) == 2
    # the single writer's last acknowledged write, held by a quorum
    assert out["final"] == ["w0-5"] and out["holders"] >= 5


@pytest.mark.chaos
def test_chaos_duplicate_reorder_during_tag_reads_twin():
    """Schedule 4: duplication and reordering on the proxy's links while
    writes interleave with batched tag reads; duplicated replies stuff no
    quorum and the final tag round agrees with the last write."""

    async def go(pkg):
        s = Schedule(pkg, seed=404)
        for i in range(7):
            s.net.set_pair("proxy-0", f"replica-{i}",
                           s.m.chaos.LinkFaults(duplicate=0.3, reorder=0.3))
        rounds = {"n": 0}

        async def tag_reader():
            rng = random.Random(8)
            for _ in range(8):
                dl = s.deadline()
                tags = await s.m.retry.retry_deadline(
                    lambda: s.c.client.read_tags([KEY], deadline=dl), dl, s.policy, rng=rng)
                assert len(tags) == 1
                rounds["n"] += 1
                await asyncio.sleep(rng.uniform(0, 0.003))

        await asyncio.gather(s.writer(0, 6, seed=9), s.reader(8, seed=10), tag_reader())
        await s.net.quiesce()
        value, tag = await s.c.client.fetch_set_tagged(KEY)
        tags = await s.c.client.read_tags([KEY])
        return s.outcome(rounds=rounds["n"], final=value,
                         tag_agrees=tags == [tag], tag=(tag.seq, tag.id))

    out = twins(go, 404)
    assert out["rounds"] == 8 and out["final"] == ["w0-5"] and out["tag_agrees"]
    actions = {e[4] for e in out["trace"]}
    assert {"duplicate", "parked", "released_reordered"} <= actions


@pytest.mark.chaos
def test_chaos_lossy_corrupting_links_twin():
    """Schedule 5: 5 % drop, 3 % corruption and jitter on every link;
    corrupted messages die at the MAC and codec layers, the loss is
    retried away, and after heal a quorum holds the final value."""

    async def go(pkg):
        s = Schedule(pkg, seed=505)
        s.net.default_faults = s.m.chaos.LinkFaults(drop=0.05, corrupt=0.03, jitter=0.003)
        await asyncio.gather(s.writer(0, 5, seed=11), s.writer(1, 5, seed=12),
                             s.reader(8, seed=13))
        s.net.heal_all()
        final = await s.c.client.fetch_set(KEY)
        return s.outcome(final=final, holders=await s.holders(final))

    out = twins(go, 505)
    assert sum(1 for o in out["ops"] if o["kind"] == "write") == 10
    assert out["holders"] >= 5
    actions = {e[4] for e in out["trace"]}
    assert {"drop", "corrupt"} <= actions or {"drop", "corrupt_undecodable"} <= actions


@pytest.mark.chaos
def test_chaos_nemesis_mixed_attack_schedule_twin():
    """Schedule 6: Nemesis compromises one replica, partitions another and
    floods a third (within f = 2), then heals mid-workload; the single
    writer's last write is final."""

    async def go(pkg):
        s = Schedule(pkg, seed=606)
        nem = s.m.trudy.Nemesis(s.net, s.c.active, max_faults=1, rng=random.Random(42),
                                flood_messages=15)
        victims = {}

        async def attacker():
            await asyncio.sleep(0.005)
            byz = victims["byzantine"] = nem.trigger("byzantine")
            nem.replicas = [a for a in s.c.active if a not in byz]
            cut = victims["partition"] = nem.trigger("partition")
            nem.replicas = [a for a in s.c.active if a not in byz + cut]
            victims["flood"] = nem.trigger("flood")
            await asyncio.sleep(0.12)
            nem.trigger("heal")

        await asyncio.gather(s.writer(0, 5, seed=14), s.reader(8, seed=15), attacker())
        final = await s.c.client.fetch_set(KEY)
        return s.outcome(final=final, holders=await s.holders(final), victims=victims,
                         behaviors={a: r.behavior for a, r in s.c.replicas.items()})

    out = twins(go, 606, reseeds=True)
    assert out["final"] == ["w0-4"] and out["holders"] >= 5
    assert len({v for vs in out["victims"].values() for v in vs}) == 3
    # the compromised replica is byzantine still, or already recovered
    assert out["behaviors"][out["victims"]["byzantine"][0]] in ("byzantine", "sentinent")
