"""The port's recovery plane against the reference's, exactly.

The same seeded inputs go through `dds_tpu` and `dds_tpu_torch`: the
membership, recovery, anti-entropy and fault-injection messages (field
names and order), the value digest and the manifest and anti-entropy
signatures (equal bytes), `MerkleIndex` over seeded repositories of 0, 1,
300 and 4,096 keys (roots, bucket digests, key listings, manifests;
incremental updates against a rebuild), replica snapshot files written by
one package and loaded by the other (bit-flip quarantine, keep-N,
in-flight nonces), Trudy's victims for a seed, and the fault-injection
gate (`Crash` and `Compromise` ignored without `[attacks] enabled`).
Then twins of the reference's recovery cases (verified transfer in
chunks, the freshest spare, the legacy Sleep, anti-entropy convergence
and its in-sync round, the snapshot cases, /health and /metrics), and the
slice end to end: a deployment with default.toml's `[replicas]` and
`[recovery]` (short timers) on the `cpu` backend, 64 Paillier-512 rows,
and a SumAll taken during a byzantine recovery that equals the reference
deployment's ciphertext and decrypts to the total. Every async case is
bounded by `asyncio.wait_for`.
"""

import asyncio
import dataclasses
import importlib
import json
import random

import pytest

from dds_tpu.core import messages as RM
from dds_tpu.core import snapshot as rsnap
from dds_tpu.core.antientropy import MerkleIndex as RMerkle
from dds_tpu.core.replica import BFTABDNode as RNode
from dds_tpu.core.replica import ReplicaConfig as RReplicaConfig
from dds_tpu.core.transport import InMemoryNet as RNet
from dds_tpu.malicious.trudy import Trudy as RTrudy
from dds_tpu.malicious.trudy import parse_attack as r_parse_attack
from dds_tpu.utils import sigs as rsigs
from dds_tpu_torch.core import messages as PM
from dds_tpu_torch.core import snapshot as psnap
from dds_tpu_torch.core.antientropy import MerkleIndex as PMerkle
from dds_tpu_torch.core.replica import BFTABDNode as PNode
from dds_tpu_torch.core.replica import ReplicaConfig as PReplicaConfig
from dds_tpu_torch.core.transport import InMemoryNet as PNet
from dds_tpu_torch.malicious.trudy import Trudy as PTrudy
from dds_tpu_torch.malicious.trudy import parse_attack as p_parse_attack
from dds_tpu_torch.utils import sigs as psigs

BOUND = 60.0  # seconds: every async case's asyncio.wait_for

PORTED_MESSAGES = (
    "Suspect", "Awake", "State", "Sleep", "Complying", "Kill", "Redeploy",
    "Redeployed", "RequestReplicas", "ActiveReplicas", "StateDigestRequest",
    "StateDigest", "SleepBegin", "StateChunk", "MerkleRootRequest",
    "MerkleRoot", "MerkleBucketRequest", "MerkleBuckets", "MerkleKeysRequest",
    "MerkleKeys", "RepairRequest", "RepairReply", "Compromise", "Crash",
)


def bounded(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND))


def seeded_repo(n: int, seed: int, M) -> dict:
    """{key: (tag, value)} with seeded tags, values, deletes (None under a
    real tag) and a few implicit `_state()` defaults (seq 0, None)."""
    rng = random.Random(seed)
    repo = {}
    for i in range(n):
        key = rsigs.key_from_set([seed, i])
        r = rng.random()
        if r < 0.05:
            repo[key] = (M.ABDTag(0, f"replica-{rng.randrange(9)}"), None)
        elif r < 0.15:
            repo[key] = (M.ABDTag(rng.randrange(1, 1 << 20), f"replica-{rng.randrange(9)}"), None)
        else:
            repo[key] = (M.ABDTag(rng.randrange(1, 1 << 20), f"replica-{rng.randrange(9)}"),
                         [i, f"v{rng.randrange(1 << 30)}", rng.randrange(1 << 64), None])
    return repo


# -------------------------------------------------------------- messages


@pytest.mark.parametrize("name", PORTED_MESSAGES)
def test_message_fields_equal_the_reference(name):
    ref, port = getattr(RM, name), getattr(PM, name)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert [f.default for f in dataclasses.fields(port)] == \
        [f.default for f in dataclasses.fields(ref)]
    assert port.__dataclass_params__.frozen == ref.__dataclass_params__.frozen


# ------------------------------------------------------------ signatures


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_digest_manifest_and_antientropy_signatures_equal_the_reference(seed):
    rng = random.Random(seed)
    secret = rng.randbytes(32)
    value = [rng.randrange(1 << 2048), "x" * rng.randrange(9), None, True, 1.5]
    assert psigs.value_digest(value) == rsigs.value_digest(value)
    assert psigs.value_digest(None) == rsigs.value_digest(None)
    manifest = {rsigs.key_from_set([seed, i]): [rng.randrange(1 << 31), f"r{i}",
                                                rsigs.value_digest([i])]
                for i in range(50)}
    nonce = rng.getrandbits(63)
    sig = rsigs.manifest_signature(secret, "replica-3", manifest, nonce)
    assert psigs.manifest_signature(secret, "replica-3", manifest, nonce) == sig
    assert psigs.validate_manifest_signature(secret, "replica-3", manifest, nonce, sig)
    assert not psigs.validate_manifest_signature(secret, "replica-4", manifest, nonce, sig)
    for kind, payload in (("root", ["ab" * 32, 7]), ("buckets", ["0" * 64] * 64),
                          ("keys", manifest)):
        sig = rsigs.antientropy_signature(secret, kind, payload, nonce)
        assert psigs.antientropy_signature(secret, kind, payload, nonce) == sig
        assert psigs.validate_antientropy_signature(secret, kind, payload, nonce, sig)
        assert not psigs.validate_antientropy_signature(secret, kind, payload, nonce + 1, sig)


# ------------------------------------------------------------ MerkleIndex


def merkle_view(idx) -> tuple:
    return (idx.root(), idx.bucket_digests(), idx.manifest(),
            idx.entries_in(range(0, 64, 3)), len(idx))


@pytest.mark.parametrize("n", [0, 1, 300, 4096])
def test_merkle_index_equals_the_reference(n):
    prepo, rrepo = seeded_repo(n, n, PM), seeded_repo(n, n, RM)
    pidx, ridx = PMerkle(), RMerkle()
    pidx.rebuild(prepo)
    ridx.rebuild(rrepo)
    assert merkle_view(pidx) == merkle_view(ridx)
    for key in list(prepo)[:5]:
        assert (pidx.get(key) is None) == (ridx.get(key) is None)
    # incremental updates (new tags, deletes, implicit defaults) match a
    # rebuild of the final repository, in both packages
    rng = random.Random(n + 1)
    keys = list(prepo) + [f"fresh-{i}" for i in range(20)]
    for _ in range(200):
        k = rng.choice(keys)
        seq, tid = rng.randrange(0, 1 << 20), f"replica-{rng.randrange(9)}"
        value = None if rng.random() < 0.2 else [rng.randrange(100), "v"]
        prepo[k], rrepo[k] = (PM.ABDTag(seq, tid), value), (RM.ABDTag(seq, tid), value)
        pidx.update(k, *prepo[k])
        ridx.update(k, *rrepo[k])
    fresh = PMerkle()
    fresh.rebuild(prepo)
    assert merkle_view(pidx) == merkle_view(fresh) == merkle_view(ridx)


def test_merkle_index_incremental_matches_rebuild_twin():
    """The reference's own sequence (`tests/test_recovery.py:221`)."""
    out = []
    for M, Merkle in ((RM, RMerkle), (PM, PMerkle)):
        rng = random.Random(5)
        idx, repo = Merkle(), {}
        for _ in range(300):
            k = f"key-{rng.randrange(40)}"
            if rng.random() < 0.15 and k in repo:
                repo[k] = (M.ABDTag(repo[k][0].seq + 1, "r1"), None)
            else:
                repo[k] = (M.ABDTag(rng.randrange(1, 1000), f"r{rng.randrange(3)}"),
                           [rng.randrange(100), "v"])
            idx.update(k, *repo[k])
        fresh = Merkle()
        fresh.rebuild(repo)
        assert idx.root() == fresh.root()
        assert idx.bucket_digests() == fresh.bucket_digests()
        idx.update("phantom", M.ABDTag(0, "r0"), None)
        assert idx.root() == fresh.root()
        out.append(merkle_view(idx))
    assert out[0] == out[1]


# -------------------------------------------------------------- snapshots


def _node(pkg: str, name="r0"):
    if pkg == "dds_tpu":
        return RNode(name, [name, "r1"], "sup", RNet(), RReplicaConfig(quorum_size=1))
    return PNode(name, [name, "r1"], "sup", PNet(), PReplicaConfig(quorum_size=1))


SNAP = {"dds_tpu": rsnap, "dds_tpu_torch": psnap}
TAG = {"dds_tpu": RM.ABDTag, "dds_tpu_torch": PM.ABDTag}
CROSS = [("dds_tpu_torch", "dds_tpu"), ("dds_tpu", "dds_tpu_torch")]


def plain_repo(node) -> dict:
    return {k: ((t.seq, t.id), v) for k, (t, v) in node.repository.items()}


@pytest.mark.parametrize("writer,reader", CROSS)
def test_snapshot_files_cross_between_packages(writer, reader, tmp_path):
    """A file one package writes loads in the other: repository, the full
    nonce map (in-flight ones too), the Merkle root, the generation."""
    node = _node(writer)
    for k, (t, v) in seeded_repo(300, 3, RM).items():
        node._store(k, TAG[writer](t.seq, t.id), v)
    node.incoming[111] = False  # in flight
    node.incoming[222] = True   # expired
    path = SNAP[writer].save_replica(node, tmp_path)
    assert path.name == "r0.snapshot.00000001.json"
    fresh = _node(reader)
    assert SNAP[reader].load_replica(fresh, tmp_path)
    assert plain_repo(fresh) == plain_repo(node)
    assert fresh.incoming[111] is False and fresh.incoming[222] is True
    assert fresh.merkle.root() == node.merkle.root()
    assert fresh.snapshot_meta["generation"] == 1
    # and the bytes each package would write for the same state agree,
    # apart from the save time
    body = json.loads(path.read_bytes().rstrip(b"\n").rpartition(b"\n")[0])
    other = _node(reader)
    SNAP[reader].load_replica(other, tmp_path)
    p2 = SNAP[reader].save_replica(other, tmp_path)
    body2 = json.loads(p2.read_bytes().rstrip(b"\n").rpartition(b"\n")[0])
    body.pop("saved_at"), body2.pop("saved_at")
    assert body2 == {**body, "generation": 2}


@pytest.mark.parametrize("writer,reader", CROSS)
def test_snapshot_bitflip_quarantined_across_packages(writer, reader, tmp_path):
    node = _node(writer)
    node._store("k1", TAG[writer](1, "r0"), ["gen1"])
    SNAP[writer].save_replica(node, tmp_path)
    node._store("k1", TAG[writer](2, "r0"), ["gen2"])
    p2 = SNAP[writer].save_replica(node, tmp_path)
    raw = bytearray(p2.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    p2.write_bytes(bytes(raw))
    fresh = _node(reader)
    assert SNAP[reader].load_replica(fresh, tmp_path)
    assert fresh.repository["k1"][1] == ["gen1"]
    corrupt = list(tmp_path.glob("*.corrupt"))
    assert [p.name for p in corrupt] == ["r0.snapshot.00000002.corrupt"]


@pytest.mark.parametrize("pkg", ["dds_tpu", "dds_tpu_torch"])
def test_snapshot_keep_n_and_forged_footer_equal_across_packages(pkg, tmp_path):
    node = _node(pkg)
    for i in range(6):
        node._store("k", TAG[pkg](i + 1, "r0"), [i])
        SNAP[pkg].save_replica(node, tmp_path / "keep", keep=2)
    assert sorted(p.name for p in (tmp_path / "keep").glob("*.json")) == \
        ["r0.snapshot.00000005.json", "r0.snapshot.00000006.json"]
    # a file keyed under one secret never loads under another, either way
    SNAP[pkg].save_replica(node, tmp_path / "forged", secret=b"key-A")
    for other in SNAP.values():
        fresh = _node(pkg)
        assert not other.load_replica(fresh, tmp_path / "forged", secret=b"key-B")
        assert not fresh.repository
    assert list((tmp_path / "forged").glob("*.corrupt"))


def test_snapshot_v2_roundtrip_preserves_inflight_nonces_twin(tmp_path):
    node = _node("dds_tpu_torch")
    node._store("k", PM.ABDTag(2, "r0"), [1, 2])
    node.incoming[111] = False
    node.incoming[222] = True
    psnap.save_replica(node, tmp_path)
    fresh = _node("dds_tpu_torch")
    assert psnap.load_replica(fresh, tmp_path)
    assert fresh.incoming[111] is False and fresh.incoming[222] is True
    assert fresh.repository["k"] == (PM.ABDTag(2, "r0"), [1, 2])
    assert fresh.merkle.root() == node.merkle.root()
    assert fresh.snapshot_meta["generation"] == 1


def test_corrupt_legacy_snapshot_quarantined_not_crashing_twin(tmp_path):
    for pkg in ("dds_tpu", "dds_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        (d / "r0.snapshot.json").write_text('{"repository": {truncated')
        assert not SNAP[pkg].load_replica(_node(pkg), d)
        assert (d / "r0.snapshot.corrupt").exists()
        assert not (d / "r0.snapshot.json").exists()


def test_corrupt_snapshots_do_not_abort_launch_twin(tmp_path):
    """`launch` with a snapshot dir of corrupt files (a flipped v2 written
    by the reference, garbage v1) boots and quarantines both."""
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig

    cfg = DDSConfig()
    cfg.proxy.device = "cpu"
    cfg.recovery.snapshot_dir = str(tmp_path)
    node = RNode("replica-0", ["replica-0"], "sup", RNet(), RReplicaConfig())
    node._store("k", RM.ABDTag(3, "replica-0"), ["payload"])
    secret = rsnap.derive_secret(cfg.security.abd_mac_secret.encode())
    p = rsnap.save_replica(node, tmp_path, secret=secret)
    raw = bytearray(p.read_bytes())
    raw[10] ^= 0x01
    p.write_bytes(bytes(raw))
    (tmp_path / "replica-1.snapshot.json").write_text("not json at all")

    async def go():
        dep = await launch(cfg)
        try:
            assert "k" not in dep.replicas["replica-0"].repository
            assert (tmp_path / "replica-0.snapshot.00000001.corrupt").exists()
            assert (tmp_path / "replica-1.snapshot.corrupt").exists()
        finally:
            await dep.stop()

    bounded(go())


# ------------------------------------------------------------------ Trudy


class RecordingNet:
    def __init__(self):
        self.sent = []

    def send(self, src, dest, msg):
        self.sent.append((src, dest, type(msg).__name__))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("attack", ["crash", "byzantine", " Byzantine "])
def test_trudy_victims_equal_the_reference(seed, attack):
    replicas = [f"replica-{i}" for i in range(7)]
    rnet, pnet = RecordingNet(), RecordingNet()
    rv = RTrudy(rnet, replicas, 2, rng=random.Random(seed)).trigger(attack)
    pv = PTrudy(pnet, replicas, 2, rng=random.Random(seed)).trigger(attack)
    assert pv == rv and len(pv) == 2
    assert pnet.sent == rnet.sent
    assert p_parse_attack(attack).value == r_parse_attack(attack).value


def test_trudy_refuses_the_network_attacks_and_unknown_names():
    t = PTrudy(RecordingNet(), ["a", "b"], 1, rng=random.Random(0))
    for name in ("partition", "delay", "flood", "heal"):
        with pytest.raises(ValueError, match="Nemesis"):
            t.trigger(name)
    with pytest.raises(ValueError, match="unknown attack"):
        p_parse_attack("nope")
    with pytest.raises(ValueError, match="unknown attack"):
        r_parse_attack("nope")


# --------------------------------------------------- the fault-injection gate


def _launch_cfg(pkg: str, attacks: bool, extra: dict | None = None):
    cfgmod = importlib.import_module(f"{pkg}.utils.config")
    d = {
        "replicas": {"endpoints": [f"replica-{i}" for i in range(9)],
                     "sentinent": ["replica-7", "replica-8"],
                     "byz-quorum-size": 5, "byz-max-faults": 2},
        "proxy": {"crypto-backend": "cpu", "intranet-request-timeout": 1.0},
        "attacks": {"enabled": attacks},
    }
    if pkg == "dds_tpu_torch":
        d["proxy"]["device"] = "cpu"
    else:
        # planes the port does not serve yet stay off in the twin
        d["admission"] = {"enabled": False}
        d["obs"] = {"audit-enabled": False, "slo-route": False}
    for section, kv in (extra or {}).items():
        d.setdefault(section, {}).update(kv)
    return cfgmod.DDSConfig.from_dict(d)


@pytest.mark.parametrize("pkg", ["dds_tpu", "dds_tpu_torch"])
def test_crash_and_compromise_ignored_without_attacks_enabled(pkg):
    run = importlib.import_module(f"{pkg}.run")
    M = importlib.import_module(f"{pkg}.core.messages")

    async def go(attacks: bool):
        dep = await run.launch(_launch_cfg(pkg, attacks))
        try:
            for i, e in enumerate(dep.replicas):
                dep.net.send("intruder", e, M.Crash() if i % 2 else M.Compromise())
            await dep.net.quiesce()
            return ({e: dep.net.has_endpoint(e) for e in dep.replicas},
                    {e: r.behavior for e, r in dep.replicas.items()},
                    {r.cfg.allow_fault_injection for r in dep.replicas.values()})
        finally:
            await dep.stop()

    alive, behavior, allowed = bounded(go(False))
    assert allowed == {False} and all(alive.values())
    assert behavior == {f"replica-{i}": "sentinent" if i >= 7 else "healthy"
                        for i in range(9)}
    alive, behavior, allowed = bounded(go(True))
    assert allowed == {True}
    assert [e for e, up in alive.items() if not up] == [f"replica-{i}" for i in range(1, 9, 2)]
    assert {e for e, b in behavior.items() if b == "byzantine"} == \
        {f"replica-{i}" for i in range(0, 7, 2)}


# ---------------------------------------------- reference recovery twins


class Cluster:
    """The reference's recovery-test cluster (`tests/test_recovery.py`,
    no ChaosNet), in either package."""

    def __init__(self, pkg: str, awake_timeout=0.5, crashed_timeout=1.0):
        self.pkg = pkg
        self.M = importlib.import_module(f"{pkg}.core.messages")
        rep = importlib.import_module(f"{pkg}.core.replica")
        sup = importlib.import_module(f"{pkg}.core.supervisor")
        qc = importlib.import_module(f"{pkg}.core.quorum_client")
        self.sigs = importlib.import_module(f"{pkg}.utils.sigs")
        self.tracer = importlib.import_module(f"{pkg}.utils.trace").tracer
        self.net = importlib.import_module(f"{pkg}.core.transport").InMemoryNet()
        self.rcfg = rep.ReplicaConfig(quorum_size=5)
        all_addrs = [f"replica-{i}" for i in range(9)]
        self.active, self.sentinent = all_addrs[:7], all_addrs[7:]
        self.Node = rep.BFTABDNode
        self.replicas = {a: rep.BFTABDNode(a, all_addrs, "supervisor", self.net, self.rcfg)
                         for a in all_addrs}
        for a in self.sentinent:
            self.replicas[a].behavior = "sentinent"
        self.supervisor = sup.BFTSupervisor(
            "supervisor", self.active, self.sentinent, self.net,
            sup.SupervisorConfig(quorum_size=5, proactive_recovery_enabled=False,
                                 sentinent_awake_timeout=awake_timeout,
                                 crashed_recovery_timeout=crashed_timeout,
                                 manifest_timeout=1.0),
            redeploy=self._redeploy, rng=random.Random(3),
        )
        self.client = qc.AbdClient("proxy-0", self.net, self.active,
                                   qc.AbdClientConfig(request_timeout=1.0, quorum_size=5))
        self.client.replicas._rng = random.Random(7)

    async def _redeploy(self, endpoint):
        self.replicas[endpoint] = self.Node(endpoint, list(self.replicas), "supervisor",
                                            self.net, self.rcfg)

    async def write(self, value):
        key = self.sigs.key_from_set(value)
        await self.client.write_set(key, value)
        return key

    def repos(self) -> dict:
        return {a: plain_repo(r) for a, r in self.replicas.items()}


def twins(fn):
    """Run the scenario `fn(cluster)` in both packages; the port's result
    and every replica's repository must equal the reference's."""
    out = {}
    for pkg in ("dds_tpu", "dds_tpu_torch"):
        async def go():
            c = Cluster(pkg)
            res = await fn(c)
            await c.net.quiesce()
            return res, c.repos(), [a for a, _ in c.supervisor.active], c.supervisor.sentinent
        out[pkg] = bounded(go())
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    return out["dds_tpu_torch"]


def both(fn) -> dict:
    """Run the scenario `fn(cluster)` in both packages, settling the
    fabric and the reseed's hole fill (ROADMAP §C 23) after it: pkg ->
    (result, every replica's repository). For the cases where the port's
    reseed repairs its holes and the reference's keeps them."""
    out = {}
    for pkg in ("dds_tpu", "dds_tpu_torch"):
        async def go():
            c = Cluster(pkg)
            res = await fn(c)
            for _ in range(3):
                await c.net.quiesce()
                await asyncio.sleep(0.05)
            return res, c.repos()
        out[pkg] = bounded(go())
    return out


def test_verified_transfer_streams_chunks_twin():
    async def go(c):
        c.supervisor.cfg.state_chunk_keys = 4
        keys = [await c.write([i, "v"]) for i in range(11)]
        await c.net.quiesce()
        seeds = []
        orig = c.net.send

        def spy(src, dest, msg):
            if type(msg).__name__ == "StateChunk":
                seeds.append((dest, msg.seq, sorted(msg.entries)))
            orig(src, dest, msg)

        c.net.send = spy
        await c.supervisor.recover("replica-0")
        await c.net.quiesce()
        c.net.send = orig
        r0, r1 = c.replicas["replica-0"], c.replicas["replica-1"]
        assert all(r0.repository[k][1] == r1.repository[k][1] for k in keys)
        return sorted(seeds)

    seeds, *_ = twins(go)
    assert len(seeds) == 3  # 11 keys, 4 a chunk


def test_freshest_spare_preferred_and_seeder_traced_twin():
    async def go(c):
        await c.write([1, "x"])
        await c.net.quiesce()
        c.replicas["replica-7"]._install_repository({})  # a stale spare
        await c.supervisor.recover("replica-0")
        await c.net.quiesce()
        seeders = [e.meta["seeder"] for e in c.tracer.events("supervisor.seeder")
                   if e.meta.get("victim") == "replica-0"]
        return seeders[-1]

    seeder, _, active, sentinent = twins(go)
    assert seeder == "replica-8" and "replica-8" in active and "replica-7" in sentinent


def test_verified_transfer_off_falls_back_to_legacy_sleep_twin():
    async def go(c):
        c.supervisor.cfg.verified_transfer = False
        key = await c.write([9, "legacy"])
        await c.net.quiesce()
        await c.supervisor.recover("replica-0")
        await c.net.quiesce()
        return c.replicas["replica-0"].repository[key][1], c.replicas["replica-0"].behavior

    (value, behavior), *_ = twins(go)
    assert value == [9, "legacy"] and behavior == "sentinent"


def test_forged_spare_entries_rejected_by_the_digest_quorum_twin():
    """A spare holding a fabricated high-tag key and a tampered value
    seeds the recovering replica; the manifest quorum rejects both. The
    tampered key stays a hole in the reference; the port pulls its
    attested version from the peers at once (ROADMAP §C 23), never the
    fabricated key, which no manifest quorum attests."""

    async def go(c):
        keys = [await c.write([i, "honest"]) for i in range(5)]
        await c.net.quiesce()
        for spare in ("replica-7", "replica-8"):
            s = c.replicas[spare]
            s._store("FORGED-KEY", c.M.ABDTag(1 << 20, "trudy"), ["evil", 666])
            tag, _ = s.repository[keys[0]]
            s._store(keys[0], tag, ["tampered"])
        await c.supervisor.recover("replica-0")
        await c.net.quiesce()
        return keys

    out = both(go)
    for pkg, holes in (("dds_tpu", 1), ("dds_tpu_torch", 0)):
        keys, repos = out[pkg]
        r0 = repos["replica-0"]
        assert "FORGED-KEY" not in r0 and len(r0) == 5 - holes, pkg
        assert all(r0[k][1] == [i, "honest"] for i, k in enumerate(keys) if k in r0)
    # every other replica as the reference leaves it
    ref, port = out["dds_tpu"][1], out["dds_tpu_torch"][1]
    assert {a: r for a, r in port.items() if a != "replica-0"} == \
        {a: r for a, r in ref.items() if a != "replica-0"}


def test_f_attesters_cannot_smuggle_an_entry_through_the_seed_twin():
    """f = 2 active replicas and the seeding spares hold a fabricated key
    and a tampered value, and sign them into their manifests: two
    attesters are below the support 2q - n = 3, so the recovering replica
    installs neither."""

    async def go(c):
        keys = [await c.write([i, "honest"]) for i in range(4)]
        await c.net.quiesce()
        for name in ("replica-5", "replica-6", "replica-7", "replica-8"):
            r = c.replicas[name]
            r._store("SMUGGLED", c.M.ABDTag(1 << 20, "trudy"), ["evil"])
            tag, _ = r.repository[keys[1]]
            r._store(keys[1], tag, ["tampered"])
        await c.supervisor.recover("replica-0")
        await c.net.quiesce()
        return c.supervisor._support(), keys

    out = both(go)
    # the tampered key is a hole in the reference; the port fills it with
    # the attested honest version (ROADMAP §C 23)
    for pkg, n in (("dds_tpu", 3), ("dds_tpu_torch", 4)):
        (support, keys), repos = out[pkg]
        r0 = repos["replica-0"]
        values = [r0[k][1] for k in keys if k in r0]
        assert support == 3 and "SMUGGLED" not in r0, pkg
        assert ["tampered"] not in values and len(values) == n, pkg


def test_a_byzantine_peer_serving_a_newer_forged_value_cannot_fill_the_hole():
    """ROADMAP §C 23. The spares seed replica-0 with a tampered value of
    one key, which the manifest quorum rejects. The first peer the port's
    reseed asks for that hole, replica-1, is Byzantine: it holds the ABD
    secret and answers at seq + 1 with a forged value, validly signed.
    The port takes only the version f + 1 signers attested, from the next
    peer; the reference leaves the hole to the periodic loop. Neither
    installs the forgery."""

    async def go(c):
        keys = [await c.write([i, "honest"]) for i in range(5)]
        await c.net.quiesce()
        for spare in ("replica-7", "replica-8"):
            s = c.replicas[spare]
            tag, _ = s.repository[keys[0]]
            s._store(keys[0], tag, ["tampered"])
        byz = c.replicas["replica-1"]
        honest = byz.antientropy.handle
        asked = []

        def handle(sender, msg):
            if not (isinstance(msg, c.M.RepairRequest) and keys[0] in msg.keys):
                return honest(sender, msg)
            tag, _ = byz.repository[keys[0]]
            newer = c.M.ABDTag(tag.seq + 1, tag.id)
            sig = c.sigs.abd_signature(byz.cfg.abd_mac_secret, ["forged"], newer, msg.nonce)
            byz._send(sender, c.M.RepairReply(
                {keys[0]: {"tag": [newer.seq, newer.id], "value": ["forged"],
                           "sig": sig.hex()}}, msg.nonce))
            asked.append(sender)
            return True

        byz.antientropy.handle = handle
        await c.supervisor.recover("replica-0")
        await c.net.quiesce()
        return keys, asked

    out = both(go)
    for pkg, asked, held in (("dds_tpu", [], None), ("dds_tpu_torch", ["replica-0"], [0, "honest"])):
        (keys, got), repos = out[pkg]
        assert got == asked, pkg
        assert repos["replica-0"].get(keys[0], (None, None))[1] == held, pkg
        assert all(r.get(keys[0], (None, None))[1] != ["forged"] for r in repos.values()), pkg


def test_a_spares_hole_is_copied_into_the_reseed_in_the_reference_and_filled_in_the_port():
    """ROADMAP §C 23. Both spares lack one key (a hole an earlier reseed
    left, say of a key being written as its manifests were taken). The
    recovery seeds replica-0 from a spare's state, so the reference's
    replica-0 lacks the key too: each proactive recovery copies a spare's
    holes into the next victim, until no read quorum holds a copy and an
    acknowledged write reads as absent. The port's reseeded replica pulls
    every attested key its seed lacked from the peers at once."""

    async def go(c):
        keys = [await c.write([i, "kept"]) for i in range(4)]
        await c.net.quiesce()
        for spare in ("replica-7", "replica-8"):
            s = c.replicas[spare]
            s._install_repository({k: v for k, v in s.repository.items() if k != keys[2]})
        await c.supervisor.recover("replica-0")
        await c.net.quiesce()
        return keys

    out = both(go)
    holders = {}
    for pkg, ((keys), repos) in out.items():
        holders[pkg] = sorted(a for a, r in repos.items() if keys[2] in r)
        assert repos["replica-0"].get(keys[2], (None, None))[1] in (None, [2, "kept"])
    assert "replica-0" not in holders["dds_tpu"]
    assert "replica-0" in holders["dds_tpu_torch"]
    assert set(holders["dds_tpu_torch"]) - set(holders["dds_tpu"]) == {"replica-0"}


def test_a_write_taken_during_the_reseed_is_dropped_by_the_reference_and_kept_by_the_port():
    """ROADMAP §C 23. A write lands while replica-0 is between its Kill
    (wiped, healthy) and its seed's completion, so replica-0 acknowledges
    it as one of the quorum. The reference's reseed then replaces the
    whole repository and the write loses that copy; the port's keeps
    what the replica stored since its Kill."""

    async def go(c):
        keys = [await c.write([i, "before"]) for i in range(3)]
        await c.net.quiesce()
        real = c.supervisor._seed
        late = {}

        async def seed(*a, **kw):
            late["key"] = await c.write([9, "during"])
            await c.net.quiesce()
            late["held"] = late["key"] in c.replicas["replica-0"].repository
            return await real(*a, **kw)

        c.supervisor._seed = seed
        await c.supervisor.recover("replica-0")
        await c.net.quiesce()
        return keys, late

    out = both(go)
    for pkg, kept in (("dds_tpu", False), ("dds_tpu_torch", True)):
        (keys, late), repos = out[pkg]
        assert late["held"], pkg  # replica-0 stored the write before its seed
        r0 = repos["replica-0"]
        assert (late["key"] in r0) == kept, pkg
        assert all(k in r0 for k in keys), pkg


def test_antientropy_converges_stale_rejoined_replica_twin():
    async def go(c):
        keys = [await c.write([i, f"data-{i}"]) for i in range(12)]
        await c.net.quiesce()
        stale, peer = c.replicas["replica-1"], c.replicas["replica-2"]
        stale._install_repository({})
        repaired = 0
        for _ in range(3):
            repaired += await stale.antientropy.sync_once("replica-2")
            if stale.merkle.root() == peer.merkle.root():
                break
        assert all(stale.repository[k] == peer.repository[k] for k in keys)
        return repaired, stale.merkle.root() == peer.merkle.root(), stale.antientropy.rounds

    (repaired, converged, rounds), *_ = twins(go)
    assert repaired == 12 and converged and rounds == 1


def test_antientropy_in_sync_round_is_cheap_and_counted_twin():
    async def go(c):
        await c.write([1, "a"])
        await c.net.quiesce()
        node = c.replicas["replica-0"]
        repaired = await node.antientropy.sync_once("replica-1")
        stats = node.antientropy.stats()
        return repaired, stats["rounds"], stats["divergent_buckets"], \
            stats["last_sync_age"] is not None

    res, *_ = twins(go)
    assert res == (0, 1, 0, True)


def test_health_and_metrics_expose_recovery_gauges_twin(tmp_path):
    """/health grows the recovery section and /metrics the anti-entropy
    and snapshot families, with the reference's keys."""
    out = {}
    for pkg in ("dds_tpu", "dds_tpu_torch"):
        run = importlib.import_module(f"{pkg}.run")
        snap = SNAP[pkg]
        http = importlib.import_module(f"{pkg}.http.miniserver")
        d = tmp_path / pkg
        cfg = _launch_cfg(pkg, False, {"recovery": {
            "snapshot-dir": str(d), "anti-entropy-enabled": True,
            "anti-entropy-interval": 30.0}, "obs": {"metrics-route": True}})

        async def go():
            dep = await run.launch(cfg)
            try:
                secret = snap.derive_secret(cfg.security.abd_mac_secret.encode())
                snap.save_all(dep.replicas, d, secret=secret)
                await dep.replicas["replica-0"].antientropy.sync_once("replica-1")
                port = dep.server.cfg.port
                status, body = await http.http_request("127.0.0.1", port, "GET", "/health")
                mstatus, mbody = await http.http_request("127.0.0.1", port, "GET", "/metrics")
                return status, json.loads(body), mstatus, mbody.decode()
            finally:
                await dep.stop()

        out[pkg] = bounded(go())
    for pkg, (status, health, mstatus, text) in out.items():
        assert status == 200 and mstatus == 200, pkg
        rec = health["recovery"]["replica-0"]
        assert rec["anti_entropy"]["rounds"] == 1 and rec["anti_entropy"]["running"]
        assert rec["anti_entropy"]["last_sync_age"] is not None
        assert rec["snapshot"]["generation"] == 1 and rec["snapshot"]["age"] is not None
        assert rec["snapshot"]["verify_failures"] >= 0
        for family in ("dds_antientropy_divergent_buckets",
                       "dds_antientropy_last_sync_age_seconds",
                       "dds_snapshot_generation", "dds_snapshot_age_seconds",
                       "dds_trusted_replicas", "dds_replica_suspicion"):
            assert family in text, (pkg, family)
    ref, port = out["dds_tpu"][1], out["dds_tpu_torch"][1]
    assert set(port["recovery"]) == set(ref["recovery"])
    assert port["recovery"]["replica-0"].keys() == ref["recovery"]["replica-0"].keys()
    for k in ("status", "active_replicas", "reachable_replicas", "quorum_size",
              "stored_keys", "request_budget"):
        assert port[k] == ref[k], k
    assert {n: r["merkle_root"] for n, r in port["recovery"].items()} == \
        {n: r["merkle_root"] for n, r in ref["recovery"].items()}


# ------------------------------------------------------------- end to end


def test_sumall_during_a_byzantine_recovery_equals_the_reference():
    """default.toml's [replicas] and [recovery] with short timers on the
    `cpu` backend, 64 Paillier-512 rows through quorum PutSets in each
    package; Trudy (seeded alike) compromises f = 2 replicas, and a SumAll
    taken while the supervisor recovers the first victim gives the
    reference deployment's ciphertext, the Python-int fold of the stored
    ciphertexts, and decrypts to the total. Every PutSet reads back."""
    from dds_tpu_torch.models.paillier import PaillierKey

    key = PaillierKey.generate(512)
    pk = key.public
    rng = random.Random(13)
    rows = [[i, f"name-{i}", pk.encrypt(i + 1, rn=pk.blind(rng.getrandbits(400)))]
            for i in range(64)]
    total = 64 * 65 // 2
    fold = 1
    for r in rows:
        fold = fold * r[2] % pk.nsquare
    timers = {"enabled": True, "warm-up": 30.0, "interval": 30.0,
              "sentinent-awake-timeout": 0.5, "crashed-recovery-timeout": 1.0,
              "manifest-timeout": 0.5}

    def scenario(pkg):
        run = importlib.import_module(f"{pkg}.run")
        http = importlib.import_module(f"{pkg}.http.miniserver")
        cfg = _launch_cfg(pkg, True, {"recovery": timers})

        async def go():
            dep = await run.launch(cfg)
            try:
                port = dep.server.cfg.port
                sem = asyncio.Semaphore(8)

                async def put(r):
                    async with sem:
                        return await http.http_request(
                            "127.0.0.1", port, "POST", "/PutSet",
                            json.dumps({"contents": r}).encode())

                puts = await asyncio.gather(*(put(r) for r in rows))
                assert all(s == 200 for s, _ in puts)
                keys = [b.decode() for _, b in puts]
                target = f"/SumAll?position=2&nsqr={pk.nsquare}"
                status, before = await http.http_request("127.0.0.1", port, "GET", target)
                assert status == 200
                await dep.net.quiesce()
                dep.trudy._rng = random.Random(21)
                victims = dep.trudy.trigger("byzantine")
                await dep.net.quiesce()
                rec = asyncio.ensure_future(dep.supervisor.recover(victims[0]))
                await asyncio.sleep(0)
                in_flight = not dep.supervisor._idle.is_set()
                status, during = await http.http_request("127.0.0.1", port, "GET", target)
                await rec
                assert await dep.supervisor.wait_recovery_idle(10.0)
                reads = []
                for k in keys:
                    s, body = await http.http_request("127.0.0.1", port, "GET", f"/GetSet/{k}")
                    reads.append((s, json.loads(body)["contents"] if s == 200 else None))
                return (victims, in_flight, status, int(json.loads(before)["result"]),
                        int(json.loads(during)["result"]), reads,
                        [a for a, _ in dep.supervisor.active])
            finally:
                await dep.stop()

        return bounded(go())

    ref, port = scenario("dds_tpu"), scenario("dds_tpu_torch")
    victims, in_flight, status, before, during, reads, active = port
    assert victims == ref[0] and in_flight and ref[1]
    assert status == 200 == ref[2]
    assert before == during == ref[3] == ref[4] == fold
    assert key.decrypt(during) == total
    assert victims[0] not in active and victims[0] not in ref[6]
    assert [s for s, _ in reads] == [200] * 64
    assert sorted(json.dumps(v) for _, v in reads) == sorted(json.dumps(r) for r in rows)


def test_health_degrades_below_a_quorum_of_reachable_replicas_twin():
    """Two of the four coordinators' breakers open: /health answers 503,
    `degraded`, with the same counts and breaker states in both
    packages."""
    out = {}
    for pkg in ("dds_tpu", "dds_tpu_torch"):
        run = importlib.import_module(f"{pkg}.run")
        http = importlib.import_module(f"{pkg}.http.miniserver")
        cfg = _launch_cfg(pkg, False, {"replicas": {
            "endpoints": [f"replica-{i}" for i in range(4)], "sentinent": [],
            "byz-quorum-size": 3, "byz-max-faults": 1}})

        async def go():
            dep = await run.launch(cfg)
            try:
                for node in ("replica-1", "replica-2"):
                    for _ in range(3):
                        dep.server.abd._breaker(node).record_failure()
                status, body = await http.http_request(
                    "127.0.0.1", dep.server.cfg.port, "GET", "/health")
                health = json.loads(body)
                return (status, health["status"], health["reachable_replicas"],
                        health["active_replicas"], health["breakers"])
            finally:
                await dep.stop()

        out[pkg] = bounded(go())
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    assert out["dds_tpu_torch"] == (503, "degraded", 2, 4, {
        "replica-1": "open", "replica-2": "open"})
