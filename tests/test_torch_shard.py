"""The port's shard plane (`dds_tpu_torch/shard/`) against the reference's.

The same seeded inputs go through both packages and must give the same
answers: `ShardMap` owners of 10,000 seeded keys, the signed payload's
signature bytes, `moved_keys` over split, merge and relabel on random
rings, the fence lease's expiry on one fake clock; then a Constellation
of each package on the in-memory transport, driven through its router:
point ops land on exactly one group, the `read_tags` scatter agrees with
per-key reads and keeps the whole-cache identity, a stale epoch is fenced
with `WrongShardError` (no suspicion) and the same op lands after the
activation, and the storage-layer fence drops a raced `Write`. These are
the shapes of `tests/test_shard.py`'s own cases.
"""

import asyncio
import importlib
import random

import numpy as np
import pytest

SECRET = b"intranet-abd-secret"
BOUND = 60.0
PKGS = ("dds_tpu", "dds_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def shard(pkg: str):
    return mod(pkg, "shard")


def seeded_keys(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [f"K{int(x):x}" for x in rng.integers(0, 1 << 62, n)]


def twin(scenario):
    """`scenario(pkg)` on both packages; equal observations."""
    ref = asyncio.run(asyncio.wait_for(scenario("dds_tpu"), BOUND))
    port = asyncio.run(asyncio.wait_for(scenario("dds_tpu_torch"), BOUND))
    assert port == ref
    return port


def constellation(pkg: str, S: int = 2, seed: int = 7, **kw):
    net = mod(pkg, "core.transport").InMemoryNet()
    kw.setdefault("n_active", 4)
    kw.setdefault("n_sentinent", 1)
    kw.setdefault("quorum", 3)
    return shard(pkg).build_constellation(net, shard_count=S, vnodes_per_group=8,
                                          seed=seed, **kw), net


# ------------------------------------------------------------------ the map


@pytest.mark.parametrize("groups,vnodes", [(["s0", "s1"], 8), (["s0", "s1", "s2", "s3"], 16),
                                           (["a", "b", "c"], 3)])
def test_owner_of_seeded_keys_and_signature_bytes_equal(groups, vnodes):
    keys = seeded_keys(10_000, 11)
    maps = {pkg: shard(pkg).ShardMap.build(groups, vnodes).sign(SECRET) for pkg in PKGS}
    ref, port = maps["dds_tpu"], maps["dds_tpu_torch"]
    assert port.vnodes == ref.vnodes and port.groups == ref.groups
    assert port.signature == ref.signature and port.verify(SECRET)
    assert [port.owner(k) for k in keys] == [ref.owner(k) for k in keys]
    assert port.to_wire() == ref.to_wire()
    # a map crosses the wire both ways and still verifies
    assert shard("dds_tpu").ShardMap.from_wire(port.to_wire()).verify(SECRET)
    assert shard("dds_tpu_torch").ShardMap.from_wire(ref.to_wire()).verify(SECRET)


def test_a_tampered_map_fails_verification_in_both():
    for pkg in PKGS:
        m = shard(pkg).ShardMap.build(["s0", "s1"], 8).sign(SECRET)
        forged = shard(pkg).ShardMap(m.epoch, tuple((p, "s0") for p, _ in m.vnodes),
                                     m.groups, m.signature)
        assert m.verify(SECRET) and not forged.verify(SECRET)
        assert not m.verify(b"another-secret")
        with pytest.raises(ValueError):
            shard(pkg).ShardManager(forged, SECRET)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_moved_keys_over_split_merge_relabel_on_random_rings(seed):
    rng = random.Random(seed)
    S = rng.randint(2, 5)
    groups = [f"s{i}" for i in range(S)]
    vnodes = rng.randint(2, 12)
    victim = rng.choice(groups)
    keys = seeded_keys(2_000, seed)

    def moves(pkg):
        sh = shard(pkg)
        m = sh.ShardMap.build(groups, vnodes).sign(SECRET)
        split = m.split(victim, "sN").sign(SECRET)
        merged = split.merge("sN").sign(SECRET)
        gone = m.merge(victim).sign(SECRET)
        relabel = m.relabel(victim, "sR").sign(SECRET)
        return (split.signature, merged.signature, gone.signature, relabel.signature,
                m.absorbers(victim),
                sh.moved_keys(m, split, keys), sh.moved_keys(split, merged, keys),
                sh.moved_keys(m, gone, keys), sh.moved_keys(m, relabel, keys),
                [merged.owner(k) == m.owner(k) for k in keys])

    ref, port = moves("dds_tpu"), moves("dds_tpu_torch")
    assert port == ref
    # split-local and merge-local: only the victim's keys move
    m = shard("dds_tpu_torch").ShardMap.build(groups, vnodes)
    assert all(m.owner(k) == victim for k in port[5])
    assert all(m.owner(k) == victim for k in port[7])
    assert all(port[9])  # merge inverts split


def test_fence_lease_heals_to_the_committed_map_on_one_clock():
    def run(pkg):
        sh = shard(pkg)
        t = [100.0]
        m1 = sh.ShardMap.build(["s0", "s1"], 8).sign(SECRET)
        m2 = m1.split("s0", "s2").sign(SECRET)
        st = sh.ShardState("s0", m1, SECRET, clock=lambda: t[0])
        st.install(m2, lease=5.0)
        out = [st.epoch, st.leased, st.lease_remaining()]
        t[0] += 4.0
        out += [st.epoch, round(st.lease_remaining(), 6)]
        t[0] += 2.0
        out += [st.epoch, st.leased]
        with pytest.raises(ValueError):
            st.install(m1.sign(b"forged"))
        st.install(m2)
        with pytest.raises(ValueError):
            st.install(m1)  # epochs only move forward
        st.install(m1, force=True)
        out.append(st.epoch)
        mgr = sh.ShardManager(m1, SECRET)
        with pytest.raises(ValueError):
            mgr.activate(m1)
        mgr.begin_reshard()
        out.append(mgr.state)
        mgr.activate(m2)
        mgr.end_reshard()
        out += [mgr.epoch, mgr.state]
        return out

    assert run("dds_tpu_torch") == run("dds_tpu") == [2, True, 5.0, 2, 1.0, 1, False, 1,
                                                      "resharding", 2, "stable"]


# ---------------------------------------------------------- the router


def test_point_ops_route_to_exactly_one_group_twin():
    async def go(pkg):
        const, net = constellation(pkg, S=2)
        r = const.router
        keys = [f"ROUTE-{i}" for i in range(12)]
        try:
            wrote = [await r.write_set(k, [k]) for k in keys]
            read = [await r.fetch_set(k) for k in keys]
            await net.quiesce()
            holders = {}
            for k in keys:
                for g in const.groups:
                    n = sum(1 for node in g.replicas.values()
                            if node.repository.get(k, (None, None))[1] == [k])
                    if n:
                        holders.setdefault(k, []).append((g.gid, n >= g.quorum_size))
            return (wrote, read, [r.owner(k) for k in keys], holders,
                    r.load_census(), sorted(r.replicas.get_all()), r.group_ids())
        finally:
            await const.stop()

    wrote, read, owners, holders, census, members, gids = twin(go)
    assert wrote == [f"ROUTE-{i}" for i in range(12)] and read == [[k] for k in wrote]
    assert set(owners) == {"s0", "s1"}
    # every key is held by a quorum of its owner's replicas and nowhere else
    assert holders == {k: [(o, True)] for k, o in zip(wrote, owners)}
    assert sum(census.values()) == 24 and gids == ["s0", "s1"]
    assert len(members) == 8  # the active replicas of both groups


def test_router_read_tags_scatter_and_unchanged_identity_twin():
    async def go(pkg):
        const, net = constellation(pkg, S=2)
        r = const.router
        keys = sorted(f"TAGS-{i}" for i in range(8))
        try:
            for k in keys:
                await r.write_set(k, [k])
            parts = r.partition_keys(keys)
            tags = await r.read_tags(keys)
            per_key = [(await r.fetch_set_tagged(k))[1] for k in keys]
            cached = list(tags)
            again = await r.read_tags(keys, cached_tags=cached,
                                      fingerprint=b"ignored-by-router")
            # the tags' values hang on which replica coordinated each write
            # (its seq floor), a random pick: compare what must hold
            return ({g: len(v) for g, v in parts.items()}, all(t.seq >= 1 for t in tags),
                    tags == per_key, again is cached)
        finally:
            await const.stop()

    parts, written, agree, identity = twin(go)
    assert len(parts) == 2 and sum(parts.values()) == 8
    assert written and agree and identity


# ------------------------------------------------------------ fencing


def remap_all_to(pkg: str, smap, gid: str):
    """An epoch+1 map giving every vnode to `gid`, signed."""
    return shard(pkg).ShardMap(smap.epoch + 1, tuple((p, gid) for p, _ in smap.vnodes),
                               (gid,)).sign(SECRET)


def test_epoch_fence_rejects_stale_route_then_retry_lands_twin():
    async def go(pkg):
        WrongShardError = mod(pkg, "core.errors").WrongShardError
        metrics = mod(pkg, "obs.metrics").metrics
        const, net = constellation(pkg, S=2, n_sentinent=0)
        r = const.router
        try:
            smap = const.manager.current()
            key = next(k for k in (f"F{i}" for i in range(64)) if smap.owner(k) == "s1")
            await r.write_set(key, ["v0"])
            before = {m: metrics.value("dds_shard_fenced_total", shard="s1", msg=m) or 0
                      for m in ("IWrite", "IRead", "ReadTagBatch")}
            retries = metrics.value("dds_wrong_shard_retries_total", shard="s1") or 0
            m2 = remap_all_to(pkg, smap, "s0")
            const.group("s1").state.install(m2)  # freeze: s1 fences, router stale
            fenced = []
            for op in (lambda: r.write_set(key, ["v1"]), lambda: r.fetch_set(key),
                       lambda: r.read_tags([key])):
                try:
                    await op()
                    fenced.append(None)
                except WrongShardError as e:
                    fenced.append((e.replica_epoch, e.sent_epoch))
            await net.quiesce()
            counted = {m: (metrics.value("dds_shard_fenced_total", shard="s1", msg=m) or 0)
                       - before[m] for m in before}
            retried = (metrics.value("dds_wrong_shard_retries_total", shard="s1") or 0) - retries
            suspicions = sum(const.group("s1").client.replicas.suspicions().values())
            const.group("s0").state.install(m2)
            const.manager.activate(m2)
            await r.write_set(key, ["v1"])
            landed = await r.fetch_set(key)
            await net.quiesce()
            stale = [n.repository.get(key, (None, None))[1]
                     for n in const.group("s1").replicas.values()]
            return fenced, counted, retried, suspicions, landed, stale, r.owner(key)
        finally:
            await const.stop()

    fenced, counted, retried, suspicions, landed, stale, owner = twin(go)
    assert fenced == [(2, 1)] * 3
    # the coordinator and every replica of the tag round fence; no strike
    assert counted["IWrite"] == 1 and counted["IRead"] == 1 and counted["ReadTagBatch"] >= 3
    assert retried == 3 and suspicions == 0
    assert landed == ["v1"] and owner == "s0" and all(v == ["v0"] for v in stale)


def test_storage_layer_fence_blocks_raced_write_twin():
    """A Write broadcast minted before the freeze must not land after it:
    the storage fence drops it unstored and unacked, on a healthy replica
    and on a sentinent spare; an unsharded replica stores the same Write."""
    async def go(pkg):
        M = mod(pkg, "core.messages")
        sigs = mod(pkg, "utils.sigs")
        rep = mod(pkg, "core.replica")
        const, net = constellation(pkg, S=1, n_sentinent=1)
        g = const.group("s0")
        try:
            g.state.install(remap_all_to(pkg, const.manager.current(), "sX"))
            stored, acks = [], []
            net.register("spy", lambda s, m: acks.append(type(m).__name__) or asyncio.sleep(0))
            plain = rep.BFTABDNode("plain-0", ["plain-0"], "sup", net,
                                   rep.ReplicaConfig(quorum_size=1))
            for name in ("s0-replica-1", "s0-replica-4", None):
                node = g.replicas[name] if name else plain
                nonce = sigs.generate_nonce()
                tag = M.ABDTag(5, "s0-replica-0")
                sig = sigs.abd_signature(SECRET, ["stale"], tag, nonce)
                if node.behavior == "healthy":
                    node.incoming[nonce] = False  # the phase opened pre-freeze
                await node.handle("spy", M.Write(tag, "RACED", ["stale"], sig, nonce))
                stored.append("RACED" in node.repository)
            await net.quiesce()
            return stored, acks, plain.shard is None
        finally:
            await const.stop()

    assert twin(go) == ([False, False, True], ["WriteAck"], True)
