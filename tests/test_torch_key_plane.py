"""The port proxy's key plane against the reference's
(`dds_tpu/http/server.py`: `_load_keys`, `_write_keys_snapshot`,
`_save_keys_soon`, `_bootstrap_keys_from_peers`, `_key_sync_loop`,
`GET /_sync`).

Twins of `tests/test_rest.py`'s key-plane cases — two proxies gossiping
their key sets, the stored keys surviving a proxy restart through the
snapshot, a restarted proxy pulling them from a peer at start — run in
both packages on the same ciphertexts (one reference key carried across
by `convert.keys_from_reference`), every status and SumAll ciphertext
equal. Then Bastion's owner map across a restart (a cross-tenant 403
stays a 403), the snapshot's bytes equal to the reference's for the same
store in both shapes (the sorted list; `{"keys", "tenants"}` with
owners), and each package's snapshot loading in the other.
"""

import asyncio
import contextlib
import importlib
import json
import random

import pytest

from dds_tpu.models import HEKeys as RefKeys

PACKAGES = ("dds_tpu", "dds_tpu_torch")
KEYS = RefKeys.generate(paillier_bits=512, rsa_bits=512)
PK = KEYS.psse.public


def rows(n: int, seed: int) -> tuple[list, list]:
    """n one-column rows of Paillier ciphertexts and their plaintexts."""
    rng = random.Random(seed)
    vals = [rng.randrange(1 << 24) for _ in range(n)]
    return [[str(PK.encrypt(v))] for v in vals], vals


class Stack:
    """Replicas on one in-memory net (7, quorum 5) and proxies over them,
    in either package; the port's proxies fold on the CPU."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        net = importlib.import_module(f"{pkg}.core.transport")
        rep = importlib.import_module(f"{pkg}.core.replica")
        self.qc = importlib.import_module(f"{pkg}.core.quorum_client")
        self.srv = importlib.import_module(f"{pkg}.http.server")
        self.mini = importlib.import_module(f"{pkg}.http.miniserver")
        self.cfgm = importlib.import_module(f"{pkg}.utils.config")
        self.net = net.InMemoryNet()
        self.addrs = [f"replica-{i}" for i in range(7)]
        self.replicas = {a: rep.BFTABDNode(a, self.addrs, "supervisor", self.net,
                                           rep.ReplicaConfig(quorum_size=5))
                         for a in self.addrs}
        self.servers = []

    def abd(self, name: str = "proxy-0"):
        client = self.qc.AbdClient(name, self.net, self.addrs,
                                   self.qc.AbdClientConfig(request_timeout=2.0,
                                                           quorum_size=5))
        client.replicas._rng = random.Random(7)
        return client

    async def proxy(self, abd=None, tenancy: bool = False, **kw):
        if self.pkg == "dds_tpu_torch":
            kw.update(device="cpu", crypto_backend="cpu")
        if tenancy:
            kw["tenancy"] = self.cfgm.TenancyConfig(enabled=True)
        server = self.srv.DDSRestServer(abd or self.abd(), self.srv.ProxyConfig(
            host="127.0.0.1", port=0, **kw))
        await server.start()
        self.servers.append(server)
        return server

    async def call(self, server, method: str, target: str, obj=None, tenant=None):
        body = json.dumps(obj).encode() if obj is not None else None
        return await self.mini.http_request(
            "127.0.0.1", server.cfg.port, method, target, body, timeout=10.0,
            headers={"x-dds-tenant": tenant} if tenant else None)

    async def sumall(self, server) -> int:
        status, data = await self.call(server, "GET", f"/SumAll?position=0&nsqr={PK.nsquare}")
        assert status == 200, data
        return int(json.loads(data)["result"])

    async def close(self):
        for s in self.servers:
            with contextlib.suppress(Exception):
                await s.stop()


def twins(scenario) -> dict:
    """`scenario(stack)` in each package (bounded); the port's result must
    equal the reference's."""
    out = {}
    for pkg in PACKAGES:
        async def go():
            stack = Stack(pkg)
            try:
                return await scenario(stack)
            finally:
                await stack.close()
        out[pkg] = asyncio.run(asyncio.wait_for(go(), 60))
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    return out["dds_tpu_torch"]


def test_proxy_gossip_between_two_proxies_twin():
    """A key PutSet through proxy-1 reaches proxy-0 by proxy-1's push, and
    proxy-0's SumAll folds it."""

    async def go(st):
        s1 = await st.proxy()
        s2 = await st.proxy(st.abd("proxy-1"), key_sync_enabled=True, key_sync_warmup=0.05,
                            key_sync_interval=0.2, peers=[f"127.0.0.1:{s1.cfg.port}"])
        status, key = await st.call(s2, "POST", "/PutSet", {"contents": [1, 2]})
        await asyncio.sleep(0.4)  # let the push fire
        _, data = await st.call(s1, "GET", "/SumAll?position=0")
        return status, key.decode() in s1.stored_keys, json.loads(data)["result"]

    assert twins(go) == (200, True, "1")


def test_stored_keys_survive_proxy_restart_via_snapshot_twin(tmp_path):
    """A fresh server object on the same snapshot path recovers every key
    and folds all of them: the SumAll does not shrink."""
    cts, vals = rows(6, 1)

    async def go(st):
        snap = str(tmp_path / st.pkg / "proxy_keys.json")
        abd = st.abd()
        s1 = await st.proxy(abd, keys_path=snap)
        for r in cts:
            status, _ = await st.call(s1, "POST", "/PutSet", {"contents": r})
            assert status == 200
        before = await st.sumall(s1)
        await s1.stop()  # flushes the debounced snapshot
        st.servers.remove(s1)
        s2 = await st.proxy(abd, keys_path=snap)
        return len(s2.stored_keys), before, await st.sumall(s2), sorted(s2.stored_keys)

    n, before, after, keys = twins(go)
    assert n == len(vals) and before == after
    assert KEYS.psse.decrypt(after) == sum(vals)


def test_stored_keys_bootstrap_pull_from_peer_on_start_twin():
    """A proxy restarted without a snapshot pulls GET /_sync from its peer
    at start (the long gossip interval proves it is the pull); a proxy
    without key sync answers that route 404."""
    cts, vals = rows(3, 2)

    async def go(st):
        s1 = await st.proxy(key_sync_enabled=True, key_sync_warmup=60.0,
                            key_sync_interval=60.0)
        for r in cts:
            await st.call(s1, "POST", "/PutSet", {"contents": r})
        on, listed = await st.call(s1, "GET", "/_sync")
        off_server = await st.proxy(st.abd("proxy-1"))
        off, _ = await st.call(off_server, "GET", "/_sync")
        s2 = await st.proxy(st.abd("proxy-2"), key_sync_enabled=True, key_sync_warmup=60.0,
                            key_sync_interval=60.0, peers=[f"127.0.0.1:{s1.cfg.port}"])
        return (on, sorted(json.loads(listed)["keyset"]), off, len(s2.stored_keys),
                await st.sumall(s2))

    on, listed, off, n, total = twins(go)
    assert (on, off, n) == (200, 404, len(vals)) and len(listed) == len(vals)
    assert KEYS.psse.decrypt(total) == sum(vals)


def test_a_cross_tenant_403_stays_a_403_across_a_restart_twin(tmp_path):
    """With tenancy the snapshot carries each key's owner: the restarted
    proxy still refuses bob alice's row and serves it to alice."""
    cts, _ = rows(2, 3)

    async def go(st):
        snap = str(tmp_path / st.pkg / "keys.json")
        abd = st.abd()
        s1 = await st.proxy(abd, tenancy=True, keys_path=snap)
        keys = []
        for r, tenant in zip(cts, ("alice", "bob")):
            status, key = await st.call(s1, "POST", "/PutSet", {"contents": r}, tenant)
            assert status == 200
            keys.append(key.decode())
        before = [(await st.call(s1, "GET", f"/GetSet/{keys[0]}", tenant=t))[0]
                  for t in ("bob", "alice")]
        await s1.stop()
        st.servers.remove(s1)
        shape = json.loads((tmp_path / st.pkg / "keys.json").read_text())
        s2 = await st.proxy(abd, tenancy=True, keys_path=snap)
        after = [(await st.call(s2, "GET", f"/GetSet/{keys[0]}", tenant=t))[0]
                 for t in ("bob", "alice")]
        status, body = await st.call(s2, "GET", f"/GetSet/{keys[1]}", tenant="alice")
        return before, after, status, json.loads(body), shape, dict(s2._tenant_owner)

    before, after, status, body, shape, owners = twins(go)
    assert before == after == [403, 200]
    assert status == 403 and body["tenant"] == "alice"
    assert set(shape) == {"keys", "tenants"}
    assert sorted(owners.values()) == ["alice", "bob"]


@pytest.mark.parametrize("tenancy", [False, True], ids=["list", "owners"])
def test_snapshot_bytes_equal_the_reference_and_cross_load(tmp_path, tenancy):
    """The same store gives the same snapshot bytes in both packages, in
    the legacy list shape and with owners; each package's file loads in
    the other to the same keys and owners."""
    cts, _ = rows(5, 4)

    async def go(st):
        snap = tmp_path / st.pkg / "keys.json"
        s = await st.proxy(tenancy=tenancy, keys_path=str(snap))
        for i, r in enumerate(cts):
            await st.call(s, "POST", "/PutSet", {"contents": r},
                          ("alice", "bob")[i % 2] if tenancy else None)
        # a removal, a gossiped key, then the debounce writes (no stop yet)
        await st.call(s, "DELETE", f"/RemoveSet/{sorted(s.stored_keys)[0]}",
                      tenant=s._tenant_owner.get(sorted(s.stored_keys)[0]))
        await st.call(s, "POST", "/_sync", {"keyset": ["GOSSIPED"]})
        await asyncio.sleep(0.5)
        return snap.read_bytes()

    out = {}
    for pkg in PACKAGES:
        async def run_one():
            st = Stack(pkg)
            try:
                return await go(st)
            finally:
                await st.close()
        out[pkg] = asyncio.run(asyncio.wait_for(run_one(), 60))
    assert out["dds_tpu_torch"] == out["dds_tpu"]
    body = json.loads(out["dds_tpu"])
    assert isinstance(body, dict) == tenancy
    keys = body["keys"] if tenancy else body
    assert keys == sorted(keys) and "GOSSIPED" in keys and len(keys) == 5

    async def load(pkg: str, path):
        st = Stack(pkg)
        try:
            s = await st.proxy(tenancy=tenancy, keys_path=str(path))
            return sorted(s.stored_keys), dict(s._tenant_owner)
        finally:
            await st.close()

    for writer, reader in (("dds_tpu", "dds_tpu_torch"), ("dds_tpu_torch", "dds_tpu")):
        got = asyncio.run(load(reader, tmp_path / writer / "keys.json"))
        assert got == asyncio.run(load(writer, tmp_path / writer / "keys.json"))
        assert got[0] == keys


def test_a_malformed_or_unreadable_snapshot_is_ignored_twin(tmp_path):
    for i, text in enumerate(("{not json", '{"keys": 7}', '"a string"')):
        async def go(st):
            snap = tmp_path / st.pkg / f"bad-{i}.json"
            snap.parent.mkdir(parents=True, exist_ok=True)
            snap.write_text(text)
            s = await st.proxy(keys_path=str(snap))
            return sorted(s.stored_keys)

        assert twins(go) == []
