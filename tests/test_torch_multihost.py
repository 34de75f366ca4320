"""The port's multi-process single-group topology against the reference's,
on the CPU, and a deployment split between the two packages.

Every twin runs once on `dds_tpu` and once on `dds_tpu_torch` from the same
inputs and must observe the same (`tests/test_core.py`, `tests/test_aux.py`
and `tests/test_fabric.py` are the map of cases): `launch` on the TCP
transport under intranet mutual TLS; two launches in one loop, each
hosting its own replicas (`[replicas] local`, `addresses`,
`supervisor-address`) under mutual TLS and Ed25519 node identities, with
quorums that span both; Trudy's crash and a suspicion quorum's recovery
over the fabric; the supervisor on host A redeploying a replica of host B
through B's `nodehost` agent; HTTPS at the REST edge with snapshots, and
`run_workload` over it; the fail-fast check of an advertised address the
registry lacks; the trace context across real sockets; `mint_node_keys`
and `--mint-node-keys`. The interop case launches the port as host A
(replicas 0–2, the supervisor and a proxy) and the reference as host B
(replicas 3–4 and a proxy): a write through either proxy reads back
through the other.

A process's addresses must be in the other's config before either binds,
so these cases take free ports (bind 0, close) and relaunch on fresh ones
if a port was taken in between; every other socket binds 0. Each case
bounds itself with `asyncio.wait_for`. Needs the `cryptography` package.
"""

import asyncio
import errno
import importlib
import json
import random
import socket
import time

import pytest

pytestmark = pytest.mark.multihost

PKGS = ("dds_tpu", "dds_tpu_torch")
BOUND = 30.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def twin(scenario, *args, bound: float = BOUND):
    ref, port = (asyncio.run(asyncio.wait_for(scenario(pkg, *args), bound)) for pkg in PKGS)
    assert port == ref
    return port


@pytest.fixture(autouse=True)
def crypto():
    pytest.importorskip("cryptography", reason="TLS certs and node keys need cryptography")


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


async def launch_all(boot, n: int, tries: int = 3) -> list:
    """`boot(ports)` launches deployments on `n` free transport ports and
    returns them; a port taken in between (EADDRINUSE) stops what it
    launched and retries on fresh ports."""
    for attempt in range(tries):
        deps = []
        try:
            await boot(free_ports(n), deps)
            return deps
        except OSError as e:
            for d in reversed(deps):
                await d.stop()
            if e.errno != errno.EADDRINUSE or attempt == tries - 1:
                raise


def base(pkg: str, port: int = 0, n: int = 4, spares=(), quorum: int = 3):
    """Both packages' config for one process of a TCP deployment: the
    same topology, recovery off, the proxy on an OS-assigned port folding
    on the host."""
    cfg = mod(pkg, "utils.config").DDSConfig()
    cfg.transport.kind = "tcp"
    cfg.transport.port = port
    cfg.replicas.endpoints = [f"replica-{i}" for i in range(n)]
    cfg.replicas.sentinent = list(spares)
    cfg.replicas.byz_quorum_size = quorum
    cfg.recovery.enabled = False
    cfg.proxy.port = 0
    cfg.proxy.crypto_backend = "cpu"
    if pkg == "dds_tpu_torch":
        cfg.proxy.device = cfg.client.device = "cpu"
    return cfg


def split(cfg, me: str, hosts: dict, local: list, sup: str) -> None:
    """Host `me` of `hosts` (name -> "host:port") runs `local`; every
    other replica maps to the host that runs it."""
    owner = {}
    for name, names in local.items():
        owner.update({r: hosts[name] for r in names})
    cfg.replicas.local = list(local[me])
    cfg.replicas.addresses = {r: hp for r, hp in owner.items() if hp != hosts[me]}
    cfg.replicas.supervisor_address = hosts[sup]


def unhost(names, hosts: dict) -> list:
    """Endpoint names with each process's "host:port" written as its name."""
    out = []
    for n in names:
        for h, hp in hosts.items():
            n = n.replace(hp, h)
        out.append(n)
    return sorted(out)


# --------------------------------------------------------------- one process


def test_launch_tcp_with_intranet_tls_end_to_end_twin(tmp_path):
    async def go(pkg):
        cfg = base(pkg)
        cfg.security.intranet_tls_enabled = True
        cfg.security.tls_dir = str(tmp_path / pkg)
        dep = await mod(pkg, "run").launch(cfg)
        try:
            abd = dep.server.abd
            k, t = await abd.write_set_tagged("tls-key", [41, 42])
            value, rt = await abd.fetch_set_tagged("tls-key")
            tags = await abd.read_tags(["tls-key"])
            hp = dep.net.advertised
            return (k, value, rt == t, tags == [rt], dep.net._ssl_server is not None,
                    unhost(dep.replicas, {"A": hp}), dep.supervisor is not None,
                    cfg.transport.port == int(hp.rsplit(":", 1)[1]) != 0)
        finally:
            await dep.stop()

    out = twin(go)
    assert out == ("tls-key", [41, 42], True, True, True,
                   [f"A/replica-{i}" for i in range(4)], True, True)


def test_launch_with_tls_and_snapshots_and_a_workload_over_https_twin(tmp_path):
    """HTTPS at the edge: a PutSet with the deployment's client context,
    the snapshot, a fresh boot restoring it, and `run_workload` driving
    generated digests over HTTPS."""

    async def go(pkg):
        run, snap = mod(pkg, "run"), mod(pkg, "core.snapshot")
        http = mod(pkg, "http.miniserver")
        cfg = base(pkg)
        cfg.transport.kind = "memory"
        cfg.security.tls_enabled = True
        cfg.security.tls_dir = str(tmp_path / pkg / "certs")
        cfg.recovery.snapshot_dir = str(tmp_path / pkg / "snaps")
        cfg.client.paillier_bits, cfg.client.rsa_bits = 256, 512
        cfg.client.nr_of_operations = 6
        dep = await run.launch(cfg)
        try:
            body = json.dumps({"contents": [1, 2, 3]}).encode()
            status, key = await http.http_request(
                "127.0.0.1", dep.server.cfg.port, "POST", "/PutSet", body,
                ssl_context=dep.ssl_client, timeout=10.0)
            plain = None
            try:
                await http.http_request("127.0.0.1", dep.server.cfg.port, "GET", "/health",
                                        timeout=2.0)
                plain = "served"
            except (OSError, asyncio.TimeoutError, ConnectionError):
                plain = "refused"
            saved = snap.save_all(dep.replicas, cfg.recovery.snapshot_dir)
            reports = await run.run_workload(dep, seed=3)
        finally:
            await dep.stop()
        dep2 = await run.launch(cfg)
        try:
            restored = sum(1 for r in dep2.replicas.values() if r.repository)
        finally:
            await dep2.stop()
        return (status, len(key), plain, saved,
                restored > 0, [(r.operations, r.failed) for r in reports])

    *out, reports = twin(go)
    assert out == [200, 128, "refused", 4, True]
    assert len(reports) == 1 and reports[0][0] >= 6 and reports[0][1] == 0


def test_launch_rejects_an_unregistered_advertised_address_twin(tmp_path):
    """Node identity on, and this process's advertised address missing from
    the registry: launch fails fast, and the listener it bound is closed."""

    async def go(pkg):
        na = mod(pkg, "utils.nodeauth")
        cfg = base(pkg)
        cfg.transport.host = "127.0.0.1"
        cfg.security.node_key_path = str(tmp_path / f"{pkg}.key")
        cfg.security.node_public_keys = {"10.9.9.9:2552": na.public_hex(na.generate())}
        try:
            await mod(pkg, "run").launch(cfg)
            return "launched"
        except ValueError as e:
            message = "advertised" in str(e)
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", cfg.transport.port))  # the listener is gone
        finally:
            s.close()
        return message, (tmp_path / f"{pkg}.key").stat().st_mode & 0o777

    assert twin(go) == (True, 0o600)


def test_trace_context_propagates_across_tcp_sockets_twin():
    """One PutSet through a TCP launch is one span tree: the write's
    spans are children of the request's root and every replica's handler
    span joined the same trace across a real frame."""

    async def go(pkg):
        tracer = mod(pkg, "utils.trace").tracer
        http = mod(pkg, "http.miniserver")
        cfg = base(pkg)
        cfg.obs.audit_enabled = False
        dep = await mod(pkg, "run").launch(cfg)
        try:
            tracer.reset()
            status, _ = await http.http_request(
                "127.0.0.1", dep.server.cfg.port, "POST", "/PutSet",
                json.dumps({"contents": ["a", "b"]}).encode(), timeout=15.0)
            await asyncio.sleep(0.2)  # straggler acks cross the sockets
        finally:
            await dep.stop()
        roots = tracer.events("http.POST.PutSet")
        root = roots[0]
        tree = [e for e in tracer.events() if e.trace_id == root.trace_id]
        writes = [e for e in tree if e.name == "abd.write"]
        handlers = [e for e in tree if e.name == "replica.handle"]
        return (status, len(roots), root.parent_id is None,
                bool(writes) and all(e.parent_id == root.span_id for e in writes),
                len({e.meta["replica"] for e in handlers}) >= 3,
                all(e.trace_id == root.trace_id for e in handlers),
                len(tracer.events("net.serialize")) > 0)

    assert twin(go) == (200, 1, True, True, True, True, True)


def test_trudy_crash_and_suspicion_recovery_over_tcp_twin():
    """The reference's 9-replica topology (2 spares, quorum 5) on one
    TcpNet: Trudy's crash rides the fabric, the damaged quorum serves, a
    suspicion quorum recovers a victim (a spare promoted, the victim
    redeployed in-process and reseeded) and fresh quorums complete."""

    async def go(pkg):
        M, sigs = mod(pkg, "core.messages"), mod(pkg, "utils.sigs")
        errors = mod(pkg, "core.errors")
        cfg = base(pkg, n=9, spares=("replica-7", "replica-8"), quorum=5)
        cfg.replicas.byz_max_faults = 2
        cfg.attacks.enabled = True
        cfg.recovery.sentinent_awake_timeout = 1.0
        cfg.recovery.crashed_recovery_timeout = 3.0
        cfg.proxy.intranet_request_timeout = 1.0
        dep = await mod(pkg, "run").launch(cfg)
        hp = dep.net.advertised
        retry = (errors.ByzantineError, asyncio.TimeoutError)

        async def attempt(op):
            for _ in range(8):
                try:
                    return await op()
                except retry:
                    continue
            raise AssertionError("quorum never completed")

        try:
            abd = dep.server.abd
            _, t = await abd.write_set_tagged("rkey", [1, 2])
            dep.trudy._rng = random.Random(5)
            victims = dep.trudy.trigger("crash")
            await asyncio.sleep(0.3)
            dead = [v.rsplit("/", 1)[-1] not in dep.net._handlers for v in victims]
            value, _ = await attempt(lambda: abd.fetch_set_tagged("rkey"))
            victim = victims[0]
            healthy = [a for a, _ in dep.supervisor.active if a not in victims]
            for voter in healthy[:5]:
                dep.net.send(voter, f"{hp}/supervisor",
                             M.Suspect(victim, sigs.generate_nonce()))
            for _ in range(40):
                await asyncio.sleep(0.2)
                if victim in dep.supervisor.sentinent:
                    break
            active = [a for a, _ in dep.supervisor.active]
            back = victim.rsplit("/", 1)[-1] in dep.net._handlers
            reseeded = dep.replicas[victim].repository.get("rkey", (None, None))[1]
            _, t2 = await attempt(lambda: abd.write_set_tagged("rkey2", [9]))
            return (unhost(victims, {"A": hp}), dead, value,
                    victim in dep.supervisor.sentinent, victim in active, len(active),
                    back, reseeded, t is not None and t2 is not None)
        finally:
            await dep.stop()

    victims, dead, *rest = twin(go)
    assert len(victims) == 2 and all(dead)
    assert rest == [[1, 2], True, False, 7, True, [1, 2], True]


# ---------------------------------------------------------- two processes


def two_host_boot(pkg_a: str, pkg_b: str, tmp_path, *, tls: bool, keys: bool,
                  n: int, spares=(), local_a, local_b, **extra):
    """`boot(ports, deps)` for `launch_all`: host A (`pkg_a`, the supervisor)
    and host B (`pkg_b`), each a `launch` on its own TcpNet; with `tls` one
    CA's mutual TLS on the fabric, with `keys` Ed25519 node identities
    minted by the port's `mint_node_keys`."""

    async def boot(ports, deps):
        hosts = {"A": f"127.0.0.1:{ports[0]}", "B": f"127.0.0.1:{ports[1]}"}
        local = {"A": local_a, "B": local_b}
        if tls:
            paths = mod(pkg_a, "utils.tlsutil").generate_ca_and_cert(
                tmp_path / "certs", hosts=("127.0.0.1",))
        if keys:
            import tomllib

            stanza = mod("dds_tpu_torch", "run").mint_node_keys(
                2, str(tmp_path / "keys"), [hosts["A"], hosts["B"]])
            registry = tomllib.loads(stanza)["security"]["node-public-keys"]
        for i, (name, pkg) in enumerate((("A", pkg_a), ("B", pkg_b))):
            cfg = base(pkg, ports[i], n=n, spares=spares)
            split(cfg, name, hosts, local, "A")
            for section, values in extra.items():
                for k, v in values.items():
                    setattr(getattr(cfg, section), k, v)
            if tls:
                cfg.security.intranet_tls_enabled = True
                cfg.security.tls_ca = str(paths["ca"])
                cfg.security.tls_cert = str(paths["cert"])
                cfg.security.tls_key = str(paths["key"])
            if keys:
                cfg.security.node_key_path = str(tmp_path / "keys" / f"node_{i}.key")
                cfg.security.node_public_keys = dict(registry)
            deps.append(await mod(pkg, "run").launch(cfg))
        return hosts

    return boot


def test_two_process_deployment_quorum_across_tcp_twin(tmp_path):
    """Two launches host disjoint halves of a 4-replica f = 1 quorum under
    mutual TLS and node identities: writes and reads coordinate across
    both processes, and both proxies see the data."""

    async def go(pkg):
        boot = two_host_boot(pkg, pkg, tmp_path / pkg, tls=True, keys=True, n=4,
                             local_a=["replica-0", "replica-1"],
                             local_b=["replica-2", "replica-3"])
        dep_a, dep_b = await launch_all(boot, 2)
        hosts = {"A": dep_a.net.advertised, "B": dep_b.net.advertised}
        try:
            k, t = await dep_a.server.abd.write_set_tagged("xhost", [5, 6])
            value, rt = await dep_a.server.abd.fetch_set_tagged("xhost")
            value_b, rt_b = await dep_b.server.abd.fetch_set_tagged("xhost")
            tags = await dep_b.server.abd.read_tags(["xhost"])
            holders = sum(1 for dep in (dep_a, dep_b) for node in dep.replicas.values()
                          if node.repository.get("xhost", (None, None))[1] == [5, 6])
            return (unhost(dep_a.replicas, hosts), unhost(dep_b.replicas, hosts),
                    dep_a.supervisor is not None, dep_b.supervisor is None,
                    k, value, value_b, rt == t == rt_b, tags == [t], holders >= 3,
                    dep_b.server.cfg.supervisor == f"{hosts['A']}/supervisor")
        finally:
            await dep_b.stop()
            await dep_a.stop()

    out = twin(go)
    assert out == (["A/replica-0", "A/replica-1"], ["B/replica-2", "B/replica-3"],
                   True, True, "xhost", [5, 6], [5, 6], True, True, True, True)


def test_cross_host_redeploy_recovers_a_dead_remote_replica_twin(tmp_path):
    """The supervisor on host A recovers a crashed replica of host B: the
    spare wakes over TCP, B's node agent rebuilds the victim on A's
    Redeploy and acks it, and the Sleep reseed lands on the fresh node."""

    async def go(pkg):
        M, sigs = mod(pkg, "core.messages"), mod(pkg, "utils.sigs")
        timing = {"attacks": {"enabled": True},
                  "recovery": {"sentinent_awake_timeout": 1.0,
                               "crashed_recovery_timeout": 3.0},
                  "proxy": {"intranet_request_timeout": 1.0}}
        boot = two_host_boot(pkg, pkg, tmp_path / pkg, tls=False, keys=False, n=5,
                             spares=("replica-4",),
                             local_a=["replica-0", "replica-1", "replica-2"],
                             local_b=["replica-3", "replica-4"], **timing)
        dep_a, dep_b = await launch_all(boot, 2)
        host_a, host_b = dep_a.net.advertised, dep_b.net.advertised
        try:
            await dep_a.server.abd.write_set_tagged("xk", [3])
            victim = f"{host_b}/replica-3"
            old_node = dep_b.replicas[victim]
            dep_a.net.send(f"{host_a}/trudy", victim, M.Crash())
            await asyncio.sleep(0.3)
            dead = "replica-3" not in dep_b.net._handlers
            for voter in (f"{host_a}/replica-{i}" for i in range(3)):
                dep_a.net.send(voter, f"{host_a}/supervisor",
                               M.Suspect(victim, sigs.generate_nonce()))
            for _ in range(40):
                await asyncio.sleep(0.2)
                if victim in dep_a.supervisor.sentinent:
                    break
            new_node = dep_b.replicas[victim]
            return (dead, victim in dep_a.supervisor.sentinent, new_node is not old_node,
                    "replica-3" in dep_b.net._handlers,
                    new_node.repository.get("xk", (None, None))[1], new_node.behavior,
                    unhost([a for a, _ in dep_a.supervisor.active],
                           {"A": host_a, "B": host_b}))
        finally:
            await dep_b.stop()
            await dep_a.stop()

    assert twin(go) == (True, True, True, True, [3], "sentinent",
                        ["A/replica-0", "A/replica-1", "A/replica-2", "B/replica-4"])


def test_port_host_a_and_reference_host_b_serve_one_quorum(tmp_path):
    """DEPLOY.md's two hosts split between the packages: the port runs
    replicas 0–2, the supervisor and a proxy; the reference runs replicas
    3–4 (4 a spare) and a proxy; intranet mutual TLS and node identities on
    both. Every quorum of 3 spans the two; a write through either proxy
    reads back through the other, and the reference's proxy learns the
    active set from the port's supervisor."""

    async def go():
        boot = two_host_boot("dds_tpu_torch", "dds_tpu", tmp_path, tls=True, keys=True,
                             n=5, spares=("replica-4",),
                             local_a=["replica-0", "replica-1", "replica-2"],
                             local_b=["replica-3", "replica-4"])
        dep_a, dep_b = await launch_all(boot, 2)
        try:
            async def http(dep, http_mod, method, target, obj=None):
                body = json.dumps(obj).encode() if obj is not None else None
                status, data = await http_mod.http_request(
                    "127.0.0.1", dep.server.cfg.port, method, target, body, timeout=10.0)
                return status, data

            port_http = mod("dds_tpu_torch", "http.miniserver")
            ref_http = mod("dds_tpu", "http.miniserver")
            out = []
            st, key = await http(dep_a, port_http, "POST", "/PutSet", {"contents": [7, "a"]})
            st2, got = await http(dep_b, ref_http, "GET", f"/GetSet/{key.decode()}")
            out.append((st, st2, json.loads(got)))
            st, key = await http(dep_b, ref_http, "POST", "/PutSet", {"contents": [8, "b"]})
            st2, got = await http(dep_a, port_http, "GET", f"/GetSet/{key.decode()}")
            out.append((st, st2, json.loads(got)))
            dep_b.server.abd.refresh_from(dep_b.server.cfg.supervisor)
            await asyncio.sleep(0.3)
            return out, sorted(dep_b.server.abd.replicas.get_trusted())
        finally:
            await dep_b.stop()
            await dep_a.stop()

    out, active = asyncio.run(asyncio.wait_for(go(), BOUND))
    assert out == [(200, 200, {"contents": [7, "a"]}), (200, 200, {"contents": [8, "b"]})]
    assert len(active) == 4 and not any(a.endswith("/replica-4") for a in active)


# ----------------------------------------------------------------- minting


def test_mint_node_keys_provisions_files_and_stanza_twin(tmp_path, capsys):
    import tomllib

    hosts = ["10.0.0.1:2552", "10.0.0.2:2552", "10.0.0.3:2552"]

    async def go(pkg):
        run, na = mod(pkg, "run"), mod(pkg, "utils.nodeauth")
        d = tmp_path / pkg
        stanza = run.mint_node_keys(3, str(d), hosts)
        again = run.mint_node_keys(3, str(d), hosts) == stanza  # never rotates
        registry = tomllib.loads(stanza)["security"]["node-public-keys"]
        keys_match = all(
            na.public_hex(na.load_private((d / f"node_{i}.key").read_text())) == registry[hp]
            for i, hp in enumerate(hosts))
        modes = {(d / f"node_{i}.key").stat().st_mode & 0o777 for i in range(3)}
        capsys.readouterr()
        run.main(["--mint-node-keys", "3", "--mint-dir", str(d),
                  "--mint-hosts", ",".join(hosts)])
        printed = capsys.readouterr().out == stanza
        defaults = sorted(tomllib.loads(run.mint_node_keys(2, str(d / "dflt")))
                          ["security"]["node-public-keys"])
        try:
            run.mint_node_keys(2, str(d / "bad"), hosts)
            mismatch = None
        except ValueError as e:
            mismatch = str(e)
        return (sorted(registry), again, keys_match, modes, printed, defaults, mismatch,
                stanza.splitlines()[:2])

    out = twin(go)
    assert out[:7] == (sorted(hosts), True, True, {0o600}, True,
                       ["127.0.0.1:2552", "127.0.0.1:2553"],
                       "--mint-node-keys 2 but 3 hosts given")


def test_stopping_a_tcp_launch_frees_its_listener_and_tasks():
    """Deployment.stop on the TCP transport: the listener is closed (its
    port binds again) and no transport task is left running, while the
    peer it was talking to still runs."""
    from dds_tpu_torch.utils.tasks import _TASKS

    async def go():
        boot = two_host_boot("dds_tpu_torch", "dds_tpu_torch", None, tls=False, keys=False,
                             n=4, local_a=["replica-0", "replica-1"],
                             local_b=["replica-2", "replica-3"])
        dep_a, dep_b = await launch_all(boot, 2)
        try:
            await dep_a.server.abd.write_set_tagged("k", [1])
            port_b = dep_b.net.port
            t0 = time.monotonic()
            await dep_b.stop()
            took = time.monotonic() - t0
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", port_b))  # as a listener would: no listener left
            finally:
                s.close()
            await asyncio.sleep(0)
            left = [t.get_name() for t in dep_b.net._tasks if not t.done()]
        finally:
            await dep_a.stop()
        await asyncio.sleep(0)
        return took, left, [t.get_name() for t in _TASKS if not t.done()]

    took, left, leaked = asyncio.run(asyncio.wait_for(go(), BOUND))
    assert took < 1.5 and left == [] and leaked == []
