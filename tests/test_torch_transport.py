"""The port's TCP fabric against the reference's, on the CPU, and the two
talking to each other.

Every twin runs once on `dds_tpu` and once on `dds_tpu_torch` from the same
inputs and must observe the same (`tests/test_core.py`, `tests/test_aux.py`
and `tests/test_panopticon.py` are the map of cases): the `TcpNet`
round trip, the frame MAC against a keyless forger, intranet mutual TLS
against a certless peer, `MAX_FRAME` on receive and on send, Ed25519 node
signatures against a credentialed member forging another's src, an
unsigned frame and a replayed one, the advertised address, undecodable
frames and payloads skipped on a live connection, hostile `tc` fields
clamped and counted, the `net.serialize` span and the drain histogram,
`ChaosNet` over a `TcpNet`, and the TLS helpers (certs, 0600 keys, the
contexts, an HTTPS round trip through the miniserver). The interop cases
put a reference `TcpNet` and a port `TcpNet` on one loop: MAC'd and signed
frames cross in both directions under mutual TLS, the frame bodies are the
same bytes, a forged frame is dropped by either side, and a key directory
minted by either package loads in the other.

Every socket binds port 0, so no case collides with another worker's; each
bounds itself with `asyncio.wait_for`. Needs the `cryptography` package
(TLS certs and Ed25519), as the reference's cases do.
"""

import asyncio
import importlib
import json
import logging
import ssl
import time

import pytest

pytestmark = pytest.mark.multihost

PKGS = ("dds_tpu", "dds_tpu_torch")
BOUND = 10.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def twin(scenario, *args):
    """`scenario(pkg, *args)` (a coroutine) on each package under its own
    loop and time limit; both must observe the same."""
    ref, port = (asyncio.run(asyncio.wait_for(scenario(pkg, *args), BOUND)) for pkg in PKGS)
    assert port == ref
    return port


@pytest.fixture(autouse=True)
def crypto():
    pytest.importorskip("cryptography", reason="TLS certs and node keys need cryptography")


async def raw_frames(port: int, objs, ssl_context=None) -> None:
    """Write each object (or raw bytes) as one frame on one fresh
    connection."""
    _, w = await asyncio.open_connection("127.0.0.1", port, ssl=ssl_context)
    for obj in objs:
        raw = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
        w.write(len(raw).to_bytes(4, "big") + raw)
    await w.drain()
    await asyncio.sleep(0.2)
    w.close()


async def until(cond, limit: float = 3.0) -> None:
    deadline = time.monotonic() + limit
    while not cond() and time.monotonic() < deadline:
        await asyncio.sleep(0.01)


# --------------------------------------------------------------- round trip


def test_tcp_roundtrip_twin():
    async def go(pkg):
        T, M = mod(pkg, "core.transport"), mod(pkg, "core.messages")
        net = T.TcpNet("127.0.0.1", 0)
        await net.start()
        got = asyncio.get_running_loop().create_future()

        async def handler(sender, msg):
            got.set_result((sender, M.to_dict(msg)))

        try:
            net.register(net.local_addr("alice"), handler)
            net.send("bob", net.local_addr("alice"), M.ReadTag("K", 77))
            return await asyncio.wait_for(got, 3)
        finally:
            await net.stop()

    assert twin(go) == ("bob", {"__msg__": "ReadTag", "key": "K", "nonce": 77})


def test_frame_mac_rejects_spoofed_frames_twin():
    async def go(pkg):
        T, M = mod(pkg, "core.transport"), mod(pkg, "core.messages")
        net = T.TcpNet("127.0.0.1", 0, frame_secret=b"cluster-secret")
        await net.start()
        got = []

        async def handler(sender, msg):
            got.append((sender, type(msg).__name__))

        try:
            sup = net.local_addr("sup")
            net.register(sup, handler)
            net.send("replica-0", sup, M.ReadTag("K", 1))
            await until(lambda: got)
            # a forger with socket access but no frame secret
            await raw_frames(net.port, [
                {"src": "replica-1", "dest": sup, "msg": M.to_dict(M.Suspect("replica-6", 99))},
                {"src": "replica-1", "dest": sup, "mac": "00" * 32,
                 "msg": M.to_dict(M.Suspect("replica-6", 98))},
            ])
            return got
        finally:
            await net.stop()

    assert twin(go) == [("replica-0", "ReadTag")]


def test_intranet_mutual_tls_rejects_certless_peer_twin(tmp_path):
    async def go(pkg):
        T, M, tls = mod(pkg, "core.transport"), mod(pkg, "core.messages"), mod(pkg, "utils.tlsutil")
        paths = tls.generate_ca_and_cert(tmp_path / pkg, hosts=("127.0.0.1",))
        ca, cert, key = paths["ca"], paths["cert"], paths["key"]
        net = T.TcpNet("127.0.0.1", 0, ssl_server=tls.server_context(cert, key, ca),
                       ssl_client=tls.client_context(ca, cert, key))
        await net.start()
        got = []

        async def handler(sender, msg):
            got.append((sender, type(msg).__name__))

        try:
            sup = net.local_addr("sup")
            net.register(sup, handler)
            net.send("replica-0", sup, M.ReadTag("K", 1))
            await until(lambda: got)
            # trusts the CA, presents no client certificate
            refused = False
            try:
                await raw_frames(net.port, [{"src": "replica-1", "dest": sup, "msg": {}}],
                                 ssl_context=tls.client_context(ca))
            except (ssl.SSLError, ConnectionResetError):
                refused = True
            return got, refused or len(got) == 1
        finally:
            await net.stop()

    got, refused = twin(go)
    assert got == [("replica-0", "ReadTag")] and refused


def test_oversized_frames_are_refused_both_ways_twin():
    """A declared length above MAX_FRAME drops the connection before
    anything is buffered; a frame above it is never sent (the shared
    connection would be dropped at the receiver); sane frames still flow."""

    async def go(pkg):
        T, M = mod(pkg, "core.transport"), mod(pkg, "core.messages")
        net = T.TcpNet("127.0.0.1", 0)
        await net.start()
        got = []

        async def handler(sender, msg):
            got.append(M.to_dict(msg))

        try:
            sup = net.local_addr("sup")
            net.register(sup, handler)
            r, w = await asyncio.open_connection("127.0.0.1", net.port)
            w.write((T.TcpNet.MAX_FRAME + 1).to_bytes(4, "big") + b"x" * 64)
            await w.drain()
            eof = await asyncio.wait_for(r.read(1), 2) == b""
            w.close()
            net.MAX_FRAME = 512
            net.send("a", sup, M.ReadTag("x" * 1024, 0))
            net.send("a", sup, M.ReadTag("k", 1))
            await until(lambda: got)
            await asyncio.sleep(0.1)
            return eof, got, T.TcpNet.MAX_FRAME
        finally:
            await net.stop()

    eof, got, limit = twin(go)
    assert eof and [d["__msg__"] for d in got] == ["ReadTag"] and limit == 32 * 1024 * 1024


def test_node_signed_frames_reject_credentialed_src_forgery_twin():
    """Member B holds a registered key and forges frames claiming A's
    replica and an unregistered host: only B's honest frame is accepted;
    an unsigned frame and a verbatim replay of a valid one are dropped."""

    async def go(pkg):
        T, M, na = mod(pkg, "core.transport"), mod(pkg, "core.messages"), mod(pkg, "utils.nodeauth")
        key_a, key_b = na.generate(), na.generate()
        reg = {}
        net_a = T.TcpNet("127.0.0.1", 0, node_key=key_a, peer_keys=reg)
        net_b = T.TcpNet("127.0.0.1", 0, node_key=key_b, peer_keys=reg)
        await net_a.start()
        await net_b.start()
        reg[net_a.advertised] = na.load_public(na.public_hex(key_a))
        reg[net_b.advertised] = na.load_public(na.public_hex(key_b))
        got = []

        async def handler(sender, msg):
            got.append((sender.split("/")[1], type(msg).__name__, msg.nonce))

        try:
            sup = net_a.local_addr("sup")
            net_a.register(sup, handler)
            net_b.send(net_b.local_addr("replica-2"), sup, M.WriteAck("k", 1))
            net_b.send(net_a.local_addr("replica-0"), sup, M.WriteAck("k", 2))
            net_b.send("10.0.0.9:999/replica-9", sup, M.WriteAck("k", 3))
            await until(lambda: got)
            await asyncio.sleep(0.2)
            src = net_b.local_addr("replica-2")
            await raw_frames(net_a.port, [
                {"src": src, "dest": sup, "msg": M.to_dict(M.WriteAck("k", 4))}])
            payload = M.to_dict(M.WriteAck("k", 5))
            ctr = 10**30
            body = T.TcpNet._frame_body(src, sup, payload, ctr)
            signed = {"src": src, "dest": sup, "msg": payload, "ctr": ctr,
                      "sig": key_b.sign(body).hex()}
            await raw_frames(net_a.port, [signed, signed])
            # signed for host A, delivered to host B: the dest pin drops it
            net_b.register(net_b.local_addr("sup"), handler)
            await raw_frames(net_b.port, [dict(signed, ctr=ctr + 1, sig=key_b.sign(
                T.TcpNet._frame_body(src, sup, payload, ctr + 1)).hex())])
            return got
        finally:
            await net_a.stop()
            await net_b.stop()

    assert twin(go) == [("replica-2", "WriteAck", 1), ("replica-2", "WriteAck", 5)]


def test_advertised_address_twin():
    async def go(pkg):
        T = mod(pkg, "core.transport").TcpNet
        return [T("0.0.0.0", 2552).advertised,
                T("0.0.0.0", 2552, advertise="10.0.0.9").advertised,
                T("0.0.0.0", 2552, advertise="10.0.0.9:9999").advertised,
                T("0.0.0.0", 2552, advertise="edge.example:2552").local_addr("r-0"),
                T.split("10.0.0.1:2552/replica-3")]

    assert twin(go) == ["0.0.0.0:2552", "10.0.0.9:2552", "10.0.0.9:9999",
                        "edge.example:2552/r-0", ("10.0.0.1", 2552, "replica-3")]


def test_undecodable_frames_do_not_kill_the_connection_twin():
    async def go(pkg):
        T, M = mod(pkg, "core.transport"), mod(pkg, "core.messages")
        net = T.TcpNet("127.0.0.1", 0)
        await net.start()
        got = []

        async def handler(src, msg):
            got.append(M.to_dict(msg))

        try:
            net.register("sink", handler)
            await raw_frames(net.port, [
                b"this is not json",
                {"src": "p"},
                {"src": "p", "dest": 123, "msg": {}},
                ["a", "list"],
                {"src": "p", "dest": "sink", "msg": {"__msg__": "Nope"}},
                {"src": "p", "dest": "sink", "msg": M.to_dict(M.Redeploy("replica-0"))},
            ])
            await until(lambda: got)
            return got
        finally:
            await net.stop()

    assert twin(go) == [{"__msg__": "Redeploy", "endpoint": "replica-0"}]


def test_hostile_tc_fields_are_clamped_counted_and_non_fatal_twin():
    async def go(pkg):
        T, M = mod(pkg, "core.transport"), mod(pkg, "core.messages")
        ctx, metrics = mod(pkg, "obs.context"), mod(pkg, "obs.metrics").metrics
        net = T.TcpNet("127.0.0.1", 0)
        await net.start()
        got = []

        async def handler(src, msg):
            cur = ctx.current()
            got.append((msg.nonce, cur.trace_id if cur is not None else None))

        net.register(net.local_addr("victim"), handler)
        before = metrics.value("dds_trace_context_malformed_total") or 0
        hostile = ["garbage-not-a-dict", {"t": "gg" * 8, "s": "ab12" * 4},
                   {"t": "a" * 40, "s": "ab12" * 4}, {"t": "ab12" * 4, "s": 12345},
                   {"t": "ab12" * 4, "s": "cd34" * 4}, None]
        try:
            frames = []
            for seq, tc in enumerate(hostile):
                obj = {"src": "10.6.6.6:666/evil", "dest": net.local_addr("victim"),
                       "msg": M.to_dict(M.ReadTag("k", seq))}
                if tc is not None:
                    obj["tc"] = tc
                frames.append(obj)
            await raw_frames(net.port, frames)
            await until(lambda: len(got) == 6)
            return got, (metrics.value("dds_trace_context_malformed_total") or 0) - before
        finally:
            await net.stop()

    got, malformed = twin(go)
    assert got == [(0, None), (1, None), (2, None), (3, None), (4, "ab12" * 4), (5, None)]
    assert malformed == 4


def test_serialize_span_and_drain_histogram_twin():
    """A send inside a span records `net.serialize` on the sender's trace
    (bytes and the bare dest name) and one drain observation; the receiver's
    handler runs under a child of the sender's span."""

    async def go(pkg):
        T, M = mod(pkg, "core.transport"), mod(pkg, "core.messages")
        tracer, ctx = mod(pkg, "utils.trace").tracer, mod(pkg, "obs.context")
        metrics = mod(pkg, "obs.metrics").metrics
        net = T.TcpNet("127.0.0.1", 0, frame_secret=b"s")
        await net.start()
        seen = asyncio.get_running_loop().create_future()

        async def handler(src, msg):
            seen.set_result(ctx.current())

        drains = lambda: metrics.render().count("dds_net_drain_seconds_count")  # noqa: E731
        tracer.reset()
        try:
            net.register(net.local_addr("sink"), handler)
            with tracer.span("test.send"):
                root = ctx.current()
                net.send("src", net.local_addr("sink"), M.ReadTag("k", 1))
            remote = await asyncio.wait_for(seen, 3)
            await asyncio.sleep(0.05)
            ser = tracer.events("net.serialize")
            return (len(ser), ser[0].meta["dest"], ser[0].meta["bytes"] > 0,
                    ser[0].trace_id == root.trace_id, remote.trace_id == root.trace_id,
                    remote.span_id == root.span_id, drains() > 0)
        finally:
            await net.stop()

    assert twin(go) == (1, "sink", True, True, True, True, True)


def test_chaosnet_wraps_a_tcpnet_twin():
    """ChaosNet over a TcpNet: registration, `has_endpoint` and `start`
    pass through; a partition and a dropped link act on the socket fabric;
    `quiesce` drains only the wrapper's deliveries and `stop` leaves the
    inner transport to its owner."""

    async def go(pkg):
        T, M = mod(pkg, "core.transport"), mod(pkg, "core.messages")
        C = mod(pkg, "core.chaos")
        inner = T.TcpNet("127.0.0.1", 0)
        net = C.ChaosNet(inner, seed=3)
        await net.start()
        got = []

        async def handler(src, msg):
            got.append((src.rsplit("/", 1)[-1], msg.nonce))

        try:
            a, b, c = (net.local_addr(n) for n in ("a", "b", "c"))
            net.register(b, handler)
            out = [inner.port != 0, net.has_endpoint(b), net.has_endpoint(c),
                   net.advertised == inner.advertised]
            p = net.partition(["a"], ["b"])
            net.send(a, b, M.ReadTag("k", 1))
            net.send(c, b, M.ReadTag("k", 2))
            p.heal()
            net.set_link("c", "b", C.LinkFaults(delay=0.05))
            net.send(c, b, M.ReadTag("k", 3))
            await net.quiesce()
            await until(lambda: len(got) == 2)
            await net.stop()
            out.append(inner._server.is_serving())
            return out, sorted(got), [t[1:] for t in net.trace]
        finally:
            await inner.stop()

    out, got, trace = twin(go)
    assert out == [True, True, False, True, True]
    assert got == [("c", 2), ("c", 3)] and trace[1] == ("a", "b", "ReadTag", "partition_drop")


# --------------------------------------------------------------------- TLS


def test_tls_cert_generation_and_contexts_twin(tmp_path):
    async def go(pkg):
        tls = mod(pkg, "utils.tlsutil")
        d = tmp_path / pkg
        paths = tls.generate_ca_and_cert(d, hosts=("127.0.0.1", "localhost"))
        pems = {k: p.read_bytes() for k, p in paths.items()}
        again = tls.generate_ca_and_cert(d)  # idempotent: nothing rewritten
        srv = tls.server_context(paths["cert"], paths["key"], paths["ca"])
        cli = tls.client_context(paths["ca"], paths["cert"], paths["key"])
        strict = tls.client_context(paths["ca"], verify_hostname=True)
        return (sorted(paths), again == paths,
                all(p.read_bytes() == pems[k] for k, p in again.items()),
                {k: p.stat().st_mode & 0o777 for k, p in paths.items() if "key" in k},
                srv.verify_mode == ssl.CERT_REQUIRED, cli.check_hostname,
                strict.check_hostname, srv.minimum_version == ssl.TLSVersion.TLSv1_2)

    assert twin(go) == (["ca", "ca_key", "cert", "key"], True, True,
                        {"ca_key": 0o600, "key": 0o600}, True, False, True, True)


def test_mutual_tls_http_roundtrip_twin(tmp_path):
    async def go(pkg):
        tls, http = mod(pkg, "utils.tlsutil"), mod(pkg, "http.miniserver")
        paths = tls.generate_ca_and_cert(tmp_path / pkg)
        srv_ctx = tls.server_context(paths["cert"], paths["key"], paths["ca"])
        cli_ctx = tls.client_context(paths["ca"], paths["cert"], paths["key"])

        async def handler(req):
            return http.Response.text("secure-ok")

        server = http.HttpServer("127.0.0.1", 0, handler, srv_ctx)
        await server.start()
        try:
            ok = await http.http_request("127.0.0.1", server.port, "GET", "/",
                                         ssl_context=cli_ctx, timeout=5.0)
            full = await http.http_request_full("127.0.0.1", server.port, "GET", "/",
                                                ssl_context=cli_ctx, timeout=5.0)
            refused = []
            for ctx in (tls.client_context(paths["ca"]), None):  # certless, plain
                try:
                    await http.http_request("127.0.0.1", server.port, "GET", "/",
                                            ssl_context=ctx, timeout=2.0)
                    refused.append(False)
                except (ssl.SSLError, OSError, asyncio.TimeoutError, ConnectionError):
                    refused.append(True)
            return ok, full[0], full[2], refused
        finally:
            await server.stop()

    assert twin(go) == ((200, b"secure-ok"), 200, b"secure-ok", [True, True])


# ---------------------------------------------------------------- interop


def crossed_pair(tmp_path, tls: bool):
    """A reference TcpNet and a port TcpNet with one frame secret, each its
    own node key in one registry and, with `tls`, one CA's mutual TLS."""
    import dds_tpu.core.transport as RT
    import dds_tpu.utils.nodeauth as RN
    import dds_tpu.utils.tlsutil as RTLS
    import dds_tpu_torch.core.transport as PT
    import dds_tpu_torch.utils.nodeauth as PN
    import dds_tpu_torch.utils.tlsutil as PTLS

    key_r, key_p = RN.generate(), PN.generate()
    reg_r, reg_p = {}, {}
    kw_r, kw_p = {}, {}
    if tls:
        paths = RTLS.generate_ca_and_cert(tmp_path, hosts=("127.0.0.1",))
        ca, cert, key = paths["ca"], paths["cert"], paths["key"]
        kw_r = dict(ssl_server=RTLS.server_context(cert, key, ca),
                    ssl_client=RTLS.client_context(ca, cert, key))
        kw_p = dict(ssl_server=PTLS.server_context(cert, key, ca),
                    ssl_client=PTLS.client_context(ca, cert, key))
    ref = RT.TcpNet("127.0.0.1", 0, frame_secret=b"fabric", node_key=key_r,
                    peer_keys=reg_r, **kw_r)
    port = PT.TcpNet("127.0.0.1", 0, frame_secret=b"fabric", node_key=key_p,
                     peer_keys=reg_p, **kw_p)

    async def start():
        await ref.start()
        await port.start()
        for reg, load in ((reg_r, RN.load_public), (reg_p, PN.load_public)):
            reg[ref.advertised] = load(RN.public_hex(key_r))
            reg[port.advertised] = load(PN.public_hex(key_p))

    return ref, port, key_r, key_p, start


@pytest.mark.parametrize("tls", [False, True], ids=["plain", "mutual-tls"])
def test_reference_and_port_tcpnets_exchange_signed_frames(tmp_path, tls):
    """MAC'd and Ed25519-signed frames cross in both directions, many in a
    row (the counters stay increasing on each pair's connection), with the
    trace context; each side decodes the other's messages to its own."""
    import dds_tpu.core.messages as RM
    import dds_tpu.obs.context as RC
    import dds_tpu_torch.core.messages as PM
    import dds_tpu_torch.obs.context as PC

    ref, port, _, _, start = crossed_pair(tmp_path, tls)

    async def go():
        await start()
        got = {"ref": [], "port": []}

        def sink(side, ctx):
            async def handler(src, msg):
                cur = ctx.current()
                got[side].append((src, type(msg).__module__.split(".")[0], msg.nonce,
                                  cur.trace_id if cur else None))
            return handler

        ref.register(ref.local_addr("r-sink"), sink("ref", RC))
        port.register(port.local_addr("p-sink"), sink("port", PC))
        try:
            token = PC.attach(PC.SpanContext("ab" * 8, "cd" * 8))
            for i in range(20):
                port.send(port.local_addr("proxy-0"), ref.local_addr("r-sink"),
                          PM.WriteAck("k", i))
            PC.detach(token)
            for i in range(20):
                ref.send(ref.local_addr("replica-3"), port.local_addr("p-sink"),
                         RM.WriteAck("k", i))
            await until(lambda: len(got["ref"]) == len(got["port"]) == 20, 5.0)
            return got
        finally:
            await port.stop()
            await ref.stop()

    got = asyncio.run(asyncio.wait_for(go(), BOUND))
    assert sorted(g[2] for g in got["ref"]) == list(range(20))
    assert sorted(g[2] for g in got["port"]) == list(range(20))
    assert {g[:2] for g in got["ref"]} == {(port.local_addr("proxy-0"), "dds_tpu")}
    assert {g[:2] for g in got["port"]} == {(ref.local_addr("replica-3"), "dds_tpu_torch")}
    assert {g[3] for g in got["ref"]} == {"ab" * 8} and {g[3] for g in got["port"]} == {None}


def test_frame_bodies_and_macs_are_the_same_bytes():
    import dds_tpu.core.messages as RM
    import dds_tpu.core.transport as RT
    import dds_tpu_torch.core.messages as PM
    import dds_tpu_torch.core.transport as PT

    for msg_r, msg_p in ((RM.WriteAck("k", 3), PM.WriteAck("k", 3)),
                         (RM.Redeploy("h:1/replica-3"), PM.Redeploy("h:1/replica-3")),
                         (RM.Suspect("r", 2**70), PM.Suspect("r", 2**70))):
        for ctr in (None, 12345678901234567890):
            b_r = RT.TcpNet._frame_body("h:1/a", "h:2/b", RM.to_dict(msg_r), ctr)
            b_p = PT.TcpNet._frame_body("h:1/a", "h:2/b", PM.to_dict(msg_p), ctr)
            assert b_r == b_p
            r, p = RT.TcpNet("h", 1, frame_secret=b"x"), PT.TcpNet("h", 1, frame_secret=b"x")
            assert r._frame_mac(b_r) == p._frame_mac(b_p)


@pytest.mark.parametrize("victim", ["ref", "port"])
def test_a_forged_frame_is_dropped_by_either_side(tmp_path, victim, caplog):
    """The other package's member, registered and holding the frame
    secret, forges the victim's own src; a frame with a bad MAC and one
    signed with the wrong key follow. The victim drops all three and still
    takes the honest frame that comes last on the same connection."""
    import dds_tpu.core.messages as RM
    import dds_tpu_torch.core.messages as PM

    ref, port, key_r, key_p, start = crossed_pair(tmp_path, False)
    net, other, key_other, M = ((ref, port, key_p, PM) if victim == "ref"
                                else (port, ref, key_r, RM))

    async def go():
        await start()
        got = []

        async def handler(src, msg):
            got.append((src, msg.nonce))

        sink = net.local_addr("sup")
        net.register(sink, handler)
        try:
            own = net.local_addr("replica-0")
            other.send(own, sink, M.WriteAck("k", 1))  # signed by the wrong key
            honest = other.local_addr("replica-4")
            payload = M.to_dict(M.WriteAck("k", 2))
            ctr = 10**25
            body = other._frame_body(honest, sink, payload, ctr)
            bad_mac = {"src": honest, "dest": sink, "msg": payload, "ctr": ctr,
                       "mac": "00" * 32, "sig": key_other.sign(body).hex()}
            await raw_frames(net.port, [bad_mac])
            other.send(honest, sink, M.WriteAck("k", 3))
            await until(lambda: got)
            await asyncio.sleep(0.1)
            return got
        finally:
            await port.stop()
            await ref.stop()

    with caplog.at_level(logging.WARNING):
        got = asyncio.run(asyncio.wait_for(go(), BOUND))
    assert got == [(other.local_addr("replica-4"), 3)]
    drops = [r for r in caplog.records if "dropping frame" in r.getMessage()]
    assert len(drops) == 2


@pytest.mark.parametrize("minter", PKGS)
def test_a_minted_key_directory_loads_in_the_other_package(tmp_path, minter):
    other = PKGS[1 - PKGS.index(minter)]
    hosts = ["10.0.0.1:2552", "10.0.0.2:2552"]
    stanza = mod(minter, "run").mint_node_keys(2, str(tmp_path), hosts)
    # the other package reuses the same files: the same stanza, the same keys
    assert mod(other, "run").mint_node_keys(2, str(tmp_path), hosts) == stanza
    na, nb = mod(minter, "utils.nodeauth"), mod(other, "utils.nodeauth")
    for i in range(2):
        path = tmp_path / f"node_{i}.key"
        a, b = na.load_or_create(path), nb.load_or_create(path)
        assert na.public_hex(a) == nb.public_hex(b) and na.private_hex(a) == nb.private_hex(b)
        sig = b.sign(b"frame")
        nb.registry({"h:1": na.public_hex(a)})["h:1"].verify(sig, b"frame")
