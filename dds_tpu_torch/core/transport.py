"""Async message transports for the replicated core.

Copy of `dds_tpu/core/transport.py`. Control-plane messaging stays on the
CPU in plain asyncio, with two interchangeable transports:

- `InMemoryNet`: each send becomes a task that calls the destination's
  handler, like an actor tell — fire-and-forget and unordered; all
  integrity comes from the HMAC layer inside the messages. Tasks copy the
  sender's contextvars, so a replica's spans join the originating
  request's trace.
- `TcpNet`: length-prefixed JSON frames over asyncio TCP, optionally under
  mutual TLS, with a frame HMAC and per-process Ed25519 signatures — the
  multi-host fabric. Its frames are the reference's byte for byte, so a
  port process and a reference process verify each other's frames.

Addresses are opaque strings ("replica-3", "host:port/replica-3").
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import itertools
import json
import logging
import time
from typing import Awaitable, Callable, Optional

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.obs import context as obs_context
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils.tasks import supervised_task
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.transport")

Handler = Callable[[str, object], Awaitable[None]]


class Transport:
    """Interface: register local endpoints, send to any endpoint."""

    def register(self, addr: str, handler: Handler) -> None:
        raise NotImplementedError

    def unregister(self, addr: str) -> None:
        raise NotImplementedError

    def send(self, src: str, dest: str, msg: object) -> None:
        raise NotImplementedError

    def has_endpoint(self, addr: str) -> bool:
        raise NotImplementedError


class InMemoryNet(Transport):
    def __init__(self):
        self._handlers: dict[str, Handler] = {}
        self._tasks: set[asyncio.Task] = set()

    def register(self, addr: str, handler: Handler) -> None:
        self._handlers[addr] = handler

    def unregister(self, addr: str) -> None:
        self._handlers.pop(addr, None)

    def has_endpoint(self, addr: str) -> bool:
        return addr in self._handlers

    def send(self, src: str, dest: str, msg: object) -> None:
        task = supervised_task(self._deliver(src, dest, msg),
                               name=f"inmem.deliver:{dest}")
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _deliver(self, src: str, dest: str, msg: object) -> None:
        handler = self._handlers.get(dest)
        if handler is None:
            log.debug("drop %s -> %s (no endpoint): %s", src, dest, type(msg).__name__)
            return
        try:
            await handler(src, msg)
        except Exception:
            log.exception("handler error at %s for %s", dest, type(msg).__name__)

    async def quiesce(self) -> None:
        """Wait until all in-flight deliveries (and their follow-ups) drain."""
        while True:
            pending = [t for t in self._tasks if not t.done()]
            if not pending:
                break
            await asyncio.gather(*pending, return_exceptions=True)
            await asyncio.sleep(0)


class TcpNet(Transport):
    """Multi-host transport: frames are a 4-byte big-endian length and JSON.

    Each frame carries (src, dest, payload) and, when `frame_secret` is set,
    an HMAC-SHA256 over the canonical frame body: without it a keyless
    network attacker could spoof `src` and forge sender-keyed quorum votes
    (WriteAck, Suspect). With `node_key`/`peer_keys` every frame is also
    signed by this process's Ed25519 key and verified against the claimed
    src host's registered key (`utils/nodeauth`). TLS contexts wrap the
    sockets on top.

    One listening socket per process serves all endpoints registered on
    it; outbound connections are cached per destination host, one FIFO
    connection per pair.
    """

    # the largest frame received or sent (the reference's akka
    # maximum-frame-size is 30 MB): a peer declaring a huge length must not
    # make the receiver buffer it
    MAX_FRAME = 32 * 1024 * 1024

    def __init__(
        self,
        host: str,
        port: int,
        ssl_server=None,
        ssl_client=None,
        frame_secret: bytes | None = None,
        node_key=None,
        peer_keys: dict | None = None,
        advertise: str = "",
    ):
        self.host, self.port = host, port
        # the address peers use to reach and name this process ("host" or
        # "host:port"; empty = the bind address). A process that binds
        # 0.0.0.0, or an IP while peers dial a hostname, must advertise the
        # peer-visible address, or every signed inbound frame fails the
        # dest-host check and the fabric silently drops all traffic
        self._advertise = advertise
        self._handlers: dict[str, Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: dict[str, asyncio.StreamWriter] = {}
        # accepted connections and this transport's send and handler tasks,
        # closed and cancelled by `stop`, after which nothing is sent
        self._inbound: set[asyncio.StreamWriter] = set()
        self._tasks: set[asyncio.Task] = set()
        self._closed = False
        self._ssl_server, self._ssl_client = ssl_server, ssl_client
        self._frame_secret = frame_secret
        # node_key: this process's Ed25519 private key; peer_keys:
        # "host:port" -> public key. With peer_keys set, an inbound frame is
        # accepted only if its signature verifies against the claimed src's
        # registered key
        self._node_key = node_key
        self._peer_keys = peer_keys
        # signed frames carry a strictly increasing counter, seeded with
        # wall time so a restarted process keeps increasing; receivers keep
        # the highest seen per src host:port and drop frames at or below it,
        # so a captured signed frame (a Kill, say) cannot be replayed. Sound
        # because each sender->receiver pair rides one cached FIFO
        # connection and `_send` takes the counter and writes the frame with
        # no await between them. The limits are the reference's (DEPLOY.md
        # "Replay windows"): the receiver's marks live in memory, and a
        # sender whose clock steps back across its restart is dropped until
        # the clock catches up
        self._send_ctr = itertools.count(time.time_ns())
        self._seen_ctr: dict[str, int] = {}
        self._lock = asyncio.Lock()
        self.frames_sent = 0

    @staticmethod
    def _frame_body(src: str, dest: str, payload: dict, ctr=None) -> bytes:
        """The bytes the MAC and the signature cover, the reference's byte
        for byte."""
        return json.dumps([src, dest, ctr, payload], sort_keys=True).encode()

    def _frame_mac(self, body: bytes) -> str:
        return hmac.new(self._frame_secret, body, hashlib.sha256).hexdigest()

    @staticmethod
    def split(addr: str) -> tuple[str, int, str]:
        """"host:port/name" -> (host, port, name)."""
        hostport, name = addr.split("/", 1)
        host, port = hostport.rsplit(":", 1)
        return host, int(port), name

    @property
    def advertised(self) -> str:
        """This process's peer-visible "host:port" (see `advertise`)."""
        if self._advertise:
            if ":" in self._advertise:
                return self._advertise
            return f"{self._advertise}:{self.port}"
        return f"{self.host}:{self.port}"

    def local_addr(self, name: str) -> str:
        return f"{self.advertised}/{name}"

    def register(self, addr: str, handler: Handler) -> None:
        self._handlers[self.split(addr)[2] if "/" in addr else addr] = handler

    def unregister(self, addr: str) -> None:
        self._handlers.pop(self.split(addr)[2] if "/" in addr else addr, None)

    def has_endpoint(self, addr: str) -> bool:
        return addr.rsplit("/", 1)[-1] in self._handlers

    async def start(self) -> None:
        self._closed = False
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port, ssl=self._ssl_server
        )
        if self.port == 0:  # resolve an OS-assigned port for local_addr()
            self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        """Close the outbound connections first (their EOF ends the peers'
        serve loops on this host), then the listener and the connections it
        accepted, so `wait_closed` completes while remote peers still run;
        then cancel and await this transport's tasks. Nothing is sent after
        it."""
        self._closed = True
        for w in self._conns.values():
            w.close()
        self._conns.clear()
        if self._server:
            self._server.close()
            for w in list(self._inbound):
                w.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2)
            except asyncio.TimeoutError:
                pass
        tasks = [t for t in self._tasks if not t.done()]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    def _spawn(self, coro, name: str) -> None:
        task = supervised_task(coro, name=name)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._inbound.add(writer)
        try:
            while True:
                hdr = await reader.readexactly(4)
                size = int.from_bytes(hdr, "big")
                if size > self.MAX_FRAME:
                    log.warning("dropping connection from %s: %d-byte frame declared",
                                writer.get_extra_info("peername"), size)
                    break
                frame = await reader.readexactly(size)
                # a bad frame is logged and skipped: tearing down the shared
                # connection would lose every queued frame behind it
                try:
                    obj = json.loads(frame)
                    src, dest, payload = obj["src"], obj["dest"], obj["msg"]
                    if not isinstance(src, str) or not isinstance(dest, str):
                        raise ValueError("non-string src/dest")
                except Exception as e:
                    log.warning("dropping undecodable frame from %s: %s",
                                writer.get_extra_info("peername"), e)
                    continue
                if not self._authentic(obj, src, dest, payload):
                    continue
                handler = self._handlers.get(dest.split("/", 1)[1] if "/" in dest else dest)
                if handler is None:
                    continue
                try:
                    msg = M.from_dict(payload)
                except Exception as e:
                    log.warning("dropping frame with undecodable payload from %s: %s",
                                src, e)
                    continue
                # the sender's trace context joins the handler's spans to
                # the originating request's trace; a malformed field
                # degrades to an unlinked span, never a dropped message
                tc = obs_context.from_wire(obj.get("tc"))
                coro = (self._handle_traced(handler, tc, src, msg) if tc is not None
                        else handler(src, msg))
                self._spawn(coro, f"tcp.handle:{src}")
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            self._inbound.discard(writer)
            writer.close()

    def _authentic(self, obj: dict, src: str, dest: str, payload) -> bool:
        """The frame's MAC and node signature, where configured, check out,
        its signed dest names this process and its counter is new."""
        if self._frame_secret is None and self._peer_keys is None:
            return True
        body = self._frame_body(src, dest, payload, obj.get("ctr"))
        if self._frame_secret is not None and not hmac.compare_digest(
                obj.get("mac", ""), self._frame_mac(body)):
            log.warning("dropping frame with bad MAC (src claims %s)", src)
            return False
        if self._peer_keys is None:
            return True
        src_host = src.split("/", 1)[0]
        try:
            pub = self._peer_keys.get(src_host)
            if pub is None:
                raise ValueError("unregistered src host")
            # the signed dest must name this process by its advertised
            # address: endpoint names repeat across hosts (proxy-0,
            # nodehost), so a frame captured on its way to host A must not
            # verify and dispatch on host B
            if "/" in dest and dest.split("/", 1)[0] != self.advertised:
                raise ValueError("frame destined for another host")
            pub.verify(bytes.fromhex(obj.get("sig", "")), body)
            ctr = int(obj["ctr"])
            if ctr <= self._seen_ctr.get(src_host, -1):
                raise ValueError("replayed frame counter")
            self._seen_ctr[src_host] = ctr
        except Exception:
            log.warning("dropping frame with bad/missing node signature, wrong dest "
                        "host, or replayed counter (src claims %s)", src)
            return False
        return True

    @staticmethod
    async def _handle_traced(handler, tc, src: str, msg) -> None:
        token = obs_context.attach(tc)
        try:
            await handler(src, msg)
        finally:
            obs_context.detach(token)

    def send(self, src: str, dest: str, msg: object) -> None:
        if not self._closed:
            self._spawn(self._send(src, dest, msg), f"tcp.send:{dest}")

    async def _send(self, src: str, dest: str, msg: object) -> None:
        host, port, _ = self.split(dest)
        conn_key = f"{host}:{port}"
        try:
            async with self._lock:
                w = self._conns.get(conn_key)
                if w is None or w.is_closing():
                    _, w = await asyncio.open_connection(host, port, ssl=self._ssl_client)
                    self._conns[conn_key] = w
            # from here to the write there is no await: the counter order is
            # the order of the frames on the pair's one connection
            t_ser = time.perf_counter()
            payload = M.to_dict(msg)
            obj = {"src": src, "dest": dest, "msg": payload}
            # the task copied the sender's contextvars, so this is the
            # sender's span
            tc = obs_context.to_wire()
            if tc is not None:
                obj["tc"] = tc
            if self._frame_secret is not None or self._node_key is not None:
                ctr = next(self._send_ctr) if self._node_key is not None else None
                if ctr is not None:
                    obj["ctr"] = ctr
                body = self._frame_body(src, dest, payload, ctr)
                if self._frame_secret is not None:
                    obj["mac"] = self._frame_mac(body)
                if self._node_key is not None:
                    obj["sig"] = self._node_key.sign(body).hex()
            frame = json.dumps(obj).encode()
            if tc is not None:
                # Chronoscope's serialize stage: encode, JSON and the frame's
                # MAC and signature, on the sender's span
                cur = obs_context.current()
                tracer.record(
                    "net.serialize", (time.perf_counter() - t_ser) * 1e3,
                    _ctx=obs_context.child(cur) if cur is not None else None,
                    bytes=len(frame), dest=dest.rsplit("/", 1)[-1],
                )
            if len(frame) > self.MAX_FRAME:
                # the receive bound's twin: the receiver would drop the
                # shared connection and every frame queued behind this one
                log.error("refusing to send %d-byte frame %s -> %s (MAX_FRAME %d)",
                          len(frame), src, dest, self.MAX_FRAME)
                return
            t_drain = time.perf_counter()
            w.write(len(frame).to_bytes(4, "big") + frame)
            self.frames_sent += 1
            await w.drain()
            metrics.observe("dds_net_drain_seconds", time.perf_counter() - t_drain,
                            help="TCP send-buffer drain wait (backpressure signal)")
        except OSError:
            log.warning("send failed %s -> %s", src, dest)
            self._conns.pop(conn_key, None)
