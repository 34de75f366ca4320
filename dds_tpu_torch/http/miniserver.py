"""Tiny asyncio HTTP/1.1 server + client.

Copy of `dds_tpu/http/miniserver.py`: request-line + headers +
Content-Length bodies, query strings and keep-alive over asyncio streams —
just enough HTTP/1.1 for the REST routes, with no external dependency.
With an `ssl_context` the server serves HTTPS (mutual TLS when the context
requires client certs) and the client speaks it.
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional
from urllib.parse import parse_qsl, unquote, urlsplit

MAX_BODY = 64 * 1024 * 1024

log = logging.getLogger("dds_torch.http")


@dataclass
class Request:
    method: str
    path: str            # decoded path, no query string
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes

    def json(self):
        return json.loads(self.body) if self.body else None


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "text/plain; charset=utf-8"
    headers: dict[str, str] = field(default_factory=dict)

    @staticmethod
    def json(obj, status: int = 200) -> "Response":
        return Response(status, json.dumps(obj).encode(), "application/json")

    @staticmethod
    def text(s: str, status: int = 200) -> "Response":
        return Response(status, s.encode())


_REASONS = {
    200: "OK", 304: "Not Modified", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    500: "Internal Server Error", 503: "Service Unavailable",
}

Handler = Callable[[Request], Awaitable[Response]]


class HttpServer:
    """`handler_timeout` (seconds, 0 = off) cancels a handler that outlives
    the REST layer's own budget; the client gets 503 + Retry-After.

    `stop()` closes the listener and every accepted connection: an idle
    one at once, one whose handler is still running (a parked `/shards`
    long-poll, a request in flight) after at most `STOP_GRACE` seconds,
    cancelling the handler, so a held connection never holds the stop to
    its own timeout (Python 3.12's `wait_closed` waits for every accepted
    connection)."""

    STOP_GRACE = 2.0

    def __init__(self, host: str, port: int, handler: Handler, ssl_context=None,
                 handler_timeout: float = 0.0):
        self.host, self.port = host, port
        self.handler = handler
        self.ssl_context = ssl_context
        self.handler_timeout = handler_timeout
        self._server: Optional[asyncio.AbstractServer] = None
        # each accepted connection's serving task -> whether a handler runs
        self._conns: dict[asyncio.Task, bool] = {}
        self._closing = False

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._serve, self.host, self.port,
                                                  ssl=self.ssl_context)
        if self.port == 0:  # resolve OS-assigned port
            self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if not self._server:
            return
        self._closing = True
        self._server.close()
        for task, busy in list(self._conns.items()):
            if not busy:
                task.cancel()
        running = list(self._conns)
        if running:
            _, late = await asyncio.wait(running, timeout=self.STOP_GRACE)
            for task in late:
                task.cancel()
            await asyncio.gather(*running, return_exceptions=True)
        try:
            await asyncio.wait_for(self._server.wait_closed(), 2)
        except asyncio.TimeoutError:
            pass

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        self._conns[task] = False
        try:
            while not self._closing:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
                try:
                    method, target, _ = line.decode().split(" ", 2)
                    headers: dict[str, str] = {}
                    while True:
                        h = await reader.readline()
                        if h in (b"\r\n", b"\n", b""):
                            break
                        name, _, val = h.decode().partition(":")
                        headers[name.strip().lower()] = val.strip()
                    length = int(headers.get("content-length", 0))
                    if not (0 <= length <= MAX_BODY):
                        raise ValueError("bad content-length")
                except (ValueError, UnicodeDecodeError):
                    writer.write(
                        b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n"
                        b"Connection: close\r\n\r\n"
                    )
                    await writer.drain()
                    break
                body = await reader.readexactly(length) if length else b""
                parts = urlsplit(target)
                req = Request(
                    method=method.upper(),
                    path=unquote(parts.path),
                    query=dict(parse_qsl(parts.query)),
                    headers=headers,
                    body=body,
                )
                self._conns[task] = True
                try:
                    if self.handler_timeout > 0:
                        resp = await asyncio.wait_for(
                            self.handler(req), self.handler_timeout
                        )
                    else:
                        resp = await self.handler(req)
                except asyncio.TimeoutError:
                    resp = Response(503, b"handler timed out",
                                    headers={"Retry-After": "1"})
                except Exception:
                    log.exception("handler error")
                    resp = Response(500)
                reason = _REASONS.get(resp.status, "Unknown")
                head = (
                    f"HTTP/1.1 {resp.status} {reason}\r\n"
                    f"Content-Type: {resp.content_type}\r\n"
                    f"Content-Length: {len(resp.body)}\r\n"
                )
                for k, v in resp.headers.items():
                    head += f"{k}: {v}\r\n"
                writer.write(head.encode() + b"\r\n" + resp.body)
                await writer.drain()
                self._conns[task] = False
                if headers.get("connection", "").lower() == "close":
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            self._conns.pop(task, None)
            writer.close()


async def http_request(host: str, port: int, method: str, target: str,
                       body: bytes | None = None,
                       content_type: str = "application/json",
                       ssl_context=None,
                       timeout: float = 30.0,
                       headers: dict[str, str] | None = None) -> tuple[int, bytes]:
    """One-shot HTTP client request (HTTPS with `ssl_context`); returns
    (status, body)."""
    status, _, data = await http_request_full(host, port, method, target, body,
                                              content_type, ssl_context, timeout,
                                              headers)
    return status, data


async def http_request_full(host: str, port: int, method: str, target: str,
                            body: bytes | None = None,
                            content_type: str = "application/json",
                            ssl_context=None,
                            timeout: float = 30.0,
                            headers: dict[str, str] | None = None,
                            ) -> tuple[int, dict, bytes]:
    """Like `http_request`, with the (lower-cased) response headers too:
    Retry-After and the other degradation metadata. `headers` adds request
    headers (the tenant header)."""

    async def go():
        reader, writer = await asyncio.open_connection(host, port, ssl=ssl_context)
        try:
            payload = body or b""
            extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
            head = (
                f"{method} {target} HTTP/1.1\r\n"
                f"Host: {host}:{port}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"{extra}"
                f"Connection: close\r\n\r\n"
            )
            writer.write(head.encode() + payload)
            await writer.drain()
            status_line = await reader.readline()
            try:
                status = int(status_line.split()[1])
            except (IndexError, ValueError):
                raise ConnectionError(f"malformed status line: {status_line!r}")
            rheaders: dict[str, str] = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                name, _, val = h.decode().partition(":")
                rheaders[name.strip().lower()] = val.strip()
            if "content-length" in rheaders:
                data = await reader.readexactly(int(rheaders["content-length"]))
            else:
                data = await reader.read()
            return status, rheaders, data
        finally:
            writer.close()

    return await asyncio.wait_for(go(), timeout)
