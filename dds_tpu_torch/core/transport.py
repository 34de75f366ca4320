"""Async message transport for the replicated core: `InMemoryNet`.

Trimmed copy of `dds_tpu/core/transport.py` (TcpNet waits for a later
slice). Control-plane messaging stays on the CPU in plain asyncio: each
send becomes a task that calls the destination's handler, like an actor
tell — fire-and-forget and unordered; all integrity comes from the HMAC
layer inside the messages. Tasks copy the sender's contextvars, so a
replica's spans join the originating request's trace.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable

from dds_tpu_torch.utils.tasks import supervised_task

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
