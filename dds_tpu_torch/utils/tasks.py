"""Supervised background tasks: no silent crashes, no GC'd handles.

Trimmed copy of `dds_tpu/utils/tasks.py`: the event loop keeps only weak
references to tasks, so `supervised_task` retains a strong one until the
task finishes and logs a crash the moment it happens. Cancellation is a
normal shutdown path and is not reported.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Coroutine

log = logging.getLogger("dds_torch.tasks")

_TASKS: set[asyncio.Task] = set()


def supervised_task(coro: Coroutine, name: str | None = None) -> asyncio.Task:
    """Spawn `coro` with a retained handle and crash reporting."""
    task = asyncio.ensure_future(coro)
    if name:
        task.set_name(name)
    _TASKS.add(task)
    task.add_done_callback(_reap)
    return task


def _reap(task: asyncio.Task) -> None:
    _TASKS.discard(task)
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        log.error("supervised task %r crashed: %r", task.get_name(), exc,
                  exc_info=exc)
