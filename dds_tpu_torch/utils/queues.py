"""TimedQueue: a bounded hand-off queue with enqueue timestamps.

Copy of `dds_tpu/utils/queues.py`, the write-ingest queue of the resident
plane and of the search plane: the request path appends work, a debounced worker drains it in
batches. Every entry is stamped at enqueue, its wait measured at drain,
and every discarded entry counted under a `reason` label (`full` at
offer time, `no_pool` for writes with no pool to ingest into), exported
as the reference's gauge family:

    dds_queue_depth{queue}                current entries
    dds_queue_oldest_age_seconds{queue}   age of the head entry
    dds_queue_dropped_total{queue,reason} cumulative discards (counter,
                                          incremented at drop time)
    dds_queue_wait_seconds{queue}         drain-time wait histogram

Drains record an `ingest.queue_wait` span (duration = the longest wait in
the batch). `maxlen=None` means unbounded; bounded queues reject at
`offer`/`offer_many` time with reason="full"; `clear(reason=)` counts
what it discards under that reason.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Iterable, Optional

from dds_tpu_torch.obs import context as obs_context
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils.trace import tracer

_WAIT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0)


class TimedQueue:
    """Thread-safe FIFO of (enqueue_ts, item) with drop accounting."""

    def __init__(self, name: str, maxlen: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry=metrics):
        self.name = name
        self.maxlen = None if maxlen is None else int(maxlen)
        self._clock = clock
        self._registry = registry
        self._lock = threading.Lock()
        self._entries: collections.deque = collections.deque()
        self._offered = 0
        self._drained = 0
        self._dropped: collections.Counter = collections.Counter()

    # -------------------------------------------------------------- enqueue

    def offer(self, item: Any) -> bool:
        """Append one entry; False = queue full (counted reason="full")."""
        now = self._clock()
        with self._lock:
            if self.maxlen is not None and len(self._entries) >= self.maxlen:
                self._dropped["full"] += 1
                full = True
            else:
                self._entries.append((now, item))
                self._offered += 1
                full = False
        if full:
            self._count_drop("full", 1)
        return not full

    def offer_many(self, items: Iterable[Any]) -> int:
        """Append entries until full; returns how many were accepted (the
        remainder are counted as reason="full" drops)."""
        items = list(items)
        if not items:
            return 0
        now = self._clock()
        with self._lock:
            if self.maxlen is None:
                room = len(items)
            else:
                room = max(0, self.maxlen - len(self._entries))
            take = items[:room]
            for item in take:
                self._entries.append((now, item))
            self._offered += len(take)
            rejected = len(items) - len(take)
            if rejected:
                self._dropped["full"] += rejected
        if rejected:
            self._count_drop("full", rejected)
        return len(take)

    def drop(self, n: int = 1, *, reason: str) -> None:
        """Account entries discarded for an external reason (e.g.
        Lodestone's pool-less writes, reason="no_pool") WITHOUT them ever
        entering the queue — the silent-drop fix."""
        if n <= 0:
            return
        with self._lock:
            self._dropped[reason] += n
        self._count_drop(reason, n)

    # ---------------------------------------------------------------- drain

    def drain(self) -> list:
        """Swap-and-drain every queued item (oldest first), recording the
        batch's queue-wait telemetry. Returns the bare items."""
        now = self._clock()
        with self._lock:
            if not self._entries:
                return []
            entries, self._entries = self._entries, collections.deque()
            self._drained += len(entries)
        self._record_wait([max(0.0, now - ts) for ts, _ in entries])
        return [item for _, item in entries]

    def clear(self, *, reason: Optional[str] = None) -> int:
        """Discard everything queued; with `reason` the discards count as
        drops (the search plane's invalidation), without it they simply
        vanish."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            if reason is not None and n:
                self._dropped[reason] += n
        if reason is not None and n:
            self._count_drop(reason, n)
        return n

    # ------------------------------------------------------------ telemetry

    def _count_drop(self, reason: str, n: int) -> None:
        try:
            self._registry.inc("dds_queue_dropped_total", n,
                               queue=self.name, reason=reason,
                               help="entries discarded per queue and reason")
        except Exception:  # noqa: BLE001 — telemetry never breaks the queue
            pass

    def _record_wait(self, waits: list[float]) -> None:
        oldest = max(waits)
        try:
            self._registry.observe("dds_queue_wait_seconds", oldest,
                                   buckets=_WAIT_BUCKETS, queue=self.name)
        except Exception:  # noqa: BLE001
            pass
        cur = obs_context.current()
        tracer.record(
            "ingest.queue_wait", oldest * 1e3,
            _ctx=obs_context.child(cur) if cur is not None else None,
            queue=self.name, n=len(waits),
        )

    # -------------------------------------------------------------- surface

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    def oldest_age(self) -> float:
        """Seconds the head entry has been waiting (0.0 when empty)."""
        with self._lock:
            if not self._entries:
                return 0.0
            head_ts = self._entries[0][0]
        return max(0.0, self._clock() - head_ts)

    def dropped(self, reason: Optional[str] = None) -> int:
        with self._lock:
            if reason is not None:
                return self._dropped.get(reason, 0)
            return sum(self._dropped.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": len(self._entries),
                "offered": self._offered,
                "drained": self._drained,
                "dropped": dict(self._dropped),
            }

    def export_gauges(self, registry=metrics) -> None:
        registry.set("dds_queue_depth", self.depth(), queue=self.name,
                     help="current entries per hand-off queue")
        registry.set("dds_queue_oldest_age_seconds",
                     round(self.oldest_age(), 6), queue=self.name,
                     help="age of the oldest queued entry per queue")
