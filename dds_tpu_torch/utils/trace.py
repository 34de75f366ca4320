"""Structured tracing: causally linked spans and point events.

Trimmed copy of `dds_tpu/utils/trace.py` (the subscriber feed and JSONL
dump wait for the obs planes). Every recorded span carries `(trace_id,
span_id, parent_id)` from `obs.context`, so one REST request yields a span
tree — HTTP route -> quorum round -> replica handler -> kernel phase. The
span names match the reference's (`http.GET.SumAll`, `proxy.fetch_stored`,
`abd.read_tags`, `abd.fetch`, `proxy.fold`, `kernel.*`), so a phase split
of the port compares with the reference's.

    from dds_tpu_torch.utils.trace import tracer
    with tracer.span("abd.fetch", key=key) as meta:
        meta["coordinator"] = coord
    print(tracer.summary())
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from dds_tpu_torch.obs import context as obs_context


@dataclass
class SpanRecord:
    ts: float
    name: str
    dur_ms: float
    meta: dict
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_id: Optional[str] = None
    kind: str = "span"  # "span" (timed) | "event" (zero-duration annotation)


def _percentile(sorted_durs: list[float], q: float) -> float:
    """Nearest-rank percentile over an ascending list."""
    k = len(sorted_durs)
    return sorted_durs[max(0, min(k - 1, math.ceil(q * k) - 1))]


@dataclass
class Tracer:
    """Thread-safe bounded span recorder."""

    max_events: int = 65536
    _events: collections.deque = field(init=False, repr=False)
    _lock: threading.Lock = field(init=False, repr=False)

    def __post_init__(self):
        self._events = collections.deque(maxlen=self.max_events)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, /, _ctx: Optional[obs_context.SpanContext] = None,
             **meta):
        """Timed span; yields the mutable meta dict for mid-span facts and
        installs a child trace context for its duration."""
        ctx = _ctx if _ctx is not None else obs_context.child()
        token = obs_context.attach(ctx)
        t0 = time.perf_counter()
        try:
            yield meta
        finally:
            obs_context.detach(token)
            self.record(name, (time.perf_counter() - t0) * 1e3, _ctx=ctx, **meta)

    def record(self, name: str, dur_ms: float, /,
               _ctx: Optional[obs_context.SpanContext] = None,
               _kind: str = "span", **meta) -> None:
        ctx = _ctx if _ctx is not None else obs_context.current()
        tid, sid, pid = (
            (ctx.trace_id, ctx.span_id, ctx.parent_id) if ctx is not None
            else (None, None, None)
        )
        rec = SpanRecord(time.time(), name, dur_ms, meta, tid, sid, pid, _kind)
        with self._lock:
            self._events.append(rec)

    def event(self, name: str, /, **meta) -> None:
        """Zero-duration annotation attached to the active trace."""
        cur = obs_context.current()
        ctx = obs_context.child(cur) if cur is not None else None
        self.record(name, 0.0, _ctx=ctx, _kind="event", **meta)

    def events(self, name: str | None = None) -> list[SpanRecord]:
        with self._lock:
            evs = list(self._events)
        return [e for e in evs if name is None or e.name == name]

    def summary(self) -> dict[str, dict]:
        """Per-span-name {count, total_ms, mean_ms, p50_ms, p95_ms} over
        timed spans only."""
        groups: dict[str, list[float]] = collections.defaultdict(list)
        for e in self.events():
            if e.kind == "span":
                groups[e.name].append(e.dur_ms)
        out = {}
        for name, durs in sorted(groups.items()):
            durs.sort()
            k = len(durs)
            out[name] = {
                "count": k,
                "total_ms": round(sum(durs), 3),
                "mean_ms": round(sum(durs) / k, 3),
                "p50_ms": round(_percentile(durs, 0.50), 3),
                "p95_ms": round(_percentile(durs, 0.95), 3),
            }
        return out

    def reset(self, max_events: int | None = None) -> None:
        """Drop every span; `max_events` resizes the bound for a run that
        must keep more."""
        with self._lock:
            if max_events is not None:
                self.max_events = max_events
            self._events = collections.deque(maxlen=self.max_events)


# process-wide default tracer (subsystems import this)
tracer = Tracer()
