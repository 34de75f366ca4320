"""Trace-context propagation (trimmed copy of `dds_tpu/obs/context.py`).

A `SpanContext` names one node of a trace: `(trace_id, span_id,
parent_id)`. The REST edge mints a root per request; every
`tracer.span(...)` below it derives a child and installs it in a
`contextvars.ContextVar`, so nested spans — including replica handlers
scheduled as tasks by the in-memory transport, which copy contextvars at
creation — link parent->child without threading a parameter through.
Across a `TcpNet` hop the context travels as the frame's `tc` field
(`to_wire`/`from_wire`): observability metadata only, outside the frame
MAC and signature, so a forged id can mislabel telemetry and never a
protocol decision.
"""

from __future__ import annotations

import contextvars
import secrets
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SpanContext:
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None


_current: contextvars.ContextVar[Optional[SpanContext]] = contextvars.ContextVar(
    "dds_torch_span_context", default=None
)


def new_id() -> str:
    return secrets.token_hex(8)


def current() -> Optional[SpanContext]:
    """The active span context of this task, or None outside any trace."""
    return _current.get()


def root() -> SpanContext:
    """Mint a fresh trace root (the REST edge)."""
    return SpanContext(new_id(), new_id(), None)


def child(parent: Optional[SpanContext] = None) -> SpanContext:
    """A child of `parent` (default: the current context); a fresh root
    when there is no parent anywhere."""
    p = parent if parent is not None else _current.get()
    if p is None:
        return root()
    return SpanContext(p.trace_id, new_id(), p.span_id)


def attach(ctx: Optional[SpanContext]) -> contextvars.Token:
    return _current.set(ctx)


def detach(token: contextvars.Token) -> None:
    _current.reset(token)


# ------------------------------------------------------------------- wire

def to_wire(ctx: Optional[SpanContext] = None) -> Optional[dict]:
    """The frame's `tc` field: (trace, span) of the sender's active span,
    or None with nothing to propagate. The receiver's spans become its
    children."""
    ctx = ctx if ctx is not None else _current.get()
    if ctx is None:
        return None
    return {"t": ctx.trace_id, "s": ctx.span_id}


def _valid_id(v) -> bool:
    """Ids minted here are 16 lowercase-hex chars; up to 32 (the W3C
    traceparent width) are accepted from foreign tracers, but only hex: the
    `tc` field is unauthenticated and its strings become collector keys,
    metric labels and flight-incident headers."""
    return (isinstance(v, str) and 0 < len(v) <= 32
            and all(c in "0123456789abcdef" for c in v))


def from_wire(d) -> Optional[SpanContext]:
    """Parse a frame's `tc` field. Absence is None; garbage is refused
    wholesale (and counted), never truncated into a plausible id, and never
    drops the message it rode on."""
    if d is None:
        return None
    if not isinstance(d, dict):
        return _malformed()
    t, s = d.get("t"), d.get("s")
    if not _valid_id(t) or not _valid_id(s):
        return _malformed()
    return SpanContext(t, s)


def _malformed() -> None:
    """Count a present but garbled context, so a peer spraying hostile `tc`
    fields shows on /metrics."""
    from dds_tpu_torch.obs.metrics import metrics  # lazy: avoids an import cycle

    metrics.inc("dds_trace_context_malformed_total",
                help="hostile/garbled tc frame fields dropped at ingest")
    return None
