"""Trace-context propagation (trimmed copy of `dds_tpu/obs/context.py`).

A `SpanContext` names one node of a trace: `(trace_id, span_id,
parent_id)`. The REST edge mints a root per request; every
`tracer.span(...)` below it derives a child and installs it in a
`contextvars.ContextVar`, so nested spans — including replica handlers
scheduled as tasks by the in-memory transport, which copy contextvars at
creation — link parent->child without threading a parameter through.
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
