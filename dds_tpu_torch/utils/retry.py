"""Deadline-propagated retry with exponential backoff and full jitter.

Trimmed copy of `dds_tpu/utils/retry.py`:

- `Deadline`: an absolute time budget minted once at the REST edge and
  passed down, so every nested retry loop and per-attempt timeout shrinks
  to what is left of the request's budget.
- `retry_deadline`: retry with delay ~ U(0, min(cap, base*mult^attempt));
  when the budget cannot fit another attempt it raises
  `DeadlineExceededError`, which the REST layer maps to 503 + Retry-After.
- `CircuitBreaker`: per-target closed -> open -> half-open state for
  transient failures (the quorum client keeps one per coordinator);
  `half_open_eta` is what a degraded response's Retry-After derives from.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional, TypeVar

from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils.trace import tracer

T = TypeVar("T")


class DeadlineExceededError(Exception):
    """The operation's time budget ran out before an attempt succeeded."""

    def __init__(self, message: str, attempts: int = 0, elapsed: float = 0.0,
                 last_error: Optional[BaseException] = None):
        super().__init__(message)
        self.attempts = attempts
        self.elapsed = elapsed
        self.last_error = last_error


class Deadline:
    """An absolute time budget, created once and passed down the stack."""

    def __init__(self, budget: float, clock: Callable[[], float] = time.monotonic):
        self.budget = budget
        self._clock = clock
        self.start = clock()
        self.at = self.start + budget

    def remaining(self) -> float:
        return self.at - self._clock()

    def elapsed(self) -> float:
        return self._clock() - self.start

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def timeout(self, per_attempt: float) -> float:
        """Per-attempt timeout clipped to what is left of the budget."""
        return max(0.0, min(per_attempt, self.remaining()))

    def __repr__(self) -> str:
        return f"Deadline({self.budget:.3f}s, {self.remaining():.3f}s left)"


@dataclass
class RetryPolicy:
    """Exponential backoff + full jitter; `max_attempts=None` lets the
    deadline alone govern."""

    base: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    max_attempts: Optional[int] = None

    def backoff(self, attempt: int, rng) -> float:
        """Delay before attempt `attempt`+1 (attempt counts from 0)."""
        return rng.uniform(0.0, min(self.max_delay, self.base * (self.multiplier ** attempt)))


async def retry_deadline(
    f: Callable[[], Awaitable[T]],
    deadline: Deadline,
    policy: Optional[RetryPolicy] = None,
    retry_on: tuple = (Exception,),
) -> T:
    """Run `f` until it succeeds, the policy's attempts run out (the last
    error propagates), or the deadline cannot fit another backoff (typed
    `DeadlineExceededError`). Exceptions outside `retry_on` propagate
    immediately."""
    policy = policy or RetryPolicy()
    attempt = 0
    while True:
        if deadline.expired:
            raise DeadlineExceededError(
                f"budget exhausted before attempt {attempt + 1} ({deadline!r})",
                attempts=attempt, elapsed=deadline.elapsed(),
            )
        try:
            return await f()
        except retry_on as e:
            attempt += 1
            tracer.event("retry.attempt", attempt=attempt, error=type(e).__name__)
            if policy.max_attempts is not None and attempt >= policy.max_attempts:
                raise
            delay = policy.backoff(attempt - 1, random)
            if delay >= deadline.remaining():
                raise DeadlineExceededError(
                    f"{deadline.budget:.3f}s budget exhausted after "
                    f"{attempt} attempt(s): {e!r}",
                    attempts=attempt, elapsed=deadline.elapsed(), last_error=e,
                ) from e
            await asyncio.sleep(delay)


class CircuitBreaker:
    """closed -> (failure_threshold consecutive failures) -> open ->
    (reset_timeout elapses) -> half-open -> one success closes / one
    failure re-opens.

    Guards a single target (one coordinator). Transient-failure state only:
    it self-heals, unlike the permanent `TrustedNodesList` strikes reserved
    for cryptographic protocol violations. Half-open deliberately admits
    concurrent probes (no single-probe token): the first recorded outcome
    resolves the state, and a duplicate probe against a healed target is
    harmless while a probe token leaked to a never-chosen candidate would
    wedge the breaker."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self,
        failure_threshold: int = 3,
        reset_timeout: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        name: str = "",
    ):
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.name = name  # guarded target, for telemetry attribution
        self._clock = clock
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        self._maybe_half_open()
        return self._state

    def _transition(self, state: str) -> None:
        if state == self._state:
            return
        self._state = state
        tracer.event("breaker." + state, target=self.name)
        metrics.inc("dds_breaker_transitions_total", state=state,
                    target=self.name,
                    help="circuit-breaker state transitions per target")
        if state == self.OPEN:
            # a breaker opening IS a fault: freeze the telemetry that led
            # here (no-op unless a flight directory is configured)
            from dds_tpu_torch.obs.flight import flight

            flight.record("breaker_open", target=self.name)

    def _maybe_half_open(self) -> None:
        if (
            self._state == self.OPEN
            and self._clock() - self._opened_at >= self.reset_timeout
        ):
            self._transition(self.HALF_OPEN)

    def allow(self) -> bool:
        """May the caller route a request at this target right now?"""
        self._maybe_half_open()
        return self._state != self.OPEN

    def half_open_eta(self) -> float:
        """Seconds until this breaker's next half-open probe (0 when it is
        not refusing traffic). The honest Retry-After for a degraded
        response: clients coming back any sooner are guaranteed to find
        the same open breaker."""
        self._maybe_half_open()
        if self._state != self.OPEN:
            return 0.0
        return max(0.0, self.reset_timeout - (self._clock() - self._opened_at))

    def record_success(self) -> None:
        self._transition(self.CLOSED)
        self._failures = 0

    def record_failure(self) -> None:
        self._maybe_half_open()
        if self._state == self.HALF_OPEN:
            self._trip()  # failed probe: back to open, timer restarted
            return
        self._failures += 1
        if self._failures >= self.failure_threshold:
            self._trip()

    def _trip(self) -> None:
        self._transition(self.OPEN)
        self._failures = 0
        self._opened_at = self._clock()
