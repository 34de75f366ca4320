"""Deadline-propagated retry with exponential backoff and full jitter.

Trimmed copy of `dds_tpu/utils/retry.py` (circuit breakers wait for a
later slice):

- `Deadline`: an absolute time budget minted once at the REST edge and
  passed down, so every nested retry loop and per-attempt timeout shrinks
  to what is left of the request's budget.
- `retry_deadline`: retry with delay ~ U(0, min(cap, base*mult^attempt));
  when the budget cannot fit another attempt it raises
  `DeadlineExceededError`, which the REST layer maps to 503 + Retry-After.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional, TypeVar

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
