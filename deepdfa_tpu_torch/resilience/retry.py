"""Generic retry: capped exponential backoff + total deadline + jitter.

Built for the Joern extraction supervisor (a JVM REPL that can hang, die,
or refuse to spawn while the host is loaded) but deliberately free of any
Joern knowledge. Two properties matter for the chaos battery:

- **deterministic jitter** — the backoff for attempt *n* is a pure function
  of ``(seed, n)`` (the fault registry's hash, :mod:`.faults`),
  so a replayed run waits the same schedule;
- **injectable clocks** — ``sleep``/``clock`` are parameters, so the unit
  tests drive a virtual clock and finish in microseconds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, TypeVar

from deepdfa_tpu_torch.resilience.faults import _unit

__all__ = ["RetryPolicy", "RetryExhausted", "retry_call"]

T = TypeVar("T")


class RetryExhausted(RuntimeError):
    """All attempts failed (or the deadline would be blown); ``__cause__``
    carries the last underlying exception."""

    def __init__(self, attempts: int, elapsed: float, last: BaseException):
        super().__init__(
            f"retry exhausted after {attempts} attempt(s) in {elapsed:.1f}s: "
            f"{type(last).__name__}: {last}"
        )
        self.attempts = attempts
        self.elapsed = elapsed
        self.last = last


@dataclass(frozen=True)
class RetryPolicy:
    """``delay(n) = min(base * multiplier**(n-1), max_delay)`` ± jitter;
    ``deadline`` bounds total wall time across attempts (checked before
    sleeping — a retry that cannot finish in budget is not started)."""

    attempts: int = 3
    base_delay: float = 0.5
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.1  # fraction of the delay, spread symmetrically
    deadline: float | None = None

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError("attempts must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def delay(self, attempt: int, seed: int = 0) -> float:
        """Backoff after failure number ``attempt`` (1-based)."""
        raw = min(self.base_delay * self.multiplier ** (attempt - 1), self.max_delay)
        if not self.jitter:
            return raw
        u = _unit(seed, "retry", attempt)
        return raw * (1.0 - self.jitter + 2.0 * self.jitter * u)


def retry_call(
    fn: Callable[[], T],
    policy: RetryPolicy = RetryPolicy(),
    retry_on: tuple[type[BaseException], ...] = (Exception,),
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    seed: int = 0,
) -> T:
    """Call ``fn`` up to ``policy.attempts`` times; raise
    :class:`RetryExhausted` when attempts or the deadline run out.
    ``on_retry(attempt, exc, delay)`` observes each scheduled retry."""
    start = clock()
    last: BaseException | None = None
    for attempt in range(1, policy.attempts + 1):
        try:
            return fn()
        except retry_on as exc:
            last = exc
            if attempt >= policy.attempts:
                break
            delay = policy.delay(attempt, seed=seed)
            if policy.deadline is not None and (clock() - start) + delay > policy.deadline:
                break
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)
    assert last is not None
    raise RetryExhausted(attempt, clock() - start, last) from last
