"""Generic retry: capped exponential backoff with deterministic jitter.

The part of ``deepdfa_tpu/resilience/retry.py`` the extraction supervisor's
session spawns need. The backoff for attempt *n* is a pure function of *n*
(the JAX package's fault-registry hash at seed 0), so a replayed run waits
the same schedule; ``sleep`` is a parameter, so tests drive a virtual
clock. The JAX package's total ``deadline``, injectable ``clock`` and
jitter ``seed`` wait for a caller that needs them.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Callable, TypeVar

__all__ = ["RetryPolicy", "RetryExhausted", "retry_call"]

T = TypeVar("T")


def _unit(seed: int, point: str, hit: int) -> float:
    """Deterministic uniform in [0, 1): pure function of (seed, point, hit)."""
    digest = hashlib.sha256(f"{seed}:{point}:{hit}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2.0**64


class RetryExhausted(RuntimeError):
    """All attempts failed; ``__cause__`` carries the last underlying
    exception."""

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
    """``delay(n) = min(base * multiplier**(n-1), max_delay)`` ± jitter."""

    attempts: int = 3
    base_delay: float = 0.5
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.1  # fraction of the delay, spread symmetrically

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError("attempts must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def delay(self, attempt: int) -> float:
        """Backoff after failure number ``attempt`` (1-based)."""
        raw = min(self.base_delay * self.multiplier ** (attempt - 1), self.max_delay)
        if not self.jitter:
            return raw
        u = _unit(0, "retry", attempt)
        return raw * (1.0 - self.jitter + 2.0 * self.jitter * u)


def retry_call(
    fn: Callable[[], T],
    policy: RetryPolicy = RetryPolicy(),
    retry_on: tuple[type[BaseException], ...] = (Exception,),
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call ``fn`` up to ``policy.attempts`` times; raise
    :class:`RetryExhausted` when the attempts run out.
    ``on_retry(attempt, exc, delay)`` observes each scheduled retry."""
    start = time.monotonic()
    last: BaseException | None = None
    for attempt in range(1, policy.attempts + 1):
        try:
            return fn()
        except retry_on as exc:
            last = exc
            if attempt >= policy.attempts:
                break
            delay = policy.delay(attempt)
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)
    raise RetryExhausted(attempt, time.monotonic() - start, last) from last
