"""Extraction supervisor: session restart + per-item retry + quarantine.

A copy of ``deepdfa_tpu/resilience/supervisor.py``. It wraps a session
that can fail (an encode session, a Joern REPL) so that a scan or a build
survives it:

- session spawn goes through :func:`deepdfa_tpu_torch.resilience.retry.
  retry_call`, with backoff;
- a session-level failure while processing an item (timeout / dead
  session / broken pipe) tears the session down and retries the item on a
  fresh session;
- an item that keeps killing sessions is a *poison* item: after
  ``attempts_per_item`` tries it is recorded on the quarantine list (with
  the partial REPL buffer when the failure was a hang, ``JoernTimeout.
  partial``) and :class:`QuarantinedError` is raised so the caller logs
  one failure row and moves on.

Item-level errors that do not implicate the session (e.g. ``ValueError``)
propagate unchanged — they are the caller's failure rows.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, TypeVar

from deepdfa_tpu_torch.resilience.retry import RetryExhausted, RetryPolicy, retry_call

__all__ = ["ExtractionSupervisor", "QuarantinedError", "SESSION_ERRORS"]

logger = logging.getLogger("deepdfa_tpu_torch")

T = TypeVar("T")

# What implicates the SESSION rather than the item: timeouts, a dead
# session (RuntimeError, a failed respawn), OS-level pipe errors.
SESSION_ERRORS: tuple[type[BaseException], ...] = (TimeoutError, RuntimeError, OSError)


class QuarantinedError(RuntimeError):
    """Item exhausted its per-item attempts; it is on the quarantine list."""

    def __init__(self, key: Any, attempts: int, reason: str):
        super().__init__(f"{key!r} quarantined after {attempts} attempt(s): {reason}")
        self.key = key
        self.attempts = attempts
        self.reason = reason


class ExtractionSupervisor:
    """``run(key, fn)`` calls ``fn(session)`` with restart-on-failure and
    quarantine-on-repeat semantics. The session is spawned lazily and
    re-spawned (with backoff) after any session-level failure."""

    def __init__(
        self,
        session_factory: Callable[[], Any],
        spawn_policy: RetryPolicy = RetryPolicy(attempts=3, base_delay=1.0, max_delay=15.0),
        attempts_per_item: int = 2,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if attempts_per_item < 1:
            raise ValueError("attempts_per_item must be >= 1")
        self._factory = session_factory
        self._spawn_policy = spawn_policy
        self._sleep = sleep
        self.attempts_per_item = attempts_per_item
        self._session: Any | None = None
        self.restarts = 0
        self.quarantine: list[dict] = []

    # -- session lifecycle --------------------------------------------------
    @property
    def session(self) -> Any:
        if self._session is None:
            self._session = retry_call(
                self._factory,
                policy=self._spawn_policy,
                retry_on=SESSION_ERRORS,
                on_retry=lambda n, exc, d: logger.warning(
                    "session spawn attempt %d failed (%s: %s); retry in %.1fs",
                    n, type(exc).__name__, exc, d,
                ),
                sleep=self._sleep,
            )
        return self._session

    def _teardown(self, why: BaseException) -> None:
        sess, self._session = self._session, None
        if sess is None:
            return
        self.restarts += 1
        logger.warning(
            "restarting extraction session after %s: %s", type(why).__name__, why
        )
        try:
            sess.close()
        except Exception:  # noqa: BLE001 — the session is already dead
            pass

    def close(self) -> None:
        sess, self._session = self._session, None
        if sess is not None:
            sess.close()

    def __enter__(self) -> "ExtractionSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- supervised execution ----------------------------------------------
    def run(self, key: Any, fn: Callable[[Any], T]) -> T:
        """Run ``fn(session)``; restart the session and retry on
        session-level failures; quarantine ``key`` (and raise
        :class:`QuarantinedError`) when attempts run out."""
        last: BaseException | None = None
        partial = None  # the most recent REPL buffer any attempt produced
        for _attempt in range(1, self.attempts_per_item + 1):
            try:
                return fn(self.session)
            except SESSION_ERRORS as exc:
                last = exc
                partial = getattr(exc, "partial", None) or partial
                if isinstance(exc, RetryExhausted):
                    # the session would not even spawn — no point retrying
                    # the item against a session that cannot exist
                    break
                self._teardown(exc)
        entry = {
            "key": key,
            "attempts": self.attempts_per_item,
            "error": f"{type(last).__name__}: {last}",
        }
        if partial:
            entry["partial"] = str(partial)[-500:]
        self.quarantine.append(entry)
        raise QuarantinedError(key, self.attempts_per_item, entry["error"]) from last

    def report(self) -> dict:
        """Summary for the ingest report: restart count + quarantine list."""
        return {"restarts": self.restarts, "quarantined": list(self.quarantine)}
