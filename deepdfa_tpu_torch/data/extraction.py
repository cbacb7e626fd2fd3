"""Streaming extraction pool: N supervised sessions + work-stealing deque.

A copy of the thread half of ``deepdfa_tpu/data/extraction.py``. Each
worker thread owns its own supervised session (spawn retry with backoff,
restart-on-failure, quarantine-on-repeat: the
:class:`~deepdfa_tpu_torch.resilience.supervisor.ExtractionSupervisor`'s
semantics, per worker), pulls from its own deque and steals from the back
of the longest other queue when it runs dry — one poison or slow file
stalls one worker, never the pool. Results come back in input order,
whichever worker finished first.

Failure domains, narrowest first:

- an item-level error (``ValueError`` family, including
  :class:`ExtractionItemError`) is one failure row;
- a session-level failure restarts that worker's session and retries the
  item; a poison item lands on the shared quarantine list after
  ``attempts_per_item`` tries.

Not ported yet: process-backed sessions and the worker-crash fault point
(ROADMAP A6 and A15).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Sequence

from deepdfa_tpu_torch.resilience.retry import RetryPolicy
from deepdfa_tpu_torch.resilience.supervisor import (ExtractionSupervisor,
                                                     QuarantinedError)

__all__ = ["ExtractionItemError", "ExtractionPool", "ExtractionResult"]


class ExtractionItemError(ValueError):
    """The ITEM failed inside a session (malformed source, extractor
    rejection) — the caller's failure-row protocol, not a session fault."""


@dataclass
class ExtractionResult:
    """One item's outcome, in input order. Exactly one of ``value`` /
    ``error`` is set; ``quarantined`` marks the error as a quarantine (the
    item is on :meth:`ExtractionPool.report`'s list)."""

    key: Any
    value: Any = None
    error: str | None = None
    worker: int = -1
    cache_hit: bool = False
    quarantined: bool = False


class ExtractionPool:
    """``run(items, fn)`` → per-item results through N supervised sessions.

    ``session_factory(worker_id)`` builds one session per worker (also
    accepts a zero-arg factory). ``fn(session, payload)`` is the per-item
    extraction. An optional :class:`~deepdfa_tpu_torch.data.extract_cache.
    ExtractCache` short-circuits items whose ``cache_code(payload)``
    source text is already committed — a warm re-run of an unchanged
    corpus performs zero extractions.
    """

    def __init__(
        self,
        session_factory: Callable[..., Any],
        n_workers: int = 4,
        *,
        attempts_per_item: int = 2,
        spawn_policy: RetryPolicy | None = None,
        cache=None,
        cache_code: Callable[[Any], str] | None = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n_workers = int(n_workers)
        self._factory = session_factory
        self._attempts = attempts_per_item
        self._spawn_policy = spawn_policy or RetryPolicy(
            attempts=3, base_delay=1.0, max_delay=15.0)
        self._sleep = sleep
        self._cache = cache
        self._cache_code = cache_code or (lambda payload: payload)
        self._queues: list[deque] = [deque() for _ in range(self.n_workers)]
        self._lock = threading.Lock()
        self._results: dict[int, ExtractionResult] = {}
        self._quarantine: list[dict] = []
        self._restarts = 0
        self._steals = 0
        self._cache_hits = 0
        self._extracted = 0

    # -- session plumbing ---------------------------------------------------
    def _make_session(self, worker_id: int):
        try:
            return self._factory(worker_id)
        except TypeError:
            return self._factory()

    def _supervisor(self, worker_id: int) -> ExtractionSupervisor:
        return ExtractionSupervisor(
            lambda: self._make_session(worker_id),
            spawn_policy=self._spawn_policy,
            attempts_per_item=self._attempts,
            sleep=self._sleep,
        )

    # -- the work deque -----------------------------------------------------
    def _next_task(self, worker_id: int):
        """Own queue first, then steal from the back of the longest other
        queue. None == no work anywhere."""
        try:
            return self._queues[worker_id].popleft()
        except IndexError:
            pass
        victims = sorted(
            (i for i in range(self.n_workers) if i != worker_id),
            key=lambda i: -len(self._queues[i]))
        for i in victims:
            try:
                task = self._queues[i].pop()  # steal cold work from the back
            except IndexError:
                continue
            with self._lock:
                self._steals += 1
            return task
        return None

    # -- per-item processing ------------------------------------------------
    def _record(self, idx: int, result: ExtractionResult) -> None:
        with self._lock:
            if idx in self._results:
                raise RuntimeError(
                    f"item {idx} ({result.key!r}) processed twice")
            self._results[idx] = result

    def _process(self, worker_id: int, sup: ExtractionSupervisor,
                 task, fn) -> None:
        idx, key, payload = task
        if self._cache is not None:
            cache_key = self._cache.key(self._cache_code(payload))
            value = self._cache.get(cache_key)
            if value is not None:
                with self._lock:
                    self._cache_hits += 1
                self._record(idx, ExtractionResult(
                    key, value=value, worker=worker_id, cache_hit=True))
                return
        try:
            value = sup.run(key, lambda session: fn(session, payload))
        except QuarantinedError as exc:
            self._record(idx, ExtractionResult(
                key, error=f"Quarantined: {exc.reason}", worker=worker_id,
                quarantined=True))
            return
        except Exception as exc:  # noqa: BLE001 — failure-row protocol
            self._record(idx, ExtractionResult(
                key, error=f"{type(exc).__name__}: {exc}", worker=worker_id))
            return
        if self._cache is not None:
            self._cache.put(cache_key, value)
        with self._lock:
            self._extracted += 1
        self._record(idx, ExtractionResult(key, value=value, worker=worker_id))

    # -- worker lifecycle ---------------------------------------------------
    def _worker(self, worker_id: int, fn) -> None:
        sup = self._supervisor(worker_id)
        try:
            while True:
                task = self._next_task(worker_id)
                if task is None:
                    return
                self._process(worker_id, sup, task, fn)
        finally:
            with self._lock:
                self._restarts += sup.restarts
                self._quarantine.extend(sup.quarantine)
            sup.close()

    # -- run ----------------------------------------------------------------
    def run(self, items: Sequence[tuple[Any, Any]], fn) -> list[ExtractionResult]:
        """Extract every ``(key, payload)`` item; returns one
        :class:`ExtractionResult` per item, in input order. Never raises
        for a failing item."""
        items = list(items)
        for i, (key, payload) in enumerate(items):
            self._queues[i % self.n_workers].append((i, key, payload))
        threads = [
            threading.Thread(target=self._worker, args=(wid, fn),
                             name=f"extract-{wid}", daemon=True)
            for wid in range(self.n_workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with self._lock:
            return [self._results[i] for i in range(len(items))]

    def report(self) -> dict:
        """Supervisor semantics (restarts + quarantine list) plus the pool's
        own accounting."""
        with self._lock:
            return {
                "workers": self.n_workers,
                "restarts": self._restarts,
                "quarantined": list(self._quarantine),
                "steals": self._steals,
                "cache_hits": self._cache_hits,
                "extracted": self._extracted,
            }
