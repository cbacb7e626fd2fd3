"""Streaming extraction pool: N supervised sessions + work-stealing deque.

The port of ``deepdfa_tpu/data/extraction.py``. Each worker thread owns its
own supervised session (spawn retry with backoff, restart-on-failure,
quarantine-on-repeat: the
:class:`~deepdfa_tpu_torch.resilience.supervisor.ExtractionSupervisor`'s
semantics, per worker), pulls from its own deque and steals from the back
of the longest other queue when it runs dry — one poison or slow file
stalls one worker, never the pool. Results come back in input order,
whichever worker finished first.

Failure domains, narrowest first:

- an item-level error (``ValueError`` family, including
  :class:`ExtractionItemError` from a process-backed session) is one
  failure row;
- a session-level failure restarts that worker's session and retries the
  item; a poison item lands on the shared quarantine list after
  ``attempts_per_item`` tries;
- a crashed *worker* (the ``extract.worker_crash`` fault point, or any
  unexpected worker-loop error) re-queues its in-flight item onto the
  shared overflow deque — processed exactly once by a surviving worker,
  never lost, never double-counted — and anything still queued after the
  threads join is drained on a recovery session, so
  :meth:`ExtractionPool.run` completes even if every worker dies.

Sessions need not be threads: :class:`ProcessSession` runs a module-level
extractor in a dedicated **spawned** child process, so CPU-bound
extraction scales past the GIL with the same supervision story (a dead
child is a session error; the supervisor respawns it). The child imports
only the extractor's module: it never initializes CUDA.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Sequence

from deepdfa_tpu_torch.resilience import faults
from deepdfa_tpu_torch.resilience.retry import RetryPolicy
from deepdfa_tpu_torch.resilience.supervisor import (ExtractionSupervisor,
                                                     QuarantinedError)

__all__ = [
    "ExtractionItemError",
    "ExtractionPool",
    "ExtractionResult",
    "ProcessSession",
]

logger = logging.getLogger("deepdfa_tpu_torch")


class ExtractionItemError(ValueError):
    """The ITEM failed inside a session (malformed source, extractor
    rejection) — the caller's failure-row protocol, not a session fault."""


class _WorkerCrashed(BaseException):
    """Internal: tears down one worker thread; never crosses run()."""

    def __init__(self, worker_id: int):
        super().__init__(f"extraction worker {worker_id} crashed")
        self.worker_id = worker_id


@dataclass
class ExtractionResult:
    """One item's outcome, in input order. Exactly one of ``value`` /
    ``error`` is set; ``quarantined`` marks the error as a quarantine (the item is on :meth:`ExtractionPool.report`'s list)."""

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
        self._overflow: deque = deque()  # re-queued in-flight items
        self._lock = threading.Lock()
        self._results: dict[int, ExtractionResult] = {}
        self._quarantine: list[dict] = []
        self._restarts = 0
        self._steals = 0
        self._requeued = 0
        self._crashed: list[int] = []
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
        """Own queue first, the shared overflow next, then steal from the
        back of the longest other queue. None == no work anywhere."""
        own = self._queues[worker_id]
        try:
            return own.popleft()
        except IndexError:
            pass
        try:
            return self._overflow.popleft()
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

    def _requeue(self, task, worker_id: int) -> None:
        self._overflow.append(task)
        with self._lock:
            self._requeued += 1
        logger.warning(
            "extraction worker %d re-queued in-flight item %r", worker_id,
            task[1])

    # -- per-item processing ------------------------------------------------
    def _record(self, idx: int, result: ExtractionResult) -> None:
        with self._lock:
            if idx in self._results:  # double-count guard (chaos-pinned)
                raise RuntimeError(
                    f"item {idx} ({result.key!r}) processed twice — the "
                    "re-queue path double-counted an in-flight item")
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
        except Exception as exc:  # noqa: BLE001 — failure-file protocol
            self._record(idx, ExtractionResult(
                key, error=f"{type(exc).__name__}: {exc}", worker=worker_id))
            return
        if self._cache is not None:
            self._cache.put(cache_key, value)
        with self._lock:
            self._extracted += 1
        self._record(idx, ExtractionResult(key, value=value, worker=worker_id))

    # -- worker lifecycle ---------------------------------------------------
    def _worker_loop(self, worker_id: int, sup: ExtractionSupervisor,
                     fn) -> None:
        while True:
            task = self._next_task(worker_id)
            if task is None:
                return
            if faults.fire("extract.worker_crash"):
                self._requeue(task, worker_id)
                raise _WorkerCrashed(worker_id)
            self._process(worker_id, sup, task, fn)

    def _worker(self, worker_id: int, fn) -> None:
        sup = self._supervisor(worker_id)
        try:
            self._worker_loop(worker_id, sup, fn)
        except _WorkerCrashed:
            with self._lock:
                self._crashed.append(worker_id)
            logger.warning("extraction worker %d crashed; its queue will "
                           "be stolen by survivors", worker_id)
        finally:
            self._absorb(sup)
            sup.close()

    def _absorb(self, sup: ExtractionSupervisor) -> None:
        with self._lock:
            self._restarts += sup.restarts
            self._quarantine.extend(sup.quarantine)

    # -- driver -------------------------------------------------------------
    def run(self, items: Sequence[tuple[Any, Any]], fn) -> list[ExtractionResult]:
        """Extract every ``(key, payload)`` item; returns one
        :class:`ExtractionResult` per item, in input order. Never raises
        for a failing item: a corpus build survives its functions."""
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
        # leftovers exist only when workers crashed with work still queued
        # (including the crash-requeued in-flight items): drain them on one
        # recovery session so the build still completes.
        leftovers = [task for q in (*self._queues, self._overflow)
                     for task in self._drain(q)]
        if leftovers:
            logger.warning("draining %d left-over item(s) after worker "
                           "crash(es) on a recovery session", len(leftovers))
            sup = self._supervisor(-1)
            try:
                for task in leftovers:
                    self._process(-1, sup, task, fn)
            finally:
                self._absorb(sup)
                sup.close()
        with self._lock:
            return [self._results[i] for i in range(len(items))]

    @staticmethod
    def _drain(q: deque) -> list:
        out = []
        while True:
            try:
                out.append(q.popleft())
            except IndexError:
                return out

    def report(self) -> dict:
        """Aggregate for the ingest summary: supervisor semantics (restarts
        + quarantine list) plus the pool's own accounting."""
        with self._lock:
            return {
                "workers": self.n_workers,
                "restarts": self._restarts,
                "quarantined": list(self._quarantine),
                "steals": self._steals,
                "requeued": self._requeued,
                "crashed_workers": list(self._crashed),
                "cache_hits": self._cache_hits,
                "extracted": self._extracted,
            }


# ---------------------------------------------------------------------------
# process-backed sessions: CPU-bound extraction past the GIL


def _process_session_main(conn, extractor_ref: str) -> None:
    """Child loop: resolve ``module:function`` and serve items until EOF.
    Item failures are replied (not raised) — they must not kill the
    session; only a genuinely dead child implicates it."""
    import importlib

    try:
        mod_name, _, fn_name = extractor_ref.partition(":")
        fn = getattr(importlib.import_module(mod_name), fn_name)
    except Exception as exc:  # noqa: BLE001 — reported to the parent
        try:
            conn.send(("spawn_error", f"{type(exc).__name__}: {exc}"))
        finally:
            conn.close()
        return
    conn.send(("ready", None))
    while True:
        try:
            kind, payload = conn.recv()
        except (EOFError, OSError):
            return
        if kind == "stop":
            conn.close()
            return
        try:
            conn.send(("ok", fn(payload)))
        except Exception as exc:  # noqa: BLE001 — item error, session lives
            conn.send(("err", f"{type(exc).__name__}: {exc}"))


class ProcessSession:
    """An extraction session whose extractor runs in a dedicated spawned
    child process. ``extractor`` is a ``"module:function"`` reference
    resolved IN THE CHILD (spawn-safe: a fork after CUDA initialization breaks the child).
    A dead/hung child raises ``SESSION_ERRORS`` members, so an
    :class:`~deepdfa_tpu_torch.resilience.supervisor.ExtractionSupervisor`
    restarts it exactly like a dead JVM; extractor-level failures raise
    :class:`ExtractionItemError` and leave the session alive."""

    def __init__(self, extractor: str, *, timeout_s: float = 120.0,
                 spawn_timeout_s: float = 120.0):
        import multiprocessing

        self.timeout_s = timeout_s
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_process_session_main, args=(child, extractor), daemon=True)
        self._proc.start()
        child.close()
        if not self._conn.poll(spawn_timeout_s):
            self.close()
            raise TimeoutError(
                f"process session did not report ready in {spawn_timeout_s}s")
        try:
            kind, detail = self._conn.recv()
        except (EOFError, OSError) as exc:
            self.close()
            raise RuntimeError("process session died during spawn") from exc
        if kind != "ready":
            self.close()
            raise RuntimeError(f"process session failed to spawn: {detail}")

    def extract(self, payload, timeout_s: float | None = None):
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        try:
            self._conn.send(("item", payload))
        except (OSError, ValueError) as exc:
            raise RuntimeError(f"process session pipe is dead: {exc}") from exc
        if not self._conn.poll(timeout_s):
            raise TimeoutError(
                f"process session gave no reply within {timeout_s}s")
        try:
            kind, out = self._conn.recv()
        except (EOFError, OSError) as exc:
            raise RuntimeError("process session died mid-item") from exc
        if kind == "ok":
            return out
        raise ExtractionItemError(out)

    def close(self) -> None:
        try:
            self._conn.send(("stop", None))
        except (OSError, ValueError):
            pass
        self._conn.close()
        self._proc.join(timeout=2.0)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=2.0)
