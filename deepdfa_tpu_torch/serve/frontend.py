"""Frontend encode pool: cold-request ``encode_source`` past the GIL.

The port of ``deepdfa_tpu/serve/frontend.py``. The serving cold path runs
the whole source → CPG → dataflow → feature pipeline in pure Python on the
host; inline on the request-handler thread, N concurrent cold requests
serialize on the GIL while the card idles between dispatches.
:class:`FrontendPool` moves that work onto N encode workers:

- each worker owns its own deque and **steals** from the back of the
  longest other queue when it runs dry; a shared overflow deque carries
  crash-requeued in-flight items;
- ``mode="process"`` workers are :class:`FrontendProcessSession`\\ s —
  **spawned** children that load the vocabularies once and encode until
  told to stop, so encode runs in parallel past the GIL and overlaps the
  micro-batcher's dispatches. A server that has initialized CUDA cannot
  fork, so the children are spawned; they run the host front end only and
  never initialize CUDA. The spawn handshake carries the child's
  vocabulary content hash; a mismatch with the serving vocabularies raises
  :class:`VocabHashMismatch` and fails the pool at start;
- ``mode="thread"`` keeps the sessions in-process;
- every worker session sits behind an
  :class:`~deepdfa_tpu_torch.resilience.supervisor.ExtractionSupervisor`
  (spawn retry with backoff, restart-on-failure, quarantine-on-repeat);
- the queue is **bounded** (:class:`~.batcher.QueueFullError` beyond
  ``max_queue``), ``stop(drain=True)`` is the flag-only SIGTERM drain, and
  the ``frontend.worker_crash`` fault point re-queues the crashed worker's
  in-flight item onto the overflow deque — completed exactly once by a
  survivor, never lost, never completed twice.

Failure classification for the server: :data:`ENCODE_ITEM_ERRORS` members
mean *the item* failed to encode (the request's 422); any other exception
means *the pool* failed — the server degrades to inline encode and never
turns pool trouble into a 5xx (standing invariant 25). The scan's
:class:`~deepdfa_tpu_torch.data.extraction.ExtractionPool` builds its
encode sessions from the same :func:`encode_session_factory`.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable

from deepdfa_tpu_torch.data.extraction import ExtractionItemError
from deepdfa_tpu_torch.resilience import faults
from deepdfa_tpu_torch.resilience.retry import RetryPolicy
from deepdfa_tpu_torch.resilience.supervisor import (ExtractionSupervisor,
                                                     QuarantinedError)

from .batcher import QueueFullError

__all__ = [
    "ENCODE_ITEM_ERRORS",
    "FrontendPool",
    "FrontendProcessSession",
    "ThreadEncodeSession",
    "VocabHashMismatch",
    "encode_session_factory",
]

logger = logging.getLogger("deepdfa_tpu_torch")

# the ITEM failed to encode (the caller's 422-row protocol); everything
# else implicates the pool and must degrade to inline encode instead
ENCODE_ITEM_ERRORS: tuple[type[BaseException], ...] = (
    ExtractionItemError, QuarantinedError)


class VocabHashMismatch(ValueError):
    """A frontend worker warm-loaded vocabularies whose content hash
    disagrees with the serving vocabs — encoding with them would score
    garbage, so the spawn fails fast (a ValueError: the supervisor's
    spawn retry must NOT retry a deterministic config error)."""


class _FrontendWorkerCrashed(BaseException):
    """Internal: tears down one worker thread; never crosses submit()."""

    def __init__(self, worker_id: int):
        super().__init__(f"frontend worker {worker_id} crashed")
        self.worker_id = worker_id


# ---------------------------------------------------------------------------
# encode sessions: the same supervision contract as extraction sessions


class ThreadEncodeSession:
    """In-process encode session: one vocab closure. Every encode failure
    is an :class:`ExtractionItemError` — in-process there is no session
    infrastructure to implicate, only the item.

    ``keep_cpg=False`` (the default) returns (name, Graph, node_ids) only;
    the interprocedural scan turns it on so its supergraph pass reuses the
    parsed per-function CPGs instead of parsing every source again."""

    def __init__(self, vocabs, *, keep_cpg: bool = False):
        self._vocabs = vocabs
        self._keep_cpg = keep_cpg

    def encode(self, code: str):
        from deepdfa_tpu_torch.pipeline import encode_source

        try:
            return encode_source(code, self._vocabs, keep_cpg=self._keep_cpg)
        except Exception as exc:  # noqa: BLE001 — item error by definition
            raise ExtractionItemError(f"{type(exc).__name__}: {exc}") from exc

    def close(self) -> None:
        pass


def _frontend_child_main(conn, vocab_blob) -> None:
    """Child loop: warm-load the vocabs ONCE, report their content hash
    in the ready handshake, then encode sources until EOF. Item failures
    are replied (not raised) — only a genuinely dead child implicates
    the session."""
    try:
        from deepdfa_tpu_torch.pipeline import (encode_source, load_vocabs,
                                                vocab_content_hash)

        vocabs = (load_vocabs(vocab_blob) if isinstance(vocab_blob, str)
                  else vocab_blob)
        vhash = vocab_content_hash(vocabs)
    except Exception as exc:  # noqa: BLE001 — reported to the parent
        try:
            conn.send(("spawn_error", f"{type(exc).__name__}: {exc}"))
        finally:
            conn.close()
        return
    conn.send(("ready", vhash))
    while True:
        try:
            kind, payload = conn.recv()
        except (EOFError, OSError):
            return
        if kind == "stop":
            conn.close()
            return
        try:
            conn.send(("ok", encode_source(payload, vocabs, keep_cpg=False)))
        except Exception as exc:  # noqa: BLE001 — item error, session lives
            conn.send(("err", f"{type(exc).__name__}: {exc}"))


class FrontendProcessSession:
    """An encode session in a dedicated **spawned** child (a fork after
    CUDA initialization breaks the child; the child itself never touches
    the card). ``vocab_blob`` is either a shard
    directory path (the child warm-loads from disk) or the vocab dict
    itself (pickled through the spawn args). The ready handshake carries
    the child's vocab content hash; disagreement with ``expect_hash``
    raises :class:`VocabHashMismatch` immediately. A dead/hung child
    raises ``SESSION_ERRORS`` members so the supervisor respawns it;
    encode-level failures raise :class:`ExtractionItemError` and leave
    the session alive."""

    def __init__(self, vocab_blob, *, expect_hash: str,
                 timeout_s: float = 120.0, spawn_timeout_s: float = 120.0):
        import multiprocessing

        self.timeout_s = timeout_s
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_frontend_child_main, args=(child, vocab_blob), daemon=True)
        self._proc.start()
        child.close()
        if not self._conn.poll(spawn_timeout_s):
            self.close()
            raise TimeoutError(
                f"frontend session did not report ready in {spawn_timeout_s}s")
        try:
            kind, detail = self._conn.recv()
        except (EOFError, OSError) as exc:
            self.close()
            raise RuntimeError("frontend session died during spawn") from exc
        if kind != "ready":
            self.close()
            raise RuntimeError(f"frontend session failed to spawn: {detail}")
        if detail != expect_hash:
            self.close()
            raise VocabHashMismatch(
                f"frontend worker warm-loaded vocab hash {detail} but the "
                f"server serves {expect_hash} — refusing to encode with "
                "divergent vocabularies")
        self.vocab_hash = detail

    def encode(self, source: str, timeout_s: float | None = None):
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        try:
            self._conn.send(("item", source))
        except (OSError, ValueError) as exc:
            raise RuntimeError(
                f"frontend session pipe is dead: {exc}") from exc
        if not self._conn.poll(timeout_s):
            raise TimeoutError(
                f"frontend session gave no reply within {timeout_s}s")
        try:
            kind, out = self._conn.recv()
        except (EOFError, OSError) as exc:
            raise RuntimeError("frontend session died mid-item") from exc
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


def encode_session_factory(vocabs, fcfg=None, *, vocab_source=None,
                           keep_cpg: bool = False) -> Callable:
    """One ``session_factory(worker_id)`` for BOTH frontends: the online
    :class:`FrontendPool` and the offline scan's
    :class:`~deepdfa_tpu_torch.data.extraction.ExtractionPool` build their
    encode sessions here, so mode/handshake/timeout semantics cannot
    drift between the two surfaces. ``vocab_source`` (a shard dir) makes
    process children warm-load from disk instead of pickling the vocabs
    through the spawn args. ``fcfg`` None means thread sessions.

    ``keep_cpg`` applies to thread sessions only: process children always
    drop the CPG (it would have to pickle back through the pipe per item
    — the interproc scan's parse-reuse degrades to a re-parse in process
    mode, which the scan reports honestly)."""
    from deepdfa_tpu_torch.pipeline import vocab_content_hash

    expect_hash = vocab_content_hash(vocabs)
    blob = str(vocab_source) if vocab_source is not None else vocabs

    def factory(worker_id: int = 0):
        faults.raise_if("frontend.spawn_fail")
        if fcfg is not None and fcfg.mode == "process":
            return FrontendProcessSession(
                blob, expect_hash=expect_hash,
                timeout_s=fcfg.encode_timeout_s,
                spawn_timeout_s=fcfg.spawn_timeout_s)
        return ThreadEncodeSession(vocabs, keep_cpg=keep_cpg)

    return factory


# ---------------------------------------------------------------------------
# the pool


class _FrontendTask:
    __slots__ = ("key", "source", "future", "ctx", "submitted_mono",
                 "done")

    def __init__(self, key, source, ctx):
        self.key = key
        self.source = source
        self.future: Future = Future()
        self.ctx = ctx
        self.submitted_mono = time.monotonic()
        self.done = False


class FrontendPool:
    """``submit(source)`` → Future resolving to the encoded functions,
    through N long-lived supervised encode workers. Unlike
    :class:`~deepdfa_tpu_torch.data.extraction.ExtractionPool` (batch
    ``run()``/join), this pool serves an open-ended request stream:
    workers block on a condition, the queue is bounded, and shutdown is
    the flag-only drain the server's SIGTERM handler drives."""

    def __init__(self, vocabs, cfg, *, metrics=None, tracer=None,
                 vocab_source=None, attempts_per_item: int = 2,
                 spawn_policy: RetryPolicy | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        if cfg.mode == "inline":
            raise ValueError(
                "mode='inline' means no pool — use FrontendPool.from_config")
        self.cfg = cfg
        self.n_workers = int(cfg.workers)
        self.metrics = metrics
        self.tracer = tracer
        from deepdfa_tpu_torch.pipeline import vocab_content_hash

        self.vocab_hash = vocab_content_hash(vocabs)
        self._factory = encode_session_factory(
            vocabs, cfg, vocab_source=vocab_source)
        self._spawn_policy = spawn_policy or RetryPolicy(
            attempts=3, base_delay=1.0, max_delay=15.0)
        self._attempts = attempts_per_item
        self._sleep = sleep
        self._queues: list[deque] = [deque() for _ in range(self.n_workers)]
        self._overflow: deque = deque()  # crash-requeued in-flight items
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._threads: list[threading.Thread] = []
        self._prespawned: dict[int, object] = {}
        self._started = False
        self._stopping = False
        self._rr = 0  # round-robin submit cursor
        self._depth = 0  # tasks queued, not yet picked up
        self._alive = 0
        self._submitted = 0
        self._encoded = 0
        self._steals = 0
        self._requeued = 0
        self._restarts = 0
        self._quarantine: list[dict] = []
        self._crashed: list[int] = []
        # parent-side encode intervals (wall clock — the same clock the
        # batcher's dispatch intervals use), for the
        # encode↔dispatch overlap measurement
        self._intervals: deque = deque(maxlen=4096)
        # host seconds start() took to spawn every process-mode child and
        # verify its handshake (0.0 in thread mode)
        self.spawn_seconds = 0.0

    @classmethod
    def from_config(cls, vocabs, cfg, **kwargs) -> "FrontendPool | None":
        """None when the config says inline — the caller encodes inline
        and no pool machinery exists at all."""
        if cfg is None or cfg.mode == "inline":
            return None
        return cls(vocabs, cfg, **kwargs)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FrontendPool":
        if self._started:
            return self
        if self.cfg.mode == "process":
            # eager spawn: every child's vocab-hash handshake is verified
            # BEFORE the pool accepts work — a mismatch fails serve
            # startup fast instead of degrading silently per request. The
            # children spawn together (each spawn is seconds of imports).
            t0 = time.perf_counter()
            spawned: dict[int, object] = {}
            errors: list[BaseException] = []

            def spawn(wid: int) -> None:
                try:
                    sess = self._factory(wid)
                except BaseException as exc:  # noqa: BLE001 — re-raised below
                    with self._lock:
                        errors.append(exc)
                else:
                    with self._lock:
                        spawned[wid] = sess

            threads = [threading.Thread(target=spawn, args=(wid,),
                                        name=f"frontend-spawn-{wid}")
                       for wid in range(self.n_workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                for sess in spawned.values():
                    try:
                        sess.close()
                    except Exception:  # noqa: BLE001 — teardown best effort
                        pass
                raise errors[0]
            with self._lock:
                self._prespawned.update(spawned)
                self.spawn_seconds = time.perf_counter() - t0
        self._threads = [
            threading.Thread(target=self._worker, args=(wid,),
                             name=f"frontend-{wid}", daemon=True)
            for wid in range(self.n_workers)
        ]
        with self._lock:
            self._alive = self.n_workers
            self._started = True
        for t in self._threads:
            t.start()
        return self

    def stop(self, drain: bool = True, timeout: float | None = None) -> None:
        """Refuse new submissions (flag-only — invariants 6/12); with
        ``drain`` let workers finish what's queued, else fail the queued
        futures immediately so callers fall back to inline encode."""
        with self._wake:
            self._stopping = True
            pending = [] if drain else self._drain_all_locked()
            if not drain:
                self._depth = 0
                if self.metrics is not None:
                    self.metrics.set_gauge("frontend_queue_depth", 0)
            self._wake.notify_all()
        for task in pending:
            self._complete(task, error=RuntimeError(
                "frontend pool shutting down"))
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._threads:
            remain = (None if deadline is None
                      else max(0.0, deadline - time.monotonic()))
            t.join(timeout=remain)

    @property
    def alive(self) -> bool:
        with self._lock:
            return self._started and not self._stopping and self._alive > 0

    def queue_depth(self) -> int:
        with self._lock:
            return self._depth

    def encode_intervals(self) -> list[tuple[float, float]]:
        """Wall-clock ``(start, end)`` per completed encode: intersected
        with the batcher's dispatch intervals, the encode↔dispatch overlap
        fraction."""
        with self._lock:
            return list(self._intervals)

    # -- client side --------------------------------------------------------

    def submit(self, source: str, key=None) -> Future:
        """Enqueue one raw source; the Future resolves to its encoded
        functions. Raises :class:`QueueFullError` (backpressure) or
        RuntimeError (draining / no live workers) — the server converts
        both into inline encode, never a 5xx."""
        from deepdfa_tpu_torch.pipeline import source_key

        task = _FrontendTask(key if key is not None else source_key(source),
                             source,
                             self.tracer.current()
                             if self.tracer is not None else None)
        with self._wake:
            if not self._started or self._stopping:
                raise RuntimeError("frontend pool is not accepting work")
            if self._alive == 0:
                raise RuntimeError("frontend pool has no live workers")
            if self._depth >= self.cfg.max_queue:
                raise QueueFullError(
                    f"frontend queue at capacity ({self.cfg.max_queue})")
            self._queues[self._rr % self.n_workers].append(task)
            self._rr += 1
            self._depth += 1
            self._submitted += 1
            if self.metrics is not None:
                self.metrics.set_gauge("frontend_queue_depth", self._depth)
            self._wake.notify_all()
        return task.future

    # -- the work deque -----------------------------------------------------

    def _pop_task_locked(self, worker_id: int):
        """``(task, stolen)`` — own queue first, the shared overflow next,
        then steal from the back of the longest other queue (caller holds
        the lock; counters stay with the caller so every mutation sits
        lexically under its guard)."""
        try:
            return self._queues[worker_id].popleft(), False
        except IndexError:
            pass
        try:
            return self._overflow.popleft(), False
        except IndexError:
            pass
        victims = sorted(
            (i for i in range(self.n_workers) if i != worker_id),
            key=lambda i: -len(self._queues[i]))
        for i in victims:
            try:
                # steal cold work from the back
                return self._queues[i].pop(), True
            except IndexError:
                continue
        return None, False

    def _next_task(self, worker_id: int):
        with self._wake:
            while True:
                task, stolen = self._pop_task_locked(worker_id)
                if task is not None:
                    if stolen:
                        self._steals += 1
                    self._depth -= 1
                    if self.metrics is not None:
                        self.metrics.set_gauge(
                            "frontend_queue_depth", self._depth)
                    return task
                if self._stopping:
                    return None
                self._wake.wait()

    def _requeue(self, task, worker_id: int) -> None:
        with self._wake:
            self._overflow.append(task)
            self._depth += 1
            self._requeued += 1
            if self.metrics is not None:
                self.metrics.set_gauge("frontend_queue_depth", self._depth)
            self._wake.notify_all()
        logger.warning("frontend worker %d re-queued in-flight item %r",
                       worker_id, task.key)

    def _drain_all_locked(self) -> list:
        """Pop everything queued (caller holds the lock and owns the
        ``_depth`` reset, so the counter mutation sits under its guard)."""
        out = []
        for q in (*self._queues, self._overflow):
            while True:
                try:
                    out.append(q.popleft())
                except IndexError:
                    break
        return out

    # -- per-item processing ------------------------------------------------

    def _complete(self, task, result=None, error=None) -> None:
        with self._lock:
            if task.done:  # exactly-once guard (invariant 23)
                raise RuntimeError(
                    f"frontend task {task.key!r} completed twice — the "
                    "re-queue path double-counted an in-flight item")
            task.done = True
        if error is not None:
            task.future.set_exception(error)
        else:
            task.future.set_result(result)

    def _process(self, worker_id: int, sup: ExtractionSupervisor,
                 task) -> None:
        mono0, wall0 = time.monotonic(), time.time()
        wait_ms = (mono0 - task.submitted_mono) * 1e3
        if self.metrics is not None:
            self.metrics.frontend_queue_wait.observe(wait_ms)
        try:
            encoded = sup.run(
                task.key, lambda session: session.encode(task.source))
        except Exception as exc:  # noqa: BLE001 — classified by the caller
            self._complete(task, error=exc)
            return
        mono1, wall1 = time.monotonic(), time.time()
        with self._lock:
            self._encoded += 1
            self._intervals.append((wall0, wall1))
        if self.metrics is not None:
            self.metrics.frontend_encode.observe((mono1 - mono0) * 1e3)
        if self.tracer is not None:
            self.tracer.record(
                "frontend.encode", wall0, wall1, parent=task.ctx,
                worker=worker_id, n_functions=len(encoded),
                queue_wait_ms=round(wait_ms, 3))
        self._complete(task, result=encoded)

    # -- worker lifecycle ---------------------------------------------------

    def _supervisor(self, worker_id: int) -> ExtractionSupervisor:
        def factory():
            with self._lock:
                sess = self._prespawned.pop(worker_id, None)
            return sess if sess is not None else self._factory(worker_id)

        return ExtractionSupervisor(
            factory,
            spawn_policy=self._spawn_policy,
            attempts_per_item=self._attempts,
            sleep=self._sleep,
        )

    def _worker_loop(self, worker_id: int,
                     sup: ExtractionSupervisor) -> None:
        while True:
            task = self._next_task(worker_id)
            if task is None:
                return
            if faults.fire("frontend.worker_crash"):
                self._requeue(task, worker_id)
                raise _FrontendWorkerCrashed(worker_id)
            self._process(worker_id, sup, task)

    def _worker(self, worker_id: int) -> None:
        sup = self._supervisor(worker_id)
        try:
            self._worker_loop(worker_id, sup)
        except _FrontendWorkerCrashed:
            with self._lock:
                self._crashed.append(worker_id)
            logger.warning("frontend worker %d crashed; its queue will be "
                           "stolen by survivors", worker_id)
        finally:
            with self._lock:
                self._restarts += sup.restarts
                self._quarantine.extend(sup.quarantine)
            sup.close()
            self._on_worker_exit(worker_id)

    def _on_worker_exit(self, worker_id: int) -> None:
        with self._wake:
            self._alive -= 1
            # pool death with work still queued: fail the pending futures
            # so waiting requests fall back to inline encode — the queue
            # must never strand a request (invariant 25)
            fail: list = []
            if self._alive == 0:
                fail = self._drain_all_locked()
                self._depth = 0
                if self.metrics is not None:
                    self.metrics.set_gauge("frontend_queue_depth", 0)
            self._wake.notify_all()
        for task in fail:
            self._complete(task, error=RuntimeError(
                "frontend pool died — no live encode workers"))

    def report(self) -> dict:
        with self._lock:
            return {
                "mode": self.cfg.mode,
                "workers": self.n_workers,
                "alive": self._alive,
                "queue_depth": self._depth,
                "submitted": self._submitted,
                "encoded": self._encoded,
                "steals": self._steals,
                "requeued": self._requeued,
                "restarts": self._restarts,
                "quarantined": list(self._quarantine),
                "crashed_workers": list(self._crashed),
                "vocab_hash": self.vocab_hash,
                "spawn_seconds": self.spawn_seconds,
            }
