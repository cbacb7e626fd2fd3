"""Dynamic micro-batching over the scoring engine.

A copy of ``deepdfa_tpu/serve/batcher.py`` without the tracing and metrics
hooks. A ~50-node CFG nowhere near saturates the card, so concurrent
requests are coalesced into one padded dispatch:

- requests enter a **bounded** queue (``max_queue``) — beyond it,
  :class:`QueueFullError` (backpressure instead of unbounded latency);
- a single dispatcher thread wakes on the first queued request, then waits
  until ``max_batch`` requests are pending or ``max_wait_ms`` has elapsed
  since that first request (size-or-deadline window);
- the drained window is grouped by the engine's size buckets and each group
  greedy-packed into batches within the bucket's budgets.

Engine failures fail the requests *of that batch* via their futures and the
loop continues. ``stop(drain=True)`` refuses new work and drains what is
queued.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

from .engine import ScoringEngine, ServeBucket

__all__ = ["QueueFullError", "MicroBatcher"]


class QueueFullError(RuntimeError):
    """Admission control: the bounded request queue is at capacity."""


@dataclass
class _Pending:
    graph: object
    bucket: ServeBucket
    future: Future = field(default_factory=Future)


class MicroBatcher:
    def __init__(self, engine: ScoringEngine, max_batch: int = 16,
                 max_wait_ms: float = 5.0, max_queue: int = 128):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_queue = int(max_queue)
        self._pending: list[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stopping = False
        self._thread = threading.Thread(
            target=self._run, name="serve-batcher", daemon=True)
        self._started = False

    # -- client side --------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def submit(self, graph) -> Future:
        """Route + enqueue one graph; the Future resolves to its function
        probability. Raises :class:`QueueFullError` (backpressure),
        :class:`~.engine.OversizeGraphError` (no bucket), or RuntimeError
        once draining."""
        bucket = self.engine.assign_bucket(graph)  # raises OversizeGraphError
        item = _Pending(graph=graph, bucket=bucket)
        with self._wake:
            if self._stopping:
                raise RuntimeError("batcher is draining — not accepting work")
            if len(self._pending) >= self.max_queue:
                raise QueueFullError(
                    f"request queue at capacity ({self.max_queue})")
            self._pending.append(item)
            self._wake.notify_all()
        return item.future

    def stop(self, drain: bool = True, timeout: float | None = None) -> None:
        """Refuse new submissions; with ``drain`` wait for queued requests
        to resolve (bounded by ``timeout``), else fail them immediately."""
        with self._wake:
            self._stopping = True
            if not drain:
                for item in self._pending:
                    item.future.set_exception(
                        RuntimeError("server shutting down"))
                self._pending.clear()
            self._wake.notify_all()
        if self._started:
            self._thread.join(timeout=timeout)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- dispatcher side ----------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._wake:
                while not self._pending and not self._stopping:
                    self._wake.wait()
                if not self._pending and self._stopping:
                    return
            # size-or-deadline window, measured from the first request
            deadline = time.monotonic() + self.max_wait_s
            with self._wake:
                while (len(self._pending) < self.max_batch
                       and not self._stopping):
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        break
                    self._wake.wait(timeout=remain)
                window, self._pending = self._pending, []
            self._dispatch_window(window)

    def _dispatch_window(self, window: list[_Pending]) -> None:
        by_bucket: dict[ServeBucket, list[_Pending]] = {}
        for item in window:
            by_bucket.setdefault(item.bucket, []).append(item)
        for bucket, items in by_bucket.items():
            for batch in self._pack(bucket, items):
                self._dispatch(bucket, batch)

    def _pack(self, bucket: ServeBucket, items: list[_Pending]):
        """Greedy-fill within the bucket's graph/node/edge budgets."""
        out, nn, ne = [], 0, 0
        cur: list[_Pending] = []
        cap = min(bucket.capacity, self.max_batch)
        for item in items:
            g = item.graph
            if cur and (len(cur) >= cap
                        or not bucket.spec.fits(
                            len(cur) + 1, nn + g.n_nodes, ne + g.n_edges)):
                out.append(cur)
                cur, nn, ne = [], 0, 0
            cur.append(item)
            nn += g.n_nodes
            ne += g.n_edges
        if cur:
            out.append(cur)
        return out

    def _dispatch(self, bucket: ServeBucket, batch: list[_Pending]) -> None:
        try:
            probs = self.engine.score([i.graph for i in batch], bucket)
        except Exception as exc:  # noqa: BLE001 — per-batch failure domain
            for item in batch:
                item.future.set_exception(exc)
            return
        for item, p in zip(batch, probs):
            item.future.set_result(float(p))
