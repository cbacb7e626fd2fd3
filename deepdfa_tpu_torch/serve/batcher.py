"""Dynamic micro-batching over the scoring engine.

The port of ``deepdfa_tpu/serve/batcher.py``. A ~50-node CFG nowhere near
saturates the card, so concurrent requests are coalesced into one padded
dispatch:

- requests enter a **bounded** queue (``max_queue``) — beyond it,
  :class:`QueueFullError` (the server's 503 backpressure);
- a single dispatcher thread wakes on the first queued request, then waits
  until ``max_batch`` requests are pending or ``max_wait_ms`` has elapsed
  since that first request (size-or-deadline window);
- the drained window is grouped by the engine's size buckets and each group
  greedy-packed into batches within the bucket's budgets.

Packed batches go down in chunks of the engine's ``n_replicas``, one
``engine.score_groups`` call a chunk: a mesh-replicated engine stacks one
batch per replica in one dispatch, a single-replica engine scores each
batch (an engine built with ``latency_mode`` through
:meth:`~deepdfa_tpu_torch.serve.engine.ScoringEngine.submit`: upload and
launch under the engine lock, read back on ``result()``). With ``metrics`` and ``tracer`` attached the
batcher feeds the queue-depth gauge, the queue-wait and dispatch
reservoirs, batch occupancy and padding, and the ``queue.wait``,
``batch.assembly``, ``engine.dispatch`` and ``host.reduce`` spans.

Engine failures (the injected ``serve.engine_raises`` included) fail the
requests *of that batch* via their futures and the loop continues.
``stop(drain=True)`` refuses new work and drains what is queued, which is
what SIGTERM maps to.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # the engine imports torch; the frontend pool needs none
    from .engine import ScoringEngine, ServeBucket

__all__ = ["QueueFullError", "MicroBatcher"]


class QueueFullError(RuntimeError):
    """Admission control: the bounded request queue is at capacity."""


@dataclass
class _Pending:
    graph: object
    bucket: "ServeBucket"
    future: Future = field(default_factory=Future)
    # tracing handoff: the submitting request's span context and enqueue
    # wall time, so the dispatcher thread can close the queue.wait span
    # against the right trace
    ctx: object = None
    enqueued_s: float = 0.0


class MicroBatcher:
    def __init__(self, engine: "ScoringEngine", max_batch: int = 16,
                 max_wait_ms: float = 5.0, max_queue: int = 128,
                 metrics=None, tracer=None):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_queue = int(max_queue)
        self.metrics = metrics
        self.tracer = tracer
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
        item = _Pending(graph=graph, bucket=bucket,
                        ctx=(self.tracer.current()
                             if self.tracer is not None else None),
                        enqueued_s=time.time())
        with self._wake:
            if self._stopping:
                raise RuntimeError("batcher is draining — not accepting work")
            if len(self._pending) >= self.max_queue:
                raise QueueFullError(
                    f"request queue at capacity ({self.max_queue})")
            self._pending.append(item)
            if self.metrics is not None:
                self.metrics.set_gauge("queue_depth", len(self._pending))
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
                if self.metrics is not None:
                    self.metrics.set_gauge("queue_depth", 0)
            self._dispatch_window(window)

    def _dispatch_window(self, window: list[_Pending]) -> None:
        assembled_s = time.time()
        by_bucket: dict["ServeBucket", list[_Pending]] = {}
        for item in window:
            by_bucket.setdefault(item.bucket, []).append(item)
        # chunks of n_replicas packed batches: one dispatch each, a batch
        # per replica on a mesh-replicated engine
        chunk = max(1, self.engine.n_replicas)
        plans = [(bucket, self._pack(bucket, items))
                 for bucket, items in by_bucket.items()]
        if self.tracer is not None and window:
            parent = next((i.ctx for i in window if i.ctx is not None), None)
            self.tracer.record("batch.assembly", assembled_s, parent=parent,
                               n_graphs=len(window),
                               n_buckets=len(by_bucket))
        for bucket, packed in plans:
            for i in range(0, len(packed), chunk):
                self._dispatch(bucket, packed[i:i + chunk])

    def _pack(self, bucket: "ServeBucket", items: list[_Pending]):
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

    def _dispatch(self, bucket: "ServeBucket",
                  batches: list[list[_Pending]]) -> None:
        tracer, now = self.tracer, time.time()
        n_real = sum(len(b) for b in batches)
        first_ctx = next((i.ctx for b in batches for i in b
                          if i.ctx is not None), None)
        for b in batches:
            for item in b:
                if item.enqueued_s:
                    if self.metrics is not None:
                        self.metrics.queue_wait.observe(
                            (now - item.enqueued_s) * 1e3)
                    if tracer is not None:
                        tracer.record("queue.wait", item.enqueued_s, now,
                                      parent=item.ctx, bucket=bucket.capacity)
        t0 = time.time()
        try:
            results = self.engine.score_groups(
                [[i.graph for i in b] for b in batches], bucket)
        except Exception as exc:  # noqa: BLE001 — per-chunk failure domain
            if tracer is not None:
                tracer.record("engine.dispatch", t0, parent=first_ctx,
                              n_graphs=n_real, error=type(exc).__name__)
            for b in batches:
                for item in b:
                    item.future.set_exception(exc)
            return
        t1 = time.time()
        if self.metrics is not None:
            self.metrics.dispatch.observe((t1 - t0) * 1e3)
        if tracer is not None:
            tracer.record("engine.dispatch", t0, t1, parent=first_ctx,
                          n_graphs=n_real, n_batches=len(batches),
                          bucket=bucket.capacity)
        for b, probs in zip(batches, results):
            if self.metrics is not None:
                self.metrics.observe_batch(len(b), bucket.capacity)
                self.metrics.observe_padding(
                    bucket.graph_nodes,
                    real={"nodes": sum(i.graph.n_nodes for i in b),
                          "edges": sum(i.graph.n_edges for i in b),
                          "graphs": len(b)},
                    padded={"nodes": bucket.spec.max_nodes,
                            "edges": bucket.spec.max_edges,
                            "graphs": bucket.spec.max_graphs})
            for item, p in zip(b, probs):
                item.future.set_result(float(p))
        if tracer is not None:
            tracer.record("host.reduce", t1, parent=first_ctx,
                          n_graphs=n_real)
