"""Two-tier scoring cascade: borderline-band escalation to the joint model.

The port of ``deepdfa_tpu/serve/cascade.py``. Tier 1 — the GGNN
:class:`~deepdfa_tpu_torch.serve.engine.ScoringEngine` (kernel B1 on the
card) — answers **every** request; scores inside the configured borderline
band ``[band_lo, band_hi]`` escalate to tier 2, a second bounded
micro-batch queue feeding the joint LLM+GNN
:class:`~deepdfa_tpu_torch.llm.joint_engine.JointEngine` (its attention on
kernel B6). Traffic outside the band, where the GGNN is confident, never
touches the LLM.

The degradation contract (standing invariant 24): tier-2 failure — queue
at capacity, deadline blown, engine raise, or an armed
``cascade.tier2_timeout`` / ``cascade.escalation_drop`` fault — never fails
a request tier 1 already answered. The server keeps the tier-1 score,
marks the row ``tier2_degraded: true``, bumps
``deepdfa_serve_cascade_degraded_total`` and stays 200 with a green
``/healthz``. Escalations are traced (``cascade.escalate`` →
``tier2.queue.wait`` → ``tier2.engine.dispatch`` spans) and counted in the
per-tier latency reservoirs and the cascade counters.

Queue policy mirrors :class:`~deepdfa_tpu_torch.serve.batcher.MicroBatcher`
(size-or-deadline window, bounded depth, one dispatcher thread, per-batch
failure domain via futures), but tier-2 items are ``(source_text, graph)``
pairs — the LLM branch tokenizes raw source — and backpressure here means
*degrade*, not 503. Tier 1 and tier 2 launch on the card's default stream
from their own dispatcher threads; each engine holds its own lock.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

from deepdfa_tpu_torch.resilience import faults

__all__ = [
    "Tier2QueueFull",
    "Tier2DeadlineError",
    "EscalationDropped",
    "Tier2Batcher",
    "CascadeRouter",
]


class Tier2QueueFull(RuntimeError):
    """Tier-2 admission control: the bounded escalation queue is at
    capacity. The server degrades to the tier-1 answer — never a 503."""


class Tier2DeadlineError(RuntimeError):
    """The tier-2 deadline budget was blown (or ``cascade.tier2_timeout``
    fired). The tier-1 answer stands."""


class EscalationDropped(RuntimeError):
    """``cascade.escalation_drop`` fired at enqueue: the escalation is
    dropped, the request keeps its tier-1 answer."""


@dataclass
class _Escalation:
    text: str
    graph: object
    future: Future = field(default_factory=Future)
    ctx: object = None  # submitting request's span context (tracing handoff)
    enqueued_s: float = 0.0


class Tier2Batcher:
    """Bounded size-or-deadline micro-batch queue over a
    :class:`~deepdfa_tpu_torch.llm.joint_engine.JointEngine`.

    One dispatcher thread (the joint engine serialises on the device
    anyway); engine failures fail that window's futures and the loop
    continues — a poisoned escalation must never kill tier 2, and tier-2
    death must never fail tier 1 (invariant 24: the server converts every
    future failure into a degraded tier-1 answer).
    """

    def __init__(self, engine, max_batch: int = 4, max_wait_ms: float = 10.0,
                 max_queue: int = 64, metrics=None, tracer=None):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_queue = int(max_queue)
        self.metrics = metrics
        self.tracer = tracer
        self._pending: list[_Escalation] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stopping = False
        self._thread = threading.Thread(
            target=self._run, name="serve-tier2", daemon=True)
        self._started = False

    # -- client side --------------------------------------------------------

    def start(self) -> "Tier2Batcher":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def submit(self, text: str, graph) -> Future:
        """Enqueue one borderline function; the Future resolves to its
        tier-2 probability. Raises :class:`Tier2QueueFull` (the caller
        degrades) or RuntimeError once draining."""
        item = _Escalation(text=text, graph=graph,
                           ctx=(self.tracer.current()
                                if self.tracer is not None else None),
                           enqueued_s=time.time())
        with self._wake:
            if self._stopping:
                raise RuntimeError("tier-2 batcher is draining")
            if len(self._pending) >= self.max_queue:
                raise Tier2QueueFull(
                    f"tier-2 queue at capacity ({self.max_queue})")
            self._pending.append(item)
            if self.metrics is not None:
                self.metrics.set_gauge("tier2_queue_depth",
                                       len(self._pending))
            self._wake.notify_all()
        return item.future

    def stop(self, drain: bool = True, timeout: float | None = None) -> None:
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
            deadline = time.monotonic() + self.max_wait_s
            with self._wake:
                while (len(self._pending) < self.max_batch
                       and not self._stopping):
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        break
                    self._wake.wait(timeout=remain)
                window, self._pending = (
                    self._pending[:self.max_batch],
                    self._pending[self.max_batch:],
                )
                if self.metrics is not None:
                    self.metrics.set_gauge("tier2_queue_depth",
                                           len(self._pending))
            self._dispatch(window)

    def _dispatch(self, window: list[_Escalation]) -> None:
        tracer, now = self.tracer, time.time()
        first_ctx = next((i.ctx for i in window if i.ctx is not None), None)
        for item in window:
            if item.enqueued_s:
                if self.metrics is not None:
                    self.metrics.tier2_queue_wait.observe(
                        (now - item.enqueued_s) * 1e3)
                if tracer is not None:
                    tracer.record("tier2.queue.wait", item.enqueued_s, now,
                                  parent=item.ctx)
        t0 = time.time()
        try:
            # armed chaos: treat this window's deadline as blown — the
            # requests must keep their tier-1 answers (invariant 24)
            if faults.fire("cascade.tier2_timeout"):
                raise Tier2DeadlineError(
                    "injected tier-2 deadline blow (cascade.tier2_timeout)")
            probs = self.engine.score([(i.text, i.graph) for i in window])
        except Exception as exc:  # noqa: BLE001 — per-window failure domain
            if tracer is not None:
                tracer.record("tier2.engine.dispatch", t0, parent=first_ctx,
                              n_items=len(window),
                              error=type(exc).__name__)
            for item in window:
                item.future.set_exception(exc)
            return
        t1 = time.time()
        if self.metrics is not None:
            self.metrics.tier2_dispatch.observe((t1 - t0) * 1e3)
        if tracer is not None:
            tracer.record("tier2.engine.dispatch", t0, t1, parent=first_ctx,
                          n_items=len(window))
        for item, p in zip(window, probs):
            item.future.set_result(float(p))


class CascadeRouter:
    """Band routing + the tier-2 queue, packaged for the server.

    ``escalate`` enqueues; the *caller* owns the wait (``deadline_s``) and
    the degradation decision, because only the caller holds the tier-1
    answer to fall back on.
    """

    def __init__(self, cfg, engine, metrics=None, tracer=None):
        self.cfg = cfg
        self.engine = engine
        self.metrics = metrics
        self.tracer = tracer
        self.deadline_s = float(cfg.tier2_deadline_ms) / 1000.0
        self.batcher = Tier2Batcher(
            engine,
            max_batch=cfg.tier2_max_batch,
            max_wait_ms=cfg.tier2_max_wait_ms,
            max_queue=cfg.tier2_max_queue,
            metrics=metrics,
            tracer=tracer,
        )
        self.model_rev = getattr(engine, "model_rev", "unknown")

    def start(self) -> "CascadeRouter":
        self.batcher.start()
        return self

    def stop(self, drain: bool = True, timeout: float | None = None) -> None:
        self.batcher.stop(drain=drain, timeout=timeout)

    def in_band(self, prob: float) -> bool:
        return self.cfg.band_lo <= prob <= self.cfg.band_hi

    def escalation_allowed(self, brownout_level: int = 0) -> bool:
        """Brownout level >= 2 is tier-1 only (serve/admission.py): the
        request keeps its tier-1 answer — degradation, never a 5xx — but
        no tier-2 capacity (kernel B6 on the card) is spent while the
        fleet sheds load."""
        from .admission import BROWNOUT_TIER1_ONLY

        return brownout_level < BROWNOUT_TIER1_ONLY

    def escalate(self, text: str, graph) -> Future:
        """Enqueue one borderline function for tier-2 rescoring. Raises
        :class:`EscalationDropped` (armed ``cascade.escalation_drop``) or
        :class:`Tier2QueueFull` — both mean: keep the tier-1 answer."""
        if faults.fire("cascade.escalation_drop"):
            raise EscalationDropped(
                "injected escalation drop (cascade.escalation_drop)")
        return self.batcher.submit(text, graph)
