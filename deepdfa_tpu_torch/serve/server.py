"""Stdlib HTTP JSON scoring service — the long-lived online surface.

The port of ``deepdfa_tpu/serve/server.py``. Endpoints:

- ``POST /score``  ``{"source": "<C text>"}`` → per-function rows
  ``{"function", "vulnerable_probability"}`` (or ``{"function","error"}``
  for functions with no scoreable CFG). Repeat scans of the same
  normalized source are served from the content-addressed cache
  (``"cached": true``) without touching the frontend. With the cascade
  enabled every row also carries ``tier`` and ``tier1_score``.
- ``GET /healthz`` → liveness and the replica's identity (the JAX
  package's keys). Stays green through per-request failures; only process
  death or drain takes it away.
- ``GET /metrics`` → Prometheus text (see :mod:`.metrics`).
- ``GET /slo`` → the SLO burn-rate verdicts (:mod:`deepdfa_tpu_torch.obs.
  slo`).

Tier 1 scores every function on the engine (kernel B1 on the card for a
checkpoint served by :func:`build_server`); borderline scores escalate to
the tier-2 :class:`~deepdfa_tpu_torch.llm.joint_engine.JointEngine`
(kernel B6) through :mod:`.cascade`.

Failure domains, smallest first: a bad request body is a 400; an
unparseable source is a 422; an oversize function a 413; a shed by
admission control a 429 with a Retry-After; backpressure (bounded queue)
and the ``serve.drop_request`` fault are 503; a blown
request deadline is a 504; an engine failure (``serve.engine_raises``
included) is a 500 for the requests in that batch. None of them touch the
server's lifetime. Frontend-pool trouble degrades to inline encode
(invariant 25) and tier-2 trouble keeps the tier-1 answer (invariant 24).

Shutdown: SIGTERM/SIGINT set a flag; ``/score`` starts refusing with 503,
the micro-batcher drains what is queued, in-flight handler threads finish
writing their responses (bounded by ``serve.drain_timeout_s``), then the
listener closes. No admitted request is abandoned mid-flight.

A replica serves a ``train.fit`` run (``--run-dir``) or an exported
artifact (``--artifact``, :mod:`deepdfa_tpu_torch.serving`); with
``serve.warm_store_dir`` its warmup goes through the fleet's warm store
(:mod:`.warmstore`). With ``serve.continual.enabled`` and a
``capture_path``, every scored request is journaled for the continual loop
(:mod:`deepdfa_tpu_torch.continual.capture`), and capture can never fail
the request it records. With ``serve.admission.enabled``, admission
control sheds load before encode as a 429 with a Retry-After, and the
brownout controller steps through its degradation levels under sustained
SLO burn (:mod:`.admission`). A fleet of replicas sits behind
:mod:`.router`, the autoscaler (:mod:`.autoscaler`) and cells behind
:mod:`.federation`.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from contextlib import nullcontext
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from deepdfa_tpu_torch.config import ExperimentConfig, ServeConfig
from deepdfa_tpu_torch.obs import (FlightRecorder, ScoreDriftSentinel,
                                   SLOEngine, Tracer, parse_traceparent,
                                   serve_specs, write_alerts_artifact)
from deepdfa_tpu_torch.obs.flightrec import install_sigusr2
from deepdfa_tpu_torch.pipeline import encode_source, load_vocabs, source_key
from deepdfa_tpu_torch.resilience import faults

from .admission import QOS_CLASSES, AdmissionController, BrownoutController

from .batcher import MicroBatcher, QueueFullError
from .cache import ScanCache
from .engine import OversizeGraphError, ScoringEngine
from .frontend import ENCODE_ITEM_ERRORS, FrontendPool
from .metrics import ServeMetrics

__all__ = ["QOS_CLASSES", "ScoreServer", "build_server", "serve_command",
           "main"]

logger = logging.getLogger(__name__)

REQUEST_TIMEOUT_S = 60.0  # cap on one request's wait for its batch scores


class _HTTPServer(ThreadingHTTPServer):
    """One thread per connection. The listen backlog is 128, not
    socketserver's 5: with 5, a burst of concurrently connecting clients
    overflows the accept queue and waits out a 1 s SYN retransmit, or is
    reset."""

    daemon_threads = True  # a hung socket must not block exit
    request_queue_size = 128


class ScoreServer:
    """Engine + vocabs + cache + batcher behind a ThreadingHTTPServer."""

    def __init__(self, engine: ScoringEngine, vocabs,
                 cfg: ServeConfig | None = None, cache: ScanCache | None = None,
                 metrics: ServeMetrics | None = None,
                 replica_id: str | None = None, warm_store=None, journal=None,
                 tier2_engine=None, frontend_pool=None, vocab_source=None,
                 device=None):
        self.cfg = cfg or ServeConfig()
        self.engine = engine
        self.vocabs = vocabs
        self.replica_id = replica_id or self.cfg.replica_id
        self.warm_store = warm_store
        self.journal = journal
        self.metrics = metrics or ServeMetrics(self.cfg.latency_window)
        self.cache = cache if cache is not None else ScanCache(
            self.cfg.cache_entries)
        obs = self.cfg.obs
        self.tracer = Tracer(
            proc="serve", max_spans=obs.trace_buffer,
            slow_ms=(obs.slow_trace_ms
                     if obs.slow_trace_ms and obs.slow_trace_ms > 0
                     else None),
            exemplar_dir=obs.trace_dir, max_exemplars=obs.max_exemplars,
        ) if obs.trace else None
        self.drift = ScoreDriftSentinel(
            window=obs.drift_window, bins=obs.drift_bins,
            threshold=obs.drift_threshold,
            min_samples=obs.drift_min_samples,
            max_revs=obs.drift_max_revs)
        self.flight = FlightRecorder(
            capacity=obs.flight_events, proc="serve",
            dump_dir=obs.flight_dir)
        cascade_cfg = self.cfg.cascade
        self.slo = SLOEngine(
            serve_specs(availability=obs.slo_availability,
                        error_rate=obs.slo_error_rate,
                        p99_ms=obs.slo_p99_ms,
                        # tier 2 gets its own deadline budget as the SLO
                        # ceiling: sustained waits at the degradation
                        # boundary are an incident before degradations are
                        tier2_p99_ms=(cascade_cfg.tier2_deadline_ms
                                      if cascade_cfg.enabled else None)),
            fast_window_s=obs.slo_fast_window_s,
            slow_window_s=obs.slo_slow_window_s,
            burn_threshold=obs.slo_burn_threshold,
            flight=self.flight)
        # (responses_total, monotonic time it last changed) — the idle
        # detector behind _slo_snapshot's stale-latency suppression
        self._slo_traffic_mark = (0, time.monotonic())
        self.alerts_path = Path(obs.alerts_path) if obs.alerts_path else None
        self.metrics.tracer = self.tracer
        self.metrics.drift = self.drift
        self.metrics.flight = self.flight
        if hasattr(engine, "flight"):
            engine.flight = self.flight
        self.batcher = MicroBatcher(
            engine, max_batch=self.cfg.max_batch,
            max_wait_ms=self.cfg.max_wait_ms, max_queue=self.cfg.max_queue,
            metrics=self.metrics, tracer=self.tracer).start()
        # tier-2 escalation plane (serve/cascade.py): band routing over a
        # second bounded queue feeding the joint LLM+GNN engine
        self.cascade = None
        if cascade_cfg.enabled:
            if tier2_engine is None:
                if not cascade_cfg.joint_dir:
                    raise ValueError(
                        "serve.cascade.enabled needs a tier-2 engine: pass "
                        "tier2_engine= or set serve.cascade.joint_dir to a "
                        "JointTrainer run dir")
                from deepdfa_tpu_torch.llm.joint_engine import JointEngine

                tier2_engine = JointEngine.from_run_dir(
                    cascade_cfg.joint_dir,
                    max_batch=cascade_cfg.tier2_max_batch, device=device)
            from .cascade import CascadeRouter

            self.cascade = CascadeRouter(
                cascade_cfg, tier2_engine,
                metrics=self.metrics, tracer=self.tracer).start()
        # frontend encode pool (serve/frontend.py): cold-request encode on
        # supervised workers past the GIL; inline mode (the default) means
        # no pool at all. A process-mode vocab-hash mismatch raises out of
        # start() here — serve startup fails fast rather than scoring with
        # divergent vocabularies. An injected pool is the caller's to stop.
        self._owns_frontend = frontend_pool is None
        if frontend_pool is not None:
            self.frontend = frontend_pool
        else:
            self.frontend = FrontendPool.from_config(
                vocabs, self.cfg.frontend, metrics=self.metrics,
                tracer=self.tracer, vocab_source=vocab_source)
            if self.frontend is not None:
                self.frontend.start()
        # admission control + QoS classes + brownout (serve/admission.py):
        # shed load BEFORE encode cost is paid — always a 429 with a
        # deterministic Retry-After, never a 5xx; under sustained SLO burn
        # the brownout controller steps through declared degradation
        # levels
        adm_cfg = self.cfg.admission
        self.admission = None
        self.brownout = None
        if adm_cfg.enabled:
            self.admission = AdmissionController(
                adm_cfg, metrics=self.metrics, journal=journal,
                flight=self.flight)
            if adm_cfg.brownout:
                self.brownout = BrownoutController(
                    adm_cfg, self._observe_fast_burn, metrics=self.metrics,
                    journal=journal, flight=self.flight).start()
                self.admission.brownout = self.brownout
        # continuous-learning capture (continual/capture.py): a sampled,
        # bounded journal of scored requests feeding shadow replay and
        # incremental retraining. record_request never raises, so the hook
        # in handle_score is bare.
        cont_cfg = self.cfg.continual
        self.capture = None
        if cont_cfg.enabled and cont_cfg.capture_path:
            from deepdfa_tpu_torch.continual.capture import TrafficCapture

            self.capture = TrafficCapture(
                Path(cont_cfg.capture_path),
                sample_every=cont_cfg.capture_sample_every,
                max_records=cont_cfg.capture_max_records,
                flight=self.flight)
        self._draining = threading.Event()
        self._stop_requested = threading.Event()
        self._stopped = threading.Event()
        self.httpd = _HTTPServer((self.cfg.host, self.cfg.port),
                                 _make_handler(self))
        self._serve_thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def draining(self) -> bool:
        # a requested-but-not-yet-started drain counts: from the instant
        # SIGTERM lands, /healthz must stop advertising this replica so the
        # LB routes elsewhere while in-flight work finishes
        return self._draining.is_set() or self._stop_requested.is_set()

    def warmup(self) -> dict:
        """Warm the engine's bucket ladder (every kernel of the path built
        and launched once; through the warm store when one is wired) and,
        with the cascade, the tier-2 engine; publish the report to /metrics
        and return it. Call it before :meth:`start`: the first request then
        pays no build."""
        report = self.engine.warmup(warm_store=self.warm_store,
                                    journal=self.journal)
        if self.cascade is not None and hasattr(self.cascade.engine,
                                                "warmup"):
            report["tier2"] = self.cascade.engine.warmup()
        self.metrics.set_warmup(report)
        return report

    def start(self) -> "ScoreServer":
        if self.replica_id is None:
            self.replica_id = f"{self.cfg.host}:{self.port}"
        if self.tracer is not None:
            self.tracer.proc = f"serve:{self.replica_id}"
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="serve-http", daemon=True)
        self._serve_thread.start()
        logger.info("serving on %s:%s (%d buckets, max_batch=%d)",
                    self.cfg.host, self.port, len(self.engine.buckets),
                    self.cfg.max_batch)
        return self

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT → request a graceful drain. The handler only
        sets a flag; the actual drain runs in :meth:`wait` (signal
        handlers must not join threads). SIGUSR2 → dump the flight
        recorder (the live-incident probe)."""
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: self._stop_requested.set())
        install_sigusr2(self.flight)

    def wait(self) -> dict:
        """Block until a shutdown is requested, then drain and stop.
        Returns the final metrics snapshot (also what ``main`` prints)."""
        while not self._stop_requested.wait(timeout=0.2):
            pass
        return self.shutdown(drain=True)

    def shutdown(self, drain: bool = True) -> dict:
        """Refuse new scores, drain queue + in-flight handlers, close."""
        self._draining.set()
        self._stop_requested.set()
        if self.brownout is not None:
            self.brownout.stop()
        if self.frontend is not None and self._owns_frontend:
            self.frontend.stop(drain=drain, timeout=self.cfg.drain_timeout_s)
        self.batcher.stop(drain=drain, timeout=self.cfg.drain_timeout_s)
        if self.cascade is not None:
            self.cascade.stop(drain=drain, timeout=self.cfg.drain_timeout_s)
        deadline = time.monotonic() + self.cfg.drain_timeout_s
        while drain and self.metrics.inflight > 0:
            if time.monotonic() >= deadline:
                logger.warning("drain timeout with %d request(s) in flight",
                               self.metrics.inflight)
                break
            time.sleep(0.01)
        self.httpd.shutdown()
        self.httpd.server_close()
        self._stopped.set()
        snap = self.metrics.snapshot()
        snap["cache"] = self.cache.stats()
        if self.admission is not None:
            snap["admission"] = self.admission.summary()
        if self.brownout is not None:
            snap["brownout"] = self.brownout.summary()
        return snap

    # -- verdict layer (/slo) ----------------------------------------------

    def _slo_snapshot(self) -> dict:
        """The flat snapshot the SLO specs read: response counters split
        by badness, the p99 gauge, and the drift sentinel's alert count
        (the PR 8 PSI alert, wired into action here).

        The latency gauges go ``None`` once no response has completed
        within the fast SLO window: the reservoir quantile is a memory of
        the LAST traffic, and a replica that reads as slow while serving
        nothing can never be sent traffic to prove otherwise — the
        federation's spillover demotion plus a frozen burn is a permanent
        saturation deadlock. No traffic in the window means no latency
        verdict, the same honesty rule the ratio burn already applies."""
        snap = self.metrics.snapshot()
        responses = snap.get("responses_total") or {}
        total = sum(responses.values())
        bad_5xx = sum(n for code, n in responses.items() if int(code) >= 500)
        errors = sum(n for code, n in responses.items() if int(code) >= 400)
        drift_alerting = sum(
            1 for row in self.drift.snapshot().values() if row["alert"])
        now = time.monotonic()
        if total != self._slo_traffic_mark[0]:
            self._slo_traffic_mark = (total, now)
        idle = (now - self._slo_traffic_mark[1]) >= self.slo.fast_window_s
        return {
            "responses_total": total,
            "responses_5xx_total": bad_5xx,
            "responses_error_total": errors,
            "latency_p99_ms": None if idle else snap.get("latency_p99_ms"),
            "drift_alerting": drift_alerting,
            # cascade keys — read by the tier-2 specs when enabled
            "tier2_latency_p99_ms": (None if idle
                                     else snap.get("tier2_latency_p99_ms")),
            "cascade_escalated_total": snap.get("cascade_escalated_total"),
            "cascade_degraded_total": snap.get("cascade_degraded_total"),
        }

    def _observe_slo(self) -> None:
        """One SLO evaluation against the live snapshot: journal any
        alert transitions as events and refresh the ``alerts.json``
        promotion veto. Both the ``/slo`` scrape and the brownout
        controller's poll drive this same path, so transitions are
        journaled identically whoever observes first. None of the side
        effects can fail the caller (invariant 14 — drops count in
        ``obs_dropped_total``)."""
        events = self.slo.observe(self._slo_snapshot())
        if events:
            for evt in events:
                logger.warning("slo %s -> %s (burn fast=%s slow=%s)",
                               evt["slo"], evt["state"], evt["burn_fast"],
                               evt["burn_slow"])
                if self.journal is not None:
                    try:
                        self.journal.write(
                            event="slo_transition", slo=evt["slo"],
                            state=evt["state"], t_unix=evt["t_unix"],
                            burn_fast=evt["burn_fast"],
                            burn_slow=evt["burn_slow"])
                    except Exception:  # noqa: BLE001 — invariant 14
                        self.slo.dropped_total += 1
            if self.alerts_path is not None:
                if write_alerts_artifact(self.alerts_path,
                                         self.slo.statuses()) is None:
                    self.slo.dropped_total += 1

    def _observe_fast_burn(self) -> float | None:
        """The brownout controller's signal source: drive one SLO
        evaluation (the path a ``/slo`` scrape drives) and return the
        worst fast-window burn across the specs."""
        self._observe_slo()
        return self.slo.worst_fast_burn()

    def render_slo(self) -> str:
        """The ``/slo`` body, rendered through the shared registry
        (invariant 16) after one evaluation pass."""
        self._observe_slo()
        return self.slo.render("deepdfa_serve_")

    # -- request handling ---------------------------------------------------

    def _span(self, name: str, parent=None, root: bool = False, **attrs):
        """Tracer span when tracing is on, else a no-op context (yields
        None — callers must guard attribute writes)."""
        if self.tracer is None:
            return nullcontext()
        return self.tracer.span(name, parent=parent, root=root, **attrs)

    def handle_score(self, payload: dict) -> tuple[int, dict]:
        source = payload.get("source") if isinstance(payload, dict) else None
        if not isinstance(source, str) or not source.strip():
            return 400, {"error": "body must be JSON with a 'source' string"}
        # QoS tagging (serve/admission.py): every request carries a
        # priority class (default interactive — a human waiting on a
        # score) and a tenant for its token bucket
        qos = payload.get("class") or "interactive"
        if qos not in QOS_CLASSES:
            return 400, {"error": f"class must be one of "
                                  f"{'/'.join(QOS_CLASSES)}"}
        tenant = payload.get("tenant") or "default"
        if self.draining:
            return 503, {"error": "server is draining"}
        if faults.fire("serve.drop_request"):
            self.metrics.inc("dropped_total")
            self.flight.record("fault.fired", point="serve.drop_request")
            return 503, {"error": "request dropped (injected fault "
                                  "serve.drop_request)"}

        key = source_key(source)
        with self._span("cache.lookup") as sp:
            entry = self.cache.lookup(key)
            if sp is not None:
                sp.attrs["result_hit"] = bool(
                    entry is not None and entry.results is not None)
                sp.attrs["encode_hit"] = bool(
                    entry is not None and entry.results is None
                    and entry.encoded is not None)
        if entry is not None and entry.results is not None:
            # a result-level hit costs no encode or score work, so it is
            # served at every brownout level without spending a token —
            # the "warm-cache hits" half of brownout level 2
            return 200, {"results": entry.results, "cached": True}

        # admission control sits here — after the free cache hit, before
        # any encode cost is paid. A shed is a 429 with a deterministic
        # Retry-After (from bucket refill state), never a 5xx, and the
        # controller has journaled the decision and put it in the flight
        # ring
        if self.admission is not None:
            decision = self.admission.admit(tenant, qos)
            if not decision["admit"]:
                return 429, {"error": "request shed by admission control",
                             "reason": decision["reason"],
                             "class": qos,
                             "retry_after_s": decision["retry_after_s"]}

        if entry is not None and entry.encoded is not None:
            encoded = entry.encoded  # frontend skipped: encode-level hit
        else:
            try:
                encoded = self._frontend_encode(source, key)
            except Exception as exc:  # noqa: BLE001 — frontend failure = 422
                return 422, {"error": f"{type(exc).__name__}: {exc}"}
            self.cache.store(key, encoded=encoded)
        if not encoded:
            return 422, {"error": "no functions found in source"}

        rows: list[dict] = []
        futures: list = []
        graphs: list = []  # aligned with rows; the tier-2 escalation payload
        for enc in encoded:
            if enc.graph is None:
                rows.append({"function": enc.name, "error": enc.error})
                futures.append(None)
                graphs.append(None)
                continue
            try:
                futures.append(self.batcher.submit(enc.graph))
            except QueueFullError as exc:
                self.metrics.inc("dropped_total")
                return 503, {"error": str(exc)}
            except OversizeGraphError as exc:
                return 413, {"error": str(exc)}
            except RuntimeError as exc:  # draining race
                return 503, {"error": str(exc)}
            rows.append({"function": enc.name})
            graphs.append(enc.graph)

        cascade = self.cascade
        tier1_rev = getattr(self.engine, "model_rev", None) or "unknown"
        t_req = time.monotonic()
        deadline = t_req + REQUEST_TIMEOUT_S
        # (row, tier-2 future, escalation time) — submitted as each tier-1
        # score lands, awaited together after the loop so escalations batch
        pending_t2: list[tuple[dict, object, float]] = []
        for row, fut, graph in zip(rows, futures, graphs):
            if fut is None:
                continue
            try:
                prob = fut.result(timeout=max(0.0, deadline - time.monotonic()))
            except (TimeoutError, _FutureTimeout):
                self.flight.record("request.timeout", function=row["function"])
                return 504, {"error": "scoring timed out"}
            except Exception as exc:  # noqa: BLE001 — engine fault = 500
                # the crash question "what was it doing?" gets a file:
                # record the failure, then dump the whole ring atomically
                self.flight.record("engine.error", function=row["function"],
                                   error=f"{type(exc).__name__}: {exc}")
                self.flight.dump("engine_error")
                return 500, {"error": f"{type(exc).__name__}: {exc}"}
            row["vulnerable_probability"] = round(prob, 6)
            if cascade is None:
                self.drift.observe(prob, tier1_rev)
                continue
            # cascade path: per-(model_rev, tier) drift keying + tier
            # attribution on every row; borderline scores escalate
            self.metrics.tier1_latency.observe(
                (time.monotonic() - t_req) * 1e3)
            self.drift.observe(prob, f"{tier1_rev}@t1")
            row["tier"] = 1
            row["tier1_score"] = round(prob, 6)
            if not cascade.in_band(prob):
                continue
            if (self.brownout is not None
                    and not cascade.escalation_allowed(self.brownout.level)):
                # brownout level >= 2 is tier-1 only: the tier-1 answer
                # is served, no tier-2 capacity is spent
                self.metrics.inc("brownout_suppressed_escalations_total")
                continue
            self.metrics.inc("cascade_escalated_total")
            with self._span("cascade.escalate", score=round(prob, 6),
                            band_lo=cascade.cfg.band_lo,
                            band_hi=cascade.cfg.band_hi):
                try:
                    fut2 = cascade.escalate(source, graph)
                except Exception as exc:  # noqa: BLE001 — invariant 24:
                    # enqueue failure (queue full, injected drop, draining)
                    # degrades to the tier-1 answer, never fails the request
                    self._cascade_degrade(row, exc)
                else:
                    pending_t2.append((row, fut2, time.monotonic()))

        for row, fut2, t_esc in pending_t2:
            remain = cascade.deadline_s - (time.monotonic() - t_esc)
            try:
                prob2 = fut2.result(timeout=max(0.0, remain))
            except Exception as exc:  # noqa: BLE001 — invariant 24: blown
                # deadline / tier-2 engine failure keeps the tier-1 answer
                self._cascade_degrade(row, exc)
                continue
            self.metrics.tier2_latency.observe(
                (time.monotonic() - t_esc) * 1e3)
            row["tier"] = 2
            row["vulnerable_probability"] = round(prob2, 6)
            self.drift.observe(prob2, f"{cascade.model_rev}@t2")
        if cascade is not None:
            for row, fut in zip(rows, futures):
                if fut is not None:
                    self.metrics.observe_answered(row["tier"])

        if self.capture is not None:
            # the request as served (scores, tiers, the encoded graphs);
            # capture never fails it
            self.capture.record_request(key, rows, graphs,
                                        model_rev=tier1_rev)
        self.cache.store(key, results=rows)
        return 200, {"results": rows, "cached": False}

    def _frontend_encode(self, source: str, key: str):
        """Encode one cold source. With a pool: submit → await under the
        request deadline, so the encode runs on a supervised worker and
        overlaps the batcher's device dispatches. ANY pool-level failure
        — backpressure (``QueueFullError``), draining, pool death, a
        blown wait — **degrades to inline encode** (standing invariant
        25): pool trouble must never become a new 5xx and ``/healthz``
        stays green. Only :data:`~.frontend.ENCODE_ITEM_ERRORS` propagate
        — the item itself failed to encode, which is the caller's 422."""
        pool = self.frontend
        if pool is not None:
            try:
                fut = pool.submit(source, key=key)
            except Exception as exc:  # noqa: BLE001 — unavailability
                self._frontend_degrade(exc)
            else:
                try:
                    return fut.result(timeout=REQUEST_TIMEOUT_S)
                except ENCODE_ITEM_ERRORS:
                    raise
                except Exception as exc:  # noqa: BLE001 — pool trouble
                    self._frontend_degrade(exc)
        with self._span("frontend.encode", mode="inline"):
            return encode_source(source, self.vocabs, keep_cpg=False)

    def _frontend_degrade(self, exc: Exception) -> None:
        """Invariant 25: the request proceeds on inline encode; the
        degradation is counted and flight-recorded, never surfaced."""
        self.metrics.inc("frontend_inline_total")
        self.flight.record("frontend.degraded",
                           reason=f"{type(exc).__name__}: {exc}")

    def _cascade_degrade(self, row: dict, exc: Exception) -> None:
        """Invariant 24: tier-2 failure keeps the tier-1 answer. The row is
        marked, the degradation counted and journaled — never a 5xx."""
        self.metrics.inc("cascade_degraded_total")
        row["tier2_degraded"] = True
        self.flight.record("cascade.degraded", function=row.get("function"),
                           reason=f"{type(exc).__name__}: {exc}")


def _make_handler(server: ScoreServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route BaseHTTPServer noise
            logger.debug("http: " + fmt, *args)

        def _send(self, code: int, body, content_type="application/json",
                  extra_headers=None):
            data = (body.encode() if isinstance(body, str)
                    else json.dumps(body).encode())
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            for name, value in (extra_headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                # distinct draining state + 503 once SIGTERM is received:
                # LB health checks key on the status code, so the replica
                # drops out of rotation before the drain completes
                # a readiness gate keys on this body: replica identity, the
                # warm bucket ladder and the content hashes
                draining = server.draining
                eng = server.engine
                self._send(503 if draining else 200,
                           {"status": "draining" if draining else "ok",
                            "draining": draining,
                            "replica_id": server.replica_id,
                            "warm": bool(eng.warm_buckets),
                            "warm_buckets": list(eng.warm_buckets),
                            "vocab_hash": eng.vocab_hash,
                            "model_rev": eng.model_rev,
                            "precision": eng.precision,
                            "n_replicas": eng.n_replicas,
                            "label_style": eng.label_style,
                            "cascade": server.cascade is not None,
                            "tier2_model_rev": (
                                server.cascade.model_rev
                                if server.cascade is not None else None),
                            "frontend": (
                                {"mode": server.frontend.cfg.mode,
                                 "alive": server.frontend.alive}
                                if server.frontend is not None
                                else {"mode": "inline", "alive": True}),
                            # the overload-signal surface: the admission
                            # layer, autoscaler and federation router read
                            # these numbers, and the brownout level is
                            # reported honestly
                            "frontend_queue_wait_p99_ms": (
                                server.metrics.frontend_queue_wait
                                .quantile(0.99)),
                            "admission": server.admission is not None,
                            "brownout_level": (
                                server.brownout.level
                                if server.brownout is not None else 0),
                            "brownout": (
                                server.brownout.level_name
                                if server.brownout is not None
                                else "normal")})
            elif self.path == "/metrics":
                self._send(200, server.metrics.render(server.cache.stats()),
                           content_type="text/plain; version=0.0.4")
            elif self.path == "/slo":
                self._send(200, server.render_slo(),
                           content_type="text/plain; version=0.0.4")
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/score":
                self._send(404, {"error": f"no route {self.path}"})
                return
            t0 = time.perf_counter()
            server.metrics.inc("requests_total")
            server.metrics.inc("inflight")
            try:
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    code, body = 400, {"error": "body is not valid JSON"}
                else:
                    # the backend half of the trace: the router's
                    # traceparent (when forwarded) parents this root span,
                    # so one trace_id covers both processes
                    parent = (parse_traceparent(
                        self.headers.get("traceparent"))
                        if server.tracer is not None else None)
                    with server._span("server.request", parent=parent,
                                      root=True) as sp:
                        code, body = server.handle_score(payload)
                        if sp is not None:
                            sp.attrs["code"] = code
            except Exception as exc:  # noqa: BLE001 — request dies, server not
                code, body = 500, {"error": f"{type(exc).__name__}: {exc}"}
                server.flight.record("handler.crash",
                                     error=f"{type(exc).__name__}: {exc}")
                server.flight.dump("handler_crash")
            finally:
                server.metrics.inc("inflight", -1)
            headers = None
            if code == 429 and isinstance(body, dict) \
                    and "retry_after_s" in body:
                # the shed contract: every 429 carries a Retry-After
                # derived from bucket refill state
                headers = {"Retry-After": str(body["retry_after_s"])}
            self._send(code, body, extra_headers=headers)
            ms = (time.perf_counter() - t0) * 1000.0
            server.metrics.observe_response(code, ms)
            server.flight.record("request", code=code, ms=round(ms, 3))

    return Handler


# ---------------------------------------------------------------------------
# construction + CLI entry


def build_server(cfg: ExperimentConfig, run_dir: Path | None = None,
                 ckpt_dir: Path | None = None,
                 artifact: Path | str | None = None,
                 shard_dir: Path | str | None = None,
                 journal=None, tier2_engine=None,
                 device=None) -> ScoreServer:
    """Wire vocabs + engine + server from a config and either a
    ``train.fit`` run (``run_dir``, whose ``checkpoints/`` it restores, or
    ``ckpt_dir``: :meth:`ScoringEngine.from_checkpoint`) or an exported
    ``artifact`` directory (:meth:`ScoringEngine.from_artifact`), on
    ``device`` (``cuda`` unless the caller names another; without a GPU
    this raises). ``serve.warm_store_dir`` attaches the fleet's warm store.
    With ``serve.cascade.enabled``, ``tier2_engine`` (a
    :class:`~deepdfa_tpu_torch.llm.joint_engine.JointEngine`) is tier 2,
    else one is restored from ``serve.cascade.joint_dir``."""
    from deepdfa_tpu_torch import utils

    if shard_dir is None:
        sample = "_sample" if cfg.data.sample else ""
        shard_dir = utils.processed_dir() / cfg.data.dsname / f"shards{sample}"
    vocabs = load_vocabs(shard_dir)
    if artifact is not None:
        engine = ScoringEngine.from_artifact(artifact, vocabs=vocabs,
                                             device=device)
    else:
        if run_dir is None and ckpt_dir is None:
            raise ValueError("need --run-dir/--ckpt-dir or --artifact")
        engine = ScoringEngine.from_checkpoint(
            cfg, ckpt_dir or Path(run_dir) / "checkpoints", vocabs,
            max_batch=cfg.serve.max_batch, journal=journal, device=device)
    warm_store = None
    if cfg.serve.warm_store_dir:
        from .warmstore import WarmStore

        warm_store = WarmStore(cfg.serve.warm_store_dir)
    return ScoreServer(engine, vocabs, cfg.serve, warm_store=warm_store,
                       journal=journal, tier2_engine=tier2_engine,
                       vocab_source=shard_dir, device=device)


def serve_command(cfg: ExperimentConfig, run_dir: Path | None = None,
                  ckpt_dir: Path | None = None,
                  artifact: Path | str | None = None,
                  shard_dir: Path | str | None = None,
                  journal=None, tier2_engine=None, device=None) -> dict:
    """Foreground service: build, warm, serve until SIGTERM, drain. Prints
    one ``"serving"`` JSON line once the port is bound and one
    ``"drained"`` line at the end."""
    server = build_server(cfg, run_dir=run_dir, ckpt_dir=ckpt_dir,
                          artifact=artifact, shard_dir=shard_dir,
                          journal=journal, tier2_engine=tier2_engine,
                          device=device)
    warmed = server.warmup()
    server.install_signal_handlers()
    server.start()
    print(json.dumps({
        "status": "serving", "host": server.cfg.host, "port": server.port,
        "replica_id": server.replica_id,
        "buckets_warmed": warmed["buckets"],
        "warm_store": {k: warmed[k] for k in
                       ("hits", "misses", "compile_seconds_saved")},
        "label_style": server.engine.label_style,
        "vocab_hash": server.engine.vocab_hash,
        "model_rev": server.engine.model_rev,
        "cascade": ({"band": [cfg.serve.cascade.band_lo,
                              cfg.serve.cascade.band_hi],
                     "tier2_model_rev": server.cascade.model_rev}
                    if server.cascade is not None else None),
    }), flush=True)
    summary = server.wait()
    print(json.dumps({"status": "drained", **{
        k: summary[k] for k in ("requests_total", "batches_total",
                                "mean_batch_occupancy") if k in summary}}),
        flush=True)
    return summary


def main(argv=None) -> dict:
    """``python -m deepdfa_tpu_torch.serve.server``: the JAX package's
    flags (``--artifact`` serves an exported artifact directory instead of
    a checkpoint). ``--device cpu`` serves on the CPU (the card is the
    default)."""
    import argparse

    from deepdfa_tpu_torch.config import load_config

    parser = argparse.ArgumentParser(prog="deepdfa-tpu-torch-serve")
    parser.add_argument("--config", action="append", default=[])
    parser.add_argument("--set", action="append", default=[], dest="overrides",
                        help="dotted overrides, e.g. --set serve.max_batch=32")
    parser.add_argument("--run-dir", default=None)
    parser.add_argument("--ckpt-dir", default=None)
    parser.add_argument("--artifact", default=None,
                        help="exported artifact dir (python -m "
                             "deepdfa_tpu_torch.train.cli export) instead "
                             "of a checkpoint")
    parser.add_argument("--shard-dir", default=None,
                        help="shard dir holding vocab.json (default: the "
                             "config's processed dataset dir)")
    parser.add_argument("--journal", default=None,
                        help="journal file for warmup / int8-gate events")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    layers = list(args.config)
    if args.run_dir and (Path(args.run_dir) / "config.json").exists():
        layers.insert(0, Path(args.run_dir) / "config.json")
    cfg = load_config(*layers, overrides=parse_overrides(args.overrides))
    logging.basicConfig(level=logging.INFO)
    journal = None
    if args.journal:
        from deepdfa_tpu_torch.resilience.journal import RunJournal

        journal = RunJournal(Path(args.journal))
    return serve_command(
        cfg, run_dir=Path(args.run_dir) if args.run_dir else None,
        ckpt_dir=Path(args.ckpt_dir) if args.ckpt_dir else None,
        artifact=args.artifact, shard_dir=args.shard_dir, journal=journal,
        device=args.device)


def parse_overrides(pairs) -> dict:
    """``["a.b=1", "c=x"]`` → ``{"a.b": 1, "c": "x"}``: each value parsed
    as JSON, else kept as a string."""
    out = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        try:
            out[key] = json.loads(value)
        except json.JSONDecodeError:
            out[key] = value
    return out


if __name__ == "__main__":
    main()
