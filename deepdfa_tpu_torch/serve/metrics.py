"""Serving metrics: thread-safe counters/gauges + a latency reservoir,
rendered in the Prometheus text exposition format at ``/metrics``.

A copy of ``deepdfa_tpu/serve/metrics.py`` with every family name and
label kept. Stdlib-only, so the serve path grows no dependency: counters
are plain ints under one
lock, latency quantiles come from a bounded ring buffer — O(window) per
scrape, O(1) per request, and immune to unbounded growth on long-lived
servers.
"""

from __future__ import annotations

import threading
from collections import deque

from deepdfa_tpu_torch.obs.registry import MetricsRegistry

__all__ = ["LatencyReservoir", "ServeMetrics"]


class LatencyReservoir:
    """Last-N latency samples (ms); p50/p99 over the window. A sliding
    window — not a lifetime histogram — so quantiles track CURRENT service
    health, which is what an operator paging on p99 wants."""

    def __init__(self, window: int = 2048):
        self._samples: deque[float] = deque(maxlen=max(1, int(window)))
        self._lock = threading.Lock()

    def observe(self, ms: float) -> None:
        with self._lock:
            self._samples.append(float(ms))

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile over the window; None when empty."""
        with self._lock:
            data = sorted(self._samples)
        if not data:
            return None
        idx = min(len(data) - 1, max(0, round(q * (len(data) - 1))))
        return data[idx]


class ServeMetrics:
    """The server's one metrics registry. Counter semantics:

    - ``requests_total`` — every ``/score`` request received;
    - ``responses_total[code]`` — responses by HTTP status;
    - ``dropped_total`` — requests rejected by admission control or the
      ``serve.drop_request`` fault point;
    - ``errors_total`` — 4xx/5xx responses (a subset view of responses);
    - ``batches_total`` / ``batch_graphs_total`` / ``occupancy_sum`` —
      dispatched micro-batches, real graphs in them, and the per-batch
      occupancy sum (real graphs ÷ bucket graph capacity), so
      ``occupancy_sum / batches_total`` is the mean batch occupancy;
    - ``queue_depth`` — gauge, requests waiting in the micro-batch queue;
    - ``inflight`` — gauge, ``/score`` requests currently being handled;
    - ``padding_efficiency[bucket, axis]`` — gauge, the cumulative real ÷
      padded fraction per serving bucket and axis (nodes/edges/graphs):
      the fraction of each dispatched shape's budget occupied by real
      entries, i.e. the direct multiplier on useful FLOPs per dispatch.

    Cache hit/miss counters live on the cache itself (:mod:`.cache`) and
    are merged into the rendering by the server.
    """

    def __init__(self, latency_window: int = 2048):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.responses_total: dict[int, int] = {}
        self.errors_total = 0
        self.dropped_total = 0
        self.batches_total = 0
        self.batch_graphs_total = 0
        self.occupancy_sum = 0.0
        self.queue_depth = 0
        self.inflight = 0
        # per-bucket padding accumulators: {bucket: {axis: [real, padded]}}
        # — cumulative, so the exported gauge is the lifetime efficiency
        # (stable under scrape timing, unlike a last-batch snapshot)
        self.padding: dict[str, dict[str, list[float]]] = {}
        self.latency = LatencyReservoir(latency_window)
        # stage-level reservoirs fed by the tracing instrumentation: time a
        # graph sat in the micro-batch queue, and time one engine dispatch
        # took — the split that locates a slow /score
        self.queue_wait = LatencyReservoir(latency_window)
        self.dispatch = LatencyReservoir(latency_window)
        # cascade (serve/cascade.py): escalation counters + per-tier latency
        # reservoirs. answered counts key on the tier that produced the
        # served score; degraded = tier-2 failures converted to tier-1
        # answers (invariant 24 — they are NOT errors)
        self.cascade_escalated_total = 0
        self.cascade_degraded_total = 0
        self.cascade_answered: dict[int, int] = {}
        self.tier2_queue_depth = 0
        self.tier1_latency = LatencyReservoir(latency_window)
        self.tier2_latency = LatencyReservoir(latency_window)
        self.tier2_queue_wait = LatencyReservoir(latency_window)
        self.tier2_dispatch = LatencyReservoir(latency_window)
        # frontend encode pool (serve/frontend.py): queue-depth gauge,
        # degraded-to-inline counter (pool unavailable → inline encode,
        # invariant 25 — NOT an error), and the encode / queue-wait
        # reservoirs behind the /metrics p50-p99 gauges
        self.frontend_queue_depth = 0
        self.frontend_inline_total = 0
        self.frontend_encode = LatencyReservoir(latency_window)
        self.frontend_queue_wait = LatencyReservoir(latency_window)
        # admission control + brownout (serve/admission.py): per-class
        # admitted/shed counters (a shed is a 429 with a deterministic
        # Retry-After — invariant candidate 30, NOT an error), the current
        # brownout degradation level, its lifetime transition count, and
        # the cascade escalations suppressed at brownout level >= 2
        self.admission_admitted: dict[str, int] = {}
        self.admission_shed: dict[str, int] = {}
        self.brownout_level = 0
        self.brownout_transitions_total = 0
        self.brownout_suppressed_escalations_total = 0
        self.warmup: dict | None = None  # last engine warmup report
        # attachment points set by the server: the request tracer and the
        # score-drift sentinel both render through /metrics when present;
        # the flight recorder gets every assembled batch's shape
        self.tracer = None
        self.drift = None
        self.flight = None

    def set_warmup(self, report: dict) -> None:
        """Publish an engine warmup report (warm-store hits and misses, and
        per-bucket seconds of the first call or of the store's load) for
        /metrics scrapes."""
        with self._lock:
            self.warmup = dict(report)

    def inc(self, name: str, by: float = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + by)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            setattr(self, name, value)

    def observe_response(self, code: int, latency_ms: float) -> None:
        with self._lock:
            self.responses_total[code] = self.responses_total.get(code, 0) + 1
            if code >= 400:
                self.errors_total += 1
        self.latency.observe(latency_ms)

    def observe_answered(self, tier: int) -> None:
        """One served /score row attributed to the tier that scored it."""
        with self._lock:
            self.cascade_answered[tier] = self.cascade_answered.get(tier, 0) + 1

    def observe_admission(self, klass: str, admitted: bool) -> None:
        """One admission decision for priority class ``klass``."""
        with self._lock:
            table = self.admission_admitted if admitted else self.admission_shed
            table[klass] = table.get(klass, 0) + 1

    def observe_batch(self, n_real: int, capacity: int) -> None:
        with self._lock:
            self.batches_total += 1
            self.batch_graphs_total += n_real
            self.occupancy_sum += n_real / max(capacity, 1)
        if self.flight is not None:  # record() never raises (invariant 14)
            self.flight.record("batch", n_real=n_real, capacity=capacity)

    def observe_padding(self, bucket, real: dict, padded: dict) -> None:
        """Accumulate one dispatched batch's real vs padded counts per
        axis (``nodes``/``edges``/``graphs``) under the bucket's label."""
        with self._lock:
            acc = self.padding.setdefault(
                str(bucket), {ax: [0.0, 0.0] for ax in real})
            for ax, n in real.items():
                acc[ax][0] += float(n)
                acc[ax][1] += float(padded[ax])

    def padding_efficiency(self) -> dict[str, dict[str, float]]:
        """Cumulative real ÷ padded per bucket per axis."""
        with self._lock:
            return {bucket: {ax: (r / p if p else 0.0)
                             for ax, (r, p) in acc.items()}
                    for bucket, acc in self.padding.items()}

    def mean_batch_occupancy(self) -> float | None:
        with self._lock:
            if not self.batches_total:
                return None
            return self.occupancy_sum / self.batches_total

    def snapshot(self) -> dict:
        """Point-in-time copy for JSON consumers."""
        with self._lock:
            snap = {
                "requests_total": self.requests_total,
                "responses_total": dict(self.responses_total),
                "errors_total": self.errors_total,
                "dropped_total": self.dropped_total,
                "batches_total": self.batches_total,
                "batch_graphs_total": self.batch_graphs_total,
                "occupancy_sum": self.occupancy_sum,
                "queue_depth": self.queue_depth,
                "inflight": self.inflight,
                "warmup": dict(self.warmup) if self.warmup else None,
                "cascade_escalated_total": self.cascade_escalated_total,
                "cascade_degraded_total": self.cascade_degraded_total,
                "cascade_answered": dict(self.cascade_answered),
                "tier2_queue_depth": self.tier2_queue_depth,
                "frontend_queue_depth": self.frontend_queue_depth,
                "frontend_inline_total": self.frontend_inline_total,
                "admission_admitted": dict(self.admission_admitted),
                "admission_shed": dict(self.admission_shed),
                "brownout_level": self.brownout_level,
                "brownout_transitions_total": self.brownout_transitions_total,
                "brownout_suppressed_escalations_total":
                    self.brownout_suppressed_escalations_total,
            }
        snap["padding_efficiency"] = self.padding_efficiency()
        snap["mean_batch_occupancy"] = (
            snap["occupancy_sum"] / snap["batches_total"]
            if snap["batches_total"] else None)
        snap["latency_p50_ms"] = self.latency.quantile(0.50)
        snap["latency_p99_ms"] = self.latency.quantile(0.99)
        snap["queue_wait_p50_ms"] = self.queue_wait.quantile(0.50)
        snap["queue_wait_p99_ms"] = self.queue_wait.quantile(0.99)
        snap["dispatch_p50_ms"] = self.dispatch.quantile(0.50)
        snap["dispatch_p99_ms"] = self.dispatch.quantile(0.99)
        snap["tier1_latency_p50_ms"] = self.tier1_latency.quantile(0.50)
        snap["tier1_latency_p99_ms"] = self.tier1_latency.quantile(0.99)
        snap["tier2_latency_p50_ms"] = self.tier2_latency.quantile(0.50)
        snap["tier2_latency_p99_ms"] = self.tier2_latency.quantile(0.99)
        snap["tier2_queue_wait_p99_ms"] = self.tier2_queue_wait.quantile(0.99)
        snap["tier2_dispatch_p99_ms"] = self.tier2_dispatch.quantile(0.99)
        snap["frontend_encode_p50_ms"] = self.frontend_encode.quantile(0.50)
        snap["frontend_encode_p99_ms"] = self.frontend_encode.quantile(0.99)
        snap["frontend_queue_wait_p50_ms"] = (
            self.frontend_queue_wait.quantile(0.50))
        snap["frontend_queue_wait_p99_ms"] = (
            self.frontend_queue_wait.quantile(0.99))
        return snap

    def render(self, cache_stats: dict | None = None) -> str:
        """Prometheus text format via the shared registry: one ``# HELP``
        + one ``# TYPE`` per family (the seed's hand-rolled formatter
        repeated ``# TYPE`` before every labeled sample)."""
        snap = self.snapshot()
        reg = MetricsRegistry("deepdfa_serve_")
        reg.counter("requests_total",
                    "Every /score request received").set(
            snap["requests_total"])
        responses = reg.counter("responses_total",
                                "Responses by HTTP status", labels=("code",))
        for code, n in snap["responses_total"].items():
            responses.set(n, code=code)
        reg.counter("errors_total", "4xx/5xx responses").set(
            snap["errors_total"])
        reg.counter("dropped_total",
                    "Requests rejected by admission control").set(
            snap["dropped_total"])
        reg.counter("batches_total", "Dispatched micro-batches").set(
            snap["batches_total"])
        reg.counter("batch_graphs_total",
                    "Real graphs in dispatched batches").set(
            snap["batch_graphs_total"])
        reg.gauge("batch_occupancy_mean",
                  "Mean real-graphs / bucket-capacity per batch").set(
            snap["mean_batch_occupancy"])
        reg.gauge("queue_depth",
                  "Requests waiting in the micro-batch queue").set(
            snap["queue_depth"])
        reg.gauge("inflight", "/score requests currently in flight").set(
            snap["inflight"])
        if snap["padding_efficiency"]:
            pad = reg.gauge(
                "padding_efficiency",
                "Cumulative real / padded fraction of dispatched batch "
                "budgets per bucket (axis: nodes, edges, graphs)",
                labels=("bucket", "axis"))
            for bucket, axes in snap["padding_efficiency"].items():
                for axis, value in axes.items():
                    pad.set(value, bucket=bucket, axis=axis)
        reg.counter("cascade_escalated_total",
                    "Borderline tier-1 scores escalated to tier 2").set(
            snap["cascade_escalated_total"])
        reg.counter("cascade_degraded_total",
                    "Escalations degraded back to the tier-1 answer "
                    "(queue full / deadline blown / tier-2 failure — "
                    "invariant 24, never a 5xx)").set(
            snap["cascade_degraded_total"])
        answered = reg.counter("cascade_answered_total",
                               "Served /score rows by answering tier",
                               labels=("tier",))
        for tier, n in snap["cascade_answered"].items():
            answered.set(n, tier=tier)
        reg.gauge("tier2_queue_depth",
                  "Escalations waiting in the tier-2 queue").set(
            snap["tier2_queue_depth"])
        reg.gauge("frontend_queue_depth",
                  "Sources waiting in the frontend encode queue").set(
            snap["frontend_queue_depth"])
        reg.counter("frontend_inline_total",
                    "Cold requests encoded inline because the frontend "
                    "pool was unavailable (degrade-to-inline, invariant "
                    "25 — never a 5xx)").set(
            snap["frontend_inline_total"])
        admitted = reg.counter("admission_admitted_total",
                               "Requests admitted past admission control, "
                               "by priority class", labels=("class",))
        for klass, n in snap["admission_admitted"].items():
            admitted.set(n, **{"class": klass})
        shed = reg.counter("admission_shed_total",
                           "Requests shed by admission control (429 + "
                           "deterministic Retry-After, never a 5xx), "
                           "by priority class", labels=("class",))
        for klass, n in snap["admission_shed"].items():
            shed.set(n, **{"class": klass})
        reg.gauge("brownout_level",
                  "Current brownout degradation level (0 normal, 1 shed "
                  "batch, 2 + cache hits + tier-1 only, 3 + shed "
                  "interactive)").set(snap["brownout_level"])
        reg.counter("brownout_transitions_total",
                    "Brownout level transitions (each one journaled as a "
                    "brownout_transition event)").set(
            snap["brownout_transitions_total"])
        reg.counter("brownout_suppressed_escalations_total",
                    "Cascade escalations suppressed at brownout level >= 2 "
                    "(tier-1 only — the tier-1 answer is still served)").set(
            snap["brownout_suppressed_escalations_total"])
        for family, help_, reservoir in (
                ("latency_ms", "End-to-end /score latency", self.latency),
                ("queue_wait_ms", "Time a graph waited in the micro-batch "
                                  "queue", self.queue_wait),
                ("dispatch_ms", "Engine dispatch wall time per batch",
                 self.dispatch),
                ("tier1_latency_ms", "Tier-1 (GGNN) per-row score latency",
                 self.tier1_latency),
                ("tier2_latency_ms", "Tier-2 escalate-to-answer latency",
                 self.tier2_latency),
                ("tier2_queue_wait_ms", "Time an escalation waited in the "
                                        "tier-2 queue", self.tier2_queue_wait),
                ("tier2_dispatch_ms", "Joint-engine dispatch wall time per "
                                      "tier-2 window", self.tier2_dispatch),
                ("frontend_encode_ms", "Frontend pool encode wall time per "
                                       "source", self.frontend_encode),
                ("frontend_queue_wait_ms", "Time a source waited in the "
                                           "frontend encode queue",
                 self.frontend_queue_wait)):
            fam = reg.gauge(family, f"{help_} (windowed quantiles)",
                            labels=("quantile",))
            for q in (0.50, 0.99):
                fam.set(reservoir.quantile(q), quantile=q)
        warm = snap.get("warmup")
        if warm:
            reg.counter("warm_store_hits_total",
                        "Warm-store program hits at warmup").set(
                warm.get("hits"))
            reg.counter("warm_store_misses_total",
                        "Warm-store misses at warmup").set(warm.get("misses"))
            reg.gauge("warm_store_compile_seconds_saved",
                      "Compile seconds skipped via warm-store hits").set(
                warm.get("compile_seconds_saved"))
            compile_s = reg.gauge("warmup_compile_seconds",
                                  "Per-bucket warmup compile seconds",
                                  labels=("bucket", "source"))
            for bucket, row in (warm.get("per_bucket") or {}).items():
                compile_s.set(row.get("compile_seconds"), bucket=bucket,
                              source=row.get("source"))
        if cache_stats:
            reg.counter("cache_hits_total", "Scan-cache result hits").set(
                cache_stats.get("hits"))
            reg.counter("cache_encode_hits_total",
                        "Scan-cache encoded-graph hits").set(
                cache_stats.get("encode_hits"))
            reg.counter("cache_misses_total", "Scan-cache misses").set(
                cache_stats.get("misses"))
            reg.counter("cache_evictions_total", "Scan-cache evictions").set(
                cache_stats.get("evictions"))
            reg.gauge("cache_entries", "Scan-cache entries").set(
                cache_stats.get("entries"))
            reg.gauge("cache_hit_rate", "Scan-cache hit rate").set(
                cache_stats.get("hit_rate"))
        tracer = self.tracer
        if tracer is not None:
            reg.counter("trace_spans_total",
                        "Spans recorded by this replica's tracer").set(
                tracer.recorded_total)
            reg.counter("trace_spans_dropped_total",
                        "Spans lost at export (never fatal)").set(
                tracer.dropped_total)
        drift = self.drift
        if drift is not None:
            psi_g = reg.gauge("score_drift",
                              "PSI of the sliding score window vs the "
                              "model rev's reference window",
                              labels=("model_rev",))
            alert_g = reg.gauge("score_drift_alert",
                                "1 when score_drift crossed the configured "
                                "threshold", labels=("model_rev",))
            hist = reg.histogram(
                "score", "Current-window score distribution",
                buckets=[round((i + 1) / drift.bins, 6)
                         for i in range(drift.bins)],
                labels=("model_rev",))
            for rev, row in drift.snapshot().items():
                psi_g.set(row["psi"], model_rev=rev)
                alert_g.set(int(row["alert"]), model_rev=rev)
                hist.set_histogram(row["current_counts"], row["current_sum"],
                                   row["current_n"], model_rev=rev)
            reg.counter("score_drift_evicted_revs_total",
                        "model_revs LRU-evicted from the drift sentinel "
                        "(bounded /metrics cardinality)").set(
                drift.evicted_revs_total)
        flight = self.flight
        if flight is not None:
            reg.counter(
                "obs_dropped_total",
                "Flight-recorder events dropped instead of failing the "
                "request they annotate (invariant 14)").set(
                flight.dropped_total)
        return reg.render()
