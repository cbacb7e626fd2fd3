"""The telemetry plane: request and step tracing (W3C ``traceparent``,
Chrome trace-event export), the Prometheus-exposition metrics registry, the
score-drift sentinel, the SLO burn-rate engine, the crash flight recorder,
the training telemetry with its scrape endpoint and the perf-regression
ledger. Copies of the JAX package's ``deepdfa_tpu/obs`` modules that the
HTTP service, the fleet router, the federation, the continual loop and the
trainer read."""

from deepdfa_tpu_torch.obs.drift import ScoreDriftSentinel, psi
from deepdfa_tpu_torch.obs.flightrec import FlightRecorder, install_sigusr2
from deepdfa_tpu_torch.obs.ledger import Ledger, LedgerEntry, LedgerStore
from deepdfa_tpu_torch.obs.registry import (Family, MetricsRegistry,
                                            escape_label_value)
from deepdfa_tpu_torch.obs.slo import (SLOEngine, SLOSpec,
                                       federation_specs,
                                       read_promotion_veto, router_specs,
                                       serve_specs, train_specs,
                                       write_alerts_artifact)
from deepdfa_tpu_torch.obs.telemetry import TelemetryServer, TrainTelemetry
from deepdfa_tpu_torch.obs.tracing import (Span, SpanContext, Tracer,
                                           chrome_trace, load_trace_records,
                                           new_span_id, new_trace_id,
                                           parse_traceparent)

__all__ = ["Family", "FlightRecorder", "Ledger", "LedgerEntry",
           "LedgerStore", "MetricsRegistry", "SLOEngine", "SLOSpec",
           "ScoreDriftSentinel", "Span", "SpanContext", "TelemetryServer",
           "Tracer", "TrainTelemetry", "chrome_trace", "escape_label_value",
           "federation_specs",
           "install_sigusr2", "load_trace_records", "new_span_id",
           "new_trace_id", "parse_traceparent", "psi",
           "read_promotion_veto", "router_specs", "serve_specs",
           "train_specs", "write_alerts_artifact"]
