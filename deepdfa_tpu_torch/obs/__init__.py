"""The telemetry plane: request and step tracing (W3C ``traceparent``,
Chrome trace-event export), the Prometheus-exposition metrics registry, the
score-drift sentinel, the SLO burn-rate engine, the crash flight recorder
and the training telemetry with its scrape endpoint. Copies of the JAX
package's ``deepdfa_tpu/obs`` modules that the HTTP service and the trainer
read; the perf ledger waits for ROADMAP A13."""

from deepdfa_tpu_torch.obs.drift import ScoreDriftSentinel, psi
from deepdfa_tpu_torch.obs.flightrec import FlightRecorder, install_sigusr2
from deepdfa_tpu_torch.obs.registry import (Family, MetricsRegistry,
                                            escape_label_value)
from deepdfa_tpu_torch.obs.slo import (SLOEngine, SLOSpec, serve_specs,
                                       train_specs, write_alerts_artifact)
from deepdfa_tpu_torch.obs.telemetry import TelemetryServer, TrainTelemetry
from deepdfa_tpu_torch.obs.tracing import (Span, SpanContext, Tracer,
                                           chrome_trace, load_trace_records,
                                           new_span_id, new_trace_id,
                                           parse_traceparent)

__all__ = ["Family", "FlightRecorder", "MetricsRegistry", "SLOEngine",
           "SLOSpec", "ScoreDriftSentinel", "Span", "SpanContext",
           "TelemetryServer", "Tracer", "TrainTelemetry", "chrome_trace",
           "escape_label_value", "install_sigusr2", "load_trace_records",
           "new_span_id", "new_trace_id", "parse_traceparent", "psi",
           "serve_specs", "train_specs", "write_alerts_artifact"]
