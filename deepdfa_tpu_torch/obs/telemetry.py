"""Training-step timelines: per-step host wall, data-wait and dispatch
accounting, a compile count, MFU against a roofline, an optional trainer
HTTP ``/metrics`` + ``/healthz`` + ``/slo`` endpoint, and per-epoch
journal stats.

A copy of ``deepdfa_tpu/obs/telemetry.py``. :class:`TrainTelemetry` is fed
from inside ``Trainer.train_epoch`` (wait and dispatch wall times measured
around the prefetch iterator and the step call) and renders through the
same :class:`~deepdfa_tpu_torch.obs.registry.MetricsRegistry` as the serve
endpoint. It only reads clocks: it adds no device sync. On the card a
step's dispatch time ends at the in-step guard's host sync, so
``dispatch_s`` is the step's wall time, device work included.

The "compiles" count keeps the JAX package's heuristic: the first step
carrying an unseen batch-shape tuple counts as one (on the card, the first
call at a shape is where the caching allocator grows and the kernels'
first launches at that shape happen; nothing is compiled).

MFU is reported only when the caller gives both a per-step FLOP count and a
roofline (FLOP/s ceiling): no silent guessing.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from deepdfa_tpu_torch.obs.registry import MetricsRegistry
from deepdfa_tpu_torch.obs.tracing import Tracer

__all__ = ["TrainTelemetry", "TelemetryServer"]


class TrainTelemetry:
    """Aggregates per-step timings; thread-safe (the watchdog may drive
    steps from a worker thread)."""

    def __init__(self, tracer: Tracer | None = None,
                 roofline_flops_per_s: float | None = None,
                 slo=None, flight=None):
        self.tracer = tracer if tracer is not None else Tracer(proc="train")
        self.roofline_flops_per_s = roofline_flops_per_s
        # verdict-layer attachments (both optional): the SLO engine backs
        # the /slo endpoint; the flight recorder takes step/fault events
        self.slo = slo
        self.flight = flight
        self._lock = threading.Lock()
        self._shapes: set = set()
        self._started_s = time.time()
        # cumulative (lifetime) and window (since last epoch_stats) tallies
        self._cum = self._zero()
        self._win = self._zero()
        self.epoch = -1
        self.last_step_s = 0.0
        self.last_mfu: float | None = None

    @staticmethod
    def _zero() -> dict:
        return {"steps": 0, "wall_s": 0.0, "data_wait_s": 0.0,
                "dispatch_s": 0.0, "compiles": 0, "flops": 0.0,
                "mfu_sum": 0.0, "mfu_n": 0}

    # -- feed path (inside train_epoch) -------------------------------------

    def observe_step(self, wait_s: float, dispatch_s: float,
                     shape_key=None, flops: float | None = None) -> None:
        wait_s = max(0.0, float(wait_s))
        dispatch_s = max(0.0, float(dispatch_s))
        mfu = None
        if (flops and self.roofline_flops_per_s
                and dispatch_s > 0 and self.roofline_flops_per_s > 0):
            mfu = float(flops) / dispatch_s / self.roofline_flops_per_s
        with self._lock:
            compiled = shape_key is not None and shape_key not in self._shapes
            if compiled:
                self._shapes.add(shape_key)
            for t in (self._cum, self._win):
                t["steps"] += 1
                t["wall_s"] += wait_s + dispatch_s
                t["data_wait_s"] += wait_s
                t["dispatch_s"] += dispatch_s
                t["compiles"] += int(compiled)
                if flops:
                    t["flops"] += float(flops)
                if mfu is not None:
                    t["mfu_sum"] += mfu
                    t["mfu_n"] += 1
            self.last_step_s = wait_s + dispatch_s
            if mfu is not None:
                self.last_mfu = mfu

    def observe_epoch(self, epoch: int) -> None:
        with self._lock:
            self.epoch = int(epoch)

    # -- journal path -------------------------------------------------------

    @staticmethod
    def _stats(t: dict) -> dict:
        steps = t["steps"]
        out = {
            "steps": steps,
            "wall_s": round(t["wall_s"], 6),
            "data_wait_s": round(t["data_wait_s"], 6),
            "dispatch_s": round(t["dispatch_s"], 6),
            "compiles": t["compiles"],
        }
        if steps:
            out["mean_step_ms"] = round(t["wall_s"] / steps * 1e3, 4)
            out["data_wait_frac"] = round(
                t["data_wait_s"] / t["wall_s"], 6) if t["wall_s"] else 0.0
        if t["mfu_n"]:
            out["mfu"] = round(t["mfu_sum"] / t["mfu_n"], 6)
        return out

    def epoch_stats(self) -> dict:
        """Stats for the steps since the previous call (one epoch's worth
        when called from the per-epoch journal write); resets the window."""
        with self._lock:
            win, self._win = self._win, self._zero()
        return self._stats(win)

    def snapshot(self) -> dict:
        with self._lock:
            cum = dict(self._cum)
        out = self._stats(cum)
        out["epoch"] = self.epoch
        out["uptime_s"] = round(time.time() - self._started_s, 3)
        return out

    # -- scrape path --------------------------------------------------------

    def render(self) -> str:
        reg = MetricsRegistry("deepdfa_train_")
        with self._lock:
            cum = dict(self._cum)
            epoch, last_step_s, last_mfu = (
                self.epoch, self.last_step_s, self.last_mfu)
            dropped = self.tracer.dropped_total
        reg.counter("steps_total", "Training steps completed").set(
            cum["steps"])
        reg.counter("compiles_total",
                    "Distinct batch-shape signatures seen (jit compiles)"
                    ).set(cum["compiles"])
        reg.counter("data_wait_seconds_total",
                    "Host seconds spent waiting on the input stream").set(
            round(cum["data_wait_s"], 6))
        reg.counter("dispatch_seconds_total",
                    "Host seconds spent in step dispatch").set(
            round(cum["dispatch_s"], 6))
        reg.gauge("epoch", "Current epoch index").set(epoch)
        reg.gauge("last_step_seconds",
                  "Host wall time of the most recent step").set(
            round(last_step_s, 6))
        if last_mfu is not None:
            reg.gauge("mfu", "Model FLOP utilization of the last measured "
                             "step vs the bench roofline").set(
                round(last_mfu, 6))
        reg.counter("trace_spans_dropped_total",
                    "Spans lost by the trainer tracer (never fatal)").set(
            dropped)
        return reg.render()

    def healthz(self) -> dict:
        snap = self.snapshot()
        return {"ok": True, "role": "trainer", **snap}

    def record_event(self, kind: str, **fields) -> None:
        """Forward one structured event to the flight recorder (a no-op
        without one; never raises — telemetry must not perturb the step
        it annotates)."""
        if self.flight is not None:
            self.flight.record(kind, **fields)

    def render_slo(self) -> str:
        """The trainer's ``/slo`` body. With no engine attached an empty
        one is built on the fly so the endpoint still renders the
        conformant counter families (and the obs_dropped_total account)."""
        if self.slo is None:
            from deepdfa_tpu_torch.obs.slo import SLOEngine

            self.slo = SLOEngine((), flight=self.flight)
        snap = self.snapshot()
        self.slo.observe({"mean_step_ms": snap.get("mean_step_ms"),
                          "mfu": snap.get("mfu")})
        return self.slo.render("deepdfa_train_")


class _TelemetryHandler(BaseHTTPRequestHandler):
    server: "TelemetryServer"

    def log_message(self, fmt, *args):  # quiet — tests run many scrapes
        pass

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        telemetry = self.server.telemetry
        if self.path.startswith("/metrics"):
            self._send(200, telemetry.render().encode(),
                       "text/plain; version=0.0.4")
        elif self.path.startswith("/slo"):
            self._send(200, telemetry.render_slo().encode(),
                       "text/plain; version=0.0.4")
        elif self.path.startswith("/healthz"):
            self._send(200, json.dumps(telemetry.healthz()).encode(),
                       "application/json")
        else:
            self._send(404, b'{"error": "not found"}', "application/json")


class TelemetryServer(ThreadingHTTPServer):
    """Optional trainer-side scrape endpoint (``serve.obs.train_port``;
    -1 disables, 0 binds an ephemeral port). Serves in a daemon thread: a
    hung scrape never blocks training shutdown."""

    daemon_threads = True

    def __init__(self, telemetry: TrainTelemetry, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__((host, port), _TelemetryHandler)
        self.telemetry = telemetry
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> "TelemetryServer":
        self._thread = threading.Thread(
            target=self.serve_forever, name="train-telemetry", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
