"""Shared-nothing fleet router: consistent-hash ``source_key`` sharding.

A copy of ``deepdfa_tpu/serve/router.py`` (host only: no model, no
kernel). One :class:`~deepdfa_tpu_torch.serve.server.ScoreServer` owns one
in-process :class:`~deepdfa_tpu_torch.serve.cache.ScanCache`. Behind a
round-robin balancer every replica would re-scan (and re-cache) the same
sources. The router routes each request by the content address the cache
keys on (``pipeline.source_key``, sha256 of the whitespace-normalized
source), so each source lands on exactly one backend and the fleet's cache
is the union of N disjoint shards.

Routing is a consistent-hash ring (``vnodes`` points per backend from
sha256, binary-searched, exactly as the JAX package hashes, so both
packages route a key to the same node): a backend joining or leaving
remaps only ~1/N of the keyspace.

Backend lifecycle:

- **readiness-gated registration**: a backend enters the ring only after
  a ``/healthz`` 200 whose body says the bucket ladder is warm; a replica
  still compiling takes no traffic;
- **health probes**: a background thread re-probes every backend on an
  interval; a connection failure or 5xx takes it out of the ring (state
  ``down``) until it probes healthy again;
- **drain-aware rebalancing**: a backend answering 503/``draining`` (its
  SIGTERM flag) leaves the ring at once; its keyspace slides to ring
  neighbours while in-flight requests finish. The router's own SIGTERM
  sets the same flag-only drain: ``/healthz`` goes 503, new scores get
  503, in-flight forwards complete.

Per-request failover: a forward that fails at the socket marks the backend
down and retries the next ring node (bounded by the live backend count),
so one crashed replica costs its cache shard, not its keyspace's
availability. ``python -m deepdfa_tpu_torch.serve.router --backend
HOST:PORT ...`` runs it on its own (one ``routing`` JSON line, SIGTERM
drains).
"""

from __future__ import annotations

import bisect
import hashlib
import http.client
import json
import logging
import signal
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from deepdfa_tpu_torch.config import ObsConfig
from deepdfa_tpu_torch.obs import (MetricsRegistry, SLOEngine, Tracer,
                                   parse_traceparent, router_specs)
from deepdfa_tpu_torch.pipeline import source_key

from .metrics import LatencyReservoir

__all__ = ["HashRing", "Backend", "RouterMetrics", "FleetRouter", "main"]

logger = logging.getLogger(__name__)

DEFAULT_VNODES = 64
FORWARD_TIMEOUT_S = 90.0  # one backend round-trip (covers a cold compile)


class _HTTPServer(ThreadingHTTPServer):
    """One thread per connection, with the port's server's listen backlog
    of 128 (socketserver's 5 resets or delays a burst of concurrently
    connecting clients)."""

    daemon_threads = True
    request_queue_size = 128


def _ring_hash(token: str) -> int:
    return int.from_bytes(hashlib.sha256(token.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring with virtual nodes. ``route(key)`` walks
    clockwise from the key's point to the first live node; ``exclude``
    keeps walking past named nodes (per-request failover)."""

    def __init__(self, vnodes: int = DEFAULT_VNODES):
        self.vnodes = int(vnodes)
        self._points: list[int] = []     # sorted ring positions
        self._owners: list[str] = []     # node name at each position
        self._nodes: set[str] = set()
        self._lock = threading.Lock()

    @property
    def nodes(self) -> set[str]:
        with self._lock:
            return set(self._nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    def add(self, name: str) -> None:
        with self._lock:
            if name in self._nodes:
                return
            self._nodes.add(name)
            for i in range(self.vnodes):
                pt = _ring_hash(f"{name}#{i}")
                idx = bisect.bisect(self._points, pt)
                self._points.insert(idx, pt)
                self._owners.insert(idx, name)

    def remove(self, name: str) -> None:
        with self._lock:
            if name not in self._nodes:
                return
            self._nodes.discard(name)
            keep = [(p, o) for p, o in zip(self._points, self._owners)
                    if o != name]
            self._points = [p for p, _ in keep]
            self._owners = [o for _, o in keep]

    def route(self, key: str, exclude=frozenset()) -> str | None:
        """Owner of ``key``, skipping ``exclude``; None when no eligible
        node remains."""
        with self._lock:
            if not self._points:
                return None
            candidates = self._nodes - set(exclude)
            if not candidates:
                return None
            start = bisect.bisect(self._points, _ring_hash(key))
            n = len(self._points)
            for step in range(n):
                owner = self._owners[(start + step) % n]
                if owner in candidates:
                    return owner
            return None


@dataclass
class Backend:
    """One ScoreServer the router fronts. ``state`` transitions:
    pending → ready (first warm healthz 200) → draining/down → ready."""

    name: str                     # "host:port" — also the ring node name
    host: str
    port: int
    state: str = "pending"
    health: dict = field(default_factory=dict)  # last healthz body
    forwarded: int = 0
    failures: int = 0

    @classmethod
    def parse(cls, spec: str) -> "Backend":
        host, _, port = spec.rpartition(":")
        return cls(name=spec, host=host or "127.0.0.1", port=int(port))


class RouterMetrics:
    """Router-side counters; rendered as ``deepdfa_router_*``."""

    def __init__(self, latency_window: int = 2048):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.forwarded_total: dict[str, int] = {}
        self.retries_total = 0
        self.no_backend_total = 0
        self.errors_total = 0
        self.latency = LatencyReservoir(latency_window)
        self.tracer = None  # attachment point set by the router

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + by)

    def observe_forward(self, backend: str) -> None:
        with self._lock:
            self.forwarded_total[backend] = (
                self.forwarded_total.get(backend, 0) + 1)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests_total": self.requests_total,
                "forwarded_total": dict(self.forwarded_total),
                "retries_total": self.retries_total,
                "no_backend_total": self.no_backend_total,
                "errors_total": self.errors_total,
                "latency_p50_ms": self.latency.quantile(0.50),
                "latency_p99_ms": self.latency.quantile(0.99),
            }

    def render(self) -> str:
        """Prometheus text via the shared registry (one ``# HELP`` +
        ``# TYPE`` per family, same renderer as serve + train)."""
        snap = self.snapshot()
        reg = MetricsRegistry("deepdfa_router_")
        reg.counter("requests_total", "Every /score the router received").set(
            snap["requests_total"])
        fwd = reg.counter("forwarded_total", "Forwards by backend",
                          labels=("backend",))
        for name, n in snap["forwarded_total"].items():
            fwd.set(n, backend=name)
        reg.counter("retries_total",
                    "Per-request failovers past a dead backend").set(
            snap["retries_total"])
        reg.counter("no_backend_total",
                    "Requests with no ready backend").set(
            snap["no_backend_total"])
        reg.counter("errors_total", "4xx/5xx responses").set(
            snap["errors_total"])
        lat = reg.gauge("latency_ms",
                        "Router round-trip latency (windowed quantiles)",
                        labels=("quantile",))
        for q in (0.50, 0.99):
            lat.set(self.latency.quantile(q), quantile=q)
        tracer = self.tracer
        if tracer is not None:
            reg.counter("trace_spans_total",
                        "Spans recorded by the router tracer").set(
                tracer.recorded_total)
            reg.counter("trace_spans_dropped_total",
                        "Spans lost at export (never fatal)").set(
                tracer.dropped_total)
        return reg.render()


class FleetRouter:
    """The fleet's one client-facing surface.

    ``POST /score`` computes the body's ``source_key``, routes it on the
    ring, and proxies the backend's response verbatim (plus an
    ``X-DeepDFA-Backend`` header naming the shard). ``GET /healthz``
    reports the router + per-backend states; ``GET /metrics`` the
    ``deepdfa_router_*`` counters."""

    def __init__(self, backends, host: str = "127.0.0.1", port: int = 0,
                 vnodes: int = DEFAULT_VNODES,
                 probe_interval_s: float = 2.0,
                 metrics: RouterMetrics | None = None,
                 obs: ObsConfig | None = None,
                 allow_empty: bool = False):
        # membership is dynamic (the autoscaler adds/removes ring members
        # over /admin/backends at runtime), so every read of the table
        # snapshots under this lock
        self._backends_lock = threading.Lock()
        self.backends: dict[str, Backend] = {}
        for spec in backends:
            b = spec if isinstance(spec, Backend) else Backend.parse(str(spec))
            self.backends[b.name] = b
        if not self.backends and not allow_empty:
            raise ValueError("router needs at least one backend")
        self.ring = HashRing(vnodes)
        self.metrics = metrics or RouterMetrics()
        obs = obs or ObsConfig()
        self.tracer = Tracer(
            proc="router", max_spans=obs.trace_buffer,
            slow_ms=(obs.slow_trace_ms
                     if obs.slow_trace_ms and obs.slow_trace_ms > 0
                     else None),
            exemplar_dir=obs.trace_dir, max_exemplars=obs.max_exemplars,
        ) if obs.trace else None
        self.metrics.tracer = self.tracer
        # the router's verdict layer: availability + p99 SLOs judged from
        # its own snapshot at /slo scrape time (invariant 16: same
        # registry renderer as every other endpoint)
        self.slo = SLOEngine(
            router_specs(availability=obs.slo_availability,
                         p99_ms=obs.slo_p99_ms),
            fast_window_s=obs.slo_fast_window_s,
            slow_window_s=obs.slo_slow_window_s,
            burn_threshold=obs.slo_burn_threshold)
        self.probe_interval_s = float(probe_interval_s)
        self._draining = threading.Event()
        self._stop_requested = threading.Event()
        self._probe_thread: threading.Thread | None = None
        self.httpd = _HTTPServer((host, port), _make_handler(self))
        self._serve_thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def draining(self) -> bool:
        return self._draining.is_set() or self._stop_requested.is_set()

    def start(self, probe: bool = True) -> "FleetRouter":
        if probe:
            self.probe_once()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="router-probe", daemon=True)
            self._probe_thread.start()
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="router-http", daemon=True)
        self._serve_thread.start()
        logger.info("routing on :%s over %d backend(s), %d ready",
                    self.port, len(self._backend_list()), len(self.ring))
        return self

    def install_signal_handlers(self) -> None:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: self._stop_requested.set())

    def wait(self) -> dict:
        while not self._stop_requested.wait(timeout=0.2):
            pass
        return self.shutdown()

    def request_stop(self) -> None:
        self._stop_requested.set()

    def request_drain(self) -> None:
        """Flag-only cell-level drain (invariant 6 one level up): new
        ``/score``s get 503, ``/healthz`` goes 503/``draining`` so the
        federation drops this cell from its ring, in-flight forwards
        finish. The process keeps serving — ``clear_drain`` reverses it."""
        self._draining.set()

    def clear_drain(self) -> None:
        """Reverse a flag-only drain: the next federation probe finds the
        cell healthy again and readmits it (readiness-gated, invariant
        13). A SIGTERM-initiated stop is NOT reversible."""
        self._draining.clear()

    def shutdown(self) -> dict:
        self._draining.set()
        self._stop_requested.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        return self.metrics.snapshot()

    def render_slo(self) -> str:
        """The ``/slo`` body: the router's snapshot is already flat
        (errors_total / requests_total / latency_p99_ms), so it feeds
        the engine directly. Never fails the scrape (invariant 14)."""
        self.slo.observe(self.metrics.snapshot())
        return self.slo.render("deepdfa_router_")

    # -- dynamic membership (the autoscaler's actuation surface) ------------

    def add_backend(self, spec) -> Backend:
        """Register a backend at runtime. It enters as ``pending`` and
        joins the ring only after the next probe finds it warm — the same
        readiness gate as construction-time members (invariant 13), so the
        autoscaler can never admit a cold replica by registering early."""
        b = spec if isinstance(spec, Backend) else Backend.parse(str(spec))
        with self._backends_lock:
            existing = self.backends.get(b.name)
            if existing is not None:
                return existing
            self.backends[b.name] = b
        self._probe_backend(b)
        logger.info("backend %s registered (state %s)", b.name, b.state)
        return b

    def remove_backend(self, name: str) -> bool:
        """Deregister a backend: out of the ring immediately (its keyspace
        slides to ring neighbours), out of the table. The caller owns the
        replica's drain — the router never signals processes."""
        with self._backends_lock:
            b = self.backends.pop(name, None)
        if b is None:
            return False
        self.ring.remove(name)
        logger.info("backend %s deregistered", name)
        return True

    def _backend_list(self) -> list[Backend]:
        with self._backends_lock:
            return list(self.backends.values())

    def _get_backend(self, name: str) -> Backend | None:
        with self._backends_lock:
            return self.backends.get(name)

    # -- backend health -----------------------------------------------------

    def _probe_backend(self, b: Backend) -> None:
        try:
            conn = http.client.HTTPConnection(b.host, b.port, timeout=5.0)
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                body = json.loads(resp.read() or b"{}")
            finally:
                conn.close()
        except (OSError, json.JSONDecodeError) as exc:
            self._mark(b, "down", {"error": f"{type(exc).__name__}: {exc}"})
            return
        if resp.status == 200 and not body.get("draining"):
            # readiness gate: only a WARM replica joins the ring — a
            # compiling one would stall its whole keyspace
            if body.get("warm", True):
                self._mark(b, "ready", body)
            else:
                self._mark(b, "pending", body)
        elif body.get("draining"):
            self._mark(b, "draining", body)
        else:
            self._mark(b, "down", body)

    def _mark(self, b: Backend, state: str, health: dict) -> None:
        prev = b.state
        b.state = state
        b.health = health
        if state == "ready":
            self.ring.add(b.name)
        else:
            self.ring.remove(b.name)
        if state != prev:
            logger.info("backend %s: %s -> %s", b.name, prev, state)

    def probe_once(self) -> dict:
        """Probe every backend once; returns ``{name: state}``."""
        snapshot = self._backend_list()
        for b in snapshot:
            self._probe_backend(b)
        return {b.name: b.state for b in snapshot}

    def _probe_loop(self) -> None:
        while not self._stop_requested.wait(timeout=self.probe_interval_s):
            self.probe_once()

    # -- request path -------------------------------------------------------

    def _span(self, name: str, parent=None, root: bool = False, **attrs):
        if self.tracer is None:
            return nullcontext()
        return self.tracer.span(name, parent=parent, root=root, **attrs)

    def handle_score(self, raw: bytes) -> tuple[int, dict, dict]:
        """Route + forward one ``/score`` body. Returns
        ``(status, body, extra_headers)``."""
        if self.draining:
            return 503, {"error": "router is draining"}, {}
        try:
            payload = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            return 400, {"error": "body is not valid JSON"}, {}
        source = payload.get("source") if isinstance(payload, dict) else None
        if not isinstance(source, str) or not source.strip():
            return 400, {"error": "body must be JSON with a 'source' string"}, {}
        with self._span("router.route") as sp:
            key = source_key(source)
            if sp is not None:
                sp.attrs["key"] = key[:16]

        tried: set[str] = set()
        max_hops = max(1, len(self.ring))
        for _ in range(max_hops):
            name = self.ring.route(key, exclude=tried)
            if name is None:
                break
            b = self._get_backend(name)
            if b is None:  # deregistered between route and lookup
                self.ring.remove(name)
                tried.add(name)
                continue
            try:
                # the forward span's context rides the hop as the
                # traceparent header: the backend's server.request span
                # parents itself under it, one trace across both procs
                with self._span("router.forward", backend=name) as sp:
                    status, body = self._forward(
                        b, raw, ctx=None if sp is None else sp.ctx)
                    if sp is not None:
                        sp.attrs["code"] = status
            except OSError as exc:
                tried.add(name)
                b.failures += 1
                self._mark(b, "down",
                           {"error": f"{type(exc).__name__}: {exc}"})
                self.metrics.inc("retries_total")
                logger.warning("forward to %s failed (%s) — failing over",
                               name, type(exc).__name__)
                continue
            if status == 503 and "draining" in str(
                    (body or {}).get("error", "")):
                # stale ring: the backend started draining between route
                # and forward. Scoring is idempotent, so the request
                # fails over; only the probe-confirmed drain is terminal.
                tried.add(name)
                self._mark(b, "draining", {"error": body.get("error")})
                self.metrics.inc("retries_total")
                logger.info("backend %s draining — failing over", name)
                continue
            b.forwarded += 1
            self.metrics.observe_forward(name)
            extra = {"X-DeepDFA-Backend": name}
            if status == 429 and isinstance(body, dict) \
                    and body.get("retry_after_s") is not None:
                # a shed's deterministic Retry-After survives the proxy —
                # the federation (and any client) reads the header, not
                # the body (invariant 30)
                extra["Retry-After"] = str(int(body["retry_after_s"]))
            return status, body, extra
        self.metrics.inc("no_backend_total")
        return 503, {"error": "no ready backend for this key"}, {}

    def _forward(self, b: Backend, raw: bytes,
                 ctx=None) -> tuple[int, dict]:
        headers = {"Content-Type": "application/json"}
        if ctx is not None:
            headers["traceparent"] = ctx.traceparent()
        conn = http.client.HTTPConnection(b.host, b.port,
                                          timeout=FORWARD_TIMEOUT_S)
        try:
            conn.request("POST", "/score", body=raw, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        try:
            return resp.status, json.loads(data or b"{}")
        except json.JSONDecodeError:
            return 502, {"error": "backend returned invalid JSON"}

    def admin_backends(self) -> tuple[int, dict]:
        """``GET /admin/backends``: the membership table as the autoscaler
        sees it (states, ring membership, forward/failure counters)."""
        return 200, {
            "ready": sorted(self.ring.nodes),
            "backends": {b.name: {"state": b.state,
                                  "replica_id": b.health.get("replica_id"),
                                  "forwarded": b.forwarded,
                                  "failures": b.failures}
                         for b in self._backend_list()},
        }

    def handle_admin(self, raw: bytes) -> tuple[int, dict]:
        """``POST /admin/backends``: ``{"action": "add"|"remove",
        "backend": "host:port"}`` — the runtime membership surface the
        autoscaler drives. Add is readiness-gated (the member enters
        ``pending`` and must probe warm before taking traffic); remove
        only drops ring membership — draining the process stays with the
        caller, so the router can never hard-kill a replica."""
        try:
            payload = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            return 400, {"error": "body is not valid JSON"}
        action = payload.get("action") if isinstance(payload, dict) else None
        spec = payload.get("backend") if isinstance(payload, dict) else None
        if action not in ("add", "remove") or not isinstance(spec, str) \
                or ":" not in spec:
            return 400, {"error": "need {'action': 'add'|'remove', "
                                  "'backend': 'host:port'}"}
        if action == "add":
            b = self.add_backend(spec)
            return 200, {"backend": b.name, "state": b.state}
        removed = self.remove_backend(spec)
        return (200 if removed else 404), {"backend": spec,
                                           "removed": removed}

    def handle_admin_drain(self, raw: bytes) -> tuple[int, dict]:
        """``POST /admin/drain``: ``{"action": "drain"|"undrain"}`` — the
        federation's cell-level deploy surface. Drain is flag-only: this
        router's ``/healthz`` goes 503/``draining`` (so the federation's
        next probe drops the cell from its ring), new ``/score``s get
        503, in-flight forwards finish. Undrain clears the flag; the cell
        rejoins through the same readiness gate as a new member."""
        try:
            payload = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            return 400, {"error": "body is not valid JSON"}
        action = payload.get("action") if isinstance(payload, dict) else None
        if action not in ("drain", "undrain"):
            return 400, {"error": "need {'action': 'drain'|'undrain'}"}
        if action == "drain":
            self.request_drain()
        else:
            self.clear_drain()
        return 200, {"action": action, "draining": self.draining}

    def healthz(self) -> tuple[int, dict]:
        ready = sorted(self.ring.nodes)
        # the cell tells the truth one level up: the worst backend's
        # brownout level and queue-wait p99 ARE the cell's saturation
        # signal — the federation spills on these, no new probes
        brownout = 0
        queue_wait = 0.0
        for b in self._backend_list():
            if b.state != "ready":
                continue
            brownout = max(brownout, int(b.health.get("brownout_level") or 0))
            queue_wait = max(
                queue_wait,
                float(b.health.get("frontend_queue_wait_p99_ms") or 0.0))
        body = {
            "status": "draining" if self.draining else (
                "ok" if ready else "no_ready_backends"),
            "draining": self.draining,
            "warm": bool(ready),
            "brownout_level": brownout,
            "frontend_queue_wait_p99_ms": queue_wait,
            "ready_backends": ready,
            "backends": {b.name: {"state": b.state,
                                  "replica_id": b.health.get("replica_id"),
                                  "forwarded": b.forwarded,
                                  "failures": b.failures}
                         for b in self._backend_list()},
        }
        ok = bool(ready) and not self.draining
        return (200 if ok else 503), body


def _make_handler(router: FleetRouter):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            logger.debug("router http: " + fmt, *args)

        def _send(self, code: int, body, headers=None,
                  content_type="application/json"):
            data = (body.encode() if isinstance(body, str)
                    else json.dumps(body).encode())
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                code, body = router.healthz()
                self._send(code, body)
            elif self.path == "/metrics":
                self._send(200, router.metrics.render(),
                           content_type="text/plain; version=0.0.4")
            elif self.path == "/slo":
                self._send(200, router.render_slo(),
                           content_type="text/plain; version=0.0.4")
            elif self.path == "/admin/backends":
                code, body = router.admin_backends()
                self._send(code, body)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path in ("/admin/backends", "/admin/drain"):
                handler = (router.handle_admin
                           if self.path == "/admin/backends"
                           else router.handle_admin_drain)
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    code, body = handler(self.rfile.read(length))
                except Exception as exc:  # noqa: BLE001
                    code, body = 500, {
                        "error": f"{type(exc).__name__}: {exc}"}
                self._send(code, body)
                return
            if self.path != "/score":
                self._send(404, {"error": f"no route {self.path}"})
                return
            t0 = time.perf_counter()
            router.metrics.inc("requests_total")
            try:
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                parent = (parse_traceparent(self.headers.get("traceparent"))
                          if router.tracer is not None else None)
                with router._span("router.request", parent=parent,
                                  root=True) as sp:
                    code, body, extra = router.handle_score(raw)
                    if sp is not None:
                        sp.attrs["code"] = code
            except Exception as exc:  # noqa: BLE001 — request dies, router not
                code, body, extra = 500, {
                    "error": f"{type(exc).__name__}: {exc}"}, {}
            if code >= 400:
                router.metrics.inc("errors_total")
            self._send(code, body, headers=extra)
            router.metrics.latency.observe(
                (time.perf_counter() - t0) * 1000.0)

    return Handler


def main(argv=None) -> dict:
    import argparse

    parser = argparse.ArgumentParser(prog="deepdfa-tpu-torch-route")
    parser.add_argument("--backend", action="append", default=[],
                        required=False, dest="backends", metavar="HOST:PORT",
                        help="a ScoreServer to front (repeatable)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8900)
    parser.add_argument("--vnodes", type=int, default=DEFAULT_VNODES)
    parser.add_argument("--probe-interval", type=float, default=2.0,
                        dest="probe_interval_s")
    args = parser.parse_args(argv)
    if not args.backends:
        parser.error("need at least one --backend HOST:PORT")

    logging.basicConfig(level=logging.INFO)
    router = FleetRouter(args.backends, host=args.host, port=args.port,
                         vnodes=args.vnodes,
                         probe_interval_s=args.probe_interval_s)
    router.install_signal_handlers()
    router.start()
    print(json.dumps({"status": "routing", "port": router.port,
                      "backends": router.probe_once()}), flush=True)
    summary = router.wait()
    print(json.dumps({"status": "drained", **summary}), flush=True)
    return summary


if __name__ == "__main__":
    main()
