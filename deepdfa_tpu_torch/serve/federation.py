"""Multi-cell federation: spillover routing, cell-level drain, and
cell-kill survival.

The port of ``deepdfa_tpu/serve/federation.py``: the same routes, codes and
bodies for the same cells and states. One autoscaled fleet (a
:class:`~deepdfa_tpu_torch.serve.router.FleetRouter` plus its
:class:`~deepdfa_tpu_torch.serve.autoscaler.Autoscaler`) is one blast
radius. The :class:`FederationRouter` fronts N shared-nothing **cells**,
each a complete fleet with its own router, replicas (scoring on the card),
warm store and admission plane. Capacity grows by adding cells; robustness
comes from routing between them: losing any single cell loses no request.
The federation itself is host code and owns no device.

Routing is **source-key sticky** by default — the fleet router's
consistent-hash ring, so each source's scan-cache entry lives in exactly
one cell. Stickiness yields only under pressure:

- **spillover** — a cell that reports saturation (its ``/healthz``
  ``brownout_level``, its frontend queue-wait p99, or its ``/slo``
  fast-window burn past the configured watermarks) keeps its ring position
  but new requests prefer the least-burned healthy cell until it recovers;
- **cell-level drain** — a deploy drains a whole cell flag-only: the cell
  leaves the federation ring first (no new forwards), in-flight forwards
  finish inside :data:`FederationConfig.drain_deadline_s`, then the cell's
  own router gets the drain flag; undrain readmits it through the same
  readiness gate as a new member;
- **cell-death failover** — a forward that fails at the socket marks the
  cell down and retries the next cell; a dead cell costs its cache shard,
  never its keyspace's availability, and nothing becomes a 5xx;
- **cross-cell shed semantics** — a 429 from one cell triggers spillover;
  only a fleet-wide shed (every reachable cell shed) reaches the client,
  still as a 429 with the largest Retry-After any cell gave, never a 5xx.
  When no cell is reachable the client gets a 429 with
  ``retry_after_floor_s``: scoring is idempotent, so explicit backpressure
  beats a lying 5xx.

Chaos points: ``federation.cell_kill`` (the probe loop kill -9s a whole
cell through the installed ``kill_hook``), ``federation.spillover_drop`` (a
spilled forward dies on the wire — counted, retried, never a 5xx),
``federation.probe_partition`` (one health probe reads as a socket failure
— the cell is marked down and rejoins on the next clean probe).

Entry point: ``python -m deepdfa_tpu_torch.serve.federation --cell
HOST:PORT ...`` (one ``federating`` JSON line, SIGTERM → ``drained``).
"""

from __future__ import annotations

import http.client
import json
import logging
import signal
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler

from deepdfa_tpu_torch.config import FederationConfig, ObsConfig
from deepdfa_tpu_torch.obs import MetricsRegistry, SLOEngine, federation_specs
from deepdfa_tpu_torch.pipeline import source_key
from deepdfa_tpu_torch.resilience import faults

from .autoscaler import max_fast_burn
from .metrics import LatencyReservoir
from .router import FORWARD_TIMEOUT_S, HashRing, _HTTPServer

__all__ = ["Cell", "FederationMetrics", "FederationRouter", "main"]

logger = logging.getLogger(__name__)

PROBE_TIMEOUT_S = 5.0


@dataclass
class Cell:
    """One fleet the federation fronts. ``state`` transitions mirror
    :class:`~deepdfa_tpu_torch.serve.router.Backend` one level up:
    pending → ready (first healthy probe) → draining/down → ready."""

    name: str                     # "host:port" of the cell's FleetRouter
    host: str
    port: int
    state: str = "pending"
    health: dict = field(default_factory=dict)  # last /healthz body
    burn: float | None = None     # last /slo fast-window burn rate
    forwarded: int = 0
    failures: int = 0
    spillover: int = 0            # forwards this cell absorbed for others
    inflight: int = 0             # forwards currently on the wire

    @classmethod
    def parse(cls, spec: str) -> "Cell":
        host, _, port = spec.rpartition(":")
        return cls(name=spec, host=host or "127.0.0.1", port=int(port))


class FederationMetrics:
    """Federation-tier counters; rendered as ``deepdfa_federation_*``."""

    def __init__(self, latency_window: int = 2048):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.forwarded_total: dict[str, int] = {}
        self.spillover_total = 0
        self.spillover_errors_total = 0
        self.retries_total = 0
        self.fleetwide_shed_total = 0
        self.fleetwide_5xx_total = 0
        self.no_cell_total = 0
        self.latency = LatencyReservoir(latency_window)

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + by)

    def observe_forward(self, cell: str) -> None:
        with self._lock:
            self.forwarded_total[cell] = self.forwarded_total.get(cell, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests_total": self.requests_total,
                "forwarded_total": dict(self.forwarded_total),
                "spillover_total": self.spillover_total,
                "spillover_errors_total": self.spillover_errors_total,
                "retries_total": self.retries_total,
                "fleetwide_shed_total": self.fleetwide_shed_total,
                "fleetwide_5xx_total": self.fleetwide_5xx_total,
                "no_cell_total": self.no_cell_total,
                "latency_p50_ms": self.latency.quantile(0.50),
                "latency_p99_ms": self.latency.quantile(0.99),
            }

    def render(self) -> str:
        snap = self.snapshot()
        reg = MetricsRegistry("deepdfa_federation_")
        reg.counter("requests_total",
                    "Every /score the federation received").set(
            snap["requests_total"])
        fwd = reg.counter("forwarded_total", "Forwards by cell",
                          labels=("cell",))
        for name, n in snap["forwarded_total"].items():
            fwd.set(n, cell=name)
        reg.counter("spillover_total",
                    "Forwards served off the sticky cell").set(
            snap["spillover_total"])
        reg.counter("spillover_errors_total",
                    "Spilled forwards lost on the wire (retried)").set(
            snap["spillover_errors_total"])
        reg.counter("retries_total",
                    "Per-request failovers past a cell").set(
            snap["retries_total"])
        reg.counter("fleetwide_shed_total",
                    "Requests every reachable cell shed (client 429)").set(
            snap["fleetwide_shed_total"])
        reg.counter("fleetwide_5xx_total",
                    "5xx leaked to a client (invariant 32 violations)").set(
            snap["fleetwide_5xx_total"])
        reg.counter("no_cell_total",
                    "Requests with no reachable cell (client 429)").set(
            snap["no_cell_total"])
        lat = reg.gauge("latency_ms",
                        "Federation round-trip latency",
                        labels=("quantile",))
        for q in (0.50, 0.99):
            lat.set(self.latency.quantile(q), quantile=q)
        return reg.render()


class FederationRouter:
    """The federation's one client-facing surface.

    ``POST /score`` routes the body's ``source_key`` sticky on the cell
    ring, spills past saturated/dead/shedding cells, and proxies the
    first successful cell response verbatim (plus an ``X-DeepDFA-Cell``
    header). ``GET /healthz`` reports the cell table, ``GET /metrics``
    the ``deepdfa_federation_*`` counters, ``GET /slo`` the federation
    objectives; ``/admin/cells`` is the membership + drain surface."""

    def __init__(self, cells=(), cfg: FederationConfig | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 metrics: FederationMetrics | None = None,
                 obs: ObsConfig | None = None,
                 kill_hook=None):
        self.cfg = cfg or FederationConfig()
        self._cells_lock = threading.Lock()
        self.cells: dict[str, Cell] = {}
        for spec in tuple(self.cfg.cells) + tuple(cells):
            c = spec if isinstance(spec, Cell) else Cell.parse(str(spec))
            self.cells.setdefault(c.name, c)
        self.ring = HashRing(self.cfg.vnodes)
        self.metrics = metrics or FederationMetrics()
        obs = obs or ObsConfig()
        self.slo = SLOEngine(
            federation_specs(availability=obs.slo_availability,
                             p99_ms=obs.slo_p99_ms),
            fast_window_s=obs.slo_fast_window_s,
            slow_window_s=obs.slo_slow_window_s,
            burn_threshold=obs.slo_burn_threshold)
        # chaos surface: federation.cell_kill fires through this hook —
        # the caller owns the processes, the router only names the victim
        # (the autoscale.replica_crash shape)
        self.kill_hook = kill_hook
        self._draining = threading.Event()
        self._stop_requested = threading.Event()
        self._probe_thread: threading.Thread | None = None
        # a listen backlog of 128, as the server's and the router's
        self.httpd = _HTTPServer((host, port), _make_handler(self))
        self._serve_thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def draining(self) -> bool:
        return self._draining.is_set() or self._stop_requested.is_set()

    def start(self, probe: bool = True) -> "FederationRouter":
        if probe:
            self.probe_once()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="federation-probe", daemon=True)
            self._probe_thread.start()
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="federation-http",
            daemon=True)
        self._serve_thread.start()
        logger.info("federating on :%s over %d cell(s), %d ready",
                    self.port, len(self._cell_list()), len(self.ring))
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

    def shutdown(self) -> dict:
        self._draining.set()
        self._stop_requested.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        return self.metrics.snapshot()

    def render_slo(self) -> str:
        self.slo.observe(self.metrics.snapshot())
        return self.slo.render("deepdfa_federation_")

    # -- cell membership ----------------------------------------------------

    def add_cell(self, spec) -> Cell:
        """Register a cell at runtime. It enters ``pending`` and joins the
        ring only after a healthy probe — the same readiness gate as the
        fleet router's backends (invariant 13), so a cell whose fleet is
        still compiling takes no federation traffic."""
        c = spec if isinstance(spec, Cell) else Cell.parse(str(spec))
        with self._cells_lock:
            existing = self.cells.get(c.name)
            if existing is not None:
                return existing
            self.cells[c.name] = c
        self._probe_cell(c)
        logger.info("cell %s registered (state %s)", c.name, c.state)
        return c

    def remove_cell(self, name: str) -> bool:
        with self._cells_lock:
            c = self.cells.pop(name, None)
        if c is None:
            return False
        self.ring.remove(name)
        logger.info("cell %s deregistered", name)
        return True

    def drain_cell(self, name: str) -> tuple[bool, dict]:
        """Cell-level drain for deploys, in invariant-6 order: (1) the
        cell leaves the federation ring — no NEW forwards route to it;
        (2) in-flight forwards finish (bounded by ``drain_deadline_s``);
        (3) the cell's own router gets the flag-only drain, which
        cascades to its replicas through its own probe loop."""
        c = self._get_cell(name)
        if c is None:
            return False, {"error": f"no cell {name}"}
        self.ring.remove(name)
        c.state = "draining"
        deadline = time.monotonic() + self.cfg.drain_deadline_s
        while c.inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        inflight_left = c.inflight
        try:
            status, body = self._cell_admin(c, {"action": "drain"})
        except OSError as exc:
            status, body = 0, {"error": f"{type(exc).__name__}: {exc}"}
        logger.info("cell %s drained (inflight_left=%d, cell said %s)",
                    name, inflight_left, status)
        return True, {"cell": name, "state": c.state,
                      "inflight_at_flag": inflight_left,
                      "cell_status": status, "cell_body": body}

    def undrain_cell(self, name: str) -> tuple[bool, dict]:
        """Reverse a cell drain: clear the cell router's flag, then let
        the next probe readmit it through the readiness gate."""
        c = self._get_cell(name)
        if c is None:
            return False, {"error": f"no cell {name}"}
        try:
            status, body = self._cell_admin(c, {"action": "undrain"})
        except OSError as exc:
            return False, {"error": f"{type(exc).__name__}: {exc}"}
        self._probe_cell(c)
        return True, {"cell": name, "state": c.state,
                      "cell_status": status, "cell_body": body}

    def _cell_admin(self, c: Cell, payload: dict) -> tuple[int, dict]:
        conn = http.client.HTTPConnection(c.host, c.port,
                                          timeout=PROBE_TIMEOUT_S)
        try:
            conn.request("POST", "/admin/drain", body=json.dumps(payload),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read() or b"{}")
        finally:
            conn.close()
        return resp.status, body

    def _cell_list(self) -> list[Cell]:
        with self._cells_lock:
            return list(self.cells.values())

    def _get_cell(self, name: str) -> Cell | None:
        with self._cells_lock:
            return self.cells.get(name)

    # -- cell health --------------------------------------------------------

    def _probe_cell(self, c: Cell) -> None:
        try:
            if faults.fire("federation.probe_partition"):
                raise OSError("injected probe partition")
            conn = http.client.HTTPConnection(c.host, c.port,
                                              timeout=PROBE_TIMEOUT_S)
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                body = json.loads(resp.read() or b"{}")
            finally:
                conn.close()
        except (OSError, json.JSONDecodeError) as exc:
            self._mark(c, "down", {"error": f"{type(exc).__name__}: {exc}"})
            return
        if resp.status == 200 and not body.get("draining"):
            if body.get("warm", True):
                self._mark(c, "ready", body)
            else:
                self._mark(c, "pending", body)
        elif body.get("draining"):
            self._mark(c, "draining", body)
        else:
            self._mark(c, "down", body)
        if c.state == "ready":
            c.burn = self._probe_burn(c)

    def _probe_burn(self, c: Cell) -> float | None:
        """The cell's own ``/slo`` verdict — the spillover burn signal.
        A failed scrape is not a health event (the healthz probe owns
        liveness); the last burn just goes stale-to-None."""
        try:
            conn = http.client.HTTPConnection(c.host, c.port,
                                              timeout=PROBE_TIMEOUT_S)
            try:
                conn.request("GET", "/slo")
                resp = conn.getresponse()
                text = resp.read().decode("utf-8", "replace")
            finally:
                conn.close()
        except OSError:
            return None
        return max_fast_burn(text) if resp.status == 200 else None

    def _mark(self, c: Cell, state: str, health: dict) -> None:
        prev = c.state
        c.state = state
        c.health = health
        if state == "ready":
            self.ring.add(c.name)
        else:
            self.ring.remove(c.name)
        if state != prev:
            logger.info("cell %s: %s -> %s", c.name, prev, state)

    def probe_once(self) -> dict:
        """Probe every cell once; returns ``{name: state}``."""
        snapshot = self._cell_list()
        if self.kill_hook is not None and faults.fire("federation.cell_kill"):
            victim = next((c for c in snapshot if c.state == "ready"), None)
            if victim is not None:
                logger.warning("cell_kill fault: killing cell %s",
                               victim.name)
                self.kill_hook(victim.name)
        for c in snapshot:
            self._probe_cell(c)
        return {c.name: c.state for c in snapshot}

    def _probe_loop(self) -> None:
        while not self._stop_requested.wait(
                timeout=self.cfg.probe_interval_s):
            self.probe_once()

    def saturated(self, c: Cell) -> bool:
        """Derived, never stored: the cell's last probe already carries
        the truth (brownout level, queue-wait p99, SLO burn) — saturation
        is a judgment over it at routing time."""
        level = int(c.health.get("brownout_level") or 0)
        if level >= self.cfg.spill_brownout_level:
            return True
        queue_wait = float(c.health.get("frontend_queue_wait_p99_ms") or 0.0)
        if queue_wait >= self.cfg.spill_queue_wait_p99_ms:
            return True
        return c.burn is not None and c.burn >= self.cfg.spill_burn_high

    # -- request path -------------------------------------------------------

    def plan_route(self, key: str) -> list[str]:
        """The ordered cells one request will try. Sticky owner first —
        UNLESS it is saturated, in which case the least-burned healthy
        non-saturated cell leads and the sticky owner becomes the
        fallback (saturation spillover is a preference, not a refusal:
        when every cell is saturated the sticky owner still serves)."""
        ready = [c for c in self._cell_list() if c.state == "ready"
                 and c.name in self.ring.nodes]
        if not ready:
            return []
        by_name = {c.name: c for c in ready}
        sticky = self.ring.route(key)
        order = sorted(
            ready, key=lambda c: (self.saturated(c),
                                  c.burn if c.burn is not None else 0.0,
                                  c.name != (sticky or ""), c.name))
        if sticky in by_name and not self.saturated(by_name[sticky]):
            order = [by_name[sticky]] + [c for c in order
                                         if c.name != sticky]
        return [c.name for c in order]

    def handle_score(self, raw: bytes) -> tuple[int, dict, dict]:
        """Route + forward one ``/score`` body across the cell ring.
        Returns ``(status, body, extra_headers)`` — never a 5xx of the
        federation's own making (invariant candidate 32)."""
        if self.draining:
            # the federation front drains like a cell: explicit
            # backpressure, scoring is idempotent, the client retries
            return 429, {"error": "federation is draining",
                         "retry_after_s": self.cfg.retry_after_floor_s}, {
                "Retry-After": str(self.cfg.retry_after_floor_s)}
        try:
            payload = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            return 400, {"error": "body is not valid JSON"}, {}
        source = payload.get("source") if isinstance(payload, dict) else None
        if not isinstance(source, str) or not source.strip():
            return 400, {"error": "body must be JSON with a 'source' "
                                  "string"}, {}
        key = source_key(source)
        plan = self.plan_route(key)
        # spillover is relative to the RING OWNER, not the plan position:
        # a saturation-reordered plan serving at hop 0 is still spillover
        # (the owner was demoted), while a request whose dead owner has
        # already left the ring is reassignment, not spillover
        owner = self.ring.route(key)
        max_retry_after = 0
        saw_shed = False
        for hop, name in enumerate(plan):
            c = self._get_cell(name)
            if c is None:  # deregistered between plan and lookup
                self.ring.remove(name)
                continue
            spill = owner is not None and name != owner
            try:
                if spill and faults.fire("federation.spillover_drop"):
                    raise OSError("injected spillover drop")
                status, body, retry_after = self._forward(c, raw)
            except OSError as exc:
                c.failures += 1
                self.metrics.inc("retries_total")
                if spill:
                    # a lost spillover forward is a counted error, not a
                    # health event — the next cell absorbs it
                    self.metrics.inc("spillover_errors_total")
                    logger.warning("spilled forward to %s lost (%s) — "
                                   "retrying next cell", name,
                                   type(exc).__name__)
                else:
                    self._mark(c, "down",
                               {"error": f"{type(exc).__name__}: {exc}"})
                    logger.warning("forward to cell %s failed (%s) — "
                                   "failing over", name, type(exc).__name__)
                continue
            if status == 429:
                # one cell shedding is spillover's cue, not the client's
                # problem — only a fleet-wide shed surfaces (invariant 30)
                saw_shed = True
                max_retry_after = max(max_retry_after, retry_after or 0)
                self.metrics.inc("retries_total")
                continue
            if status == 503 and "draining" in str(
                    (body or {}).get("error", "")):
                self._mark(c, "draining", {"error": body.get("error")})
                self.metrics.inc("retries_total")
                continue
            if status >= 500:
                # a cell-internal failure is tracked, never surfaced —
                # scoring is idempotent, the next cell re-scores
                c.failures += 1
                self.metrics.inc("retries_total")
                logger.warning("cell %s returned %d — failing over",
                               name, status)
                continue
            c.forwarded += 1
            if spill:
                c.spillover += 1
                self.metrics.inc("spillover_total")
            self.metrics.observe_forward(name)
            return status, body, {"X-DeepDFA-Cell": name,
                                  "X-DeepDFA-Spillover": str(spill).lower()}
        # exhausted: every reachable cell shed, or none was reachable.
        # Either way the honest answer is backpressure, never a 5xx.
        retry_after = max(max_retry_after, self.cfg.retry_after_floor_s)
        if saw_shed:
            self.metrics.inc("fleetwide_shed_total")
            error = "every cell shed this request"
        else:
            self.metrics.inc("no_cell_total")
            error = "no reachable cell" if plan else "no ready cell"
        return 429, {"error": error, "retry_after_s": retry_after}, {
            "Retry-After": str(int(retry_after))}

    def _forward(self, c: Cell,
                 raw: bytes) -> tuple[int, dict, int | None]:
        """One cell round-trip: ``(status, body, retry_after_s)`` — the
        Retry-After comes from the header the cell router propagates
        (falling back to the body the admission plane writes)."""
        c.inflight += 1
        try:
            conn = http.client.HTTPConnection(c.host, c.port,
                                              timeout=FORWARD_TIMEOUT_S)
            try:
                conn.request("POST", "/score", body=raw,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
            finally:
                conn.close()
        finally:
            c.inflight -= 1
        try:
            body = json.loads(data or b"{}")
        except json.JSONDecodeError:
            return 502, {"error": "cell returned invalid JSON"}, None
        retry_after = None
        header = resp.getheader("Retry-After")
        if header is not None:
            try:
                retry_after = int(header)
            except ValueError:
                retry_after = None
        if retry_after is None and isinstance(body, dict) \
                and body.get("retry_after_s") is not None:
            retry_after = int(body["retry_after_s"])
        return resp.status, body, retry_after

    # -- admin + health -----------------------------------------------------

    def admin_cells(self) -> tuple[int, dict]:
        """``GET /admin/cells``: the cell table as the operator sees it."""
        return 200, {
            "ready": sorted(self.ring.nodes),
            "cells": {c.name: {"state": c.state,
                               "saturated": (c.state == "ready"
                                             and self.saturated(c)),
                               "burn": c.burn,
                               "brownout_level": int(
                                   c.health.get("brownout_level") or 0),
                               "forwarded": c.forwarded,
                               "spillover": c.spillover,
                               "failures": c.failures}
                      for c in self._cell_list()},
        }

    def handle_admin(self, raw: bytes) -> tuple[int, dict]:
        """``POST /admin/cells``: ``{"action": "add"|"remove"|"drain"|
        "undrain", "cell": "host:port"}`` — the deploy surface. Add is
        readiness-gated; drain runs the invariant-6 order (ring exit
        first, in-flight forwards finish, then the cell's flag)."""
        try:
            payload = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            return 400, {"error": "body is not valid JSON"}
        action = payload.get("action") if isinstance(payload, dict) else None
        spec = payload.get("cell") if isinstance(payload, dict) else None
        if action not in ("add", "remove", "drain", "undrain") \
                or not isinstance(spec, str) or ":" not in spec:
            return 400, {"error": "need {'action': 'add'|'remove'|'drain'|"
                                  "'undrain', 'cell': 'host:port'}"}
        if action == "add":
            c = self.add_cell(spec)
            return 200, {"cell": c.name, "state": c.state}
        if action == "remove":
            removed = self.remove_cell(spec)
            return (200 if removed else 404), {"cell": spec,
                                               "removed": removed}
        ok, body = (self.drain_cell(spec) if action == "drain"
                    else self.undrain_cell(spec))
        return (200 if ok else 404), body

    def healthz(self) -> tuple[int, dict]:
        ready = sorted(self.ring.nodes)
        body = {
            "status": "draining" if self.draining else (
                "ok" if ready else "no_ready_cells"),
            "draining": self.draining,
            "ready_cells": ready,
            "cells": {c.name: {"state": c.state,
                               "saturated": (c.state == "ready"
                                             and self.saturated(c)),
                               "burn": c.burn,
                               "brownout_level": int(
                                   c.health.get("brownout_level") or 0)}
                      for c in self._cell_list()},
        }
        ok = bool(ready) and not self.draining
        return (200 if ok else 503), body


def _make_handler(fed: FederationRouter):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            logger.debug("federation http: " + fmt, *args)

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
                code, body = fed.healthz()
                self._send(code, body)
            elif self.path == "/metrics":
                self._send(200, fed.metrics.render(),
                           content_type="text/plain; version=0.0.4")
            elif self.path == "/slo":
                self._send(200, fed.render_slo(),
                           content_type="text/plain; version=0.0.4")
            elif self.path == "/admin/cells":
                code, body = fed.admin_cells()
                self._send(code, body)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/admin/cells":
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    code, body = fed.handle_admin(self.rfile.read(length))
                except Exception as exc:  # noqa: BLE001
                    code, body = 500, {
                        "error": f"{type(exc).__name__}: {exc}"}
                self._send(code, body)
                return
            if self.path != "/score":
                self._send(404, {"error": f"no route {self.path}"})
                return
            t0 = time.perf_counter()
            fed.metrics.inc("requests_total")
            try:
                length = int(self.headers.get("Content-Length") or 0)
                code, body, extra = fed.handle_score(self.rfile.read(length))
            except Exception as exc:  # noqa: BLE001 — request dies, the
                # federation front does not; this is the ONLY federation
                # path that can 5xx, and the counter indicts it
                code, body, extra = 500, {
                    "error": f"{type(exc).__name__}: {exc}"}, {}
            if code >= 500:
                fed.metrics.inc("fleetwide_5xx_total")
            self._send(code, body, headers=extra)
            fed.metrics.latency.observe((time.perf_counter() - t0) * 1000.0)

    return Handler


def main(argv=None) -> dict:
    import argparse

    parser = argparse.ArgumentParser(prog="deepdfa-tpu-torch-federate")
    parser.add_argument("--cell", action="append", default=[],
                        dest="cells", metavar="HOST:PORT",
                        help="a cell's FleetRouter to front (repeatable)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8950)
    parser.add_argument("--vnodes", type=int, default=16)
    parser.add_argument("--probe-interval", type=float, default=1.0,
                        dest="probe_interval_s")
    args = parser.parse_args(argv)
    if not args.cells:
        parser.error("need at least one --cell HOST:PORT")

    logging.basicConfig(level=logging.INFO)
    cfg = FederationConfig(enabled=True, cells=tuple(args.cells),
                           vnodes=args.vnodes,
                           probe_interval_s=args.probe_interval_s)
    fed = FederationRouter(cfg=cfg, host=args.host, port=args.port)
    fed.install_signal_handlers()
    fed.start()
    print(json.dumps({"status": "federating", "port": fed.port,
                      "cells": fed.probe_once()}), flush=True)
    summary = fed.wait()
    print(json.dumps({"status": "drained", **summary}), flush=True)
    return summary


if __name__ == "__main__":
    main()
