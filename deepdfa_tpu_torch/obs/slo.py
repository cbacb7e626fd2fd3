"""SLO burn-rate engine — declarative objectives judged from metric snapshots.

A trimmed copy of ``deepdfa_tpu/obs/slo.py``: the engine, the serve-side,
router, federation and trainer specs, the ``alerts.json`` artifact and its
fail-closed reader (the promotion veto). An :class:`SLOSpec`
declares one objective over keys of a flat metrics snapshot, in one of
three kinds:

- ``ratio`` — an error-budget SLO over two cumulative counters: ``bad`` /
  ``total`` must stay under ``1 - target``. Burn rate is the SRE
  multi-window form: the bad fraction over a window divided by the budget,
  alerting only when BOTH the fast and the slow window burn above the
  threshold.
- ``max`` — a windowed gauge ceiling (p99 latency, mean step time). Burn is
  ``mean / target``; it alerts when sustained above 1.
- ``min`` — a windowed gauge floor (MFU). Burn is ``target / mean``.

The engine is fed at *scrape* time (``observe(snapshot)``), keeps a bounded
sample deque per spec, and renders through
:class:`~deepdfa_tpu_torch.obs.registry.MetricsRegistry` only. Alert
*transitions* (firing ↔ resolved) are returned from ``observe`` so callers
can journal them and refresh the ``alerts.json`` promotion-veto artifact;
evaluation failures never fail the scrape (counted in ``dropped_total``,
exported as ``deepdfa_serve_obs_dropped_total``).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path

from deepdfa_tpu_torch.obs.registry import MetricsRegistry
from deepdfa_tpu_torch.resilience.journal import atomic_write_text

__all__ = [
    "SLOSpec",
    "SLOEngine",
    "federation_specs",
    "read_promotion_veto",
    "router_specs",
    "serve_specs",
    "train_specs",
    "write_alerts_artifact",
]

_KINDS = ("ratio", "max", "min")
_BURN_CAP = 1e6  # keeps burn JSON-serializable (no Infinity)


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over snapshot keys.

    ``ratio``: ``bad``/``total`` name cumulative counters; ``target`` is
    the good fraction (0 < target < 1). ``max``/``min``: ``value`` names a
    gauge; ``target`` is the bound. ``alert_burn`` overrides the firing
    threshold (default: the engine's ``burn_threshold`` for ratios, 1.0
    for gauge bounds)."""

    name: str
    kind: str
    target: float
    bad: str = ""
    total: str = ""
    value: str = ""
    alert_burn: float | None = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"SLO kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        if self.kind == "ratio":
            if not (self.bad and self.total):
                raise ValueError(f"ratio SLO {self.name!r} needs bad= and "
                                 "total= snapshot keys")
            if not 0.0 < self.target < 1.0:
                raise ValueError(f"ratio SLO {self.name!r} target must be "
                                 f"in (0, 1), got {self.target}")
        elif not self.value:
            raise ValueError(f"{self.kind} SLO {self.name!r} needs a "
                             "value= snapshot key")


class SLOEngine:
    """Evaluates specs against successive snapshots; tracks burn over a
    fast and a slow window; reports alert transitions."""

    def __init__(self, specs, *, fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0, burn_threshold: float = 2.0,
                 clock=time.time, flight=None):
        self.specs = tuple(specs)
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        if not 0 < fast_window_s <= slow_window_s:
            raise ValueError("need 0 < fast_window_s <= slow_window_s")
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self._clock = clock
        self.flight = flight  # optional FlightRecorder: transition events
        self._lock = threading.Lock()
        # per spec: deque of (t, numerator-or-value, denominator)
        self._samples: dict[str, deque] = {s.name: deque() for s in self.specs}
        self._alerting: dict[str, bool] = {s.name: False for s in self.specs}
        self.transitions: deque = deque(maxlen=128)
        self.evals_total = 0
        self.transitions_total = 0
        self.dropped_total = 0

    # -- ingestion ----------------------------------------------------------

    def observe(self, snapshot) -> list[dict]:
        """Ingest one snapshot; returns the alert-transition events it
        caused (possibly empty). Never raises — an SLO evaluation must
        never fail the scrape that triggered it."""
        try:
            events = self._observe(snapshot)
        except Exception:  # noqa: BLE001 — invariant 14: swallow, count
            self.dropped_total += 1
            return []
        for evt in events:
            if self.flight is not None:
                self.flight.record("slo.transition", **evt)
        return events

    def _observe(self, snapshot) -> list[dict]:
        now = float(self._clock())
        events: list[dict] = []
        with self._lock:
            self.evals_total += 1
            for spec in self.specs:
                dq = self._samples[spec.name]
                if spec.kind == "ratio":
                    bad = snapshot.get(spec.bad)
                    total = snapshot.get(spec.total)
                    if bad is None or total is None:
                        continue
                    dq.append((now, float(bad), float(total)))
                else:
                    val = snapshot.get(spec.value)
                    if val is None:
                        continue
                    dq.append((now, float(val), 1.0))
                # keep one sample beyond the slow window as its left edge
                cutoff = now - self.slow_window_s
                while len(dq) >= 2 and dq[1][0] <= cutoff:
                    dq.popleft()
                status = self._status_locked(spec, now)
                firing = bool(status["alert"])
                if firing != self._alerting[spec.name]:
                    self._alerting[spec.name] = firing
                    self.transitions_total += 1
                    events.append({
                        "event": "slo_transition",
                        "slo": spec.name,
                        "state": "firing" if firing else "resolved",
                        "t_unix": round(now, 3),
                        "burn_fast": status["burn_fast"],
                        "burn_slow": status["burn_slow"],
                        "target": spec.target,
                    })
            self.transitions.extend(events)
        return events

    # -- evaluation ---------------------------------------------------------

    def _window_burn(self, spec: SLOSpec, dq, now: float,
                     window: float) -> float | None:
        if not dq:
            return None
        cutoff = now - window
        base = dq[0]
        for sample in dq:
            if sample[0] <= cutoff:
                base = sample
            else:
                break
        head = dq[-1]
        if spec.kind == "ratio":
            d_total = head[2] - base[2]
            if d_total <= 0:
                return 0.0  # no traffic in the window = no budget burned
            ratio = max(0.0, head[1] - base[1]) / d_total
            budget = 1.0 - spec.target
            return min(_BURN_CAP, ratio / budget)
        vals = [s[1] for s in dq if s[0] >= cutoff]
        if not vals:
            # every gauge sample aged out of this window: no observations
            # means no violation — mirroring the ratio branch above. The
            # old fallback (reuse the last value forever) froze an idle
            # replica at its final saturation reading, and a replica that
            # reads saturated gets no traffic, so it could never recover.
            return 0.0
        mean = sum(vals) / len(vals)
        if spec.kind == "max":
            if spec.target <= 0:
                return _BURN_CAP if mean > 0 else 0.0
            return min(_BURN_CAP, mean / spec.target)
        if mean <= 0:
            return _BURN_CAP if spec.target > 0 else 0.0
        return min(_BURN_CAP, spec.target / mean)

    def _status_locked(self, spec: SLOSpec, now: float) -> dict:
        dq = self._samples[spec.name]
        fast = self._window_burn(spec, dq, now, self.fast_window_s)
        slow = self._window_burn(spec, dq, now, self.slow_window_s)
        thr = spec.alert_burn if spec.alert_burn is not None else (
            self.burn_threshold if spec.kind == "ratio" else 1.0)
        alert = fast is not None and slow is not None and (
            fast > thr and slow > thr)
        return {
            "slo": spec.name, "kind": spec.kind, "target": spec.target,
            "burn_fast": None if fast is None else round(fast, 6),
            "burn_slow": None if slow is None else round(slow, 6),
            "threshold": thr, "alert": alert,
        }

    def statuses(self) -> list[dict]:
        now = float(self._clock())
        with self._lock:
            return [self._status_locked(spec, now) for spec in self.specs]

    # -- exposition ---------------------------------------------------------

    def worst_fast_burn(self) -> float | None:
        """Max fast-window burn across the specs — the one-number
        overload signal. The autoscaler reads it over HTTP (``/slo`` and
        ``max_fast_burn``); the in-process brownout controller
        (``serve/admission.py``) reads it here, off the same statuses."""
        burns = [row["burn_fast"] for row in self.statuses()
                 if row.get("burn_fast") is not None]
        return max(burns, default=None)

    # -- exposition ---------------------------------------------------------

    def stage(self, reg: MetricsRegistry) -> None:
        """Stage the SLO families into a caller-owned registry (the caller
        picks the ``deepdfa_*`` prefix — invariant 16)."""
        rows = self.statuses()
        obj = reg.gauge("slo_objective", "Declared objective per SLO",
                        labels=("slo",))
        burn = reg.gauge(
            "slo_burn_rate",
            "Error-budget burn rate (ratio SLOs: bad-fraction/budget; "
            "gauge SLOs: value/bound)", labels=("slo", "window"))
        alert = reg.gauge("slo_alert",
                          "1 while the SLO's multi-window burn condition "
                          "is firing", labels=("slo",))
        for row in rows:
            obj.set(row["target"], slo=row["slo"])
            burn.set(row["burn_fast"], slo=row["slo"], window="fast")
            burn.set(row["burn_slow"], slo=row["slo"], window="slow")
            alert.set(int(row["alert"]), slo=row["slo"])
        reg.counter("slo_evaluations_total",
                    "Snapshots ingested by the SLO engine").set(
            self.evals_total)
        reg.counter("slo_transitions_total",
                    "Alert state changes (firing or resolved)").set(
            self.transitions_total)
        dropped = self.dropped_total
        if self.flight is not None:
            dropped += self.flight.dropped_total
        reg.counter(
            "obs_dropped_total",
            "Flight-recorder events or SLO evaluations dropped instead of "
            "failing the request/step they annotate (invariant 14)").set(
            dropped)

    def render(self, prefix: str) -> str:
        """The ``/slo`` endpoint body: one registry, caller's prefix."""
        reg = MetricsRegistry(prefix)
        self.stage(reg)
        return reg.render()


# ---------------------------------------------------------------------------
# spec factories — the declarative defaults each process serves


def serve_specs(*, availability: float = 0.99, error_rate: float = 0.95,
                p99_ms: float = 2000.0, tier2_p99_ms: float | None = None,
                tier2_success: float = 0.99) -> tuple[SLOSpec, ...]:
    """Serve-side objectives. ``availability`` budgets 5xx only (the
    server's own failures); ``error_rate`` budgets every non-2xx (client
    junk included — a looser floor that catches abusive traffic shifts);
    ``score_drift`` turns the drift sentinel's PSI alert gauge into a page + promotion
    veto the moment any model_rev's window drifts.

    With the cascade enabled, pass ``tier2_p99_ms`` (its own deadline
    budget — tier 2 is allowed to be slower than tier 1, but not slower
    than the budget the degradation contract waits out) to add the
    per-tier objectives: a tier-2 latency ceiling and a tier-2 success
    ratio (degraded / escalated — degradations are correct behaviour per
    request, invariant 24, but a *rate* of them is an incident)."""
    specs = (
        SLOSpec("availability", "ratio", availability,
                bad="responses_5xx_total", total="responses_total"),
        SLOSpec("error_rate", "ratio", error_rate,
                bad="responses_error_total", total="responses_total"),
        SLOSpec("latency_p99", "max", p99_ms, value="latency_p99_ms"),
        SLOSpec("score_drift", "max", 0.0, value="drift_alerting"),
    )
    if tier2_p99_ms is not None:
        specs += (
            SLOSpec("tier2_latency_p99", "max", tier2_p99_ms,
                    value="tier2_latency_p99_ms"),
            SLOSpec("tier2_success", "ratio", tier2_success,
                    bad="cascade_degraded_total",
                    total="cascade_escalated_total"),
        )
    return specs


def router_specs(*, availability: float = 0.99,
                 p99_ms: float = 2000.0) -> tuple[SLOSpec, ...]:
    """The fleet router's objectives: availability over every non-2xx it
    answers, and its round-trip p99."""
    return (
        SLOSpec("availability", "ratio", availability,
                bad="errors_total", total="requests_total"),
        SLOSpec("latency_p99", "max", p99_ms, value="latency_p99_ms"),
    )


def federation_specs(*, availability: float = 0.99,
                     p99_ms: float = 2000.0) -> tuple[SLOSpec, ...]:
    """Federation-tier objectives (invariant candidate 32). Availability
    budgets 5xx ONLY — a fleet-wide 429 shed is correct behaviour per
    request, a 5xx is a broken promise; ``spillover_errors`` pages the
    moment a spilled forward is lost instead of retried."""
    return (
        SLOSpec("availability", "ratio", availability,
                bad="fleetwide_5xx_total", total="requests_total"),
        SLOSpec("latency_p99", "max", p99_ms, value="latency_p99_ms"),
        SLOSpec("spillover_errors", "max", 0.0,
                value="spillover_errors_total"),
    )


def train_specs(*, step_ms: float = 0.0,
                mfu_floor: float = 0.0) -> tuple[SLOSpec, ...]:
    """Train-side objectives; 0 disables a spec (step time and MFU floors
    are hardware-specific, so there is no honest universal default)."""
    specs = []
    if step_ms > 0:
        specs.append(SLOSpec("step_time", "max", step_ms,
                             value="mean_step_ms"))
    if mfu_floor > 0:
        specs.append(SLOSpec("mfu_floor", "min", mfu_floor, value="mfu"))
    return tuple(specs)


# ---------------------------------------------------------------------------
# the promotion-veto artifact


def write_alerts_artifact(path, statuses, *, extra_alerts=(),
                          clock=time.time) -> Path | None:
    """Atomically write ``alerts.json`` — the machine-readable veto the
    promotion tooling checks before rolling a checkpoint into serving.
    ``promotion_vetoed`` is true while ANY alert fires. Never raises (the caller counts a
    drop on None)."""
    try:
        rows = list(statuses) + [dict(a) for a in extra_alerts]
        firing = sorted(r["slo"] for r in rows if r.get("alert"))
        doc = {
            "schema": 1,
            "generated_at_unix": int(clock()),
            "alerts": rows,
            "firing": firing,
            "promotion_vetoed": bool(firing),
        }
        path = Path(path)
        if path.parent != Path(""):
            path.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_text(path, json.dumps(doc, indent=2, sort_keys=True)
                          + "\n")
        return path
    except Exception:  # noqa: BLE001 — the veto artifact is advisory output
        return None


def read_promotion_veto(path, *, max_age_s: float = 3600.0,
                        clock=time.time) -> dict:
    """The consuming half of :func:`write_alerts_artifact`: the promotion
    controller's veto check, and it is fail-closed. A missing, torn
    (unparseable or of the wrong shape) or stale (``generated_at_unix``
    older than ``max_age_s``) ``alerts.json`` is no veto evidence, and no
    evidence refuses. Only a fresh, well-formed artifact with
    ``promotion_vetoed`` false gives ``allow=True``.

    Returns ``{"allow", "reason", "vetoed", "age_s", "firing"}``;
    ``vetoed``/``age_s`` are None when the artifact could not be read.
    Never raises."""
    refusal = {"allow": False, "vetoed": None, "age_s": None, "firing": []}
    if path is None:
        return {**refusal, "reason": "missing"}
    try:
        text = Path(path).read_text()
    except (FileNotFoundError, OSError):
        return {**refusal, "reason": "missing"}
    try:
        doc = json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return {**refusal, "reason": "torn"}
    if (not isinstance(doc, dict) or doc.get("schema") != 1
            or not isinstance(doc.get("generated_at_unix"), (int, float))
            or "promotion_vetoed" not in doc):
        return {**refusal, "reason": "torn"}
    age_s = float(clock()) - float(doc["generated_at_unix"])
    firing = doc.get("firing") or []
    if age_s > max_age_s:
        return {**refusal, "reason": "stale", "age_s": round(age_s, 3),
                "vetoed": bool(doc["promotion_vetoed"]), "firing": firing}
    if doc["promotion_vetoed"]:
        return {"allow": False, "reason": "vetoed", "vetoed": True,
                "age_s": round(age_s, 3), "firing": firing}
    return {"allow": True, "reason": "fresh", "vetoed": False,
            "age_s": round(age_s, 3), "firing": firing}
