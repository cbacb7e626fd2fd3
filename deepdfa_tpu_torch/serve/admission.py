"""Admission control, QoS classes, and brownout mode — the serving
fleet's explicit overload behavior. The port of
``deepdfa_tpu/serve/admission.py``: the same decisions, Retry-After
values and journal events for the same clock and inputs.

Three pieces, layered in front of the frontend encode pool so load is
shed *before* encode cost is paid:

- :class:`TokenBucket` — per-(tenant, class) refill buckets. The
  Retry-After a shed request carries is derived from the bucket's refill
  state (the ceil of the token deficit over the refill rate), a pure
  function of bucket state — never wall-clock randomness (invariant 5).
- :class:`AdmissionController` — the per-request admit/shed decision:
  two priority classes (``interactive`` score vs ``batch`` rescore,
  tagged per-request), deadline-aware shedding off the frontend
  queue-wait p99 and queue-depth signals, and the brownout level. A shed
  is ALWAYS a 429 + deterministic Retry-After, never a 5xx, and every
  decision is journaled and mirrored into the flight ring under
  invariant 20's no-fail rule (sinks may drop, never raise).
- :class:`BrownoutController` — the same hysteresis/streak/cooldown
  decision shape as the autoscaler (``serve/autoscaler.py``), stepping
  through declared degradation levels under sustained SLO burn instead
  of replica counts: level 1 sheds the batch class, level 2 additionally
  serves warm-cache hits + tier-1 only (no cascade escalation), level 3
  sheds interactive as the last resort. Each transition is journaled as
  a ``brownout_transition`` event and ``/healthz`` reports the level
  honestly.

The interactive class sheds last (invariant candidate 30): batch gets
the smaller token budget, the depth guard binds batch only, and the
brownout ladder reaches interactive only at its final level.

Chaos points (``DEEPDFA_FAULTS``): ``admission.bucket_exhausted`` drains
one bucket at admission, ``admission.deadline_blown`` forces one
deadline check to judge the wait as blown, ``admission.brownout_force``
pushes the brownout controller one level deeper on its next poll — all
three must degrade to the declared 429/brownout behavior, never a 5xx.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque

from deepdfa_tpu_torch.resilience import faults

__all__ = [
    "QOS_CLASSES",
    "BROWNOUT_LEVELS",
    "BROWNOUT_SHED_BATCH",
    "BROWNOUT_TIER1_ONLY",
    "BROWNOUT_SHED_INTERACTIVE",
    "TokenBucket",
    "AdmissionController",
    "BrownoutController",
]

logger = logging.getLogger(__name__)

# the two priority classes, in shed order LAST to FIRST: batch (rescore
# traffic) sheds first, interactive (a human waiting on a score) last
QOS_CLASSES = ("interactive", "batch")

# the declared brownout ladder; each level includes everything above it
BROWNOUT_SHED_BATCH = 1  # shed the batch class
BROWNOUT_TIER1_ONLY = 2  # + serve warm-cache hits + tier-1 only
BROWNOUT_SHED_INTERACTIVE = 3  # + shed interactive (last resort)
BROWNOUT_LEVELS = {
    0: "normal",
    BROWNOUT_SHED_BATCH: "shed_batch",
    BROWNOUT_TIER1_ONLY: "cache_tier1_only",
    BROWNOUT_SHED_INTERACTIVE: "shed_interactive",
}

# bounded decision memory on both controllers: sustained overload sheds
# thousands of requests and the server is long-lived, so raw decisions
# ride a ring while the summary() counters stay exact
DECISION_RING = 4096


class TokenBucket:
    """One refill bucket. All state transitions go through the injected
    clock, so tests drive time explicitly and Retry-After is exactly
    reproducible: it is the ceil of the token deficit over the refill
    rate — the earliest whole second at which a retry can succeed."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t_last = clock()
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:
        self._tokens = min(
            self.burst, self._tokens + max(0.0, now - self._t_last) * self.rate)
        self._t_last = now

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked(self._clock())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def drain(self) -> None:
        """Empty the bucket (the ``admission.bucket_exhausted`` chaos
        point uses this so the fault exercises the REAL shed path)."""
        with self._lock:
            self._refill_locked(self._clock())
            self._tokens = 0.0

    def tokens(self) -> float:
        with self._lock:
            self._refill_locked(self._clock())
            return self._tokens

    def retry_after_s(self, n: float = 1.0) -> int:
        """Whole seconds until the bucket holds ``n`` tokens — pure
        function of (deficit, rate), floor 1 (RFC 7231 Retry-After is an
        integer and "retry immediately" is never the answer to a shed)."""
        with self._lock:
            self._refill_locked(self._clock())
            deficit = max(0.0, n - self._tokens)
        return max(1, math.ceil(deficit / self.rate))


class AdmissionController:
    """The per-request admit/shed decision, in signal-priority order:
    brownout class policy, then the (tenant, class) token bucket, then
    the deadline check against the observed frontend queue-wait p99 and
    the queue-depth guard. Decision dicts carry everything the bench
    gates on: class, tenant, reason, Retry-After, and the brownout level
    at decision time (the "only batch sheds before brownout escalates"
    gate reads that field)."""

    def __init__(self, cfg, metrics=None, journal=None, flight=None,
                 clock=time.monotonic):
        self.cfg = cfg
        self.metrics = metrics
        self.journal = journal
        self.flight = flight
        self._clock = clock
        self.brownout: BrownoutController | None = None
        self._lock = threading.Lock()
        self._buckets: dict[tuple[str, str], TokenBucket] = {}
        self._decisions: deque[dict] = deque(maxlen=DECISION_RING)
        self._admitted: dict[str, int] = {}
        self._shed: dict[str, int] = {}
        self._shed_reasons: dict[str, int] = {}
        # interactive sheds while the brownout ladder had NOT reached its
        # last level — the "interactive sheds last" gate counts these
        # exactly (the decision ring is bounded; this counter is not)
        self._early_interactive_sheds = 0
        self._journal_drops = 0
        self._t0 = clock()

    # -- buckets -------------------------------------------------------------

    def _bucket(self, tenant: str, klass: str) -> TokenBucket:
        with self._lock:
            bucket = self._buckets.get((tenant, klass))
            if bucket is None:
                cfg = self.cfg
                rate, burst = (
                    (cfg.interactive_rate, cfg.interactive_burst)
                    if klass == "interactive"
                    else (cfg.batch_rate, cfg.batch_burst))
                bucket = TokenBucket(rate, burst, clock=self._clock)
                self._buckets[(tenant, klass)] = bucket
            return bucket

    # -- the decision --------------------------------------------------------

    def level(self) -> int:
        return self.brownout.level if self.brownout is not None else 0

    def admit(self, tenant: str, klass: str) -> dict:
        """One request's verdict: ``{"admit": True, ...}`` or a shed dict
        with ``reason`` and a deterministic ``retry_after_s``."""
        level = self.level()
        bucket = self._bucket(tenant, klass)
        # brownout class policy first: a browned-out class sheds without
        # consuming a token (its budget stays intact for recovery)
        if klass == "batch" and level >= BROWNOUT_SHED_BATCH:
            return self._shed_decision(tenant, klass, "brownout", bucket, level)
        if klass == "interactive" and level >= BROWNOUT_SHED_INTERACTIVE:
            return self._shed_decision(tenant, klass, "brownout", bucket, level)
        if faults.fire("admission.bucket_exhausted"):
            bucket.drain()  # the fault drives the REAL exhaustion path
        if not bucket.try_take():
            return self._shed_decision(
                tenant, klass, "bucket_exhausted", bucket, level)
        if self._deadline_blown(klass):
            return self._shed_decision(
                tenant, klass, "deadline_blown", bucket, level)
        with self._lock:
            self._admitted[klass] = self._admitted.get(klass, 0) + 1
        if self.metrics is not None:
            self.metrics.observe_admission(klass, admitted=True)
        return {"admit": True, "class": klass, "tenant": tenant,
                "level": level}

    def _deadline_blown(self, klass: str) -> bool:
        """Deadline-aware shedding off the signals that already exist:
        the frontend queue-wait reservoir p99 (the admission layer,
        autoscaler and /healthz all read this one surface) and the
        queue-depth guard, which binds the batch class only — depth
        pressure is exactly when batch must yield to interactive."""
        if faults.fire("admission.deadline_blown"):
            return True
        cfg, m = self.cfg, self.metrics
        if m is None:
            return False
        deadline_ms = (cfg.interactive_deadline_ms if klass == "interactive"
                       else cfg.batch_deadline_ms)
        wait_p99 = m.frontend_queue_wait.quantile(0.99)
        if wait_p99 is not None and wait_p99 > deadline_ms:
            return True
        if klass == "batch" and cfg.depth_shed_factor > 0:
            if m.frontend_queue_depth > cfg.depth_shed_factor * cfg.batch_burst:
                return True
        return False

    def _shed_decision(self, tenant: str, klass: str, reason: str,
                       bucket: TokenBucket, level: int) -> dict:
        retry_after = bucket.retry_after_s()
        decision = {
            "admit": False, "class": klass, "tenant": tenant,
            "reason": reason, "retry_after_s": retry_after, "level": level,
            "t": round(self._clock() - self._t0, 3),
        }
        with self._lock:
            self._decisions.append(decision)
            self._shed[klass] = self._shed.get(klass, 0) + 1
            self._shed_reasons[reason] = self._shed_reasons.get(reason, 0) + 1
            if (klass == "interactive"
                    and level < BROWNOUT_SHED_INTERACTIVE):
                self._early_interactive_sheds += 1
        if self.metrics is not None:
            self.metrics.observe_admission(klass, admitted=False)
        if self.journal is not None:
            try:
                self.journal.write(event="admission_shed", **{
                    k: v for k, v in decision.items() if k != "admit"})
            except Exception:  # noqa: BLE001 — invariant 20: sinks never
                # fail the decision they record; drops are counted
                with self._lock:
                    self._journal_drops += 1
                logger.warning("admission journal write dropped")
        if self.flight is not None:
            self.flight.record("admission.shed", **{
                k: v for k, v in decision.items() if k != "admit"})
        return decision

    # -- observability -------------------------------------------------------

    def summary(self) -> dict:
        """The bench/artifact view: exact per-class counters plus the
        recent decision ring (bounded — counters, not the ring, are the
        totals)."""
        with self._lock:
            return {
                "admitted": dict(self._admitted),
                "shed": dict(self._shed),
                "shed_reasons": dict(self._shed_reasons),
                "shed_total": sum(self._shed.values()),
                "interactive_sheds_before_brownout":
                    self._early_interactive_sheds,
                "journal_drops": self._journal_drops,
                "decisions": [dict(d) for d in self._decisions],
            }


class BrownoutController:
    """The brownout decision loop: hysteresis watermarks over the worst
    fast-window SLO burn, consecutive-poll streaks, and a post-action
    cooldown — :meth:`poll_once` is shape-for-shape the autoscaler's
    ``_decide_scale``, stepping a degradation level instead of a replica
    count. ``burn_fn`` is the signal source (the server passes its own
    SLO engine's worst fast burn; tests inject a script)."""

    def __init__(self, cfg, burn_fn, metrics=None, journal=None, flight=None,
                 clock=time.monotonic):
        self._cfg = cfg
        self._burn_fn = burn_fn
        self._metrics = metrics
        self._journal = journal
        self._flight = flight
        self._clock = clock
        self._lock = threading.Lock()
        self._level = 0
        self._streak_up = 0
        self._streak_down = 0
        self._last_action_t: float | None = None
        self._transitions: deque[dict] = deque(maxlen=DECISION_RING)
        self._transitions_total = 0
        self._journal_drops = 0
        self._t0 = clock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    @property
    def level_name(self) -> str:
        return BROWNOUT_LEVELS[self.level]

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "BrownoutController":
        self._thread = threading.Thread(target=self._run, name="brownout",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._cfg.poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the controller never dies
                logger.exception("brownout poll failed; continuing")

    def stop(self) -> dict:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        return self.summary()

    # -- one decision tick ---------------------------------------------------

    def poll_once(self) -> list[dict]:
        """One tick: chaos first (``admission.brownout_force`` pushes one
        level deeper regardless of burn — the honest-degradation paths
        must hold even when the signal lies), then the hysteresis
        decision over the observed burn."""
        if faults.fire("admission.brownout_force"):
            with self._lock:
                level = self._level
            if level >= self._cfg.max_level:
                return []
            return [self._transition(level, level + 1, burn=None,
                                     reason="fault_injected")]
        burn = self._burn_fn()
        if burn is None:
            return []
        now = self._clock()
        cfg = self._cfg
        with self._lock:
            # hysteresis: streaks advance only outside the dead band, and
            # any excursion into the opposite band resets the other side
            if burn >= cfg.burn_high:
                self._streak_up += 1
                self._streak_down = 0
            elif burn <= cfg.burn_low:
                self._streak_down += 1
                self._streak_up = 0
            else:
                self._streak_up = 0
                self._streak_down = 0
            up = self._streak_up >= cfg.up_consecutive
            down = self._streak_down >= cfg.down_consecutive
            cooling = (self._last_action_t is not None
                       and now - self._last_action_t < cfg.cooldown_s)
            level = self._level
        if cooling or not (up or down):
            return []
        if up:
            if level >= cfg.max_level:
                self._reset_streaks()
                return []
            return [self._transition(level, level + 1, burn=burn,
                                     reason="burn_high")]
        if level <= 0:
            self._reset_streaks()
            return []
        return [self._transition(level, level - 1, burn=burn,
                                 reason="burn_low")]

    def _reset_streaks(self, acted: bool = False) -> None:
        with self._lock:
            self._streak_up = 0
            self._streak_down = 0
            if acted:
                self._last_action_t = self._clock()

    def _transition(self, level_from: int, level_to: int,
                    burn: float | None, reason: str) -> dict:
        transition = {
            "level_from": level_from, "level_to": level_to,
            "level_name": BROWNOUT_LEVELS[level_to], "reason": reason,
            "burn": round(burn, 3) if burn is not None else None,
            "t": round(self._clock() - self._t0, 3),
        }
        with self._lock:
            self._level = level_to
            self._transitions.append(transition)
            self._transitions_total += 1
        self._reset_streaks(acted=True)
        if self._metrics is not None:
            self._metrics.set_gauge("brownout_level", level_to)
            self._metrics.inc("brownout_transitions_total")
        if self._journal is not None:
            try:
                self._journal.write(event="brownout_transition", **transition)
            except Exception:  # noqa: BLE001 — invariant 20
                with self._lock:
                    self._journal_drops += 1
                logger.warning("brownout journal write dropped")
        if self._flight is not None:
            self._flight.record("brownout.transition", **transition)
        logger.warning("brownout %s -> %s (%s)",
                       BROWNOUT_LEVELS[level_from], BROWNOUT_LEVELS[level_to],
                       reason)
        return transition

    # -- observability -------------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            return {
                "level": self._level,
                "level_name": BROWNOUT_LEVELS[self._level],
                "max_level_seen": max(
                    (t["level_to"] for t in self._transitions),
                    default=self._level),
                "transitions": [dict(t) for t in self._transitions],
                "transitions_total": self._transitions_total,
                "journal_drops": self._journal_drops,
            }
