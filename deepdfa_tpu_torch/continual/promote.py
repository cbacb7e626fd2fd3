"""Automated checkpoint promotion.

A copy of ``deepdfa_tpu/continual/promote.py``.
:class:`PromotionController` is the only path a candidate ``model_rev``
takes to the serving ring, and it is fail-closed end to end:

1. **Veto check**: :func:`deepdfa_tpu_torch.obs.slo.read_promotion_veto`
   over ``alerts.json``: a vetoed, missing, torn or stale artifact refuses
   (no veto evidence is not permission).
2. **Shadow gate**: the candidate's ``shadow_report.json`` must pass
   (:func:`deepdfa_tpu_torch.continual.shadow.shadow_gate`).
3. **Warm staging**: :func:`stage_candidate` exports the candidate's
   bucket ladder into the warm store under its content-addressed keys, so
   every join during the roll is a store hit.
4. **Replica-by-replica roll** through the router's membership protocol:
   spawn candidate → warm join (``join_cold_compiles`` must be 0) → ring
   entry → only then drain one prior replica. The ring is never empty and
   no healthy replica is hard-killed.
5. **Drift watch**: after the roll, the per-``(model_rev, tier)`` drift
   alert is polled against the new rev; a firing alert (or the injected
   ``continual.rollback_trigger``) rolls the fleet back to the prior rev
   the same replica-by-replica way.

The brownout gate reads each target's ``/healthz`` ``brownout_level`` (a
cell router aggregates the worst backend level, a single replica reports
its own; an unreachable target reads as level 0: brownout is a pressure
signal, and liveness is the roll's own probe's job). The controller never
deploys into an overloaded target.

Every decision is journaled as ``event="promotion_transition"`` and
flight-mirrored, and neither sink may fail the roll. Progress also lands
in a crash-state journal (``RunJournal``) after every membership change,
so a controller that dies mid-rollout (``continual.rollout_crash``) can be
resumed: :meth:`PromotionController.converge` reads the state and drives
the fleet to a consistent end (rollback to the prior rev) without cold
compiles or surfaced 5xx.
"""

from __future__ import annotations

import os
import re
import signal
import time

from deepdfa_tpu_torch.obs.slo import read_promotion_veto
from deepdfa_tpu_torch.resilience import faults

from .shadow import shadow_gate

__all__ = ["PromotionController", "stage_candidate", "drift_alert_firing"]

_DRIFT_ALERT_RE = re.compile(
    r'score_drift_alert\{[^}]*model_rev="([^"]+)"[^}]*\}\s+([0-9.eE+-]+)')


def drift_alert_firing(metrics_text: str, rev: str) -> bool:
    """True when any ``score_drift_alert`` sample for ``rev`` (including
    its per-tier ``rev@t1``/``rev@t2`` keys) is set in a /metrics page."""
    for label_rev, value in _DRIFT_ALERT_RE.findall(metrics_text or ""):
        if label_rev == rev or label_rev.startswith(rev + "@"):
            try:
                if float(value) >= 1.0:
                    return True
            except ValueError:
                continue
    return False


def stage_candidate(engine, warm_store, journal=None) -> dict:
    """Export the candidate engine's compiled bucket ladder into the warm
    store (invariant 11: content-addressed on vocab hash, model_rev,
    precision, label style, feature keys, and bucket shape) so every
    replica spawned during the roll warms with zero cold compiles."""
    report = engine.warmup(warm_store=warm_store, journal=journal)
    return {"buckets": report.get("buckets"),
            "hits": report.get("hits"), "misses": report.get("misses"),
            "model_rev": getattr(engine, "model_rev", None)}


def _handle_pid(handle) -> int | None:
    """OS pid of a launcher handle (SubprocessReplica keeps it on
    ``.proc``); None for fakes without one."""
    pid = getattr(handle, "pid", None)
    if pid is None:
        pid = getattr(getattr(handle, "proc", None), "pid", None)
    return pid


def _default_rev_probe(name: str, timeout: float = 5.0) -> str | None:
    """model_rev from a backend's /healthz (the roll's source of truth
    for which rev a ring member serves)."""
    import http.client
    import json as _json

    host, port = name.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        body = _json.loads(resp.read() or b"{}")
        return body.get("model_rev")
    except (OSError, ValueError):
        return None
    finally:
        conn.close()


def _default_brownout_probe(name: str, timeout: float = 5.0) -> int:
    """``brownout_level`` from a target's /healthz (a cell router
    aggregates the worst backend level; a single replica reports its
    own). An unreachable target reads as level 0 — brownout is a
    *pressure* signal, and liveness is the roll's own probe's job."""
    import http.client
    import json as _json

    host, port = name.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", "/healthz")
        body = _json.loads(conn.getresponse().read() or b"{}")
        return int(body.get("brownout_level") or 0)
    except (OSError, ValueError):
        return 0
    finally:
        conn.close()


def _default_drift_probe(name: str, timeout: float = 5.0) -> str:
    import http.client

    host, port = name.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", "/metrics")
        return conn.getresponse().read().decode("utf-8", "replace")
    except OSError:
        return ""
    finally:
        conn.close()


class PromotionController:
    """Drives one candidate rev through veto check → shadow gate → warm
    roll → drift watch, with journaled decisions and crash-resumable
    state.

    ``router`` needs the membership triple ``add_backend`` /
    ``remove_backend`` / ``probe_once`` — a live
    :class:`~deepdfa_tpu_torch.serve.router.FleetRouter` and the HTTP
    :class:`~deepdfa_tpu_torch.serve.autoscaler.AdminRouterClient` twin both
    qualify, so the controller can run in-process or out-of-process.
    ``candidate_launcher`` / ``prior_launcher`` spawn replicas serving
    the respective rev (the autoscaler's ``SubprocessLauncher`` shape:
    ``spawn() -> handle`` with ``name``/``pid``/``join_cold_compiles``/
    ``drain``)."""

    def __init__(self, router, candidate_launcher, prior_launcher, *,
                 candidate_rev: str, prior_rev: str,
                 alerts_path=None, veto_max_age_s: float = 3600.0,
                 state_journal=None, journal=None, flight=None,
                 rev_probe=None, drift_probe=None,
                 brownout_probe=None, brownout_targets=None,
                 brownout_pause_timeout_s: float = 60.0,
                 drift_settle_polls: int = 3, poll_interval_s: float = 0.5,
                 join_timeout_s: float = 120.0,
                 clock=time.monotonic, sleep=time.sleep,
                 wall_clock=time.time):
        self._router = router
        self._candidate_launcher = candidate_launcher
        self._prior_launcher = prior_launcher
        self.candidate_rev = candidate_rev
        self.prior_rev = prior_rev
        self._alerts_path = alerts_path
        self._veto_max_age_s = veto_max_age_s
        self._state = state_journal
        self._journal = journal
        self._flight = flight
        self._rev_probe = rev_probe or _default_rev_probe
        self._drift_probe = drift_probe or _default_drift_probe
        # brownout coordination: the controller never deploys INTO an
        # overloaded target. Targets are
        # the cells (or replicas) whose /healthz brownout_level gates the
        # roll — an iterable of "host:port" names or a zero-arg callable
        # returning one; None leaves the gate off (single-cell deploys
        # that predate federation keep their exact behaviour).
        self._brownout_probe = brownout_probe or _default_brownout_probe
        self._brownout_targets = brownout_targets
        self._brownout_pause_timeout_s = brownout_pause_timeout_s
        self._settle_polls = max(1, drift_settle_polls)
        self._poll_interval_s = poll_interval_s
        self._join_timeout_s = join_timeout_s
        self._clock = clock
        self._sleep = sleep
        self._wall_clock = wall_clock
        self.decisions: list[dict] = []
        self.join_cold_compiles = 0
        self.rollback_total = 0
        self._handles: dict[str, object] = {}  # name -> launcher handle

    def adopt(self, handle) -> None:
        """Register an already-running replica's launcher handle (the
        prior fleet this controller did not spawn) so its retirement can
        flag-drain the process (invariant 22) instead of merely dropping
        the name from the ring."""
        self._handles[handle.name] = handle

    # -- bookkeeping (invariant 20: recording never fails the roll) ---------

    def _record(self, action: str, **fields) -> dict:
        decision = {"action": action, "t": round(self._clock(), 3),
                    "candidate_rev": self.candidate_rev,
                    "prior_rev": self.prior_rev, **fields}
        self.decisions.append(decision)
        if self._journal is not None:
            try:
                self._journal.write(event="promotion_transition", **decision)
            except Exception:  # noqa: BLE001 — a dead journal sink must
                # not fail the promotion it records
                pass
        if self._flight is not None:
            try:
                self._flight.record(f"promotion.{action}", **fields)
            except Exception:  # noqa: BLE001 — same no-fail rule
                pass
        return decision

    def _save_state(self, phase: str, **extra) -> None:
        if self._state is None:
            return
        try:
            self._state.write(
                event="promotion_state", phase=phase,
                candidate_rev=self.candidate_rev, prior_rev=self.prior_rev,
                t_unix=int(self._wall_clock()),
                joined=[{"name": n, "pid": _handle_pid(h)}
                        for n, h in self._handles.items()], **extra)
        except Exception:  # noqa: BLE001 — state is resume metadata, not
            # a gate; losing it degrades resume, never the roll itself
            pass

    # -- ring introspection -------------------------------------------------

    def _ring_by_rev(self) -> dict[str, list[str]]:
        """{rev: [backend names]} for every current ring member (the
        /healthz ``model_rev`` is the classification authority)."""
        by_rev: dict[str, list[str]] = {}
        for name in sorted(self._router.probe_once()):
            rev = self._rev_probe(name) or "unknown"
            by_rev.setdefault(rev, []).append(name)
        return by_rev

    def _wait_ready(self, name: str) -> bool:
        deadline = self._clock() + self._join_timeout_s
        while self._clock() < deadline:
            if self._router.probe_once().get(name) == "ready":
                return True
            self._sleep(min(self._poll_interval_s, 0.05))
        return False

    # -- gates --------------------------------------------------------------

    def _worst_brownout(self) -> tuple[int, str | None]:
        """Worst ``brownout_level`` any target cell reports, and which
        cell. Probe failures read as level 0 (pressure signal, not a
        liveness gate)."""
        targets = self._brownout_targets
        if targets is None:
            return 0, None
        if callable(targets):
            targets = targets()
        worst, worst_name = 0, None
        for name in targets:
            try:
                level = int(self._brownout_probe(name) or 0)
            except Exception:  # noqa: BLE001 — an unprobeable target is
                # not browned out; cell liveness is the roll's own problem
                level = 0
            if level > worst:
                worst, worst_name = level, name
        return worst, worst_name

    def check_gates(self, shadow_report=None) -> dict | None:
        """Refusal decision, or None when every gate passes. Order
        matters: the veto is the operator's hand on the big red button
        and is checked first; the brownout gate refuses to START a roll
        into any target cell already shedding load (a deploy spends
        spawn/compile/drain capacity exactly when the cell has none)."""
        veto = read_promotion_veto(self._alerts_path,
                                   max_age_s=self._veto_max_age_s,
                                   clock=self._wall_clock)
        if not veto["allow"]:
            return self._record("refused", gate="veto",
                                reason=veto["reason"], veto=veto)
        level, name = self._worst_brownout()
        if level > 0:
            return self._record(
                "refused", gate="brownout",
                reason=f"target {name} reports brownout_level {level}",
                brownout_level=level, target=name)
        allow, reason = shadow_gate(shadow_report)
        if not allow:
            return self._record("refused", gate="shadow", reason=reason)
        return None

    def _await_brownout_clear(self) -> None:
        """Mid-roll pause: before each membership change the roll re-reads
        the target cells' brownout level and HOLDS while any is > 0 —
        resuming when it clears, raising (→ rollout_failed → rollback)
        when the pause outlives ``brownout_pause_timeout_s``. Both
        transitions are journaled/flight-mirrored (invariant 20)."""
        level, name = self._worst_brownout()
        if level <= 0:
            return
        self._record("paused", gate="brownout", brownout_level=level,
                     target=name)
        self._save_state("paused", brownout_level=level, target=name)
        deadline = self._clock() + self._brownout_pause_timeout_s
        while self._clock() < deadline:
            self._sleep(self._poll_interval_s)
            level, name = self._worst_brownout()
            if level <= 0:
                self._record("resumed", gate="brownout")
                self._save_state("rolling")
                return
        raise RuntimeError(
            f"brownout pause exceeded {self._brownout_pause_timeout_s}s "
            f"(target {name} still at level {level})")

    # -- the roll -----------------------------------------------------------

    def _join_one(self, launcher, rev: str) -> object:
        """Spawn one replica of ``rev``, verify its warm join, enter the
        ring, wait ready. Raises RuntimeError on any admission failure —
        the caller owns the rollback decision."""
        handle = launcher.spawn()
        self._handles[handle.name] = handle
        cold = getattr(handle, "join_cold_compiles", 0) or 0
        self.join_cold_compiles += cold
        self._router.add_backend(handle.name)
        if not self._wait_ready(handle.name):
            raise RuntimeError(
                f"replica {handle.name} ({rev}) never reached ready within "
                f"{self._join_timeout_s}s")
        self._record("warm_join", backend=handle.name, rev=rev,
                     join_cold_compiles=cold)
        # state BEFORE the next membership change: a controller that dies
        # right after this join leaves the new replica's pid on record, so
        # converge() can retire the orphan
        self._save_state("rolling")
        return handle

    def _retire_one(self, name: str, pid=None) -> None:
        """Ring exit first, then flag-only drain (invariant 22: never a
        hard kill of a healthy replica)."""
        self._router.remove_backend(name)
        handle = self._handles.pop(name, None)
        if handle is not None:
            try:
                handle.drain()
            except Exception:  # noqa: BLE001 — an already-dead replica
                # drains vacuously
                pass
        elif pid:
            try:
                os.kill(int(pid), signal.SIGTERM)
            except (OSError, ValueError):
                pass
        self._record("drained", backend=name)

    def promote(self, shadow_report=None) -> dict:
        """The full promotion: gates → replica-by-replica roll → drift
        watch → complete or rollback. Returns a summary dict."""
        t0 = self._clock()
        refused = self.check_gates(shadow_report)
        if refused is not None:
            return self.summary(completed=False, refused=True,
                                rollout_seconds=self._clock() - t0)
        prior = list(self._ring_by_rev().get(self.prior_rev, []))
        self._record("rollout_start", prior_backends=prior)
        self._save_state("rolling", remaining_prior=prior)
        try:
            for i, old_name in enumerate(prior):
                # brownout hold point: a roll caught by load mid-flight
                # pauses BEFORE the next membership change and resumes
                # when the cells recover. Rollback deliberately does NOT
                # pause — restoring known-good capacity during a brownout
                # is the correct move, not a deploy.
                self._await_brownout_clear()
                self._join_one(self._candidate_launcher, self.candidate_rev)
                # the chaos point: a controller hard-exit between a
                # candidate's warm join and the prior replica's retirement
                # — exactly the window a crash leaves the fleet mixed-rev
                faults.crash_if("continual.rollout_crash")
                self._retire_one(old_name)
                self._save_state("rolling", remaining_prior=prior[i + 1:])
        except Exception as exc:  # noqa: BLE001 — any roll failure
            # (spawn, join timeout, admin error) rolls the fleet back
            self._record("rollout_failed",
                         reason=f"{type(exc).__name__}: {exc}")
            self.rollback()
            return self.summary(completed=False, rolled_back=True,
                                rollout_seconds=self._clock() - t0)
        self._save_state("rolled")
        self._record("rolled", rollout_seconds=round(self._clock() - t0, 3))
        if not self._drift_settled():
            self.rollback()
            return self.summary(completed=False, rolled_back=True,
                                rollout_seconds=self._clock() - t0)
        self._save_state("complete")
        self._record("complete",
                     rollout_seconds=round(self._clock() - t0, 3))
        return self.summary(completed=True,
                            rollout_seconds=self._clock() - t0)

    def _drift_settled(self) -> bool:
        """Post-roll watch: ``drift_settle_polls`` consecutive clean polls
        of every ring member's drift SLO against the NEW rev. A firing
        alert — or the injected ``continual.rollback_trigger`` — fails
        the watch."""
        for _ in range(self._settle_polls):
            if faults.fire("continual.rollback_trigger"):
                self._record("drift_alert", rev=self.candidate_rev,
                             injected=True)
                return False
            for name in sorted(self._router.probe_once()):
                text = self._drift_probe(name)
                if drift_alert_firing(text, self.candidate_rev):
                    self._record("drift_alert", rev=self.candidate_rev,
                                 backend=name)
                    return False
            self._sleep(self._poll_interval_s)
        self._record("drift_settled", rev=self.candidate_rev,
                     polls=self._settle_polls)
        return True

    def rollback(self) -> dict:
        """Restore the prior rev replica-by-replica: join a prior-rev
        replica for every candidate member, then retire the candidate —
        the same never-empty, warm-join-only discipline as the forward
        roll."""
        self.rollback_total += 1
        self._record("rollback_start")
        self._save_state("rolling_back")
        by_rev = self._ring_by_rev()
        candidates = list(by_rev.get(self.candidate_rev, []))
        for name in candidates:
            self._join_one(self._prior_launcher, self.prior_rev)
            self._retire_one(name)
        if not by_rev.get(self.prior_rev) and not candidates:
            # a crash before ANY membership change: nothing to undo, but
            # the floor must hold — ensure at least one prior replica
            self._join_one(self._prior_launcher, self.prior_rev)
        self._save_state("rolled_back")
        self._record("rollback_complete",
                     restored_rev=self.prior_rev)
        return self.summary(completed=False, rolled_back=True)

    # -- crash resume -------------------------------------------------------

    def converge(self, state: dict | None = None) -> dict:
        """Resume after a mid-rollout controller death. Reads the state
        journal (or an explicit ``state`` record): a roll that reached
        ``complete`` needs nothing; anything in flight converges by
        ROLLING BACK to the prior rev — the conservative end state, since
        a dead controller cannot have finished its drift watch. Orphaned
        candidate replicas recorded in the state are retired by pid."""
        if state is None and self._state is not None:
            state = self._state.read()
        phase = (state or {}).get("phase")
        if phase == "complete":
            self._record("converged", outcome="already_complete")
            return self.summary(completed=True, converged=True)
        # retire-by-pid metadata for replicas whose handles died with the
        # old controller process
        orphan_pids = {row.get("name"): row.get("pid")
                       for row in (state or {}).get("joined", [])}
        self._record("converge_start", phase=phase or "unknown")
        self.rollback_total += 1
        self._record("rollback_start", resumed=True)
        by_rev = self._ring_by_rev()
        candidates = list(by_rev.get(self.candidate_rev, []))
        for name in candidates:
            self._join_one(self._prior_launcher, self.prior_rev)
            self._retire_one(name, pid=orphan_pids.get(name))
        if not self._ring_by_rev().get(self.prior_rev):
            self._join_one(self._prior_launcher, self.prior_rev)
        self._save_state("rolled_back")
        self._record("rollback_complete", restored_rev=self.prior_rev,
                     resumed=True)
        return self.summary(completed=False, rolled_back=True,
                            converged=True)

    def summary(self, **extra) -> dict:
        by_rev = {}
        try:
            by_rev = self._ring_by_rev()
        except Exception:  # noqa: BLE001 — summary is reporting, and the
            # router may already be gone at teardown
            pass
        return {"candidate_rev": self.candidate_rev,
                "prior_rev": self.prior_rev,
                "join_cold_compiles": self.join_cold_compiles,
                "rollback_total": self.rollback_total,
                "ring_by_rev": by_rev,
                "decisions": list(self.decisions), **extra}
