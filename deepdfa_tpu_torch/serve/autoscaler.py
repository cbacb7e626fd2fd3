"""The fleet autoscaler and its replica launcher.

The port of ``deepdfa_tpu/serve/autoscaler.py``: the same decisions for the
same burn series, launcher and clock. The :class:`Autoscaler` supervises a
set of ``ScoreServer`` replicas (each ``python -m
deepdfa_tpu_torch.serve.server ...``, scoring on the card) behind a
:class:`~deepdfa_tpu_torch.serve.router.FleetRouter`. Each poll it

1. **heals** — a replica whose process died (``kill -9``, OOM) leaves the
   ring and is replaced; the replacement warm-joins through the warm store
   and enters the ring only once the router's readiness probe finds it
   warm. Healing is not subject to the scale cooldown: a dead replica is
   replaced at once, within ``serve.autoscale.replace_deadline_s``;
2. **observes** — scrapes every live replica's ``/slo`` and takes the
   worst fast-window burn rate as the fleet's load signal;
3. **decides** — hysteresis watermarks (``burn_high``/``burn_low``) with
   consecutive-poll streaks and a post-action cooldown, so a flapping burn
   never oscillates the fleet; the replica count is clamped to
   ``[min_replicas, max_replicas]``.

Scale-down leaves the ring first, then drains through the replica's
flag-only SIGTERM path: the autoscaler never hard-kills a healthy replica.
Spawns retry with deterministic backoff through
:mod:`deepdfa_tpu_torch.resilience.retry`; exhaustion journals a give-up.
Every decision is journaled as an ``autoscale_transition`` event and
mirrored into the flight ring (neither sink may fail the decision).

The launcher (:class:`SubprocessLauncher`, :class:`SubprocessReplica`,
:class:`SpawnError`) waits for each replica's ``{"status": "serving",
...}`` line, which carries the bound port and the warm-store join report;
the promotion controller (:mod:`deepdfa_tpu_torch.continual.promote`)
spawns through it too. :class:`AdminRouterClient` is the HTTP twin of the
router's membership surface. A handle's ``drain()`` is the flag-only
SIGTERM path; ``kill()`` is SIGKILL and exists for chaos only.

Chaos points (``DEEPDFA_FAULTS``): ``autoscale.spawn_fail`` fails a launch
inside the retry loop; ``autoscale.replica_crash`` kill -9's one managed
replica mid-load, driving the heal path deterministically.
"""

from __future__ import annotations

import http.client
import json
import logging
import re
import signal
import subprocess
import threading
import time
from collections import deque

from deepdfa_tpu_torch.config import AutoscaleConfig
from deepdfa_tpu_torch.resilience import faults
from deepdfa_tpu_torch.resilience.retry import (RetryExhausted, RetryPolicy,
                                               retry_call)

__all__ = [
    "SpawnError",
    "SubprocessReplica",
    "SubprocessLauncher",
    "AdminRouterClient",
    "Autoscaler",
    "max_fast_burn",
]

logger = logging.getLogger(__name__)

SCRAPE_TIMEOUT_S = 5.0

_SAMPLE_RE = re.compile(r"slo_burn_rate\{([^}]*)\}\s+(\S+)")
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def max_fast_burn(text: str) -> float | None:
    """Worst fast-window burn rate in one ``/slo`` exposition body; None
    when the scrape carries no finite fast-window sample yet."""
    best = None
    for m in _SAMPLE_RE.finditer(text or ""):
        labels = dict(_LABEL_RE.findall(m.group(1)))
        if labels.get("window") != "fast":
            continue
        try:
            value = float(m.group(2))
        except ValueError:
            continue
        if value != value:  # NaN: window has no samples yet
            continue
        if best is None or value > best:
            best = value
    return best


class SpawnError(RuntimeError):
    """A replica launch failed before its serving line (retryable)."""


class SubprocessReplica:
    """One launched replica process: the handle the autoscaler manages.

    ``drain()`` is the flag-only SIGTERM path (invariants 6/12) — the
    replica finishes in-flight work and exits on its own; ``kill()`` is
    SIGKILL and exists for chaos only."""

    def __init__(self, proc, host: str, port: int, serving: dict):
        self.proc = proc
        self.host = host
        self.port = int(port)
        self.name = f"{host}:{port}"
        self.serving = dict(serving)
        warm = self.serving.get("warm_store") or {}
        # invariant 11: a warm join reports zero store misses
        self.join_cold_compiles = warm.get("misses")

    def poll(self) -> int | None:
        """Exit code when the process has died, else None."""
        return self.proc.poll()

    def drain(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()

    def wait(self, timeout: float | None = None) -> int:
        return self.proc.wait(timeout)


class SubprocessLauncher:
    """Spawns replica subprocesses and blocks until each prints its
    ``{"status": "serving", ...}`` line (the serve CLI contract), which
    carries the bound port and the warm-store join report."""

    def __init__(self, build_argv, host: str = "127.0.0.1", env=None,
                 startup_timeout_s: float = 120.0):
        # build_argv(index) -> argv for the index-th launch, or a static argv
        self._build_argv = build_argv
        self._host = host
        self._env = env
        self._startup_timeout_s = float(startup_timeout_s)
        self._spawned = 0

    def spawn(self) -> SubprocessReplica:
        argv = (self._build_argv(self._spawned)
                if callable(self._build_argv) else list(self._build_argv))
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=self._env)
        serving: dict = {}
        found = threading.Event()
        tail: deque[str] = deque(maxlen=50)

        def _scan_stdout():
            # keeps draining after the serving line so the pipe never fills
            for line in proc.stdout:
                tail.append(line.rstrip())
                if not found.is_set():
                    try:
                        obj = json.loads(line)
                    except (json.JSONDecodeError, ValueError):
                        continue
                    if isinstance(obj, dict) and obj.get("status") == "serving":
                        serving.update(obj)
                        found.set()

        threading.Thread(target=_scan_stdout, name="replica-stdout",
                         daemon=True).start()
        if not found.wait(self._startup_timeout_s):
            proc.kill()
            raise SpawnError(
                "replica never printed its serving line "
                f"(exit={proc.poll()}, tail={list(tail)[-5:]})")
        self._spawned += 1
        host = serving.get("host") or self._host
        return SubprocessReplica(proc, host, serving["port"], serving)


class AdminRouterClient:
    """HTTP twin of :class:`~deepdfa_tpu_torch.serve.router.FleetRouter`'s
    membership surface (``/admin/backends``), for a controller running
    outside the router process. Duck-compatible with the in-process router: ``add_backend``,
    ``remove_backend``, ``probe_once``."""

    def __init__(self, host: str, port: int, timeout_s: float = 5.0):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)

    def _request(self, method: str, path: str, payload=None) -> dict:
        body = None if payload is None else json.dumps(payload).encode()
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        try:
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        return json.loads(data or b"{}")

    def add_backend(self, spec) -> dict:
        return self._request("POST", "/admin/backends",
                             {"action": "add", "backend": str(spec)})

    def remove_backend(self, name: str) -> bool:
        out = self._request("POST", "/admin/backends",
                            {"action": "remove", "backend": str(name)})
        return bool(out.get("removed"))

    def probe_once(self) -> dict:
        out = self._request("GET", "/admin/backends")
        return {name: info.get("state")
                for name, info in (out.get("backends") or {}).items()}


class Autoscaler:
    """The decision loop. ``router`` needs ``add_backend`` /
    ``remove_backend`` / ``probe_once`` (a :class:`FleetRouter` or an
    :class:`AdminRouterClient`); ``launcher`` needs ``spawn() -> handle``
    where a handle has ``name/host/port/join_cold_compiles/poll/drain/
    kill``. ``scrape``, ``clock`` and ``sleep`` are injectable so the
    unit battery drives a virtual clock."""

    def __init__(self, cfg: AutoscaleConfig, router, launcher,
                 journal=None, flight=None, scrape=None,
                 clock=time.monotonic, sleep=time.sleep):
        self._cfg = cfg
        self._router = router
        self._launcher = launcher
        self._journal = journal
        self._flight = flight
        self._scrape = scrape or self._scrape_slo
        self._clock = clock
        self._sleep = sleep
        # one lock guards all decision state: the poll loop runs on its
        # own thread while summary()/stop() read from the caller's
        # (the analysis unguarded-state pass holds this at every commit)
        self._lock = threading.Lock()
        self._replicas: dict[str, object] = {}  # name -> live handle
        self._drained: list = []  # handles we SIGTERM'd, awaiting exit
        self._decisions: list[dict] = []
        self._streak_up = 0
        self._streak_down = 0
        self._last_action_t: float | None = None
        self._t0 = clock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Autoscaler":
        self.ensure_min()
        self._thread = threading.Thread(target=self._run, name="autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._cfg.poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the supervisor never dies
                logger.exception("autoscale poll failed; continuing")

    def stop(self, drain: bool = True) -> dict:
        """Stop the loop; optionally drain every managed replica (ring
        exit first, then flag-only SIGTERM). Returns :meth:`summary`."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if drain:
            with self._lock:
                handles = list(self._replicas.items())
                self._replicas = {}
            for name, handle in handles:
                self._router.remove_backend(name)
                handle.drain()
                with self._lock:
                    self._drained.append(handle)
        return self.summary()

    def adopt(self, handle) -> None:
        """Take over supervision of an already-running replica (a caller
        hands the autoscaler its baseline fleet this way)."""
        with self._lock:
            self._replicas[handle.name] = handle
        self._router.add_backend(handle.name)

    # -- one decision-loop tick ---------------------------------------------

    def poll_once(self) -> list[dict]:
        """One supervisor tick: chaos, heal, min-clamp, observe, decide.
        Returns the decisions made this tick."""
        made: list[dict] = []
        made += self._maybe_inject_crash()
        made += self._heal()
        made += self.ensure_min()
        made += self._decide_scale(self._observe_burn())
        return made

    def _maybe_inject_crash(self) -> list[dict]:
        # seed-deterministic chaos: kill -9 one managed replica mid-load,
        # proving detection + ring failover + warm replacement end to end
        if not faults.fire("autoscale.replica_crash"):
            return []
        with self._lock:
            handle = next(reversed(list(self._replicas.values())), None)
        if handle is None:
            return []
        handle.kill()
        return [self._record("replica_crash_injected", backend=handle.name)]

    def _heal(self) -> list[dict]:
        with self._lock:
            snapshot = list(self._replicas.items())
        made = []
        for name, handle in snapshot:
            code = handle.poll()
            if code is None:
                continue
            t_detect = self._clock()
            logger.warning("replica %s died (exit %s) — replacing", name, code)
            self._router.remove_backend(name)
            with self._lock:
                self._replicas.pop(name, None)
            new = self._spawn_replica(reason=f"replace:{name}")
            fields = {"backend": name, "exit_code": code}
            if new is not None:
                fields.update(
                    replacement=new.name,
                    replace_latency_s=round(self._clock() - t_detect, 3),
                    join_cold_compiles=new.join_cold_compiles)
            made.append(self._record("replace", **fields))
        return made

    def ensure_min(self) -> list[dict]:
        """Spawn until ``min_replicas`` live replicas exist (startup and
        after give-ups); not subject to the cooldown."""
        made = []
        while True:
            with self._lock:
                n = len(self._replicas)
            if n >= self._cfg.min_replicas:
                break
            handle = self._spawn_replica(reason="min_replicas")
            if handle is None:
                break  # give-up already recorded; retry next tick
            made.append(self._record(
                "scale_up", reason="min_replicas", backend=handle.name,
                replicas=n + 1,
                join_cold_compiles=handle.join_cold_compiles))
        return made

    def _observe_burn(self) -> float | None:
        with self._lock:
            handles = list(self._replicas.values())
        burns = []
        for handle in handles:
            burn = self._scrape(handle)
            if burn is not None:
                burns.append(burn)
        return max(burns, default=None)

    def _scrape_slo(self, handle) -> float | None:
        try:
            conn = http.client.HTTPConnection(handle.host, handle.port,
                                              timeout=SCRAPE_TIMEOUT_S)
            try:
                conn.request("GET", "/slo")
                text = conn.getresponse().read().decode()
            finally:
                conn.close()
        except OSError:
            return None  # dead/draining replica: the heal path owns it
        return max_fast_burn(text)

    def _decide_scale(self, burn: float | None) -> list[dict]:
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
            n = len(self._replicas)
        if cooling or not (up or down):
            return []
        if up:
            if n >= cfg.max_replicas:
                self._reset_streaks()
                return [self._record("hold", reason="max_replicas",
                                     burn=round(burn, 3), replicas=n)]
            return [self._scale_up(burn, n)]
        if n <= cfg.min_replicas:
            self._reset_streaks()
            return [self._record("hold", reason="min_replicas",
                                 burn=round(burn, 3), replicas=n)]
        return [self._scale_down(burn, n)]

    def _reset_streaks(self, acted: bool = False) -> None:
        with self._lock:
            self._streak_up = 0
            self._streak_down = 0
            if acted:
                self._last_action_t = self._clock()

    def _scale_up(self, burn: float, n: int) -> dict:
        handle = self._spawn_replica(reason=f"burn={burn:.2f}")
        self._reset_streaks(acted=True)
        if handle is None:
            return self._decisions_tail()
        return self._record(
            "scale_up", reason="burn_high", burn=round(burn, 3),
            backend=handle.name, replicas=n + 1,
            join_cold_compiles=handle.join_cold_compiles)

    def _scale_down(self, burn: float, n: int) -> dict:
        # newest replica first (LIFO): the baseline fleet survives swings
        with self._lock:
            items = list(self._replicas.items())
            if not items:
                return {}
            name, handle = items[-1]
            del self._replicas[name]
        # ring exit first — its keyspace slides to neighbours while the
        # replica finishes in-flight work under the flag-only drain
        self._router.remove_backend(name)
        handle.drain()
        with self._lock:
            self._drained.append(handle)
        self._reset_streaks(acted=True)
        return self._record("scale_down", reason="burn_low",
                            burn=round(burn, 3), backend=name,
                            replicas=n - 1)

    # -- spawning ------------------------------------------------------------

    def _spawn_replica(self, reason: str):
        cfg = self._cfg

        def attempt():
            faults.raise_if("autoscale.spawn_fail")
            return self._launcher.spawn()

        policy = RetryPolicy(attempts=cfg.spawn_attempts,
                             base_delay=cfg.spawn_backoff_s,
                             deadline=cfg.replace_deadline_s)
        try:
            handle = retry_call(
                attempt, policy=policy, sleep=self._sleep, clock=self._clock,
                on_retry=lambda n, exc, delay: logger.warning(
                    "spawn attempt %d failed (%s); retrying in %.2fs",
                    n, type(exc).__name__, delay))
        except RetryExhausted as exc:
            self._record("spawn_give_up", reason=reason,
                         attempts=exc.attempts, error=str(exc.last))
            return None
        self._router.add_backend(handle.name)
        with self._lock:
            self._replicas[handle.name] = handle
        if not self._wait_ready(handle.name):
            logger.warning("replica %s not ready within deadline", handle.name)
        return handle

    def _wait_ready(self, name: str) -> bool:
        """Block until the router's readiness probe admits ``name`` (warm
        healthz), bounded by ``replace_deadline_s``."""
        deadline = self._clock() + self._cfg.replace_deadline_s
        while True:
            states = self._router.probe_once()
            if states.get(name) == "ready":
                return True
            if self._clock() >= deadline:
                return False
            self._sleep(0.05)

    # -- observability -------------------------------------------------------

    def _record(self, action: str, **fields) -> dict:
        decision = {"action": action,
                    "t": round(self._clock() - self._t0, 3), **fields}
        with self._lock:
            self._decisions.append(decision)
        if self._journal is not None:
            try:
                self._journal.write(event="autoscale_transition", **decision)
            except Exception:  # noqa: BLE001 — invariant 20: sinks never
                logger.warning("autoscale journal write dropped")
        if self._flight is not None:
            self._flight.record("autoscale.transition", **decision)
        logger.info("autoscale decision: %s", decision)
        return decision

    def _decisions_tail(self) -> dict:
        with self._lock:
            return dict(self._decisions[-1]) if self._decisions else {}

    def summary(self) -> dict:
        """Every decision plus the gate
        aggregates (worst replacement latency, join compiles, give-ups)."""
        with self._lock:
            decisions = [dict(d) for d in self._decisions]
            replicas = sorted(self._replicas)
        latencies = [d["replace_latency_s"] for d in decisions
                     if d.get("replace_latency_s") is not None]
        joins = [d["join_cold_compiles"] for d in decisions
                 if d.get("join_cold_compiles") is not None]
        return {
            "replicas": replicas,
            "decisions": decisions,
            "scale_decisions": len(decisions),
            "replace_latency_s": max(latencies) if latencies else None,
            "replacements": sum(d["action"] == "replace" for d in decisions),
            "join_cold_compiles": sum(joins) if joins else 0,
            "spawn_give_ups": sum(d["action"] == "spawn_give_up"
                                  for d in decisions),
        }
