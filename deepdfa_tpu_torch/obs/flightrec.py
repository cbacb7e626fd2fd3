"""Crash flight recorder — a bounded ring of "what was it doing?" events.

A copy of ``deepdfa_tpu/obs/flightrec.py``. The metrics record
*aggregates*; after a crash those answer "how much" but not "what, exactly,
just happened". The flight recorder keeps
the last N structured events — request summaries, batch shapes, engine
dispatches, checkpoint commits, fault-point firings — in a fixed-size
in-memory ring, and dumps them atomically (``atomic_write_text``, the same
protocol as checkpoint meta commits — ROADMAP invariant 1) as
``flight-<ts>.json`` when something dies or on ``SIGUSR2``.

Two hard rules, both inherited from the tracing plane:

- recording must NEVER fail the request/step it annotates (ROADMAP
  invariant 14, extended here): every failure — including the
  ``obs.flight_drop`` chaos point — is swallowed into ``dropped_total``,
  which scrape endpoints export as ``deepdfa_*_obs_dropped_total``;
- recording must be cheap enough to leave on: one dict build + one deque
  append under a lock.
"""

from __future__ import annotations

import json
import signal
import tempfile
import threading
import time
from collections import deque
from pathlib import Path

from deepdfa_tpu_torch.resilience import faults
from deepdfa_tpu_torch.resilience.journal import atomic_write_text

__all__ = ["FlightRecorder", "install_sigusr2"]


class FlightRecorder:
    """Bounded ring of structured events with an atomic crash dump.

    ``record`` never raises and never blocks beyond one lock acquisition;
    ``dump`` never raises either (a crash handler that crashes is worse
    than no handler). Event fields are kept as passed and coerced with
    ``repr`` only at dump time, so the hot path does no serialization.
    """

    def __init__(self, capacity: int = 256, proc: str = "proc",
                 dump_dir=None, clock=time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.proc = proc
        self.dump_dir = Path(dump_dir) if dump_dir is not None else None
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._seq = 0
        self.recorded_total = 0
        self.dropped_total = 0
        self.dumps_total = 0

    # -- hot path -----------------------------------------------------------

    def record(self, kind: str, **fields) -> bool:
        """Append one event; returns False (and counts a drop) on ANY
        failure — the caller's request/step must not notice."""
        try:
            faults.raise_if("obs.flight_drop")
            evt = {"ts": round(self._clock(), 6), "kind": str(kind)}
            evt.update(fields)
            with self._lock:
                self._seq += 1
                evt["seq"] = self._seq
                self._ring.append(evt)
                self.recorded_total += 1
            return True
        except Exception:  # noqa: BLE001 — invariant 14: swallow, count
            try:
                self.dropped_total += 1
            except Exception:  # noqa: BLE001
                pass
            return False

    # -- read / dump --------------------------------------------------------

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(evt) for evt in self._ring]

    def dump(self, reason: str, dump_dir=None) -> Path | None:
        """Atomically write the ring as ``flight-<ts>.json``; returns the
        path, or None on failure (counted in ``dropped_total`` — a dump
        must never turn one crash into two). With no configured directory
        dumps land in the system temp dir, never the working directory."""
        try:
            doc = {
                "schema": 1,
                "proc": self.proc,
                "reason": reason,
                "dumped_at_unix": int(self._clock()),
                "capacity": self.capacity,
                "recorded_total": self.recorded_total,
                "dropped_total": self.dropped_total,
                "events": self.snapshot(),
            }
            root = Path(dump_dir) if dump_dir is not None else (
                self.dump_dir if self.dump_dir is not None
                else Path(tempfile.gettempdir()))
            root.mkdir(parents=True, exist_ok=True)
            stamp = int(self._clock() * 1000)
            path = root / f"flight-{stamp}.json"
            n = 1
            while path.exists():  # same-millisecond dumps (tests, SIGUSR2 bursts)
                n += 1
                path = root / f"flight-{stamp}-{n}.json"
            atomic_write_text(
                path, json.dumps(doc, indent=2, default=repr) + "\n")
            with self._lock:
                self.dumps_total += 1
            return path
        except Exception:  # noqa: BLE001 — never raise out of a crash path
            try:
                self.dropped_total += 1
            except Exception:  # noqa: BLE001
                pass
            return None


def install_sigusr2(recorder: FlightRecorder, dump_dir=None):
    """``kill -USR2 <pid>`` → dump the ring (the live-incident probe).

    Returns the previous handler so tests can restore it, or None when
    installation is impossible (non-main thread, platform without
    SIGUSR2) — flight recording itself keeps working either way.
    """
    def _handler(signum, frame):  # noqa: ARG001 — signal API
        recorder.dump("sigusr2", dump_dir)

    try:
        return signal.signal(signal.SIGUSR2, _handler)
    except (AttributeError, ValueError, OSError):
        return None
