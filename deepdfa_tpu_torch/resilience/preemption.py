"""Preemption handling: signal → flag → emergency checkpoint → resumable rc.

A copy of ``deepdfa_tpu/resilience/preemption.py``. A spot or preemptible
GPU host gets a SIGTERM (or a maintenance notifier's SIGUSR1) shortly
before it is reclaimed. This is the cooperative half of that handshake:

1. :class:`PreemptionHandler` installs signal handlers that only set a
   flag: no I/O and no locks in the handler itself.
2. The train loop reads the flag at the next **step boundary** (never
   mid-step: the step in flight finishes, so the state carried is a real
   post-update state) and raises :class:`Preempted` with the state and the
   number of batches consumed this epoch.
3. ``fit`` commits an *emergency checkpoint* through the ordinary atomic
   ``*.tmp`` + ``os.replace`` protocol (its ``meta.json`` carries a
   ``preempted`` block), journals the preemption and exits with
   :data:`PREEMPTED_RC`, so a supervisor tells "resume me" (rc 75) from a
   real failure (rc 1) or a hard kill (rc 137).

The ``preempt.sigterm`` fault point sets the same flag from inside the
process, seed-deterministically.
"""

from __future__ import annotations

import logging
import signal
import threading

__all__ = ["PREEMPTED_RC", "Preempted", "PreemptedExit", "PreemptionHandler"]

logger = logging.getLogger(__name__)

# EX_TEMPFAIL: "try again later", distinct from 1 (crash) and 137 (SIGKILL)
PREEMPTED_RC = 75


class Preempted(RuntimeError):
    """Raised by the train loop at a step boundary once preemption is
    flagged. Carries what the emergency checkpoint needs: the post-update
    :class:`~deepdfa_tpu_torch.train.loop.TrainState` and how many batches
    of the (deterministic) epoch stream were consumed; the resume replays
    the epoch and skips exactly that many."""

    def __init__(self, state, steps_done: int, reason: str = "preempted"):
        super().__init__(f"{reason} after {steps_done} step(s) this epoch")
        self.state = state
        self.steps_done = int(steps_done)
        self.reason = reason


class PreemptedExit(SystemExit):
    """Process exit with the resumable rc. A ``SystemExit``, so the CLI's
    crash handling (``except Exception``: log → ``.log.error``) does not
    fire: a preempted run is suspended, not crashed."""

    def __init__(self, reason: str = "preempted"):
        super().__init__(PREEMPTED_RC)
        self.reason = reason


class PreemptionHandler:
    """Flag-only signal handler for SIGTERM/SIGUSR1 (the preemption notice).

    ``install`` keeps the previous handlers and ``uninstall`` restores them,
    so a library caller (tests, embedded fits) never keeps the process's
    signal disposition. Off the main thread ``signal.signal`` raises: the
    handler then degrades, with a warning, to fault and manual triggering
    (``trigger``)."""

    SIGNALS = (signal.SIGTERM, signal.SIGUSR1)

    def __init__(self):
        self._flag = threading.Event()
        self._prev: dict[int, object] = {}
        self.reason: str | None = None

    def _on_signal(self, signum, frame):
        self.reason = f"signal {signal.Signals(signum).name}"
        self._flag.set()

    def install(self) -> "PreemptionHandler":
        try:
            for sig in self.SIGNALS:
                self._prev[sig] = signal.signal(sig, self._on_signal)
        except ValueError:  # not the main thread: signals stay untouched
            self._prev.clear()
            logger.warning(
                "preemption handler: not on the main thread — signal "
                "delivery disabled, fault-point triggering still active"
            )
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev.clear()

    def trigger(self, reason: str) -> None:
        """Flag preemption from inside the process (fault injection, or an
        orchestrator thread that learned of it another way)."""
        self.reason = reason
        self._flag.set()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()
