"""Deadline watchdog for blocking device work (a wedged step).

A copy of ``deepdfa_tpu/resilience/watchdog.py``. A kernel that never
finishes, or a host sync that never returns, hangs the process with no
signal at all: an infinite hang looks like a slow step unless something
watches the clock.

:class:`HangWatchdog` runs the blocking call in a daemon worker thread and
waits with a deadline. On expiry it raises :class:`WatchdogTimeout` (a
``TimeoutError``) in the *caller*: the run gets a clean, journaled abort
instead of an eternal hang. The worker cannot be killed (Python threads are
not cancellable, and neither is a CUDA kernel), so:

- a real device hang leaves one parked daemon thread behind; the process is
  aborting anyway, and daemon threads never block interpreter exit. Nothing
  joins it past the one-second grace below;
- *injected* hangs (the ``step.hang`` fault) are cancel-aware: the worker
  receives a per-call ``threading.Event`` and parks on it, the timeout path
  sets it, and the thread unwinds at once.

The worker thread has CUDA's per-thread current device at its default, so a
watched function is handed its tensors (and so its device) explicitly.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

__all__ = ["HangWatchdog", "WatchdogTimeout"]


class WatchdogTimeout(TimeoutError):
    """A watched call exceeded its deadline: treat the device work as
    wedged and abort instead of hanging forever."""

    def __init__(self, point: str, deadline_s: float):
        super().__init__(
            f"watchdog: {point!r} exceeded {deadline_s:.1f}s deadline — "
            "wedged device or hung collective"
        )
        self.point = point
        self.deadline_s = float(deadline_s)


class HangWatchdog:
    """Deadline wrapper for blocking calls.

    ``on_timeout(point, deadline_s)`` is called (best effort) before the
    :class:`WatchdogTimeout` is raised: the journaling hook. ``n_timeouts``
    counts expiries."""

    def __init__(self, deadline_s: float,
                 on_timeout: Callable[[str, float], None] | None = None):
        if deadline_s <= 0:
            raise ValueError("watchdog deadline_s must be > 0")
        self.deadline_s = float(deadline_s)
        self.on_timeout = on_timeout
        self.n_timeouts = 0

    def call(
        self,
        point: str,
        fn: Callable[..., Any],
        *args: Any,
        deadline_s: float | None = None,
        cancel_aware: bool = False,
        **kwargs: Any,
    ) -> Any:
        """Run ``fn(*args, **kwargs)`` with a deadline; return its result or
        re-raise its exception. ``cancel_aware=True`` prepends a
        ``threading.Event`` argument that is set when the deadline expires,
        so a cooperative worker (a simulated hang) unwinds instead of
        staying parked."""
        deadline = self.deadline_s if deadline_s is None else float(deadline_s)
        cancel = threading.Event()
        done = threading.Event()
        box: dict[str, Any] = {}

        def runner():
            try:
                if cancel_aware:
                    box["value"] = fn(cancel, *args, **kwargs)
                else:
                    box["value"] = fn(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 — re-raised in caller
                box["error"] = exc
            finally:
                done.set()

        worker = threading.Thread(target=runner, name=f"watchdog:{point}",
                                  daemon=True)
        worker.start()
        if not done.wait(deadline):
            cancel.set()
            worker.join(timeout=1.0)  # a cancel-aware hang unwinds here
            self.n_timeouts += 1
            if self.on_timeout is not None:
                try:
                    self.on_timeout(point, deadline)
                except Exception:  # noqa: BLE001 — must not mask the timeout
                    pass
            raise WatchdogTimeout(point, deadline)
        if "error" in box:
            raise box["error"]
        return box.get("value")
