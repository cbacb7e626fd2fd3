"""Replica launcher: spawn ``ScoreServer`` processes for the fleet.

A trimmed copy of ``deepdfa_tpu/serve/autoscaler.py``: the launcher
(:class:`SubprocessLauncher`, :class:`SubprocessReplica`,
:class:`SpawnError`) that the promotion controller
(:mod:`deepdfa_tpu_torch.continual.promote`) spawns replicas through, and
:class:`AdminRouterClient`, the HTTP twin of the fleet router's membership
surface for a controller that runs outside the router's process. A
replica is ``python -m deepdfa_tpu_torch.serve.server ...``; the launcher
waits for its ``{"status": "serving", ...}`` line, which carries the bound
port and the warm-store join report. The SLO-driven ``Autoscaler`` loop
is not ported yet (ROADMAP A15).

A handle's ``drain()`` is the flag-only SIGTERM path: the replica finishes
its in-flight work and exits on its own; ``kill()`` is SIGKILL and exists
for chaos only.
"""

from __future__ import annotations

import http.client
import json
import signal
import subprocess
import threading
from collections import deque

__all__ = ["AdminRouterClient", "SpawnError", "SubprocessLauncher",
           "SubprocessReplica"]


class SpawnError(RuntimeError):
    """A replica launch failed before its serving line (retryable)."""


class SubprocessReplica:
    """One launched replica process: the handle a controller manages."""

    def __init__(self, proc, host: str, port: int, serving: dict):
        self.proc = proc
        self.host = host
        self.port = int(port)
        self.name = f"{host}:{port}"
        self.serving = dict(serving)
        warm = self.serving.get("warm_store") or {}
        # a warm join reports zero store misses
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
    ``{"status": "serving", ...}`` line (the serve entry point's contract),
    which carries the bound port and the warm-store join report."""

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
    outside the router process. Duck-compatible with the in-process
    router: ``add_backend``, ``remove_backend``, ``probe_once``."""

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
