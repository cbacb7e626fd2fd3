"""Deterministic, named fault-injection points.

A copy of ``deepdfa_tpu/resilience/faults.py`` that declares only the
points the port fires: the trainer's (``train/checkpoint.py``,
``train/loop.py``, ``data/prefetch.py``), the Joern session's
(``cpg/joern_session.py``), the HTTP service's, the tracer's and flight
recorder's, the extraction pool's and its cache's, the cascade's, the
frontend pool's and the function-embedding cache's.
The other points of the JAX registry come with their fire sites (ROADMAP
A11, A15).

Faults are (a) reachable from outside the process — a subprocess under
test arms them through the ``DEEPDFA_FAULTS`` environment variable — (b)
zero-cost when disarmed (one empty-dict check), and (c)
seed-deterministic: whether hit number *n* of point *p* fires is a pure
function of ``(seed, p, n)``, so a spec gives the JAX package's schedule.

Spec grammar (env var or :func:`install` argument), entries ``;``-separated::

    joern.die@2                                # fire on the 2nd hit (1-based)
    joern.die@3,4,5                            # fire on hits 3, 4 and 5
    joern.hang:p=0.25:seed=7:max=2             # Bernoulli(0.25) per hit, cap 2
    joern.hang                                 # fire on every hit
"""

from __future__ import annotations

import hashlib
import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass

__all__ = [
    "ENV_VAR",
    "KNOWN_POINTS",
    "POINT_DOCS",
    "FaultSpec",
    "InjectedFault",
    "parse_spec",
    "install",
    "install_from_env",
    "installed",
    "clear",
    "active",
    "fire",
    "raise_if",
    "crash_if",
    "counters",
]

ENV_VAR = "DEEPDFA_FAULTS"

KNOWN_POINTS = (
    "ckpt.crash_between_state_and_meta",
    "step.nan_grads",
    "prefetch.producer_raises",
    "joern.hang",
    "joern.die",
    "serve.drop_request",
    "serve.engine_raises",
    "preempt.sigterm",
    "step.hang",
    "obs.trace_drop",
    "obs.flight_drop",
    "extract.worker_crash",
    "extract.cache_corrupt",
    "cascade.tier2_timeout",
    "cascade.escalation_drop",
    "frontend.worker_crash",
    "frontend.spawn_fail",
    "embcache.cache_corrupt",
)

# One line per point; keys equal KNOWN_POINTS.
POINT_DOCS = {
    "ckpt.crash_between_state_and_meta": (
        "hard-exit between the checkpoint state write and its meta.json "
        "commit (train/checkpoint.py)"),
    "step.nan_grads": (
        "poison one train step's loss scale so its gradients go NaN "
        "(train/loop.py)"),
    "prefetch.producer_raises": (
        "raise inside the prefetch producer thread (data/prefetch.py)"),
    "joern.hang": (
        "swallow one REPL command so the prompt never returns "
        "(cpg/joern_session.py)"),
    "joern.die": (
        "kill the joern subprocess before a command (cpg/joern_session.py)"),
    "serve.drop_request": (
        "drop one /score request at admission — the client gets a 503, the "
        "server keeps serving (serve/server.py)"),
    "serve.engine_raises": (
        "raise inside the scoring engine — that batch's requests get 500s, "
        "the dispatcher survives (serve/server.py)"),
    "preempt.sigterm": (
        "flag a preemption notice at a train step boundary, as if SIGTERM "
        "had arrived — drives the emergency-checkpoint path (train/loop.py)"),
    "step.hang": (
        "wedge one train step: a cancel-aware sleep the HangWatchdog must "
        "convert into a bounded, journaled timeout abort (train/loop.py)"),
    "obs.trace_drop": (
        "lose one span at export — counted in dropped_total; the request it "
        "annotates must still succeed (obs/tracing.py)"),
    "obs.flight_drop": (
        "lose one flight-recorder event at record — counted in "
        "obs_dropped_total; the request/step it annotates must still "
        "succeed (obs/flightrec.py)"),
    "extract.worker_crash": (
        "kill one extraction-pool worker thread mid-task — its in-flight "
        "item is re-queued and survivors steal its backlog "
        "(data/extraction.py)"),
    "extract.cache_corrupt": (
        "corrupt one extraction-cache payload at read — the entry must "
        "read as a MISS, never a decode crash (data/extract_cache.py)"),
    "cascade.tier2_timeout": (
        "blow one tier-2 batch's deadline inside the cascade dispatcher — "
        "the requests keep their tier-1 answers with tier2_degraded: true "
        "(serve/cascade.py)"),
    "cascade.escalation_drop": (
        "drop one borderline escalation at enqueue — the request keeps its "
        "tier-1 answer with tier2_degraded: true, never a 5xx "
        "(serve/cascade.py)"),
    "frontend.worker_crash": (
        "kill one frontend encode worker mid-task — its in-flight source "
        "is re-queued and completed exactly once by a survivor; total pool "
        "death degrades requests to inline encode (serve/frontend.py)"),
    "frontend.spawn_fail": (
        "fail one frontend encode-session spawn — the supervisor retries "
        "with backoff; a pool that cannot spawn at all degrades to inline "
        "encode, never a 5xx (serve/frontend.py)"),
    "embcache.cache_corrupt": (
        "corrupt one function-embedding-cache payload at read — the entry "
        "must read as a MISS (level 1 re-embeds), never a decode crash "
        "(serve/embcache.py)"),
}


class InjectedFault(RuntimeError):
    """Raised by :func:`raise_if` when its fault point fires."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


def _unit(seed: int, point: str, hit: int) -> float:
    """Deterministic uniform in [0, 1): pure function of (seed, point, hit)."""
    digest = hashlib.sha256(f"{seed}:{point}:{hit}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2.0**64


@dataclass(frozen=True)
class FaultSpec:
    """One armed fault point. ``at`` wins over ``prob``; ``prob >= 1`` means
    every hit; ``max_fires`` caps total fires regardless of mode."""

    point: str
    at: tuple[int, ...] = ()  # 1-based hit indices; empty = probabilistic
    prob: float = 1.0
    seed: int = 0
    max_fires: int | None = None

    def decide(self, hit: int) -> bool:
        """Would hit number ``hit`` (1-based) fire? Pure — ignores the
        ``max_fires`` cap, which needs the registry's fire counter."""
        if self.at:
            return hit in self.at
        if self.prob >= 1.0:
            return True
        return _unit(self.seed, self.point, hit) < self.prob

    def schedule(self, n: int) -> list[bool]:
        """Fire decisions for the first ``n`` hits, cap applied — what a
        fresh registry would do; the determinism tests assert on this."""
        fired, out = 0, []
        for h in range(1, n + 1):
            yes = self.decide(h) and (self.max_fires is None or fired < self.max_fires)
            fired += int(yes)
            out.append(yes)
        return out


def parse_spec(text: str) -> dict[str, FaultSpec]:
    specs: dict[str, FaultSpec] = {}
    for entry in filter(None, (e.strip() for e in (text or "").split(";"))):
        head, *opts = entry.split(":")
        at: tuple[int, ...] = ()
        name = head
        if "@" in head:
            name, _, idxs = head.partition("@")
            at = tuple(int(tok) for tok in idxs.split(",") if tok)
        prob, seed, max_fires = 1.0, 0, None
        for opt in opts:
            key, _, val = opt.partition("=")
            if key == "p":
                prob = float(val)
            elif key == "seed":
                seed = int(val)
            elif key == "max":
                max_fires = int(val)
            else:
                raise ValueError(f"unknown fault option {opt!r} in {entry!r}")
        specs[name] = FaultSpec(point=name, at=at, prob=prob, seed=seed, max_fires=max_fires)
    return specs


class _Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._specs: dict[str, FaultSpec] = {}
        self._hits: dict[str, int] = {}
        self._fires: dict[str, int] = {}

    def install(self, spec: str | dict[str, FaultSpec]) -> None:
        specs = parse_spec(spec) if isinstance(spec, str) else dict(spec)
        with self._lock:
            self._specs = specs
            self._hits = {}
            self._fires = {}

    def active(self, point: str) -> bool:
        return point in self._specs

    def fire(self, point: str) -> bool:
        if not self._specs:  # disarmed fast path: production runs stop here
            return False
        with self._lock:
            spec = self._specs.get(point)
            if spec is None:
                return False
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            fired = spec.decide(hit)
            if fired and spec.max_fires is not None and self._fires.get(point, 0) >= spec.max_fires:
                fired = False
            if fired:
                self._fires[point] = self._fires.get(point, 0) + 1
            return fired

    def counters(self) -> dict:
        with self._lock:
            return {"hits": dict(self._hits), "fires": dict(self._fires)}


_REGISTRY = _Registry()


def install(spec: str | dict[str, FaultSpec]) -> None:
    """Arm fault points from a spec string (grammar above) or a parsed
    ``{point: FaultSpec}`` dict; resets all hit/fire counters."""
    _REGISTRY.install(spec)


def install_from_env() -> bool:
    """(Re-)arm from ``DEEPDFA_FAULTS``; returns whether anything was armed.
    Runs once at import so subprocesses inherit their chaos schedule."""
    text = os.environ.get(ENV_VAR, "")
    if text:
        _REGISTRY.install(text)
    return bool(text)


def clear() -> None:
    _REGISTRY.install({})


def active(point: str) -> bool:
    """Is the point armed at all? (Does NOT consume a hit.)"""
    return _REGISTRY.active(point)


def fire(point: str) -> bool:
    """Consume one hit of ``point``; True iff the fault fires now."""
    return _REGISTRY.fire(point)


def raise_if(point: str) -> None:
    if _REGISTRY.fire(point):
        raise InjectedFault(point, _REGISTRY.counters()["hits"].get(point, 0))


def crash_if(point: str, exit_code: int = 137) -> None:
    """Simulated ``kill -9``: ``os._exit`` skips atexit handlers, finally
    blocks and stream flushes — exactly the preemption the atomic
    checkpoint commit must survive."""
    if _REGISTRY.fire(point):
        os._exit(exit_code)


def counters() -> dict:
    """``{"hits": {point: n}, "fires": {point: n}}`` since the last install."""
    return _REGISTRY.counters()


@contextmanager
def installed(spec: str | dict[str, FaultSpec]):
    """Test helper: arm ``spec`` inside the block, restore the previous
    arming (with fresh counters) after."""
    with _REGISTRY._lock:
        prev = dict(_REGISTRY._specs)
    _REGISTRY.install(spec)
    try:
        yield _REGISTRY
    finally:
        _REGISTRY.install(prev)


install_from_env()
