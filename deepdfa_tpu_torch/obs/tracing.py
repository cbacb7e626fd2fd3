"""Stdlib-only request/step tracing: W3C ``traceparent`` propagation,
a bounded in-memory span buffer, slow-request exemplar journaling, and
Perfetto/Chrome trace-event export.

A copy of ``deepdfa_tpu/obs/tracing.py``. Stdlib-only: the serve path
grows no dependency. The surface is deliberately tiny:

- :class:`SpanContext` — ``(trace_id, span_id)`` identity; rendered to /
  parsed from the W3C ``traceparent`` header (``00-{trace}-{span}-{flags}``)
  so a trace crosses the router→backend HTTP hop intact;
- :class:`Tracer` — per-process span recorder. ``span()`` is a context
  manager (nesting via a thread-local stack); ``record()`` takes explicit
  start/end wall times for cross-thread stages (a queue-wait span starts
  on the submitting request thread and ends on the dispatcher thread).
  Finished spans land in a bounded deque — a long-lived server never
  grows, old traces fall off the back;
- **exemplar journaling** — when a *root* span (one ``server.request`` /
  ``router.request``) finishes slower than ``slow_ms``, its whole trace
  is committed to ``exemplar_dir/trace-<id>.json`` as an ``event=trace``
  record with the journal's atomic write discipline (sideways ``.tmp`` +
  ``os.replace``), capped at ``max_exemplars`` files;
- :func:`chrome_trace` — spans → Chrome trace-event JSON (phase ``"X"``
  complete events, µs timestamps, one pid lane per process name), the
  format Perfetto / ``chrome://tracing`` open directly.

Failure domain: recording a span must NEVER fail the request it
annotates. Every export path is wrapped, and the ``obs.trace_drop``
fault point (``DEEPDFA_FAULTS`` grammar) injects exactly that loss so
the chaos battery can prove it — a dropped span bumps
``dropped_total`` and nothing else.

All span timestamps are wall-clock (``time.time()``) so spans recorded
in different processes land on one consistent export timeline.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

from deepdfa_tpu_torch.resilience import faults

__all__ = [
    "SpanContext",
    "Span",
    "Tracer",
    "new_trace_id",
    "new_span_id",
    "load_trace_records",
    "parse_traceparent",
    "chrome_trace",
]

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


@dataclass(frozen=True)
class SpanContext:
    """The identity that crosses process boundaries: which trace, and
    which span is the parent on the other side of the hop."""

    trace_id: str
    span_id: str
    sampled: bool = True

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"


def parse_traceparent(header: str | None) -> SpanContext | None:
    """Parse a W3C ``traceparent`` header; None on anything malformed
    (an unparseable header must start a fresh trace, not fail the
    request). All-zero trace/span ids are invalid per the spec."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id, sampled=bool(int(flags, 16) & 1))


@dataclass
class Span:
    """One finished stage. ``start_s``/``dur_s`` are wall-clock seconds;
    export converts to the µs the trace-event format wants."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    proc: str
    start_s: float
    dur_s: float = 0.0
    root: bool = False
    attrs: dict = field(default_factory=dict)
    tid: int = 0

    @property
    def ctx(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def to_record(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "proc": self.proc,
            "start_s": self.start_s,
            "dur_ms": round(self.dur_s * 1e3, 4),
            "root": self.root,
            "attrs": dict(self.attrs),
        }


class Tracer:
    """Per-process bounded span recorder (thread-safe)."""

    def __init__(self, proc: str = "serve", max_spans: int = 4096,
                 slow_ms: float | None = None,
                 exemplar_dir: str | Path | None = None,
                 max_exemplars: int = 16):
        self.proc = proc
        self.slow_ms = slow_ms
        self.exemplar_dir = Path(exemplar_dir) if exemplar_dir else None
        self.max_exemplars = int(max_exemplars)
        self._spans: deque[Span] = deque(maxlen=max(1, int(max_spans)))
        self._lock = threading.Lock()
        self._local = threading.local()
        self.recorded_total = 0
        self.dropped_total = 0

    # -- span creation ------------------------------------------------------

    def _stack(self) -> list[SpanContext]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> SpanContext | None:
        """Context of the innermost open span on THIS thread (what a
        cross-thread handoff — e.g. a batcher submit — should carry)."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextmanager
    def span(self, name: str, parent: SpanContext | None = None,
             root: bool = False, **attrs):
        """Open one span. ``parent`` wins; otherwise the innermost open
        span on this thread; otherwise a fresh trace is started. The
        yielded :class:`Span` exposes ``.ctx`` for propagation and a
        mutable ``attrs`` dict."""
        if parent is None:
            parent = self.current()
        if parent is None:
            trace_id, parent_id = new_trace_id(), None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        sp = Span(name=name, trace_id=trace_id, span_id=new_span_id(),
                  parent_id=parent_id, proc=self.proc, start_s=time.time(),
                  root=root, attrs=dict(attrs),
                  tid=threading.get_ident() % 1_000_000)
        stack = self._stack()
        stack.append(sp.ctx)
        try:
            yield sp
        finally:
            stack.pop()
            sp.dur_s = max(0.0, time.time() - sp.start_s)
            self._record(sp)

    def record(self, name: str, start_s: float, end_s: float | None = None,
               parent: SpanContext | None = None, root: bool = False,
               **attrs) -> Span:
        """Record a span from explicit wall-clock times — the cross-thread
        path (queue wait) and the measured-after-the-fact path (a step
        already timed by its caller)."""
        end_s = time.time() if end_s is None else end_s
        if parent is None:
            trace_id, parent_id = new_trace_id(), None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        sp = Span(name=name, trace_id=trace_id, span_id=new_span_id(),
                  parent_id=parent_id, proc=self.proc, start_s=start_s,
                  dur_s=max(0.0, end_s - start_s), root=root,
                  attrs=dict(attrs), tid=threading.get_ident() % 1_000_000)
        self._record(sp)
        return sp

    def _record(self, sp: Span) -> None:
        # a lost span export must never fail the request it annotates:
        # the injected obs.trace_drop loss and any real export failure
        # both end here, counted and swallowed
        try:
            if faults.fire("obs.trace_drop"):
                with self._lock:
                    self.dropped_total += 1
                return
            with self._lock:
                self._spans.append(sp)
                self.recorded_total += 1
            if (sp.root and self.slow_ms is not None
                    and sp.dur_s * 1e3 >= self.slow_ms
                    and self.exemplar_dir is not None):
                self._journal_exemplar(sp)
        except Exception:  # noqa: BLE001 — tracing is strictly best-effort
            with self._lock:
                self.dropped_total += 1

    # -- reading back -------------------------------------------------------

    def spans(self, trace_id: str | None = None) -> list[Span]:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # -- exemplar journaling ------------------------------------------------

    def _journal_exemplar(self, root: Span) -> None:
        from deepdfa_tpu_torch.resilience.journal import atomic_write_text

        spans = self.spans(root.trace_id)
        rec = {
            "schema": 1,
            "event": "trace",
            "trace_id": root.trace_id,
            "root": root.name,
            "proc": self.proc,
            "dur_ms": round(root.dur_s * 1e3, 4),
            "slow_ms": self.slow_ms,
            "spans": [s.to_record() for s in spans],
        }
        self.exemplar_dir.mkdir(parents=True, exist_ok=True)
        path = self.exemplar_dir / f"trace-{root.trace_id[:16]}.json"
        atomic_write_text(path, json.dumps(rec, indent=2, sort_keys=True))
        # bounded exemplar set: evict oldest beyond the cap (best-effort)
        files = sorted(self.exemplar_dir.glob("trace-*.json"),
                       key=lambda p: p.stat().st_mtime)
        for stale in files[: max(0, len(files) - self.max_exemplars)]:
            try:
                stale.unlink()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Chrome / Perfetto trace-event export


def chrome_trace(spans) -> dict:
    """Spans (``Span`` objects or ``to_record()`` dicts, possibly from
    several processes) → a Chrome trace-event JSON object. One pid lane
    per process name (named via ``process_name`` metadata events), phase
    ``"X"`` complete events with µs timestamps."""
    records = [s.to_record() if isinstance(s, Span) else dict(s)
               for s in spans]
    pids: dict[str, int] = {}
    events: list[dict] = []
    for rec in records:
        proc = rec.get("proc") or "proc"
        if proc not in pids:
            pids[proc] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": pids[proc], "tid": 0,
                           "args": {"name": proc}})
        events.append({
            "name": rec["name"],
            "ph": "X",
            "ts": round(float(rec["start_s"]) * 1e6, 1),
            "dur": max(1.0, round(float(rec.get("dur_ms", 0.0)) * 1e3, 1)),
            "pid": pids[proc],
            "tid": int(rec.get("tid", 0) or 0),
            "args": {"trace_id": rec.get("trace_id"),
                     "span_id": rec.get("span_id"),
                     "parent_id": rec.get("parent_id"),
                     **(rec.get("attrs") or {})},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def load_trace_records(path: str | Path) -> list[dict]:
    """Load ``event=trace`` exemplar records from one file or every
    ``trace-*.json`` under a directory (a run dir is searched recursively
    so ``<run>/traces/`` works without naming it). Unreadable or non-trace
    files are skipped: export is a reporting path."""
    path = Path(path)
    files = ([path] if path.is_file()
             else sorted(path.rglob("trace-*.json")))
    out = []
    for f in files:
        try:
            rec = json.loads(f.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(rec, dict) and rec.get("event") == "trace":
            out.append(rec)
    return out
