"""Sampled, bounded request-capture journal.

A copy of ``deepdfa_tpu/continual/capture.py``. :class:`TrafficCapture`
sits on ``ScoreServer.handle_score`` and records one JSONL row per scored
function: the request's content-addressed ``source_key``, the encoded
features (the graph the engine actually scored: senders, receivers and the
node feature columns, so shadow replay needs no vocabulary or front end),
the served score, the answering tier, and the ``model_rev`` that produced
it.

The contract: **capture can never fail the request it records.** Every
failure (a full disk, a serialization surprise, the injected
``continual.capture_drop`` fault) is swallowed, counted in ``dropped`` and
mirrored to the flight ring; the caller's 200 is never at stake. Sampling
(``sample_every``) and the record bound (``max_records``) keep the journal
cheap and finite; a sampled-out or over-bound request is *skipped*, not
dropped: the two counters answer different questions (policy against
failure).

The read side (:func:`read_capture`, :func:`record_graph`) tolerates a
torn tail: a half-written last line (the crash case append-mode JSONL
cannot exclude) reads as "the journal ends here", never as a decode crash.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import numpy as np

from deepdfa_tpu_torch.resilience import faults

__all__ = ["TrafficCapture", "read_capture", "record_graph"]

SCHEMA = 1


def _graph_payload(graph) -> dict:
    """JSON-serializable encoding of one scored graph (int lists)."""
    return {
        "senders": np.asarray(graph.senders).tolist(),
        "receivers": np.asarray(graph.receivers).tolist(),
        "node_feats": {k: np.asarray(v).tolist()
                       for k, v in graph.node_feats.items()},
    }


def record_graph(record: dict):
    """Rebuild the :class:`~deepdfa_tpu_torch.data.graphs.Graph` a capture
    row encodes (the shadow harness's input). Returns None when the row
    carries no graph payload."""
    from deepdfa_tpu_torch.data.graphs import Graph

    payload = record.get("graph")
    if not isinstance(payload, dict):
        return None
    return Graph(
        senders=np.asarray(payload["senders"], dtype=np.int32),
        receivers=np.asarray(payload["receivers"], dtype=np.int32),
        node_feats={k: np.asarray(v, dtype=np.int32)
                    for k, v in payload["node_feats"].items()},
    )


class TrafficCapture:
    """Append-mode JSONL capture journal with sampling and a record bound.

    ``record_request`` is the only write path and it never raises: the
    serving thread calls it with live request state, so a capture failure
    is the capture's problem, counted and flight-recorded, invisible to
    the client."""

    def __init__(self, path: str | Path, *, sample_every: int = 1,
                 max_records: int = 10000, flight=None, clock=time.time):
        self.path = Path(path)
        self.sample_every = max(1, int(sample_every))
        self.max_records = max(1, int(max_records))
        self.flight = flight
        self._clock = clock
        self._lock = threading.Lock()
        self._seen = 0  # requests offered (sampling denominator)
        self.written = 0  # rows committed to the journal
        self.skipped = 0  # sampled out or over the record bound (policy)
        self.dropped = 0  # write/serialize failures

    def record_request(self, source_key: str, rows, graphs,
                       model_rev: str) -> int:
        """Capture one scored request: one JSONL row per (row, graph) pair
        that carries a score. Returns the rows written (0 on sample-out,
        bound or failure). Never raises."""
        try:
            with self._lock:
                self._seen += 1
                if (self._seen - 1) % self.sample_every != 0:
                    self.skipped += 1
                    return 0
                if self.written >= self.max_records:
                    self.skipped += 1
                    return 0
            if faults.fire("continual.capture_drop"):
                raise OSError("injected fault continual.capture_drop")
            lines = []
            for row, graph in zip(rows, graphs):
                if graph is None or "vulnerable_probability" not in row:
                    continue  # encode-failed rows never scored
                lines.append(json.dumps({
                    "schema": SCHEMA,
                    "t": self._clock(),
                    "source_key": source_key,
                    "function": row.get("function"),
                    "score": row["vulnerable_probability"],
                    "tier": row.get("tier", 1),
                    "model_rev": model_rev,
                    "graph": _graph_payload(graph),
                }, sort_keys=True))
            if not lines:
                return 0
            with self._lock:
                budget = self.max_records - self.written
                lines = lines[:max(0, budget)]
                if not lines:
                    self.skipped += 1
                    return 0
                self.path.parent.mkdir(parents=True, exist_ok=True)
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write("\n".join(lines) + "\n")
                self.written += len(lines)
                return len(lines)
        except Exception as exc:  # noqa: BLE001 — a capture failure must
            # never become the request's failure
            with self._lock:
                self.dropped += 1
            if self.flight is not None:
                try:
                    self.flight.record(
                        "capture.dropped",
                        reason=f"{type(exc).__name__}: {exc}")
                except Exception:  # noqa: BLE001 — flight is best-effort too
                    pass
            return 0

    def stats(self) -> dict:
        with self._lock:
            return {"written": self.written, "skipped": self.skipped,
                    "dropped": self.dropped, "seen": self._seen}


def read_capture(path: str | Path) -> list[dict]:
    """Every committed capture row, in order. A missing file gives an
    empty list; a torn or garbage line (the crash-truncated tail) ends the
    journal there rather than raising, as ``RunJournal.read`` does."""
    path = Path(path)
    try:
        text = path.read_text(encoding="utf-8")
    except (FileNotFoundError, OSError):
        return []
    rows: list[dict] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            break  # torn tail: the journal ends at the last good row
        if isinstance(rec, dict):
            rows.append(rec)
    return rows
