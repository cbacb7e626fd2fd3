"""Offline shadow A/B harness.

A copy of ``deepdfa_tpu/continual/shadow.py``. :func:`shadow_replay`
replays a captured traffic file (``capture.py`` JSONL) against two engines,
baseline and candidate, both real
:class:`~deepdfa_tpu_torch.serve.engine.ScoringEngine` instances built from
checkpoints or artifacts (kernel B1 on the card), and diffs the score
distributions per ``(bucket, tier)`` with the PSI the online drift
sentinel uses (:func:`deepdfa_tpu_torch.obs.drift.psi`), so the offline
gate and the online alarm speak one statistic. The report lands as
``shadow_report.json`` (atomic write) and is the promotion controller's
first gate:

- identical revs must produce a zero-diff report (``max_abs_delta == 0``,
  ``max_psi == 0``: replay is deterministic, so any nonzero diff on the
  same rev is an engine bug, not noise);
- a candidate passes while every per-bucket PSI stays under ``max_psi``.

The replay is paired: both engines score the same reconstructed graphs
batch for batch, so per-record deltas are meaningful, not just the
histogram summary.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from deepdfa_tpu_torch.obs.drift import psi
from deepdfa_tpu_torch.resilience.journal import atomic_write_text

from .capture import read_capture, record_graph

__all__ = ["shadow_replay", "shadow_gate", "REPORT_NAME"]

REPORT_NAME = "shadow_report.json"
SCHEMA = 1


def _hist(scores, bins: int) -> list[int]:
    counts, _ = np.histogram(np.asarray(scores, dtype=np.float64),
                             bins=bins, range=(0.0, 1.0))
    return counts.astype(int).tolist()


def _replay(engine, graphs_by_bucket: dict) -> dict:
    """Score every reconstructed graph through the real engine, bucket by
    bucket, chunked at the bucket's batch capacity. Returns
    {bucket_key: [scores aligned with that bucket's graph list]}."""
    out: dict[str, list[float]] = {}
    for bkey, (bucket, graphs) in graphs_by_bucket.items():
        scores: list[float] = []
        cap = max(1, bucket.capacity)
        for i in range(0, len(graphs), cap):
            chunk = graphs[i:i + cap]
            probs = engine.score(chunk, bucket)
            scores.extend(float(p) for p in np.asarray(probs)[:len(chunk)])
        out[bkey] = scores
    return out


def shadow_replay(traffic_path, engine_a, engine_b, *, bins: int = 10,
                  max_psi: float = 0.25, out_path=None,
                  clock=time.time) -> dict:
    """Replay captured traffic through both engines and diff them.

    ``engine_a`` is the committed baseline, ``engine_b`` the candidate.
    Records whose graph no engine bucket admits are counted as
    ``oversize`` and excluded from both sides (paired replay stays
    paired). Raises ``ValueError`` on an empty traffic file: a shadow gate
    with no evidence must not silently pass."""
    records = read_capture(traffic_path)
    graphs_by_bucket: dict[str, tuple] = {}
    tiers: dict[str, list[int]] = {}
    oversize = 0
    for rec in records:
        g = record_graph(rec)
        if g is None:
            continue
        try:
            bucket = engine_a.assign_bucket(g)
        except Exception:  # noqa: BLE001 — OversizeGraphError and kin
            oversize += 1
            continue
        bkey = engine_a.bucket_key(bucket)
        if bkey not in graphs_by_bucket:
            graphs_by_bucket[bkey] = (bucket, [])
            tiers[bkey] = []
        graphs_by_bucket[bkey][1].append(g)
        tiers[bkey].append(int(rec.get("tier", 1)))
    n_replayed = sum(len(gs) for _, gs in graphs_by_bucket.values())
    if n_replayed == 0:
        raise ValueError(
            f"shadow replay has no scoreable traffic in {traffic_path} "
            f"({len(records)} records, {oversize} oversize) — refusing to "
            "emit an evidence-free report")

    scores_a = _replay(engine_a, graphs_by_bucket)
    scores_b = _replay(engine_b, graphs_by_bucket)

    buckets: dict[str, dict] = {}
    max_psi_seen = 0.0
    max_abs_delta = 0.0
    for bkey in sorted(graphs_by_bucket):
        a, b = scores_a[bkey], scores_b[bkey]
        delta = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
        bucket_psi = float(psi(_hist(a, bins), _hist(b, bins)))
        buckets[bkey] = {
            "n": len(a),
            "tiers": sorted(set(tiers[bkey])),
            "psi": round(bucket_psi, 6),
            "max_abs_delta": round(delta, 6),
            "mean_a": round(float(np.mean(a)), 6),
            "mean_b": round(float(np.mean(b)), 6),
        }
        max_psi_seen = max(max_psi_seen, bucket_psi)
        max_abs_delta = max(max_abs_delta, delta)

    rev_a = getattr(engine_a, "model_rev", None) or "unknown"
    rev_b = getattr(engine_b, "model_rev", None) or "unknown"
    report = {
        "schema": SCHEMA,
        "generated_at_unix": int(clock()),
        "traffic_path": str(traffic_path),
        "rev_a": rev_a,
        "rev_b": rev_b,
        "n_records": len(records),
        "n_replayed": n_replayed,
        "oversize": oversize,
        "bins": bins,
        "max_psi_gate": max_psi,
        "buckets": buckets,
        "max_psi": round(max_psi_seen, 6),
        "max_abs_delta": round(max_abs_delta, 6),
        "zero_diff": max_abs_delta == 0.0 and max_psi_seen == 0.0,
        "pass": max_psi_seen <= max_psi,
    }
    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_text(out_path,
                          json.dumps(report, indent=2, sort_keys=True) + "\n")
    return report


def shadow_gate(report: dict | None) -> tuple[bool, str]:
    """(allow, reason) from a shadow report. Missing or invalid evidence
    refuses: the same fail-closed posture as the veto artifact."""
    if not isinstance(report, dict) or report.get("schema") != SCHEMA:
        return False, "no shadow evidence"
    if not report.get("pass"):
        return False, (f"shadow gate failed: max_psi={report.get('max_psi')}"
                       f" > {report.get('max_psi_gate')}")
    return True, "shadow gate passed"
