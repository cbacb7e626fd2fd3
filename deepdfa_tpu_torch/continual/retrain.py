"""Scheduled incremental retraining.

A copy of ``deepdfa_tpu/continual/retrain.py``. The loop's training leg,
built on three standing pieces: (1) the corpus delta re-extracts only
extraction-cache misses: :func:`corpus_delta` walks the new corpus through
the content-addressed :class:`~deepdfa_tpu_torch.data.extract_cache.
ExtractCache`, so an unchanged function costs a cache read, never a front
end parse; (2) fine-tuning resumes from the last committed checkpoint
through :func:`deepdfa_tpu_torch.train.fit.fit` (``resume=True``: the
crash-safe commits, sentinel rollback and preemption handling apply to the
retrain, and on the card a fused model trains on kernels B1 and B2); (3)
the candidate passes a fail-closed no-regression gate before promotion is
attempted: the perf ledger must be green (:class:`~deepdfa_tpu_torch.obs.
ledger.Ledger`, when ledger paths are given), the shadow report must pass,
and the tracked eval metric must not drop.

Every decision is journaled (``event="retrain"``), so an operator can
answer "what did the last retrain do and why was it refused" from one file.
"""

from __future__ import annotations

import time
from pathlib import Path

from deepdfa_tpu_torch.obs.ledger import Ledger

from .shadow import shadow_gate

__all__ = ["corpus_delta", "no_regression_gate", "run_retrain"]


def corpus_delta(sources, cache, extract) -> tuple[dict, dict]:
    """Extract a corpus through the content-addressed cache: only misses
    pay ``extract``. ``sources`` is ``{id: code}``; returns ``(values,
    stats)`` where ``values`` maps id → extracted value and ``stats``
    counts the delta (``misses`` is the work the new corpus cost)."""
    values: dict = {}
    hits = misses = failures = 0
    for sid, code in sources.items():
        try:
            value, hit = cache.get_or_extract(code, extract)
        except Exception:  # noqa: BLE001 — a poison function is a failure
            # row in the delta, never an aborted retrain
            failures += 1
            continue
        values[sid] = value
        if hit:
            hits += 1
        else:
            misses += 1
    stats = {"total": len(sources), "hits": hits, "misses": misses,
             "failures": failures,
             "delta_fraction": (misses / len(sources)) if sources else 0.0}
    return values, stats


def no_regression_gate(candidate_metrics, baseline_metrics, shadow_report,
                       *, metric: str, higher_is_better: bool = True,
                       max_drop: float = 0.0,
                       ledger_paths=None) -> dict:
    """Fail-closed candidate gate: ledger green AND shadow pass AND the
    tracked metric no worse than baseline − ``max_drop``. Missing evidence
    on any leg refuses (a gate with nothing to judge must not wave a
    candidate through). ``ledger_paths`` None leaves the ledger leg out."""
    reasons = []
    ledger_ok = True
    if ledger_paths is not None:
        ledger_ok, _rows = Ledger.from_paths(list(ledger_paths)).check()
        if not ledger_ok:
            reasons.append("perf ledger has a regression verdict")
    shadow_ok, shadow_reason = shadow_gate(shadow_report)
    if not shadow_ok:
        reasons.append(shadow_reason)
    cand = (candidate_metrics or {}).get(metric)
    base = (baseline_metrics or {}).get(metric)
    metric_ok = False
    if cand is None or base is None:
        reasons.append(f"metric {metric!r} missing from "
                       f"{'candidate' if cand is None else 'baseline'}")
    else:
        drop = (base - cand) if higher_is_better else (cand - base)
        metric_ok = drop <= max_drop
        if not metric_ok:
            reasons.append(f"{metric} regressed: {cand} vs baseline {base} "
                           f"(drop {drop:.6g} > {max_drop:.6g})")
    allow = ledger_ok and shadow_ok and metric_ok
    return {"allow": allow, "ledger_ok": ledger_ok, "shadow_ok": shadow_ok,
            "metric_ok": metric_ok, "metric": metric, "candidate": cand,
            "baseline": base, "reasons": reasons}


def _default_fit(cfg, run_dir, resume):
    from deepdfa_tpu_torch.train.fit import fit

    return fit(cfg, Path(run_dir), resume=resume)


def run_retrain(cfg, run_dir, *, sources, cache, extract,
                baseline_metrics=None, shadow_report=None,
                metric: str = "val_f1", higher_is_better: bool = True,
                max_drop: float = 0.0, ledger_paths=None, fit_fn=None,
                journal=None, clock=time.time) -> dict:
    """One scheduled retrain: delta-extract → fine-tune from the last
    committed checkpoint (``resume=True`` through ``fit``'s resilience
    path, on the card unless ``fit_fn`` says otherwise) → no-regression
    gate. Returns the decision record; ``promoted_candidate`` is True only
    when every gate leg passed. ``fit_fn(cfg, run_dir, resume)`` is
    injectable so schedulers and tests own the training cost."""
    t0 = clock()
    _values, delta = corpus_delta(sources, cache, extract)
    fit_fn = fit_fn or _default_fit
    run_dir = Path(run_dir)
    try:
        candidate_metrics = fit_fn(cfg, run_dir, True)
        fit_error = None
    except Exception as exc:  # noqa: BLE001 — a failed fine-tune is a
        # refused candidate with a reason, not a crashed scheduler
        candidate_metrics = None
        fit_error = f"{type(exc).__name__}: {exc}"
    gate = no_regression_gate(
        candidate_metrics, baseline_metrics, shadow_report,
        metric=metric, higher_is_better=higher_is_better,
        max_drop=max_drop, ledger_paths=ledger_paths)
    if fit_error is not None:
        gate["allow"] = False
        gate["reasons"].insert(0, f"fine-tune failed: {fit_error}")
    record = {
        "event": "retrain",
        "t_unix": int(t0),
        "seconds": round(clock() - t0, 3),
        "delta": delta,
        "metrics": candidate_metrics,
        "gate": gate,
        "promoted_candidate": bool(gate["allow"]),
    }
    if journal is not None:
        try:
            journal.write(**record)
        except Exception:  # noqa: BLE001 — journaling the decision must
            # not fail the decision
            pass
    return record
