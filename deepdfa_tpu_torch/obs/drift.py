"""Score-distribution drift sentinel.

A copy of ``deepdfa_tpu/obs/drift.py``. A server that journals scores but
never watches their *shape* misses the earliest signal of trouble: a
model rev whose score distribution walks away from what it produced when
it went live is the earliest operable signal of input drift, a bad
artifact promotion, or a poisoned cache. This sentinel keeps, per
``model_rev``:

- a **reference window** — the first ``window`` scores observed for that
  rev, frozen once full (the distribution the rev exhibited at launch);
- a **current window** — a sliding deque of the most recent ``window``
  scores;
- the **PSI** (population stability index) between the two, computed
  over ``bins`` equal-width bins on [0, 1]:

      PSI = sum_i (q_i - p_i) * ln(q_i / p_i)

  with epsilon-smoothed proportions so empty bins don't blow up. The
  usual operating folklore: PSI < 0.1 stable, 0.1–0.25 drifting,
  > 0.25 shifted — the default alert threshold (``obs.drift_threshold``)
  sits at 0.2.

Everything is O(window) per scrape and O(1) per observe; scores are
observed on the request path so this must stay allocation-light and
lock-cheap.
"""

from __future__ import annotations

import math
import threading
from collections import deque

__all__ = ["ScoreDriftSentinel", "psi"]

_EPS = 1e-4


def _proportions(counts, total: int, n_bins: int) -> list[float]:
    if total <= 0:
        return [1.0 / n_bins] * n_bins
    return [max(_EPS, c / total) for c in counts]


def psi(ref_counts, cur_counts) -> float:
    """Population stability index between two same-length histograms."""
    if len(ref_counts) != len(cur_counts):
        raise ValueError("histogram length mismatch")
    n = len(ref_counts)
    p = _proportions(ref_counts, sum(ref_counts), n)
    q = _proportions(cur_counts, sum(cur_counts), n)
    return float(sum((qi - pi) * math.log(qi / pi) for pi, qi in zip(p, q)))


class _RevWindow:
    __slots__ = ("reference", "current", "n_observed")

    def __init__(self, window: int):
        self.reference: list[float] | None = []   # frozen (-> tuple) when full
        self.current: deque[float] = deque(maxlen=window)
        self.n_observed = 0


class ScoreDriftSentinel:
    """Windowed per-``model_rev`` score histograms + PSI drift score.

    ``observe(score, model_rev)`` on the request path; ``snapshot()`` /
    ``stage(registry-families)`` at scrape time. The drift gauge for a
    rev is 0.0 until both windows hold at least ``min_samples`` scores —
    a cold rev never alerts.

    ``max_revs`` bounds the tracked revs LRU-style: a long-lived server
    scoring across many checkpoint promotions evicts its coldest rev's
    windows instead of growing ``/metrics`` and memory without bound
    (``evicted_revs_total`` counts them; a re-observed evicted rev starts
    cold, so it re-freezes a fresh reference window).
    """

    def __init__(self, window: int = 512, bins: int = 10,
                 threshold: float = 0.2, min_samples: int = 64,
                 max_revs: int = 64):
        if window < 2 or bins < 2:
            raise ValueError("drift window and bins must each be >= 2")
        if max_revs < 1:
            raise ValueError("drift max_revs must be >= 1")
        self.window = int(window)
        self.bins = int(bins)
        self.threshold = float(threshold)
        self.min_samples = max(1, int(min_samples))
        self.max_revs = int(max_revs)
        self.evicted_revs_total = 0
        self._lock = threading.Lock()
        # insertion order IS the LRU order: observe() re-inserts its rev
        self._revs: dict[str, _RevWindow] = {}

    # -- request path -------------------------------------------------------

    def observe(self, score: float, model_rev: str = "unknown") -> None:
        score = min(1.0, max(0.0, float(score)))
        with self._lock:
            rw = self._revs.pop(model_rev, None)
            if rw is None:
                rw = _RevWindow(self.window)
                while len(self._revs) >= self.max_revs:
                    self._revs.pop(next(iter(self._revs)))
                    self.evicted_revs_total += 1
            self._revs[model_rev] = rw  # (re-)insert at the hot end
            rw.n_observed += 1
            if isinstance(rw.reference, list):
                rw.reference.append(score)
                if len(rw.reference) >= self.window:
                    rw.reference = tuple(rw.reference)
            rw.current.append(score)

    # -- scrape path --------------------------------------------------------

    def _hist(self, scores) -> list[int]:
        counts = [0] * self.bins
        for s in scores:
            idx = min(self.bins - 1, int(s * self.bins))
            counts[idx] += 1
        return counts

    def snapshot(self) -> dict[str, dict]:
        """Per-rev drift state: current-window histogram, PSI vs the
        reference window, and whether the alert threshold is crossed."""
        with self._lock:
            revs = {rev: (list(rw.reference or ()), list(rw.current),
                          rw.n_observed)
                    for rev, rw in self._revs.items()}
        out: dict[str, dict] = {}
        for rev, (ref, cur, n_observed) in revs.items():
            ref_counts = self._hist(ref)
            cur_counts = self._hist(cur)
            ready = (len(ref) >= self.min_samples
                     and len(cur) >= self.min_samples)
            drift = psi(ref_counts, cur_counts) if ready else 0.0
            out[rev] = {
                "psi": round(drift, 6),
                "alert": bool(ready and drift >= self.threshold),
                "ready": ready,
                "n_observed": n_observed,
                "reference_n": len(ref),
                "current_n": len(cur),
                "current_counts": cur_counts,
                "current_sum": round(sum(cur), 6),
            }
        return out
