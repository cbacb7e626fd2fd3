"""Masked confusion counts and the metrics computed from them.

The port of the part of ``deepdfa_tpu/train/metrics.py`` the trainer uses:
the counts are float32 scalar tensors on the batch's device, updated step by
step without a host sync; masked rows contribute nothing. ``compute_metrics``
mirrors torchmetrics' micro-averaged defaults (global counts, threshold 0.5,
0 when a denominator is 0). :func:`classification_report` is the JAX
package's sklearn-style report, computed here with numpy alone.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["ConfusionState", "classification_report", "compute_metrics",
           "update_confusion"]


class ConfusionState(NamedTuple):
    tp: torch.Tensor
    fp: torch.Tensor
    tn: torch.Tensor
    fn: torch.Tensor

    @classmethod
    def zeros(cls, device=None) -> "ConfusionState":
        return cls(*(torch.zeros((), dtype=torch.float32, device=device)
                     for _ in range(4)))


def update_confusion(state: ConfusionState, probs: torch.Tensor,
                     labels: torch.Tensor, mask: torch.Tensor | None = None,
                     threshold: float = 0.5) -> ConfusionState:
    """Accumulate confusion counts. ``probs`` in [0,1]; ``labels`` {0,1}."""
    preds = (probs >= threshold).float()
    labels = labels.float()
    m = torch.ones_like(preds) if mask is None else mask.float()
    tp = torch.sum(m * preds * labels)
    fp = torch.sum(m * preds * (1 - labels))
    fn = torch.sum(m * (1 - preds) * labels)
    tn = torch.sum(m * (1 - preds) * (1 - labels))
    return ConfusionState(state.tp + tp, state.fp + fp, state.tn + tn,
                          state.fn + fn)


def compute_metrics(state: ConfusionState, prefix: str = "") -> dict[str, float]:
    """Micro-averaged Accuracy/Precision/Recall/F1 from accumulated counts
    (torchmetrics' convention: 0 when the denominator is 0)."""
    tp, fp, tn, fn = (float(x) for x in state)
    total = tp + fp + tn + fn
    acc = (tp + tn) / total if total else 0.0
    prec = tp / (tp + fp) if (tp + fp) else 0.0
    rec = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
    return {
        f"{prefix}Accuracy": acc,
        f"{prefix}Precision": prec,
        f"{prefix}Recall": rec,
        f"{prefix}F1Score": f1,
    }


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """``num / den`` in float64, 0 where ``den`` is 0 (sklearn's
    ``zero_division=0``)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.where(den == 0, 0.0, num / np.where(den == 0, 1.0, den))


def classification_report(probs: np.ndarray, labels: np.ndarray,
                          macro: bool = True,
                          threshold: float = 0.5) -> dict[str, float]:
    """The report the reference logs (``train.py:450-459,576-585``), as
    sklearn's ``precision_recall_fscore_support(labels=[0, 1],
    zero_division=0)`` computes it: per-class precision, recall and F1 and
    their macro (imbalanced Big-Vul) or support-weighted average over the
    classes present in the labels or the predictions (sklearn's average
    call takes no ``labels``), and each class's support. A prediction is
    positive at ``probs >= threshold``. No examples raise ``ValueError``,
    as in sklearn."""
    preds = (np.asarray(probs) >= threshold).astype(int)
    labels = np.asarray(labels).astype(int)
    if labels.size == 0:
        raise ValueError("classification_report: no examples")
    classes = np.array([0, 1])
    tp = np.array([np.sum((preds == c) & (labels == c)) for c in classes])
    pred_sum = np.array([np.sum(preds == c) for c in classes])
    true_sum = np.array([np.sum(labels == c) for c in classes])
    p = _divide(tp, pred_sum)
    r = _divide(tp, true_sum)
    # sklearn's F-score from counts: 2 tp / (true + predicted)
    f = _divide(2.0 * tp, 1.0 * true_sum + pred_sum)
    avg = "macro" if macro else "weighted"
    present = np.isin(classes, np.union1d(labels, preds))

    def mean(x: np.ndarray) -> float:
        if macro:
            return float(np.mean(x[present]))
        w = true_sum[present]
        return float(np.average(x[present], weights=w)) if w.sum() else 0.0

    return {
        "precision_0": float(p[0]), "recall_0": float(r[0]),
        "f1_0": float(f[0]),
        "precision_1": float(p[1]), "recall_1": float(r[1]),
        "f1_1": float(f[1]),
        f"precision_{avg}": mean(p), f"recall_{avg}": mean(r),
        f"f1_{avg}": mean(f),
        "support_0": int(true_sum[0]), "support_1": int(true_sum[1]),
    }
