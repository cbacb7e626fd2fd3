"""Masked confusion counts, the metrics computed from them, PR curves and
the confusion matrix.

The port of ``deepdfa_tpu/train/metrics.py``: the counts are float32 scalar
tensors on the batch's device, updated step by step without a host sync;
masked rows contribute nothing. ``compute_metrics`` mirrors torchmetrics'
micro-averaged defaults (global counts, threshold 0.5, 0 when a denominator
is 0). :func:`classification_report` and :func:`pr_curve` are the JAX
package's sklearn calls, computed here with numpy alone (the card's machine
has no sklearn). :func:`eval_statements` and :func:`eval_statements_list`
are IVDetect's statement top-k ranking, which ``test`` reports for
node-label models.
"""

from __future__ import annotations

from typing import NamedTuple

import warnings

import numpy as np
import torch

__all__ = ["ConfusionState", "MeanState", "binned_pr_curve",
           "classification_report", "compute_metrics", "confusion_matrix",
           "eval_statements", "eval_statements_list", "pr_curve", "update_confusion", "update_confusion_by_class",
           "update_mean"]


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


class MeanState(NamedTuple):
    total: torch.Tensor
    count: torch.Tensor

    @classmethod
    def zeros(cls, device=None) -> "MeanState":
        return cls(*(torch.zeros((), dtype=torch.float32, device=device)
                     for _ in range(2)))

    def compute(self) -> float:
        c = float(self.count)
        return float(self.total) / c if c else 0.0


def update_mean(state: MeanState, value, weight=1.0) -> MeanState:
    value = torch.as_tensor(value, dtype=torch.float32,
                            device=state.total.device)
    weight = torch.as_tensor(weight, dtype=torch.float32,
                             device=state.total.device)
    return MeanState(state.total + value * weight, state.count + weight)


def update_confusion_by_class(state_pos: ConfusionState,
                              state_neg: ConfusionState, probs: torch.Tensor,
                              labels: torch.Tensor,
                              mask: torch.Tensor | None = None,
                              threshold: float = 0.5
                              ) -> tuple[ConfusionState, ConfusionState]:
    """Positive-only and negative-only collections (the reference's
    ``test_metrics_positive`` / ``_negative``, ``base_module.py:50-60``):
    each sees only the examples whose true label matches."""
    m = torch.ones_like(probs) if mask is None else mask.float()
    lab = labels.float()
    pos = update_confusion(state_pos, probs, labels, m * lab, threshold)
    neg = update_confusion(state_neg, probs, labels, m * (1.0 - lab),
                           threshold)
    return pos, neg


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


def confusion_matrix(probs: np.ndarray, labels: np.ndarray,
                     threshold: float = 0.5) -> np.ndarray:
    """2x2 confusion matrix [[tn, fp], [fn, tp]] (``base_module.py:383``)."""
    preds = (np.asarray(probs) >= threshold).astype(int)
    labels = np.asarray(labels).astype(int)
    return np.bincount(labels * 2 + preds, minlength=4).reshape(2, 2)


def eval_statements(probs: np.ndarray, labels: np.ndarray,
                    thresh: float = 0.5) -> dict[int, int]:
    """IVDetect's top-k statement ranking for ONE function
    (``helpers/evaluate.py:262-291``): rank statements by probability;
    hit@k is 1 iff a truly vulnerable statement is in the top k. For a
    function with no vulnerable statement, hit@k is 1 iff nothing is
    predicted above ``thresh`` (a correct all-clear)."""
    probs = np.asarray(probs, dtype=float)
    labels = np.asarray(labels, dtype=int)
    if labels.sum() == 0:
        clear = int(not (probs > thresh).any())
        return {k: clear for k in range(1, 11)}
    order = np.argsort(-probs, kind="stable")
    ranked = labels[order]
    return {k: int(ranked[:k].any()) for k in range(1, 11)}


def eval_statements_list(items: list[tuple[np.ndarray, np.ndarray]],
                         thresh: float = 0.5,
                         vulonly: bool = False) -> dict[int, float]:
    """Corpus-level top-k hit rates (``evaluate.py:294-322``): the mean
    hit@k over vulnerable functions, times the all-clear rate over the
    other functions unless ``vulonly``. An absent class counts as 1, so a
    corpus with no clean function keeps its vulnerable rate."""

    def rate(subset, empty: float):
        if not subset:
            return {k: empty for k in range(1, 11)}
        acc = {k: 0 for k in range(1, 11)}
        for probs, labels in subset:
            hit = eval_statements(probs, labels, thresh)
            for k in acc:
                acc[k] += hit[k]
        return {k: v / len(subset) for k, v in acc.items()}

    vul = [i for i in items if np.asarray(i[1]).sum() > 0]
    vul_rate = rate(vul, 0.0)
    if vulonly:
        return vul_rate
    nonvul = [i for i in items if np.asarray(i[1]).sum() == 0]
    nonvul_rate = rate(nonvul, 1.0)
    if not vul:
        return nonvul_rate
    return {k: vul_rate[k] * nonvul_rate[k] for k in range(1, 11)}


def pr_curve(probs: np.ndarray, labels: np.ndarray):
    """(precision, recall, thresholds), written to ``pr.csv``
    (``base_module.py:358-359``): ``sklearn.metrics.precision_recall_curve``
    as sklearn 1.9 computes it (no truncation at full recall), with a
    closing threshold of 1.0 appended as the JAX package does. Scores are
    sorted descending; each distinct score is one threshold, its ties
    counted together; precision is 0 where nothing is predicted positive,
    and recall is 1 everywhere (with a warning) when no label is positive.
    Labels must be 0/1."""
    y_true = np.asarray(labels).reshape(-1)
    y_score = np.asarray(probs).reshape(-1)
    if y_true.shape != y_score.shape:
        raise ValueError(f"pr_curve: {y_true.size} labels for {y_score.size} "
                         "scores")
    if not np.all(np.isfinite(y_score)):
        raise ValueError("pr_curve: non-finite scores")
    if not np.isin(np.unique(y_true), (0, 1)).all():
        raise ValueError("pr_curve: labels must be 0/1")
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score = y_score[order]
    hit = (y_true[order] == 1).astype(np.float64)
    idx = np.concatenate([np.nonzero(np.diff(y_score))[0],
                          [y_true.size - 1]])
    tps = np.cumsum(hit, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    ps = tps + fps
    precision = np.where(ps != 0, np.divide(tps, np.where(ps != 0, ps, 1.0)),
                         0.0)
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to "
                      "one for all thresholds.")
        recall = np.full(tps.shape, 1.0)
    else:
        recall = tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]),
            np.concatenate([y_score[idx][::-1], [1.0]]))


def binned_pr_curve(probs: np.ndarray, labels: np.ndarray, bins: int = 1):
    """Fixed-threshold PR curve, as
    ``torchmetrics.BinnedPrecisionRecallCurve(num_thresholds=bins)``."""
    thresholds = np.linspace(0, 1, bins)
    precision = np.zeros(bins + 1)
    recall = np.zeros(bins + 1)
    for i, t in enumerate(thresholds):
        preds = probs >= t
        tp = float(np.sum(preds & (labels == 1)))
        fp = float(np.sum(preds & (labels == 0)))
        fn = float(np.sum(~preds & (labels == 1)))
        precision[i] = tp / (tp + fp) if (tp + fp) else 1.0
        recall[i] = tp / (tp + fn) if (tp + fn) else 0.0
    precision[bins] = 1.0
    recall[bins] = 0.0
    return precision, recall, np.concatenate([thresholds, [1.0]])
