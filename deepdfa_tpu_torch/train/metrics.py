"""Masked confusion counts and the metrics computed from them.

The port of the part of ``deepdfa_tpu/train/metrics.py`` the trainer uses:
the counts are float32 scalar tensors on the batch's device, updated step by
step without a host sync; masked rows contribute nothing. ``compute_metrics``
mirrors torchmetrics' micro-averaged defaults (global counts, threshold 0.5,
0 when a denominator is 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["ConfusionState", "compute_metrics", "update_confusion"]


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
