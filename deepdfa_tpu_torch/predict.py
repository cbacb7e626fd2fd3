"""Function scoring with a live GGNN.

The port of ``make_scorer`` from ``deepdfa_tpu/predict.py`` for graph labels:
one callable from a padded batch of tensors to per-graph vulnerability
probabilities and per-node attention-gate weights (the cheap statement
saliency of the readout).
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["make_scorer"]


def make_scorer(model, label_style: str) -> Callable:
    """``batch -> (fn_prob[max_graphs], gate_weights[max_nodes])`` under
    ``torch.inference_mode()``. Unsupported checkpoints fail here with a
    clear message."""
    cfg = getattr(model, "cfg", None)
    if cfg is not None and cfg.encoder_mode:
        raise ValueError(
            "predict needs a classifier head; encoder_mode models return "
            "pooled embeddings")
    if cfg is not None and cfg.layout == "megabatch":
        raise ValueError(
            "a layout='megabatch' model computes no per-node gate weights, "
            "which scoring reports; serve its state dict with "
            "layout='fused' (the same parameters and logits)")
    if label_style == "node":
        raise NotImplementedError(
            "node-label scoring is not ported yet (ROADMAP A3/A6)")
    if label_style != "graph":
        raise ValueError(
            f"predict supports label_style 'graph' or 'node', not "
            f"{label_style!r}")

    def score(batch):
        with torch.inference_mode():
            logits, gate = model(batch, return_gate=True)
            return torch.sigmoid(logits), gate

    return score
