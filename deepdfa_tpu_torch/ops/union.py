"""Differentiable set-union operators and their segment aggregators.

The port of ``deepdfa_tpu/ops/union.py``: the "learn the DFA lattice"
surface, bit-vector union made smooth so a GNN can imitate the
reaching-definitions meet operator.

- ``simple_union(a, b) = a + b - ab``;
- ``relu_union(a, b) = 1 - relu(1 - (a + b))``, ``min(1, a + b)`` on [0, 1].

The folds over a node's incoming messages have closed forms, so one
segment reduction does each aggregation:

- iterated ``simple_union`` over {x_i} = ``1 - Π (1 - x_i)``, the product
  taken as the exponential of an ordered sum of logs, with an exact-zero
  count;
- iterated ``relu_union`` over {x_i} ⊂ [0, 1] = ``min(1, Σ x_i)``.

Both fold in the node's own state as well. These are plain torch over
:func:`~deepdfa_tpu_torch.ops.segment.segment_sum`, whose order is fixed
on the card, so reruns are bitwise equal; the JAX package computes them
outside any Pallas kernel too.
"""

from __future__ import annotations

import torch

from deepdfa_tpu_torch.ops.segment import gather, segment_sum

__all__ = ["relu_union", "segment_union_relu", "segment_union_simple",
           "simple_union"]


def _relu(x: torch.Tensor) -> torch.Tensor:
    # ``torch.maximum`` splits the gradient at a tie, as ``jnp.maximum``
    # does (``clamp`` would pass all of it)
    return torch.maximum(x, torch.zeros_like(x))


def simple_union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b - a * b


def relu_union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return 1.0 - _relu(1.0 - (a + b))


def _segment_prod(data: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Product per segment: ``exp(Σ log(max(x, tiny)))``, and exactly 0
    where a segment holds a row ``<= 0``; an empty segment gives 1."""
    tiny = torch.finfo(data.dtype).tiny
    logs = torch.log(torch.maximum(data, torch.full_like(data, tiny)))
    log_prod = segment_sum(logs, segment_ids, num_segments)
    has_zero = segment_sum((data <= 0).to(data.dtype), segment_ids,
                           num_segments)
    return torch.where(has_zero > 0, torch.zeros_like(log_prod),
                       torch.exp(log_prod))


def segment_union_simple(h: torch.Tensor, messages: torch.Tensor,
                         senders: torch.Tensor,
                         receivers: torch.Tensor) -> torch.Tensor:
    """``simple_union`` folded over each node's incoming messages and its
    own state: ``1 - (1 - h) · Π_incoming (1 - msg)``."""
    comp = 1.0 - gather(messages, senders)
    prod = _segment_prod(comp, receivers, h.shape[0])
    return 1.0 - (1.0 - h) * prod


def segment_union_relu(h: torch.Tensor, messages: torch.Tensor,
                       senders: torch.Tensor,
                       receivers: torch.Tensor) -> torch.Tensor:
    """``relu_union`` folded over incoming messages and the node's own
    state: ``min(1, h + Σ_incoming msg)`` (exact for inputs in [0, 1])."""
    total = segment_sum(gather(messages, senders), receivers, h.shape[0])
    return relu_union(h, total)
