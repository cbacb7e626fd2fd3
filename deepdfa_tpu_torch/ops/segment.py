"""Segment reductions for batched graphs, in plain torch.

The port of ``deepdfa_tpu/ops/segment.py``. These are not kernels: the JAX
package runs them as XLA ops outside any Pallas call, and here they are
torch ops. ``num_segments`` is always explicit (batches have fixed shapes).

Summation order: on the CPU, ``index_add_`` adds rows in index order, as
XLA's CPU scatter does, so sums agree with the JAX package bit for bit. On
CUDA, ``index_add_`` adds with float atomics in an order that changes from
run to run; callers compare against it with a tolerance (the GGNN tests use
``atol=2e-5, rtol=1e-4``, and the card's end-to-end check 1e-4 on
probabilities).
"""

from __future__ import annotations

import torch

__all__ = ["gather", "segment_sum", "segment_max", "segment_softmax"]


def gather(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``values[indices]`` along axis 0 — an edge reads its endpoint."""
    return values.index_select(0, indices)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum of the rows of ``data`` that share a segment id; an empty
    segment sums to 0."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of the rows of ``data`` that share a segment id; an empty
    segment gives ``-inf`` (the identity of max, as ``jax.ops.segment_max``)."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), float("-inf"))
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce_(0, idx.expand_as(data), data, "amax",
                               include_self=True)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Numerically stable softmax within each segment.

    ``mask`` (bool, per row) excludes padding rows: their weight is exactly
    0 and they do not shift the max. A segment of padding rows only has max
    ``-inf``, which becomes 0; a zero denominator becomes 1.
    """
    if mask is not None:
        m = mask if logits.dim() == 1 else mask[:, None]
        logits = torch.where(m, logits, torch.full_like(logits, float("-inf")))
    maxes = segment_max(logits, segment_ids, num_segments)
    maxes = torch.where(torch.isfinite(maxes), maxes, torch.zeros_like(maxes))
    exp = torch.exp(logits - gather(maxes, segment_ids))
    if mask is not None:
        exp = torch.where(m, exp, torch.zeros_like(exp))
    denom = segment_sum(exp, segment_ids, num_segments)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return exp / gather(denom, segment_ids)
