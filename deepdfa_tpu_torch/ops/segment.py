"""Segment reductions for batched graphs, in plain torch.

The port of ``deepdfa_tpu/ops/segment.py``. These are not kernels: the JAX
package runs them as XLA ops outside any Pallas call, and here they are
torch ops. ``num_segments`` is always explicit (batches have fixed shapes).

Summation order: on the CPU, ``index_add_`` adds rows in index order, as
XLA's CPU scatter does, so sums agree with the JAX package bit for bit. On
CUDA, ``index_add_`` would add with float atomics in an order that changes
from run to run, so :func:`segment_sum` and the backward of :func:`gather`
reduce in a fixed order instead: the rows are put in segment order by a
stable sort and reduced by ``torch.segment_reduce`` over contiguous ranges,
with no float atomics. Two calls on the same inputs are bitwise equal, and
so are two training runs and a resumed one. A :func:`segment_sum` that
needs no gradient goes through the registered op ``deepdfa::segment_sum``
(:mod:`.custom_ops`), so an exported program picks the CPU or the CUDA sum
from its inputs' device when it runs, not when it was traced.
"""

from __future__ import annotations

import torch

from deepdfa_tpu_torch.ops import custom_ops

__all__ = ["gather", "segment_sum", "segment_max", "segment_softmax"]


def _ordered_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """CUDA: the per-segment sum in a fixed order. A stable sort puts each
    segment's rows together in index order (a permutation, so its own
    backward adds no two rows into one); ``segment_reduce`` then reduces
    each contiguous range without atomics."""
    ids, order = torch.sort(segment_ids, stable=True)
    bounds = torch.arange(num_segments + 1, device=ids.device, dtype=ids.dtype)
    offsets = torch.searchsorted(ids, bounds)
    return torch.segment_reduce(data.index_select(0, order), "sum",
                                offsets=offsets, axis=0, unsafe=True)


class _Gather(torch.autograd.Function):
    """``values[indices]`` whose backward is the ordered segment sum of the
    cotangent (``index_select``'s own backward adds with atomics on CUDA)."""

    @staticmethod
    def forward(ctx, values, indices):
        ctx.save_for_backward(indices)
        ctx.n = values.shape[0]
        return values.index_select(0, indices)

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        return _ordered_segment_sum(g, indices, ctx.n), None


def gather(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``values[indices]`` along axis 0 — an edge reads its endpoint."""
    if values.device.type == "cuda" and values.requires_grad:
        return _Gather.apply(values, indices)
    return values.index_select(0, indices)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum of the rows of ``data`` that share a segment id; an empty
    segment sums to 0."""
    if not (torch.is_grad_enabled() and data.requires_grad):
        return custom_ops.segment_sum(data, segment_ids, num_segments)
    if data.device.type == "cuda":
        return _ordered_segment_sum(data, segment_ids, num_segments)
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
