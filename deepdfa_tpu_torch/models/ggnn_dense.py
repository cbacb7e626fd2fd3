"""GGNN over dense per-graph adjacency: message passing as batched products.

The port of ``deepdfa_tpu/models/ggnn_dense.py``: the same model and the
same parameters as :class:`~deepdfa_tpu_torch.models.ggnn.GGNN` (module
names match, so a state dict moves between the layouts), but the graph is a
``[G, n, n]`` adjacency (:class:`~deepdfa_tpu_torch.data.dense.DenseBatch`)
instead of flat edge lists, and one round of message passing is

    ``agg = einsum('gji,gjd->gid', adj, msg)``

a batched matrix product. The union aggregators become products too:

- ``union_relu``: ``min(1, σh + adjᵀ σm)``, the same product on σ;
- ``union_simple``: ``1 - (1-σh) · exp(adjᵀ log(1-σm))``, the product over
  incoming edges taken in log space in float32 (a duplicate edge counts
  once per copy, as in the segment fold), with the clamp that makes a
  saturated message an exact zero.

The JAX package computes these products with ``jnp.einsum`` outside any
Pallas kernel, so here they stay ``torch.bmm`` (cuBLAS on the card), in
float32 with TF32 off in the forward and in the products' backward,
whatever the process's global setting. Padding nodes are inert (zero
adjacency rows and columns, masked out of pooling).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from deepdfa_tpu_torch.data.dense import DenseBatch
from deepdfa_tpu_torch.models.ggnn import (GGNN, GatedGraphConv,
                                           GlobalAttentionPooling)

__all__ = ["GGNNDense", "GatedGraphConvDense", "GlobalAttentionPoolingDense",
           "ieee_fp32"]

# the smallest normal float32 and its float32 logarithm
_TINY = torch.finfo(torch.float32).tiny
_LOG_TINY = float(torch.log(torch.tensor(_TINY, dtype=torch.float32)))


@contextmanager
def ieee_fp32():
    """float32 products without TF32 on the card for the block's duration
    (the global setting is restored after)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _AdjacencyProduct(torch.autograd.Function):
    """``adjᵀ @ x`` per graph (``einsum('gji,gjd->gid')``), forward and
    backward in IEEE float32."""

    @staticmethod
    def forward(ctx, adj, x):
        ctx.save_for_backward(adj)
        with ieee_fp32():
            return torch.bmm(adj.transpose(1, 2), x)

    @staticmethod
    def backward(ctx, grad):
        (adj,) = ctx.saved_tensors
        with ieee_fp32():
            return None, torch.bmm(adj, grad)


def adjacency_product(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum('gji,gjd->gid', adj, x)``: each node sums its in-edges'
    rows (the adjacency is a constant of the batch: no gradient)."""
    return _AdjacencyProduct.apply(adj, x)


class GatedGraphConvDense(GatedGraphConv):
    """``n_steps`` of (linear → adjacency product → GRU) on ``[G, n, d]``
    states; the parameters are :class:`GatedGraphConv`'s."""

    def forward(self, h: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        if h.shape[-1] > self.out_feats:
            raise ValueError("in_feats must be <= out_feats (DGL contract)")
        if h.shape[-1] < self.out_feats:
            pad = h.new_zeros((*h.shape[:-1], self.out_feats - h.shape[-1]))
            h = torch.cat([h, pad], dim=-1)
        adj = adj.to(h.dtype)
        for _ in range(self.n_steps):
            msg = self.edge_linear(h)
            if self.aggregation == "sum":
                agg = adjacency_product(adj, msg)
            elif self.aggregation == "union_relu":
                total = adjacency_product(adj, torch.sigmoid(msg))
                agg = 1.0 - torch.clamp(1.0 - (torch.sigmoid(h) + total),
                                        min=0.0)
            else:  # union_simple
                m = torch.sigmoid(msg)
                logs = torch.log(torch.clamp(1.0 - m, min=_TINY).float())
                logsum = adjacency_product(adj.float(), logs)
                # a saturated message (σm == 1) zeroes the segment fold's
                # product, while the log-space sum bottoms out near
                # exp(log(tiny)·k): flush every sum at or below log(tiny)
                # to an exact 0 (a real product that small underflows to 0
                # anyway)
                prod = torch.where(logsum <= _LOG_TINY,
                                   torch.zeros_like(logsum),
                                   torch.exp(logsum)).to(h.dtype)
                agg = 1.0 - (1.0 - torch.sigmoid(h)) * prod
            h = self.gru(agg, h)
        return h


class GlobalAttentionPoolingDense(GlobalAttentionPooling):
    """Masked softmax attention readout over the node axis of ``[G, n, d]``:
    padding nodes get a gate logit of −∞. Returns the pooled ``[G, d]`` and
    the ``[G, n]`` gate weights."""

    def forward(self, h: torch.Tensor, node_mask: torch.Tensor):
        gate_logit = self.gate(h)[..., 0]
        neg_inf = torch.full_like(gate_logit, float("-inf"))
        gate_logit = torch.where(node_mask, gate_logit, neg_inf)
        top = torch.amax(torch.where(node_mask, gate_logit,
                                     torch.full_like(gate_logit, -1e30)),
                         dim=1, keepdim=True)
        gate_logit = gate_logit - top
        exp = torch.where(node_mask, torch.exp(gate_logit),
                          torch.zeros_like(gate_logit))
        denom = torch.sum(exp, dim=1, keepdim=True)
        gate = exp / torch.where(denom == 0, torch.ones_like(denom), denom)
        return torch.einsum("gn,gnd->gd", gate, h), gate


class GGNNDense(GGNN):
    """The dense-layout forward of the flagship model
    (``layout="dense"``), over :class:`DenseBatch` tensors: one logit per
    graph slot ``[G]`` (``label_style="graph"``) or per node slot ``[G, n]``
    (the node styles), the pooled rows in ``encoder_mode``. The parameters
    are :class:`GGNN`'s; ``taps`` are a segment-layout diagnostic and
    raise."""

    def __init__(self, cfg, input_dim: int):
        super().__init__(cfg, input_dim)
        if cfg.label_style == "graph":
            self.pooling = GlobalAttentionPoolingDense(self.pooling.gate
                                                       .in_features)

    def _conv(self, hidden_dim: int):
        return GatedGraphConvDense(hidden_dim, self.cfg.n_steps,
                                   self.cfg.aggregation)

    def forward(self, batch: DenseBatch, return_gate: bool = False,
                taps=None):
        if taps is not None:
            raise ValueError("per-step taps are a segment-layout diagnostic "
                             "(use layout=segment)")
        if not hasattr(batch, "adj"):
            raise TypeError(
                f"layout='dense' takes a DenseBatch, got "
                f"{type(batch).__name__} (score segment batches with the "
                f"segment twin, train.loop.segment_twin)")
        with ieee_fp32():
            feat_embed = self.embed_nodes(batch)  # [G, n, e]
            ggnn_out = self.ggnn(feat_embed, batch.adj)
            out = torch.cat([ggnn_out, feat_embed], dim=-1)
            gate = None
            if self.cfg.label_style == "graph":
                out, gate = self.pooling(out, batch.node_mask)
            if self.cfg.encoder_mode:
                return (out, gate) if return_gate else out
            for i, layer in enumerate(self.head):
                out = layer(out)
                if i != len(self.head) - 1:
                    out = torch.relu(out)
        logits = out[..., 0]
        return (logits, gate) if return_gate else logits
