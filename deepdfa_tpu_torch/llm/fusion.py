"""LLM ⊕ GGNN fusion head.

The port of ``deepdfa_tpu/llm/fusion.py``:

- :func:`pool_tokens` — the per-example summary token of ``[b, s, h]``
  hidden states (``"last"`` real token by default, ``"first"``, ``"cls"``);
- :class:`ClassificationHead` — concatenate the pooled graph embedding, then
  ``dropout → dense(hidden) → tanh → dropout → out_proj(2)``. As in the JAX
  package the float32 graph embedding is first cast to the hidden states'
  type (bf16 for CodeLlama), then the whole row to the head's float32;
- :class:`FusionModel` — the GGNN in ``encoder_mode`` over the joined graph
  batch (slot ``i`` belongs to example ``i``) plus the head; 2-way logits.
  The encoder's layout follows ``gnn_cfg.layout``; a graph batch of the
  other layout (a segment batch to a dense encoder or the reverse) raises
  the JAX module's ``TypeError``;
- :func:`fusion_loss` — masked mean cross-entropy and the softmax.

Parameter names follow the JAX tree (``flowgnn_encoder.*``,
``classifier.dense``, ``classifier.out_proj``), so
``bridge.fusion_flax_to_torch`` carries a trained tree across.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from deepdfa_tpu_torch import resolve_device
from deepdfa_tpu_torch.config import GGNNConfig

__all__ = ["ClassificationHead", "FusionModel", "build_fusion",
           "fusion_loss", "pool_tokens"]


def pool_tokens(features: torch.Tensor, token_mask: torch.Tensor | None,
                pool: str) -> torch.Tensor:
    """The summary token of ``[b, s, h]`` hidden states: ``"last"`` the last
    real token (position ``s-1`` under the framework's left padding; an
    all-padding row falls back to ``s-1``), ``"first"`` position 0, ``"cls"``
    the first real token."""
    if pool == "first" or (pool == "cls" and token_mask is None):
        return features[:, 0, :]
    rows = torch.arange(features.shape[0], device=features.device)
    if pool == "cls":
        first = torch.argmax(token_mask.to(torch.int32), dim=1)
        return features[rows, first]
    if pool != "last":
        raise ValueError(f"unknown pool {pool!r}")
    if token_mask is None:
        return features[:, -1, :]
    s = features.shape[1]
    rev = torch.flip(token_mask.to(torch.int32), dims=(1,))
    last = s - 1 - torch.argmax(rev, dim=1)
    return features[rows, last]


class ClassificationHead(nn.Module):
    """``dense(in_features → hidden_size) → tanh → out_proj(2)`` with
    dropout before each, in float32."""

    def __init__(self, in_features: int, hidden_size: int,
                 dropout_rate: float = 0.0, pool: str = "last"):
        super().__init__()
        self.pool = pool
        self.dropout = nn.Dropout(dropout_rate)
        self.dense = nn.Linear(in_features, hidden_size)
        self.out_proj = nn.Linear(hidden_size, 2)

    def forward(self, features: torch.Tensor,
                flowgnn_embed: torch.Tensor | None,
                token_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = pool_tokens(features, token_mask, self.pool)
        if flowgnn_embed is not None:
            x = torch.cat([x, flowgnn_embed.to(x.dtype)], dim=-1)
        x = self.dense(self.dropout(x.to(torch.float32)))
        return self.out_proj(self.dropout(torch.tanh(x)))


class FusionModel(nn.Module):
    """GGNN encoder + classification head. ``gnn_cfg`` is forced into
    encoder mode with graph labels; ``use_gnn=False`` is the LLM-only head.
    The encoder's layout follows ``gnn_cfg.layout`` (segment, fused or
    dense: one parameter set), and the joined batch's type must match it:
    ``GraphJoin(layout="dense")`` for a dense encoder."""

    def __init__(self, gnn_cfg: GGNNConfig, input_dim: int,
                 llm_hidden_size: int, use_gnn: bool = True,
                 dropout_rate: float = 0.0, pool: str = "last"):
        super().__init__()
        self.use_gnn = use_gnn
        in_features = llm_hidden_size
        if use_gnn:
            from deepdfa_tpu_torch.models.ggnn import GGNN
            from deepdfa_tpu_torch.models.ggnn_dense import GGNNDense
            from deepdfa_tpu_torch.models.ggnn_fused import GGNNFused
            from deepdfa_tpu_torch.models.ggnn_megabatch import GGNNMegabatch

            cfg = dataclasses.replace(gnn_cfg, encoder_mode=True,
                                      label_style="graph")
            cls = {"fused": GGNNFused, "megabatch": GGNNMegabatch,
                   "dense": GGNNDense}.get(cfg.layout, GGNN)
            self.flowgnn_encoder = cls(cfg, input_dim)
            in_features += cfg.out_dim
        self.classifier = ClassificationHead(in_features, llm_hidden_size,
                                             dropout_rate, pool)

    def forward(self, llm_hidden_states: torch.Tensor, graphs,
                token_mask: torch.Tensor | None = None) -> torch.Tensor:
        embed = None
        if self.use_gnn:
            # the batch's type is the layout: a nameable error instead of a
            # shape error deep inside the encoder
            is_dense = hasattr(graphs, "adj")
            want_dense = self.flowgnn_encoder.cfg.layout == "dense"
            if is_dense != want_dense:
                raise TypeError(
                    f"FusionModel(layout={self.flowgnn_encoder.cfg.layout!r}"
                    f") got a {'dense' if is_dense else 'segment'}-layout "
                    "graph batch — construct GraphJoin with the same layout "
                    "as fusion.gnn_cfg.layout")
            pooled = self.flowgnn_encoder(graphs)  # [max_graphs, out_dim]
            embed = pooled[: llm_hidden_states.shape[0]]
        return self.classifier(llm_hidden_states, embed, token_mask)


def fusion_loss(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean cross-entropy over the real examples, softmax probabilities)."""
    ce = F.cross_entropy(logits, labels.long(), reduction="none")
    w = mask.to(torch.float32)
    loss = torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)
    return loss, torch.softmax(logits, dim=-1)


def build_fusion(gnn_cfg: GGNNConfig, input_dim: int, llm_hidden_size: int,
                 *, use_gnn: bool = True, dropout_rate: float = 0.0,
                 pool: str = "last", device=None, seed: int = 0
                 ) -> FusionModel:
    """A :class:`FusionModel` initialised from ``seed`` with the JAX
    package's initialisers in distribution, on ``device`` (``cuda`` unless
    the caller names another)."""
    from deepdfa_tpu_torch.models.ggnn import init_params

    dev = resolve_device(device)
    model = FusionModel(gnn_cfg, input_dim, llm_hidden_size, use_gnn,
                        dropout_rate, pool)
    return init_params(model, seed).to(dev).eval()
