"""Gated Graph Neural Network over batched CFGs, in PyTorch.

The port of ``deepdfa_tpu/models/ggnn.py`` (segment layout): abstract-dataflow
embeddings → ``n_steps`` rounds of (edge linear → gather(senders) → sum over
receivers → GRU) → gated attention pooling → MLP classifier. Parameters
carry the JAX package's values through :mod:`deepdfa_tpu_torch.bridge`.

This slice covers the concatenated-subkey and single-table embeddings,
``label_style="graph"``, the classifier head and ``encoder_mode`` (no head:
the pooled ``[max_graphs, out_dim]`` rows, what the LLM fusion head reads).
The static-analysis feature families, union aggregation, node labels and
per-step ``taps`` raise ``NotImplementedError``: later slices port them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from deepdfa_tpu_torch import resolve_device
from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig
from deepdfa_tpu_torch.data.graphs import BatchedGraphs
from deepdfa_tpu_torch.ops.segment import gather, segment_softmax, segment_sum

__all__ = ["GGNN", "GRUCell", "GatedGraphConv", "GlobalAttentionPooling",
           "check_edges_sorted", "init_params"]


class GRUCell(nn.Module):
    """GRU cell with torch ``nn.GRUCell``'s gate layout (reset/update/new).
    The three per-gate projections of each input are fused into one
    ``features → 3·features`` linear per input, columns ordered ``r|z|n``."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features
        self.x_proj = nn.Linear(features, 3 * features)
        self.h_proj = nn.Linear(features, 3 * features)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        xr, xz, xn = self.x_proj(x).chunk(3, dim=-1)
        hr, hz, hn = self.h_proj(h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h


def check_edges_sorted(receivers: torch.Tensor) -> None:
    """Raise unless the edge list is sorted by receiver: the fused kernel
    builds its CSR segments from that order, and would sum wrongly. Skipped
    while ``torch.export`` traces (the check reads values, which a traced
    program has not): an exported program's caller checks the sort on the
    host (:mod:`deepdfa_tpu_torch.serving`)."""
    if torch.compiler.is_exporting():
        return
    if receivers.numel() > 1 and bool((receivers[1:] < receivers[:-1]).any()):
        raise ValueError(
            "edges are not sorted by receiver — sort hand-built edge lists "
            "(batch_np does this on the host)")


class GatedGraphConv(nn.Module):
    """``n_steps`` of (linear → gather(senders) → sum over receivers → GRU),
    with sum aggregation. Input features are zero-padded from ``in_feats``
    up to ``out_feats``. Edges must arrive sorted by receiver (the
    ``batch_np`` contract); every call checks it."""

    def __init__(self, out_feats: int, n_steps: int):
        super().__init__()
        self.out_feats = out_feats
        self.n_steps = n_steps
        self.edge_linear = nn.Linear(out_feats, out_feats)
        self.gru = GRUCell(out_feats)

    def _pad(self, h: torch.Tensor, receivers: torch.Tensor) -> torch.Tensor:
        check_edges_sorted(receivers)
        if h.shape[-1] > self.out_feats:
            raise ValueError("in_feats must be <= out_feats (DGL contract)")
        if h.shape[-1] < self.out_feats:
            pad = h.new_zeros((h.shape[0], self.out_feats - h.shape[-1]))
            h = torch.cat([h, pad], dim=-1)
        return h

    def forward(self, h, senders, receivers) -> torch.Tensor:
        h = self._pad(h, receivers)
        n_nodes = h.shape[0]
        for _ in range(self.n_steps):
            msg = self.edge_linear(h)
            agg = segment_sum(gather(msg, senders), receivers, n_nodes)
            h = self.gru(agg, h)
        return h


class GlobalAttentionPooling(nn.Module):
    """Masked segment-softmax attention readout (``gate_nn = Linear(d, 1)``).
    Returns the pooled ``[num_graphs, d]`` and the per-node gate weights,
    which ``predict`` reports as statement saliency."""

    def __init__(self, dim: int):
        super().__init__()
        self.gate = nn.Linear(dim, 1)

    def forward(self, h, node_gidx, node_mask, num_graphs: int):
        gate_logit = self.gate(h)[:, 0]
        gate = segment_softmax(gate_logit, node_gidx, num_graphs, mask=node_mask)
        return segment_sum(gate[:, None] * h, node_gidx, num_graphs), gate


def _unsupported(cfg: GGNNConfig) -> str | None:
    if cfg.dataflow_families or cfg.interproc_families:
        return "the static-analysis feature families (ROADMAP A3)"
    if cfg.aggregation != "sum":
        return f"aggregation={cfg.aggregation!r} (union aggregators, ROADMAP A2/A3)"
    if cfg.label_style != "graph":
        return f"label_style={cfg.label_style!r} (ROADMAP A3)"
    if cfg.dtype != "float32":
        return f"dtype={cfg.dtype!r}"
    return None


class GGNN(nn.Module):
    """The flagship DeepDFA model: abstract-dataflow embeddings → GGNN →
    attention pooling → MLP classifier. ``forward`` takes a
    :class:`BatchedGraphs` of tensors and returns one logit per graph slot
    (and the gate weights when ``return_gate``); in ``encoder_mode`` there
    is no head and it returns the pooled ``[max_graphs, out_dim]`` rows."""

    def __init__(self, cfg: GGNNConfig, input_dim: int):
        super().__init__()
        missing = _unsupported(cfg)
        if missing is not None:
            raise NotImplementedError(f"not ported yet: {missing}")
        self.cfg = cfg
        self.input_dim = input_dim
        embed_dim = cfg.hidden_dim
        if cfg.concat_all_absdf:
            self.embeddings = nn.ModuleDict(
                {sk: nn.Embedding(input_dim, embed_dim) for sk in ALL_SUBKEYS})
            embed_dim *= len(ALL_SUBKEYS)
            hidden_dim = cfg.hidden_dim * len(ALL_SUBKEYS)
        else:
            self.embedding = nn.Embedding(input_dim, embed_dim)
            hidden_dim = cfg.hidden_dim
        self.ggnn = self._conv(hidden_dim)
        out_in = embed_dim + hidden_dim
        self.pooling = GlobalAttentionPooling(out_in)
        n_head = 0 if cfg.encoder_mode else cfg.num_output_layers
        self.head = nn.ModuleList(
            nn.Linear(out_in, 1 if i == cfg.num_output_layers - 1 else out_in)
            for i in range(n_head))

    def _conv(self, hidden_dim: int) -> nn.Module:
        """Build the message-passing conv (overridden by ``GGNNFused``)."""
        return GatedGraphConv(hidden_dim, self.cfg.n_steps)

    def embed_nodes(self, batch: BatchedGraphs) -> torch.Tensor:
        if self.cfg.concat_all_absdf:
            return torch.cat(
                [self.embeddings[sk](batch.node_feats[f"_ABS_DATAFLOW_{sk}"])
                 for sk in ALL_SUBKEYS], dim=-1)
        return self.embedding(batch.node_feats["_ABS_DATAFLOW"])

    def forward(self, batch: BatchedGraphs, return_gate: bool = False):
        feat_embed = self.embed_nodes(batch)
        ggnn_out = self.ggnn(feat_embed, batch.senders, batch.receivers)
        out = torch.cat([ggnn_out, feat_embed], dim=-1)
        out, gate = self.pooling(out, batch.node_gidx, batch.node_mask,
                                 batch.max_graphs)
        if self.cfg.encoder_mode:
            return (out, gate) if return_gate else out
        for i, layer in enumerate(self.head):
            out = layer(out)
            if i != len(self.head) - 1:
                out = torch.relu(out)
        logits = out[..., 0]
        return (logits, gate) if return_gate else logits


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    # Flax's default kernel init: truncated normal with variance 1/fan_in
    # (the divisor undoes the truncation's shrinkage of the variance)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise ``model`` in place from ``seed`` with the JAX package's
    initialisers in distribution: lecun-normal linear weights, zero biases,
    embeddings with variance 1/width. Returns the model."""
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            w = torch.empty(mod.weight.shape[::-1])  # [in, out], as Flax
            _lecun_normal_(w, mod.in_features, gen)
            mod.weight.copy_(w.t())
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            w = torch.empty(mod.weight.shape)
            _lecun_normal_(w, mod.embedding_dim, gen)
            mod.weight.copy_(w)
    return model


def build(cls, cfg: GGNNConfig, input_dim: int, device=None, seed: int = 0):
    """``cls`` built on the CPU, initialised from ``seed`` and moved to
    ``device`` (``cuda`` unless the caller names another)."""
    dev = resolve_device(device)
    return init_params(cls(cfg, input_dim), seed).to(dev)
