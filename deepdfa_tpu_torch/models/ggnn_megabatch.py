"""GGNN computed by the whole-model kernel (``layout="megabatch"``).

The port of ``deepdfa_tpu/models/ggnn_megabatch.py``: the same model and the
same parameters as :class:`~deepdfa_tpu_torch.models.ggnn.GGNN` (identical
submodules and names, so one state dict serves every layout and
``bridge.flax_to_torch`` takes the JAX ``GGNNMegabatch`` tree unchanged), over
the same segment-layout batches, but the whole forward — embed → messages →
GRU → attention pooling → head — runs through
:func:`deepdfa_tpu_torch.ops.megabatch.fused_ggnn_model`: kernel B3 on the
card, its plain version on the CPU. Every bucket shape goes to B3 on the card;
there is no segment twin.

The kernel hard-codes the flagship configuration (concatenated-subkey
embeddings with embed width == hidden width, sum aggregation, graph labels,
the classifier head); the other variants raise ``ValueError`` at
construction, with the JAX package's messages. The kernel computes no
per-node gate weights, so ``return_gate=True`` raises: score a megabatch
model's state dict through ``layout="fused"``.
"""

from __future__ import annotations

import torch

from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig
from deepdfa_tpu_torch.data.graphs import BatchedGraphs
from deepdfa_tpu_torch.models.ggnn import GGNN
from deepdfa_tpu_torch.ops.megabatch import MegabatchPlan, fused_ggnn_model

__all__ = ["GGNNMegabatch"]


def _refuse(cfg: GGNNConfig) -> None:
    if not cfg.concat_all_absdf or cfg.dataflow_families or cfg.interproc_families:
        raise ValueError(
            "layout=megabatch supports the concat-subkey abstract-"
            "dataflow config only (concat_all_absdf=True, "
            "dataflow_families=False, interproc_families=False) — the "
            "whole-model kernel's embed prologue hard-codes the "
            "stacked-table gather; use layout=segment/fused for other "
            "embedding configs")
    if cfg.label_style != "graph" or cfg.encoder_mode:
        raise ValueError(
            "layout=megabatch supports graph-level classification only "
            "(label_style='graph', encoder_mode=False) — the fused "
            "epilogue IS the pooling+head; use layout=segment otherwise")
    if cfg.aggregation != "sum":
        raise ValueError(
            f"layout=megabatch supports aggregation='sum' only; got "
            f"{cfg.aggregation!r} — use layout=segment for the "
            "union-lattice aggregators")


class GGNNMegabatch(GGNN):
    """:class:`GGNN` computed by the whole-model kernel."""

    def __init__(self, cfg: GGNNConfig, input_dim: int):
        _refuse(cfg)
        super().__init__(cfg, input_dim)

    def plan_for(self, max_nodes: int, max_edges: int,
                 max_graphs: int) -> MegabatchPlan:
        """The static plan of a bucket shape."""
        return MegabatchPlan(
            max_graphs=max_graphs, max_nodes=max_nodes, max_edges=max_edges,
            width=self.cfg.hidden_dim * len(ALL_SUBKEYS),
            n_steps=self.cfg.n_steps,
            table_rows=self.input_dim * len(ALL_SUBKEYS),
            embed_width=self.cfg.hidden_dim,
            n_head_layers=self.cfg.num_output_layers)

    def forward(self, batch: BatchedGraphs, return_gate: bool = False):
        if return_gate:
            raise ValueError(
                "layout=megabatch computes no per-node gate weights (the "
                "whole-model kernel pools inside); load the same state dict "
                "into a layout='fused' model to get them")
        table = torch.cat([self.embeddings[sk].weight for sk in ALL_SUBKEYS])
        ids = torch.stack(
            [batch.node_feats[f"_ABS_DATAFLOW_{sk}"] + i * self.input_dim
             for i, sk in enumerate(ALL_SUBKEYS)], dim=-1)
        conv, gate = self.ggnn, self.pooling.gate
        el, gru = conv.edge_linear, conv.gru
        return fused_ggnn_model(
            table, ids, batch.senders, batch.receivers, batch.node_gidx,
            batch.node_mask, el.weight.t(), el.bias, gru.x_proj.weight.t(),
            gru.x_proj.bias, gru.h_proj.weight.t(), gru.h_proj.bias,
            gate.weight.t(), gate.bias,
            tuple((layer.weight.t(), layer.bias) for layer in self.head),
            n_steps=self.cfg.n_steps, n_graphs=batch.max_graphs)
