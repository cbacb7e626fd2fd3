"""GGNN with every message round on the hand-written CUDA kernel.

The port of ``deepdfa_tpu/models/ggnn_fused.py``: the same model and the
same parameters as :class:`~deepdfa_tpu_torch.models.ggnn.GGNN` (the conv
keeps ``edge_linear`` and ``gru.{x,h}_proj`` as ``nn.Linear``), but the
``n_steps`` rounds run through
:func:`deepdfa_tpu_torch.ops.fused_ggnn.fused_ggnn` — the CUDA kernel on the
card, its plain version on the CPU. Embeddings, pooling and the head are
inherited unchanged.
"""

from __future__ import annotations

from deepdfa_tpu_torch.models.ggnn import GGNN, GatedGraphConv
from deepdfa_tpu_torch.ops.fused_ggnn import fused_ggnn

__all__ = ["GGNNFused", "GatedGraphConvFused"]


class GatedGraphConvFused(GatedGraphConv):
    """Drop-in for :class:`GatedGraphConv` backed by :func:`fused_ggnn`.
    Weights go to the kernel in the JAX package's ``[in, out]`` layout."""

    def forward(self, h, senders, receivers):
        h = self._pad(h, receivers)
        el, gru = self.edge_linear, self.gru
        return fused_ggnn(
            h, senders, receivers,
            el.weight.t(), el.bias,
            gru.x_proj.weight.t(), gru.x_proj.bias,
            gru.h_proj.weight.t(), gru.h_proj.bias,
            n_steps=self.n_steps)


class GGNNFused(GGNN):
    """:class:`GGNN` with the conv swapped for the fused kernel
    (``layout="fused"``)."""

    def _conv(self, hidden_dim: int):
        return GatedGraphConvFused(hidden_dim, self.cfg.n_steps)
