"""GGNN with every message round on the hand-written CUDA kernel.

The port of ``deepdfa_tpu/models/ggnn_fused.py``: the same model and the
same parameters as :class:`~deepdfa_tpu_torch.models.ggnn.GGNN` (the conv
keeps ``edge_linear`` and ``gru.{x,h}_proj`` as ``nn.Linear``), but the
``n_steps`` rounds run through
:func:`deepdfa_tpu_torch.ops.fused_ggnn.fused_ggnn` — the CUDA kernels on the
card (forward and, when training, backward), their plain versions on the
CPU. Gradients reach the embeddings through the conv's input ``h0``.
Embeddings (the family tables included), pooling and the per-graph or
per-node head are inherited unchanged; the union aggregators and per-step
``taps`` are segment-layout features and raise here, as in the JAX
package. Without a
gradient the rounds are one call of the registered op
``deepdfa::fused_ggnn``, which is what an exported program records.
"""

from __future__ import annotations

from deepdfa_tpu_torch.models.ggnn import GGNN, GatedGraphConv
from deepdfa_tpu_torch.ops.fused_ggnn import fused_ggnn

__all__ = ["GGNNFused", "GatedGraphConvFused"]


class GatedGraphConvFused(GatedGraphConv):
    """Drop-in for :class:`GatedGraphConv` (sum aggregation) backed by
    :func:`fused_ggnn`. Weights go to the kernel in the JAX package's
    ``[in, out]`` layout (as ``.t()`` views, so autograd hands
    ``nn.Linear`` its gradients in ``[out, in]``). ``bwd_kernel`` selects
    the backward (see :func:`fused_ggnn`)."""

    def __init__(self, out_feats: int, n_steps: int, bwd_kernel: str = "auto",
                 aggregation: str = "sum"):
        if aggregation != "sum":
            raise ValueError(
                f"layout=fused supports aggregation='sum' only (DGL parity "
                f"path); got {aggregation!r} — use layout=segment for "
                f"the union-lattice aggregators")
        super().__init__(out_feats, n_steps)
        self.bwd_kernel = bwd_kernel

    def forward(self, h, senders, receivers, taps=None):
        if taps is not None:
            raise ValueError(
                "per-step taps are a segment-layout diagnostic — the fused "
                "kernel does not materialise per-round states (use "
                "layout=segment for tap-based gradient probes)")
        h = self._pad(h, receivers)
        el, gru = self.edge_linear, self.gru
        return fused_ggnn(
            h, senders, receivers,
            el.weight.t(), el.bias,
            gru.x_proj.weight.t(), gru.x_proj.bias,
            gru.h_proj.weight.t(), gru.h_proj.bias,
            n_steps=self.n_steps, bwd_kernel=self.bwd_kernel)


class GGNNFused(GGNN):
    """:class:`GGNN` with the conv swapped for the fused kernel
    (``layout="fused"``)."""

    def _conv(self, hidden_dim: int):
        return GatedGraphConvFused(hidden_dim, self.cfg.n_steps,
                                   self.cfg.bwd_kernel, self.cfg.aggregation)
