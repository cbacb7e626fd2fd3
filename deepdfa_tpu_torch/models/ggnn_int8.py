"""GGNN with int8-resident message-passing products — the serving path of
``precision="int8"``.

The port of ``deepdfa_tpu/models/ggnn_int8.py``. The same model as
:class:`~deepdfa_tpu_torch.models.ggnn.GGNN` (a subclass over the same
segment-layout batches, with the same embeddings, pooling and head), but
every conv product — ``edge_linear`` and the two fused 3-gate GRU
projections — runs through :func:`~deepdfa_tpu_torch.ops.int8_matmul.
int8_matmul` against int8 weights with per-output-channel float32 scales:
kernel B5 on the card, three launches per round, each a call of the
registered op ``deepdfa::int8_matmul`` (so an exported program records
it). Embeddings, pooling and the head stay float32.

The int8 conv is inference only: the weights are not trained in int8.
:func:`quantize_conv_params` calibrates a trained float32 state dict at
engine build; the engine gates the result against float32 scores before
serving it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deepdfa_tpu_torch.models.ggnn import GGNN, check_edges_sorted
from deepdfa_tpu_torch.ops.int8_matmul import calibrate_int8, int8_matmul
from deepdfa_tpu_torch.ops.segment import gather, segment_sum

__all__ = ["GGNNInt8", "GatedGraphConvInt8", "quantize_conv_params"]

# the conv's dense layers replaced by quantize_conv_params; every other
# entry of the state dict passes through
_CONV_DENSE = ("ggnn.edge_linear", "ggnn.gru.x_proj", "ggnn.gru.h_proj")


class _Int8Linear(nn.Module):
    """One quantized dense layer: buffers ``q`` int8 ``[in, out]`` (the JAX
    leaf's layout), ``scale`` float32 ``[out]`` and ``bias`` float32
    ``[out]``, added after the scale. The initial values are placeholders;
    real ones come from :func:`quantize_conv_params`."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.register_buffer(
            "q", torch.zeros((in_features, features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, self.q, self.scale) + self.bias


class _Int8GRU(nn.Module):
    """The GRU cell with both fused 3-gate projections int8-resident."""

    def __init__(self, features: int):
        super().__init__()
        self.x_proj = _Int8Linear(features, 3 * features)
        self.h_proj = _Int8Linear(features, 3 * features)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        xr, xz, xn = self.x_proj(x).chunk(3, dim=-1)
        hr, hz, hn = self.h_proj(h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h


class GatedGraphConvInt8(nn.Module):
    """The segment-layout conv (sum aggregation) with its three products
    int8-resident: per round, the edge linear on B5, the gather of each
    edge's sender, the ordered segment sum over receivers, and the GRU with
    both products on B5. Module names (``edge_linear``,
    ``gru.{x_proj,h_proj}``) follow the float32 conv's, so
    :func:`quantize_conv_params` maps them one to one. Edges must arrive
    sorted by receiver (checked), and input features are zero-padded up to
    ``out_feats``."""

    def __init__(self, out_feats: int, n_steps: int):
        super().__init__()
        self.out_feats = out_feats
        self.n_steps = n_steps
        self.edge_linear = _Int8Linear(out_feats, out_feats)
        self.gru = _Int8GRU(out_feats)

    def forward(self, h, senders, receivers) -> torch.Tensor:
        check_edges_sorted(receivers)
        if h.shape[-1] > self.out_feats:
            raise ValueError("in_feats must be <= out_feats (DGL contract)")
        if h.shape[-1] < self.out_feats:
            pad = h.new_zeros((h.shape[0], self.out_feats - h.shape[-1]))
            h = torch.cat([h, pad], dim=-1)
        h = h.to(torch.float32)
        n_nodes = h.shape[0]
        for _ in range(self.n_steps):
            msg = self.edge_linear(h)
            agg = segment_sum(gather(msg, senders), receivers, n_nodes)
            h = self.gru(agg, h)
        return h


class GGNNInt8(GGNN):
    """:class:`GGNN` with the conv swapped for the int8-resident one.
    Built by the serving engine for ``precision="int8"``."""

    def _conv(self, hidden_dim: int) -> nn.Module:
        return GatedGraphConvInt8(hidden_dim, self.cfg.n_steps)


def quantize_conv_params(state_dict: dict) -> dict:
    """Calibrate a trained float32 state dict into :class:`GGNNInt8`'s: for
    each conv dense layer (``ggnn.edge_linear``, ``ggnn.gru.x_proj``,
    ``ggnn.gru.h_proj``) the ``weight`` becomes ``q`` / ``scale`` by
    :func:`~deepdfa_tpu_torch.ops.int8_matmul.calibrate_int8` of its
    ``[in, out]`` kernel, and the ``bias`` stays float32; every other entry
    passes through. Raises ``ValueError`` (from ``calibrate_int8``) on
    non-finite weights: a poisoned checkpoint is not clamped into a serving
    artifact."""
    if f"{_CONV_DENSE[0]}.weight" not in state_dict:
        raise ValueError(
            "quantize_conv_params: no 'ggnn.edge_linear.weight' in the state "
            "dict — expected a GGNN/GGNNFused state dict")
    out = {k: v for k, v in state_dict.items()
           if not any(k.startswith(p + ".") for p in _CONV_DENSE)}
    for prefix in _CONV_DENSE:
        kernel = state_dict[f"{prefix}.weight"].detach().cpu().numpy().T
        q, scale = calibrate_int8(kernel)
        out[f"{prefix}.q"] = torch.from_numpy(np.ascontiguousarray(q))
        out[f"{prefix}.scale"] = torch.from_numpy(scale)
        out[f"{prefix}.bias"] = state_dict[f"{prefix}.bias"].detach().to(
            "cpu", torch.float32).clone()
    return out
