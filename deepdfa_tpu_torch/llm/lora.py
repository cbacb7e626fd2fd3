"""LoRA adapters for the LLM.

The port of ``deepdfa_tpu/llm/lora.py``'s inference half: the adapter
module (``lora_q``/``lora_v`` inside ``Attention``) and :func:`merge_lora`,
which folds trained adapters into their projections. Selecting and training
adapters (``lora_mask``, ``split_lora``) comes with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["LoRAAdapter", "merge_lora"]


class LoRAAdapter(nn.Module):
    """``x @ A @ B * (alpha / rank)``: ``lora_a`` ``[in, rank]`` and
    ``lora_b`` ``[rank, features]`` in float32 (the JAX package's layout),
    cast to ``dtype`` at use. ``A`` starts N(0, 1/rank) and ``B`` zero, so
    the adapter starts as an exact no-op."""

    def __init__(self, in_features: int, features: int, rank: int,
                 alpha: float = 16.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rank = rank
        self.alpha = alpha
        self.dtype = dtype
        self.lora_a = nn.Parameter(torch.empty(in_features, rank))
        self.lora_b = nn.Parameter(torch.zeros(rank, features))
        with torch.no_grad():
            self.lora_a.normal_(0.0, rank ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x.to(self.dtype) @ self.lora_a.to(self.dtype)) @ self.lora_b.to(
            self.dtype)
        return y * (self.alpha / self.rank)


def merge_lora(state: dict, alpha: float = 16.0) -> dict:
    """A state dict with every ``lora_{q,v}`` adapter folded into its
    sibling ``{q,v}_proj.weight`` (peft's ``merge_and_unload``) and the
    adapter entries dropped. The rank is read off ``lora_a``'s shape;
    ``alpha`` must match the config the adapters were trained with. The
    delta is summed in float32 and the merged weight keeps its type."""
    out = {k: v for k, v in state.items() if ".lora_" not in k}
    for key, a in state.items():
        if not key.endswith(".lora_a"):
            continue
        prefix, adapter = key[: -len(".lora_a")].rsplit(".", 1)
        proj = {"lora_q": "q_proj", "lora_v": "v_proj"}[adapter]
        b = state[f"{prefix}.{adapter}.lora_b"]
        delta = (a.to(torch.float32) @ b.to(torch.float32)) * (
            alpha / a.shape[1])
        w = state[f"{prefix}.{proj}.weight"]  # [out, in]
        out[f"{prefix}.{proj}.weight"] = (
            w.to(torch.float32) + delta.t()).to(w.dtype)
    return out
