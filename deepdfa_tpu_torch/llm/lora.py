"""LoRA adapters for the LLM.

The port of ``deepdfa_tpu/llm/lora.py``:

- :class:`LoRAAdapter`, the adapter module (``lora_q``/``lora_v`` inside
  ``Attention``);
- :func:`lora_mask` and :func:`split_lora`, by the JAX rule that any name
  segment starting ``lora`` marks an adapter parameter;
- :func:`freeze_base`, which leaves only the adapters trainable, so a
  backward computes no gradient of the frozen base (at CodeLlama-7B width
  that gradient would take 13 GB and a product per weight);
- :func:`merge_lora`, which folds trained adapters into their projections.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["LoRAAdapter", "freeze_base", "is_lora_name", "lora_mask",
           "merge_lora", "split_lora"]


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


def is_lora_name(name: str) -> bool:
    """True for a parameter name with a segment starting ``lora``."""
    return any(part.startswith("lora") for part in name.split("."))


def lora_mask(model_or_state) -> dict[str, bool]:
    """Parameter name → True for a LoRA adapter (trainable), False for the
    base, over a module's parameters or a state dict's entries."""
    names = (model_or_state.keys() if isinstance(model_or_state, dict)
             else (n for n, _ in model_or_state.named_parameters()))
    return {n: is_lora_name(n) for n in names}


def split_lora(state: dict) -> tuple[dict, dict]:
    """(adapters only, base only): a state dict split by :func:`lora_mask`;
    the adapters are the checkpointable artifact (the base is never
    written)."""
    lora = {k: v for k, v in state.items() if is_lora_name(k)}
    return lora, {k: v for k, v in state.items() if k not in lora}


def freeze_base(model: nn.Module) -> list[nn.Parameter]:
    """Set ``requires_grad=False`` on every parameter but the adapters; the
    adapters' ``requires_grad`` is set True. Returns the adapters."""
    trainable = []
    for name, param in model.named_parameters():
        param.requires_grad_(is_lora_name(name))
        if param.requires_grad:
            trainable.append(param)
    return trainable


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
