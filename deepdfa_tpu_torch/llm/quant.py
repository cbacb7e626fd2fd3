"""Int8 weights for the LLM's projections.

The port of ``deepdfa_tpu/llm/quant.py``'s runtime half, on state dicts:

- :func:`to_int8_runtime_params` turns a float checkpoint into the state
  dict of an ``int8_runtime=True`` model: every projection weight
  (``*.weight`` of rank 2, the embedding table excepted) becomes
  ``q`` int8 ``[in, out]`` and ``scale`` float32 ``[out]`` through
  :func:`~deepdfa_tpu_torch.ops.int8_matmul.calibrate_int8` — bit for bit
  the JAX package's ``_quantize`` of the same float32 kernel. Embeddings,
  norms and LoRA adapters pass through unchanged.
- :func:`dequantize_tree` materialises float weights from such a state dict.
- :func:`randomize_int8_runtime_params` draws a seeded int8-runtime state for
  benchmarks (JAX's threefry bits cannot be reproduced; the distributions
  are the JAX package's).
"""

from __future__ import annotations

import torch

from deepdfa_tpu_torch.ops.int8_matmul import calibrate_int8

__all__ = ["dequantize_tree", "randomize_int8_runtime_params",
           "to_int8_runtime_params"]


def _is_projection(name: str, t: torch.Tensor) -> bool:
    return (name.endswith(".weight") and t.dim() == 2
            and not name.endswith("embed_tokens.weight"))


@torch.no_grad()
def to_int8_runtime_params(state: dict) -> dict:
    """``{name.weight: [out, in]}`` → ``{name.q: int8 [in, out],
    name.scale: float32 [out]}`` for every projection, calibrated on the
    weight's own device; everything else passes through."""
    out = {}
    for name, t in state.items():
        if _is_projection(name, t):
            q, scale = calibrate_int8(t.t())
            base = name[: -len(".weight")]
            out[f"{base}.q"], out[f"{base}.scale"] = q, scale
        else:
            out[name] = t
    return out


@torch.no_grad()
def dequantize_tree(state: dict, dtype: torch.dtype = torch.bfloat16) -> dict:
    """An int8-runtime state dict back to float projection weights
    ``(q · scale)ᵀ`` in ``dtype``; everything else passes through."""
    out = {}
    for name, t in state.items():
        if name.endswith(".q") and t.dtype == torch.int8:
            base = name[: -len(".q")]
            scale = state[f"{base}.scale"]
            out[f"{base}.weight"] = (t.to(torch.float32) * scale).t().to(
                dtype).contiguous()
        elif not (name.endswith(".scale") and f"{name[:-6]}.q" in state):
            out[name] = t
    return out


@torch.no_grad()
def randomize_int8_runtime_params(state: dict, seed: int) -> dict:
    """Value-randomise an int8-runtime state dict for benchmarking (zero
    ``q`` gives zero logits): int8 entries uniform in [-127, 127], scales
    (1 + 0.1·N(0, 1))·1e-2, other float entries 0.02·N(0, 1) in their own
    type; norm weights keep their values. Drawn entry by entry on each
    tensor's device from one ``torch.Generator`` per device seeded with
    ``seed``."""
    gens: dict[torch.device, torch.Generator] = {}
    out = {}
    for name, t in state.items():
        gen = gens.get(t.device)
        if gen is None:
            gen = gens[t.device] = torch.Generator(
                device=t.device).manual_seed(int(seed))
        if t.dtype == torch.int8:
            out[name] = torch.randint(-127, 128, t.shape, generator=gen,
                                      device=t.device, dtype=torch.int8)
        elif name.endswith("scale"):
            noise = torch.randn(t.shape, generator=gen, device=t.device)
            out[name] = (1.0 + 0.1 * noise) * 1e-2
        elif "norm" in name.lower():
            out[name] = t
        else:
            out[name] = (0.02 * torch.randn(t.shape, generator=gen,
                                            device=t.device)).to(t.dtype)
    return out
