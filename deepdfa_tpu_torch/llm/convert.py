"""HF LLaMA checkpoints from a local directory.

The port of ``deepdfa_tpu/llm/convert.py``. The port's modules carry HF's
parameter names, so conversion renames nothing: :func:`convert_state_dict`
only drops what the port does not hold (rotary ``inv_freq`` buffers, which
are recomputed, and with ``bare=True`` the ``model.`` prefix and the LM
head, for :class:`~deepdfa_tpu_torch.llm.llama.LlamaModel`). Weights are
read from the directory alone — ``*.safetensors`` when the ``safetensors``
package imports, else ``pytorch_model*.bin`` / ``*.pt`` through
``torch.load(weights_only=True)`` — never from the network.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from deepdfa_tpu_torch.llm.llama import LlamaConfig

__all__ = ["convert_state_dict", "load_hf_checkpoint", "load_hf_config",
           "load_torch_state"]


def load_hf_config(ckpt_dir: str | Path) -> LlamaConfig:
    with open(Path(ckpt_dir) / "config.json") as f:
        return LlamaConfig.from_hf_dict(json.load(f))


def load_torch_state(ckpt_dir: str | Path) -> dict:
    """The raw HF state dict of a local checkpoint directory."""
    ckpt_dir = Path(ckpt_dir)
    st_files = sorted(ckpt_dir.glob("*.safetensors"))
    bin_files = sorted(ckpt_dir.glob("pytorch_model*.bin")) or sorted(
        ckpt_dir.glob("*.pt"))
    state: dict = {}
    if st_files:
        try:
            from safetensors.torch import load_file
        except ImportError:
            load_file = None
        if load_file is not None:
            for f in st_files:
                state.update(load_file(str(f)))
            return state
        if not bin_files:
            raise RuntimeError(
                f"{ckpt_dir} holds safetensors weights only, and the "
                "safetensors package does not import here")
    if not bin_files:
        raise FileNotFoundError(f"no weights found under {ckpt_dir}")
    for f in bin_files:
        state.update(torch.load(f, map_location="cpu", weights_only=True))
    return state


def convert_state_dict(state: dict, bare: bool = False) -> dict:
    """An HF llama state dict for :class:`LlamaForCausalLM` (``bare=False``)
    or :class:`LlamaModel` (``bare=True``: the ``model.`` prefix and
    ``lm_head`` go). Rotary buffers are dropped; loading into a model casts
    each tensor to the parameter's type."""
    out = {}
    for name, t in state.items():
        if name.endswith("rotary_emb.inv_freq"):
            continue
        if bare:
            if name.startswith("lm_head."):
                continue
            name = name.removeprefix("model.")
        out[name] = t
    return out


def load_hf_checkpoint(ckpt_dir: str | Path, bare: bool = False) -> dict:
    """:func:`convert_state_dict` of :func:`load_torch_state`."""
    return convert_state_dict(load_torch_state(ckpt_dir), bare=bare)
