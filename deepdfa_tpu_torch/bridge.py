"""Carry GGNN weights between the JAX package's Flax tree and a torch state dict.

The Flax tree is given as nested dicts of numpy arrays (``params`` of
``GGNN.init``, converted with ``np.asarray``). Its names are
``embed_{sk}.embedding`` (or ``embed.embedding``), one
``embed_dfa_{fam}.embedding`` per active static-analysis family,
``ggnn.edge_linear``, ``ggnn.gru.{x_proj,h_proj}``, ``pooling.gate`` (graph
labels only: the node styles have no pooling) and ``out_{i}``. A Flax
``kernel`` is ``[in, out]`` and becomes ``nn.Linear.weight`` transposed; the
GRU's fused r|z|n columns become rows in the same order. Both directions
copy values exactly, so a round trip is bit for bit.

:func:`level2_flax_to_torch` / :func:`level2_torch_to_flax` do the same for
the hierarchical scorer's call-graph GGNN (``in_proj``, ``edge_linear``,
``gru/{x_proj,h_proj}``, ``gate``, ``out``, ``attr``), whose weights the JAX
package draws from its own PRNG.

:func:`llama_flax_to_torch` / :func:`llama_torch_to_flax` carry a
``LlamaModel`` or ``LlamaForCausalLM`` tree (``layers_{i}`` ↔ ``layers.{i}``,
``embed_tokens.embedding`` ↔ ``embed_tokens.weight``, Dense ``kernel`` ↔
``weight`` transposed; the int8 runtime's ``q``/``scale`` and the LoRA
adapters' ``lora_a``/``lora_b`` keep the Flax layout), and
:func:`fusion_flax_to_torch` / :func:`fusion_torch_to_flax` the fusion
model's ``flowgnn_encoder`` (the GGNN in encoder mode) + ``classifier``
tree. Values are copied exactly (a bf16 tensor goes to float32 numpy, which
holds it exactly), so round trips are bit for bit.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from deepdfa_tpu_torch.config import (ALL_SUBKEYS, DFA_FEATURE_DIMS,
                                      GGNNConfig, active_dfa_families)

__all__ = ["flax_to_torch", "fusion_flax_to_torch", "fusion_torch_to_flax",
           "level2_flax_to_torch", "level2_torch_to_flax",
           "llama_flax_to_torch", "llama_torch_to_flax", "torch_to_flax"]


def _linear_names(cfg: GGNNConfig) -> dict[tuple[str, ...], str]:
    """Flax path of each dense layer → torch module prefix."""
    names = {
        ("ggnn", "edge_linear"): "ggnn.edge_linear",
        ("ggnn", "gru", "x_proj"): "ggnn.gru.x_proj",
        ("ggnn", "gru", "h_proj"): "ggnn.gru.h_proj",
    }
    if cfg.label_style == "graph":
        names[("pooling", "gate")] = "pooling.gate"
    for i in range(0 if cfg.encoder_mode else cfg.num_output_layers):
        names[(f"out_{i}",)] = f"head.{i}"
    return names


def _embed_names(cfg: GGNNConfig, input_dim: int) -> dict[str, tuple[str, int]]:
    """Flax table name → (state-dict key, row count)."""
    if cfg.concat_all_absdf:
        names = {f"embed_{sk}": (f"embeddings.{sk}.weight", input_dim)
                 for sk in ALL_SUBKEYS}
    else:
        names = {"embed": ("embedding.weight", input_dim)}
    for fam in active_dfa_families(cfg.dataflow_families,
                                   cfg.interproc_families):
        names[f"embed_dfa_{fam}"] = (f"dfa_embeddings.{fam}.weight",
                                     DFA_FEATURE_DIMS[fam])
    return names


def _at(tree: dict, path) -> dict:
    for key in path:
        tree = tree[key]
    return tree


def flax_to_torch(params_np: dict, cfg: GGNNConfig, input_dim: int) -> dict:
    """A state dict for ``GGNN``/``GGNNFused`` from the Flax parameter tree."""
    state: dict[str, torch.Tensor] = {}

    def put(name, arr):
        state[name] = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))

    for flax_name, (torch_name, rows) in _embed_names(cfg, input_dim).items():
        table = np.asarray(params_np[flax_name]["embedding"])
        if table.shape[0] != rows:
            raise ValueError(f"{flax_name} has {table.shape[0]} rows, "
                             f"expected {rows}")
        put(torch_name, table)
    for path, prefix in _linear_names(cfg).items():
        leaf = _at(params_np, path)
        put(f"{prefix}.weight", np.asarray(leaf["kernel"]).T)
        put(f"{prefix}.bias", np.asarray(leaf["bias"]))
    return state


def torch_to_flax(state_dict: dict, cfg: GGNNConfig, input_dim: int) -> dict:
    """The Flax parameter tree (nested dicts of numpy) from a state dict."""

    def get(name):
        return state_dict[name].detach().cpu().numpy().copy()

    params: dict = {}
    for flax_name, (torch_name, rows) in _embed_names(cfg, input_dim).items():
        params[flax_name] = {"embedding": get(torch_name)}
        if params[flax_name]["embedding"].shape[0] != rows:
            raise ValueError(f"{torch_name} does not have {rows} rows")
    for path, prefix in _linear_names(cfg).items():
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = {"kernel": np.ascontiguousarray(get(f"{prefix}.weight").T),
                          "bias": get(f"{prefix}.bias")}
    return params


_LEVEL2_NAMES = {
    ("in_proj",): "in_proj",
    ("edge_linear",): "edge_linear",
    ("gru", "x_proj"): "gru.x_proj",
    ("gru", "h_proj"): "gru.h_proj",
    ("gate",): "gate",
    ("out",): "out",
    ("attr",): "attr",
}


def level2_flax_to_torch(params_np: dict) -> dict:
    """A state dict for :class:`~deepdfa_tpu_torch.models.ggnn_hier.
    CallGraphGGNN` from the JAX package's level-2 Flax tree."""
    state: dict[str, torch.Tensor] = {}
    for path, prefix in _LEVEL2_NAMES.items():
        leaf = _at(params_np, path)
        state[f"{prefix}.weight"] = torch.from_numpy(
            np.array(np.asarray(leaf["kernel"]).T, dtype=np.float32))
        state[f"{prefix}.bias"] = torch.from_numpy(
            np.array(leaf["bias"], dtype=np.float32))
    return state


def level2_torch_to_flax(state_dict: dict) -> dict:
    """The level-2 Flax tree (nested dicts of numpy) from a
    :class:`~deepdfa_tpu_torch.models.ggnn_hier.CallGraphGGNN` state
    dict."""
    params: dict = {}
    for path, prefix in _LEVEL2_NAMES.items():
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        w = state_dict[f"{prefix}.weight"].detach().cpu().numpy()
        node[path[-1]] = {
            "kernel": np.ascontiguousarray(w.T),
            "bias": state_dict[f"{prefix}.bias"].detach().cpu().numpy().copy()}
    return params


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy().copy()


def _put(node: dict, path, value) -> None:
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def llama_flax_to_torch(params_np: dict) -> dict:
    """A state dict for :class:`~deepdfa_tpu_torch.llm.llama.LlamaModel`
    (or ``LlamaForCausalLM`` from a tree with ``model``/``lm_head``) from
    the JAX package's llama tree (nested dicts of numpy arrays)."""
    state: dict[str, torch.Tensor] = {}

    def walk(node: dict, path: list[str]) -> None:
        for key, val in node.items():
            if isinstance(val, dict):
                m = re.fullmatch(r"layers_(\d+)", key)
                walk(val, path + ([f"layers.{m.group(1)}"] if m else [key]))
                continue
            arr = np.asarray(val)
            prefix = ".".join(path)
            if key == "embedding":
                name = f"{prefix}.weight"
            elif key == "kernel":
                name, arr = f"{prefix}.weight", arr.T
            else:  # RMSNorm weight, int8 q/scale, LoRA lora_a/lora_b
                name = f"{prefix}.{key}"
            state[name] = torch.from_numpy(np.array(arr, copy=True))

    walk(params_np, [])
    return state


def llama_torch_to_flax(state_dict: dict) -> dict:
    """The JAX package's llama tree (nested dicts of numpy) from a
    ``LlamaModel``/``LlamaForCausalLM`` state dict."""
    params: dict = {}
    for name, t in state_dict.items():
        *path, leaf = re.sub(r"(^|\.)layers\.(\d+)\.", r"\1layers_\2.",
                             name).split(".")
        arr = _numpy(t)
        if leaf == "weight" and path[-1] == "embed_tokens":
            _put(params, path + ["embedding"], arr)
        elif leaf == "weight" and arr.ndim == 2:
            _put(params, path + ["kernel"], np.ascontiguousarray(arr.T))
        else:
            _put(params, path + [leaf], arr)
    return params


def _fusion_cfg(gnn_cfg: GGNNConfig) -> GGNNConfig:
    return dataclasses.replace(gnn_cfg, encoder_mode=True,
                               label_style="graph")


def fusion_flax_to_torch(params_np: dict, gnn_cfg: GGNNConfig,
                         input_dim: int) -> dict:
    """A state dict for :class:`~deepdfa_tpu_torch.llm.fusion.FusionModel`
    from the JAX package's fusion tree (``flowgnn_encoder`` when the model
    uses the GGNN, and ``classifier/{dense,out_proj}``)."""
    state: dict[str, torch.Tensor] = {}
    if "flowgnn_encoder" in params_np:
        enc = flax_to_torch(params_np["flowgnn_encoder"],
                            _fusion_cfg(gnn_cfg), input_dim)
        state.update({f"flowgnn_encoder.{k}": v for k, v in enc.items()})
    for layer in ("dense", "out_proj"):
        leaf = params_np["classifier"][layer]
        state[f"classifier.{layer}.weight"] = torch.from_numpy(
            np.array(np.asarray(leaf["kernel"]).T, dtype=np.float32))
        state[f"classifier.{layer}.bias"] = torch.from_numpy(
            np.array(leaf["bias"], dtype=np.float32))
    return state


def fusion_torch_to_flax(state_dict: dict, gnn_cfg: GGNNConfig,
                         input_dim: int) -> dict:
    """The JAX package's fusion tree (nested dicts of numpy) from a
    :class:`~deepdfa_tpu_torch.llm.fusion.FusionModel` state dict."""
    params: dict = {"classifier": {}}
    enc = {k[len("flowgnn_encoder."):]: v for k, v in state_dict.items()
           if k.startswith("flowgnn_encoder.")}
    if enc:
        params["flowgnn_encoder"] = torch_to_flax(enc, _fusion_cfg(gnn_cfg),
                                                  input_dim)
    for layer in ("dense", "out_proj"):
        w = _numpy(state_dict[f"classifier.{layer}.weight"])
        params["classifier"][layer] = {
            "kernel": np.ascontiguousarray(w.T),
            "bias": _numpy(state_dict[f"classifier.{layer}.bias"])}
    return params
