"""Carry GGNN weights between the JAX package's Flax tree and a torch state dict.

The Flax tree is given as nested dicts of numpy arrays (``params`` of
``GGNN.init``, converted with ``np.asarray``). Its names are
``embed_{sk}.embedding`` (or ``embed.embedding``), ``ggnn.edge_linear``,
``ggnn.gru.{x_proj,h_proj}``, ``pooling.gate`` and ``out_{i}``. A Flax
``kernel`` is ``[in, out]`` and becomes ``nn.Linear.weight`` transposed; the
GRU's fused r|z|n columns become rows in the same order. Both directions
copy values exactly, so a round trip is bit for bit.

:func:`level2_flax_to_torch` / :func:`level2_torch_to_flax` do the same for
the hierarchical scorer's call-graph GGNN (``in_proj``, ``edge_linear``,
``gru/{x_proj,h_proj}``, ``gate``, ``out``, ``attr``), whose weights the JAX
package draws from its own PRNG.
"""

from __future__ import annotations

import numpy as np
import torch

from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig

__all__ = ["flax_to_torch", "level2_flax_to_torch",
           "level2_torch_to_flax", "torch_to_flax"]


def _linear_names(cfg: GGNNConfig) -> dict[tuple[str, ...], str]:
    """Flax path of each dense layer → torch module prefix."""
    names = {
        ("ggnn", "edge_linear"): "ggnn.edge_linear",
        ("ggnn", "gru", "x_proj"): "ggnn.gru.x_proj",
        ("ggnn", "gru", "h_proj"): "ggnn.gru.h_proj",
        ("pooling", "gate"): "pooling.gate",
    }
    for i in range(cfg.num_output_layers):
        names[(f"out_{i}",)] = f"head.{i}"
    return names


def _embed_names(cfg: GGNNConfig) -> dict[str, str]:
    if cfg.concat_all_absdf:
        return {f"embed_{sk}": f"embeddings.{sk}.weight" for sk in ALL_SUBKEYS}
    return {"embed": "embedding.weight"}


def _at(tree: dict, path) -> dict:
    for key in path:
        tree = tree[key]
    return tree


def flax_to_torch(params_np: dict, cfg: GGNNConfig, input_dim: int) -> dict:
    """A state dict for ``GGNN``/``GGNNFused`` from the Flax parameter tree."""
    state: dict[str, torch.Tensor] = {}

    def put(name, arr):
        state[name] = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))

    for flax_name, torch_name in _embed_names(cfg).items():
        table = np.asarray(params_np[flax_name]["embedding"])
        if table.shape[0] != input_dim:
            raise ValueError(f"{flax_name} has {table.shape[0]} rows, "
                             f"expected input_dim={input_dim}")
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
    for flax_name, torch_name in _embed_names(cfg).items():
        params[flax_name] = {"embedding": get(torch_name)}
        if params[flax_name]["embedding"].shape[0] != input_dim:
            raise ValueError(f"{torch_name} does not have input_dim={input_dim} rows")
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
