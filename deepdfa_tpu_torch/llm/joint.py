"""Joint LLM + GGNN scoring: the configuration and the evaluation step.

The port of the evaluation half of ``deepdfa_tpu/llm/joint.py``:

- :class:`JointConfig` — the reference's launch defaults, every field kept
  so a JAX configuration reads unchanged (the training fields take effect
  with the training slice);
- :func:`hidden_states` and :func:`eval_step` — the frozen LLM's final
  hidden states under the batch's explicit pad mask, then the fusion head,
  the masked loss and the softmax, under ``inference_mode``;
- :func:`save_fusion_epoch` / :func:`load_fusion_epoch` — the fusion state
  dict of one epoch in ``{run_dir}/epoch_{N}/``, written as
  ``train/checkpoint.py`` writes a step: ``state.pt`` and then
  ``meta.json`` into ``epoch_{N}.tmp/``, renamed into place, so
  ``meta.json`` marks a committed epoch. The LLM's weights are never
  written.

``JointTrainer``, its optimizer and ``train_step`` come with the training
slice (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from deepdfa_tpu_torch.data.graphs import to_device
from deepdfa_tpu_torch.llm.dataset import JoinedBatch
from deepdfa_tpu_torch.llm.fusion import fusion_loss
from deepdfa_tpu_torch.resilience.journal import fsync_dir

__all__ = ["JointConfig", "eval_step", "hidden_states", "load_fusion_epoch",
           "save_fusion_epoch"]


@dataclasses.dataclass(frozen=True)
class JointConfig:
    """The reference's argparse defaults (``train.py:588-801``)."""

    block_size: int = 256
    train_batch_size: int = 4
    eval_batch_size: int = 4
    learning_rate: float = 5e-5
    weight_decay: float = 0.0
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    epochs: int = 1
    best_threshold: float = 0.5
    eval_steps: int = 2  # evals per epoch after the first
    first_eval_steps: int = 5  # evals per first epoch
    seed: int = 42
    # "bigvul" → macro avg (imbalanced); anything else → weighted avg
    dataset_style: str = "bigvul"
    use_gnn: bool = True  # False = --no_flowgnn presets
    train_llm: bool = False  # LineVul-combined mode (RoBERTa presets)
    prefetch: int = 1
    freeze_gnn: bool = False


def hidden_states(llm, batch: JoinedBatch, device) -> torch.Tensor:
    """The LLM's final hidden states ``[b, s, hidden]`` of the batch's text,
    with its explicit pad mask; positions are ``arange`` (RoPE is relative,
    so a left-padded row keeps its real tokens' distances)."""
    ids = torch.from_numpy(np.ascontiguousarray(batch.text.input_ids)).to(
        device)
    mask = torch.from_numpy(np.ascontiguousarray(batch.text.pad_mask)).to(
        device)
    return llm(ids, mask)


@torch.inference_mode()
def eval_step(llm, fusion, batch: JoinedBatch,
              device) -> tuple[torch.Tensor, torch.Tensor]:
    """(masked mean loss, softmax probabilities ``[b, 2]``) of one joined
    batch: the JAX ``make_joint_steps(...)[1]``."""
    hidden = hidden_states(llm, batch, device)
    graphs = to_device(batch.graphs, device) if fusion.use_gnn else None
    token_mask = torch.from_numpy(np.ascontiguousarray(
        batch.text.pad_mask)).to(device)
    logits = fusion(hidden, graphs, token_mask=token_mask)
    labels = torch.from_numpy(np.asarray(batch.text.labels)).to(device)
    mask = torch.from_numpy(np.asarray(batch.mask)).to(device)
    return fusion_loss(logits, labels, mask)


def save_fusion_epoch(run_dir: str | Path, epoch: int, state: dict,
                      meta: dict | None = None) -> Path:
    """Write a fusion state dict as ``{run_dir}/epoch_{epoch}`` (committed
    by ``meta.json``, then one rename). Returns the directory."""
    path = Path(run_dir) / f"epoch_{int(epoch)}"
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save({k: v.detach().cpu() for k, v in state.items()},
               tmp / "state.pt")
    (tmp / "meta.json").write_text(json.dumps(
        dict(epoch=int(epoch), **(meta or {}))))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)
    fsync_dir(path.parent)
    return path


def load_fusion_epoch(path: str | Path, map_location=None) -> dict:
    """The fusion state dict of one ``epoch_N`` directory. A directory
    without this package's ``meta.json`` marker and ``state.pt`` — an orbax
    checkpoint of the JAX package, or a torn write — raises ``ValueError``."""
    path = Path(path)
    if not ((path / "meta.json").is_file() and (path / "state.pt").is_file()):
        raise ValueError(
            f"{path} is not a committed fusion checkpoint of this package "
            "(no meta.json and state.pt): an orbax directory of the JAX "
            "package is converted by restoring its tree with the JAX package "
            "and carrying it across with "
            "deepdfa_tpu_torch.bridge.fusion_flax_to_torch, then "
            "llm.joint.save_fusion_epoch")
    return torch.load(path / "state.pt", map_location=map_location,
                      weights_only=True)
