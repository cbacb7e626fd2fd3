"""LoRA fine-tuning of the LLM: the stage that produces adapter checkpoints.

The port of ``deepdfa_tpu/llm/finetune.py``:

- causal-LM loss (next-token cross-entropy) over the positions whose target
  is a real token, or with ``loss_mask`` only those whose target is a
  response token (:func:`lm_loss`);
- only the LoRA adapters train: :func:`lora_optimizer` freezes the base
  (``lora.freeze_base``: no gradient of a base weight is ever computed)
  and gives the optimizer the adapters alone, so the base has no optimizer
  state, matching peft's memory profile;
- AdamW on the linear-warmup cosine schedule, after a global-norm clip over
  the adapters' gradients (:class:`~deepdfa_tpu_torch.llm.joint.
  ClippedAdamW`; optax's schedule step for step, so the first update uses
  lr 0);
- adapters checkpoint alone (``lora.split_lora``): ``{run_dir}/{name}/``
  with ``state.pt`` and then ``meta.json``, renamed into place. The base
  weights are never written.

With ``attn_impl="flash"`` and a sequence a multiple of 128, attention on
the card runs kernel B6 forward and kernel B6b backward
(:mod:`deepdfa_tpu_torch.ops.flash_attention`). LoRA parameters stay float32
and are cast to the model's type at use.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepdfa_tpu_torch.llm.dataset import TextExamples, text_batches
from deepdfa_tpu_torch.llm.joint import (ClippedAdamW, commit_state_dir,
                                         cosine_warmup_schedule)
from deepdfa_tpu_torch.llm.lora import freeze_base, split_lora

__all__ = ["FinetuneConfig", "FinetuneState", "LoraFinetuner", "lm_loss",
           "lora_optimizer", "make_lm_steps"]


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    epochs: int = 1
    batch_size: int = 4
    warmup_frac: float = 0.02  # same // 50 family as the joint stage
    seed: int = 0


class FinetuneState(NamedTuple):
    model: nn.Module  # the whole model: base frozen, adapters training
    optimizer: ClippedAdamW


def lora_optimizer(cfg: FinetuneConfig, model: nn.Module,
                   total_steps: int) -> ClippedAdamW:
    """Freeze the base of ``model`` and return clip → AdamW over its LoRA
    adapters only, on the warmup-cosine schedule of ``total_steps``."""
    freeze_base(model)
    adapters = [(n, p) for n, p in model.named_parameters()
                if p.requires_grad]
    warmup = max(int(total_steps * cfg.warmup_frac), 1)
    return ClippedAdamW(
        adapters, cosine_warmup_schedule(cfg.learning_rate, warmup,
                                         total_steps),
        max_grad_norm=cfg.max_grad_norm, weight_decay=cfg.weight_decay)


def lm_loss(logits: torch.Tensor, input_ids: torch.Tensor,
            pad_mask: torch.Tensor,
            loss_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy over positions whose target is a real
    token (``pad_mask``) or, with ``loss_mask``, a graded response token.
    ``logits`` ``[b, s, v]`` float32, the masks ``[b, s]`` bool."""
    targets = input_ids[:, 1:].reshape(-1).long()
    w = (pad_mask if loss_mask is None else loss_mask)[:, 1:].reshape(-1).to(
        torch.float32)
    # rows of [b·(s-1), v]: the softmax runs along the contiguous last axis
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                         targets, reduction="none")
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)


def make_lm_steps(model: nn.Module, tx: ClippedAdamW | None
                  ) -> tuple[Callable, Callable]:
    """``(train_step, eval_step)``: ``train_step(state, ids, mask,
    loss_mask=None) -> (state, loss)`` takes one optimizer step;
    ``eval_step(ids, mask, loss_mask=None) -> loss`` under
    ``inference_mode``. Attention always sees the full ``pad_mask``."""

    def loss_fn(ids, mask, loss_mask=None):
        return lm_loss(model(ids, mask), ids, mask, loss_mask)

    def train_step(state: FinetuneState, ids, mask, loss_mask=None):
        loss = loss_fn(ids, mask, loss_mask)
        loss.backward()
        tx.step()
        return state, loss.detach()

    @torch.inference_mode()
    def eval_step(ids, mask, loss_mask=None):
        return loss_fn(ids, mask, loss_mask)

    return train_step, eval_step


def _lm_batches(examples, batch_size: int, seed: int = 0
                ) -> Iterator[tuple[np.ndarray, np.ndarray,
                                    np.ndarray | None]]:
    """Fixed-shape ``(ids, pad_mask, loss_mask or None)`` batches over
    :class:`TextExamples` or examples that carry a ``loss_mask`` (the
    self-instruct ``LMExamples``), through :func:`text_batches`; a
    ``loss_mask`` row is joined by row position and zeroed on padded tail
    rows."""
    has_lm = hasattr(examples, "loss_mask")
    n = len(examples)
    te = TextExamples(input_ids=examples.input_ids,
                      labels=np.zeros(n, np.int32), indices=np.arange(n),
                      pad_mask=examples.pad_mask) if has_lm else examples
    for tb in text_batches(te, batch_size, shuffle=True, seed=seed):
        lm = None
        if has_lm:
            rows = np.clip(tb.indices, 0, None).astype(np.intp)
            lm = examples.loss_mask[rows].copy()
            lm[~tb.mask] = False  # padded tail rows carry zero loss
        yield tb.input_ids, tb.pad_mask, lm


@dataclasses.dataclass
class LoraFinetuner:
    """Fine-tunes the adapters of ``model`` (a ``LlamaForCausalLM`` with
    ``lora_rank > 0``, holding its weights) in place, on the model's
    device."""

    model: nn.Module
    cfg: FinetuneConfig
    run_dir: Path | None = None

    def __post_init__(self):
        self.device = next(self.model.parameters()).device
        self.step_seconds: list[float] = []

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def train(self, examples) -> tuple[nn.Module, list[float]]:
        """(the model with tuned adapters, per-epoch mean losses).
        ``examples`` is :class:`TextExamples` (loss on every real token) or
        carries a ``loss_mask`` (loss on response tokens only)."""
        cfg = self.cfg
        n_batches = -(-len(examples) // cfg.batch_size)
        tx = lora_optimizer(cfg, self.model,
                            total_steps=cfg.epochs * n_batches)
        train_step, _ = make_lm_steps(self.model, tx)
        state = FinetuneState(self.model, tx)
        epoch_losses: list[float] = []
        for epoch in range(cfg.epochs):
            losses = []
            for ids, pad, loss_mask in _lm_batches(
                    examples, cfg.batch_size, seed=cfg.seed + epoch):
                t0 = time.perf_counter()
                state, loss = train_step(
                    state, self._tensor(ids), self._tensor(pad),
                    None if loss_mask is None else self._tensor(loss_mask))
                losses.append(float(loss))
                self.step_seconds.append(time.perf_counter() - t0)
            epoch_losses.append(float(np.mean(losses)))
            if self.run_dir is not None:
                self.save_adapters(self.model, f"adapters_epoch_{epoch}")
        return self.model, epoch_losses

    def save_adapters(self, model: nn.Module, name: str) -> Path:
        """The adapters alone as ``{run_dir}/{name}/`` (``state.pt``, then
        ``meta.json``; the base model is never written)."""
        adapters, _ = split_lora(model.state_dict())
        return commit_state_dir(Path(self.run_dir) / name, adapters,
                                {"adapters": sorted(adapters)})

    def load_adapters(self, model: nn.Module, name: str) -> nn.Module:
        """Load the adapters saved as ``name`` onto ``model`` (a fresh or
        base model of the same configuration) in place; every adapter of
        the model must be in the checkpoint. An orbax directory of the JAX
        package raises ``ValueError``."""
        path = Path(self.run_dir) / name
        if not ((path / "meta.json").is_file()
                and (path / "state.pt").is_file()):
            raise ValueError(
                f"{path} is not an adapter checkpoint of this package (no "
                "meta.json and state.pt): an orbax directory of the JAX "
                "package is converted by restoring its tree with the JAX "
                "package and carrying it across with "
                "deepdfa_tpu_torch.bridge.llama_flax_to_torch")
        adapters = torch.load(path / "state.pt", map_location="cpu",
                              weights_only=True)
        want = {k: v.shape for k, v in split_lora(model.state_dict())[0]
                .items()}
        if {k: v.shape for k, v in adapters.items()} != want:
            raise ValueError(
                f"{path}: the saved adapters' names or shapes do not match "
                "the model's (another lora_rank or model)")
        model.load_state_dict(adapters, strict=False)
        return model
