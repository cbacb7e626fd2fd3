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

Over a sharded model (``LlamaForCausalLM(cfg, mesh=...)``, every rank of
the mesh running the same finetuner on the same batches), the step is the
unsharded step, as GSPMD makes it in the JAX package:

- each rank scores its ``dp``/``sp`` block of the batch
  (:func:`sharded_lm_loss`): the sum of its tokens' cross-entropy over the
  **global** count of loss tokens (the counts summed over ``dp`` and
  ``sp``), and the blocks' parts summed over ``dp`` and ``sp``, so every
  rank holds the whole loss;
- each adapter's gradient is summed over ``dp`` and ``sp`` (the ranks
  along them ran other tokens with a replica of it); ``lora_a``'s is
  summed over ``tp`` in the backward (``ShardedLoRA``), ``lora_b`` is
  split over ``tp``;
- the clip's global norm counts each distinct element once: a shard's
  squares are summed over the axes that split it (``fsdp`` for
  ``lora_a``, ``tp`` for ``lora_b``);
- :meth:`LoraFinetuner.save_adapters` gathers the shards (mesh rank 0
  writes the unsharded run's names, shapes and values) and
  :meth:`LoraFinetuner.load_adapters` takes this rank's shard.
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
from deepdfa_tpu_torch.parallel import comm

__all__ = ["FinetuneConfig", "FinetuneState", "LoraFinetuner", "lm_loss",
           "lora_optimizer", "make_lm_steps", "sharded_lm_loss"]


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
    sums, splits = (), None
    mesh = _mesh(model)
    if mesh is not None:
        from deepdfa_tpu_torch.llm.llama import mesh_shardings

        specs = mesh_shardings(dict(adapters))
        sums = [mesh.groups.get("dp"), mesh.groups.get("sp")]
        splits = {n: tuple(mesh.groups[a] for a in specs[n]
                           if a is not None and mesh.axes[a] > 1)
                  for n, _ in adapters}
    return ClippedAdamW(
        adapters, cosine_warmup_schedule(cfg.learning_rate, warmup,
                                         total_steps),
        max_grad_norm=cfg.max_grad_norm, weight_decay=cfg.weight_decay,
        sum_groups=sums, split_groups=splits)


def _mesh(model: nn.Module):
    """The mesh a sharded model runs over, else None."""
    inner = getattr(model, "model", model)
    return None if getattr(inner, "shards", None) is None else inner.mesh


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


def sharded_lm_loss(model: nn.Module, input_ids: torch.Tensor,
                    pad_mask: torch.Tensor,
                    loss_mask: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`lm_loss` of a sharded ``LlamaForCausalLM`` (whole inputs on
    every rank): this rank's block of float32 logits against the tokens
    that follow them (the last position has none), its cross-entropy sum
    over the global count of loss tokens, summed over ``dp`` and ``sp``
    (``comm.all_reduce``, whose backward is the identity). Every rank
    returns the whole loss."""
    mesh = _mesh(model)
    b, s = input_ids.shape
    rows = mesh.block(b, "dp", "the batch")
    cols = mesh.block(s, "sp", "the sequence")
    logits = model.sharded_logits(input_ids, pad_mask)
    targets = torch.roll(input_ids, -1, dims=1)[rows, cols].reshape(-1).long()
    w = pad_mask if loss_mask is None else loss_mask
    w = torch.cat([w[:, 1:], torch.zeros_like(w[:, :1])], dim=1)
    w = w[rows, cols].reshape(-1).to(torch.float32)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets,
                         reduction="none")
    groups = (mesh.groups.get("dp"), mesh.groups.get("sp"))
    count = torch.sum(w)
    for group in groups:
        count = comm.all_reduce(count, group)
    part = torch.sum(ce * w) / torch.clamp(count, min=1.0)
    for group in groups:
        part = comm.all_reduce(part, group)
    return part


def make_lm_steps(model: nn.Module, tx: ClippedAdamW | None
                  ) -> tuple[Callable, Callable]:
    """``(train_step, eval_step)``: ``train_step(state, ids, mask,
    loss_mask=None) -> (state, loss)`` takes one optimizer step;
    ``eval_step(ids, mask, loss_mask=None) -> loss`` under
    ``inference_mode``. Attention always sees the full ``pad_mask``. A
    sharded model takes :func:`sharded_lm_loss`."""

    def loss_fn(ids, mask, loss_mask=None):
        if _mesh(model) is not None:
            return sharded_lm_loss(model, ids, mask, loss_mask)
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
    device. A sharded model: every rank of its mesh runs the finetuner
    (module docstring)."""

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
        ``meta.json``; the base model is never written). A sharded model's
        adapters are gathered whole (every rank calls this) and mesh rank
        0 writes them, the names, shapes and values of the unsharded
        model's; the ranks meet after the write."""
        from deepdfa_tpu_torch.llm.llama import gather_state

        adapters, _ = split_lora(model.state_dict())
        path = Path(self.run_dir) / name
        mesh = _mesh(model)
        if mesh is None:
            return commit_state_dir(path, adapters,
                                    {"adapters": sorted(adapters)})
        import torch.distributed as dist

        adapters = gather_state(adapters, mesh)
        if mesh.rank == 0:
            commit_state_dir(path, adapters, {"adapters": sorted(adapters)})
        dist.barrier(group=mesh.group)
        return path

    def load_adapters(self, model: nn.Module, name: str) -> nn.Module:
        """Load the adapters saved as ``name`` onto ``model`` (a fresh or
        base model of the same configuration; a sharded one takes this
        rank's shard of each) in place; every adapter of the model must be
        in the checkpoint. An orbax directory of the JAX package raises
        ``ValueError``."""
        from deepdfa_tpu_torch.llm.llama import shard_state

        path = Path(self.run_dir) / name
        if not ((path / "meta.json").is_file()
                and (path / "state.pt").is_file()):
            raise ValueError(
                f"{path} is not an adapter checkpoint of this package (no "
                "meta.json and state.pt): convert an orbax directory of the "
                "JAX package with convert_jax_checkpoint.py at the "
                "repository's root, where JAX is installed (python "
                "convert_jax_checkpoint.py lora SRC DST; it carries the tree "
                "across with deepdfa_tpu_torch.bridge.llama_flax_to_torch)")
        adapters = torch.load(path / "state.pt", map_location="cpu",
                              weights_only=True)
        want = {k: v.shape for k, v in split_lora(model.state_dict())[0]
                .items()}
        mesh = _mesh(model)
        if mesh is not None and adapters.keys() == want.keys():
            adapters = shard_state(adapters, mesh)
        if {k: v.shape for k, v in adapters.items()} != want:
            raise ValueError(
                f"{path}: the saved adapters' names or shapes do not match "
                "the model's (another lora_rank or model)")
        model.load_state_dict(adapters, strict=False)
        return model
