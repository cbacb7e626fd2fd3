"""Joint LLM + GGNN training and scoring: the MSIVD training loop.

The port of ``deepdfa_tpu/llm/joint.py``:

- :class:`JointConfig` — the reference's launch defaults, every field kept
  so a JAX configuration reads unchanged (``prefetch`` has no effect here:
  the graph join and the copies to the card run inline);
- the frozen LLM's final hidden states feed the trainable fusion model
  (:func:`hidden_states`, under ``no_grad`` in a train step: no backward is
  built through the decoder stack, and flash attention runs B6 alone);
  ``train_llm=True`` (LineVul-combined) trains the encoder too;
- :func:`joint_optimizer` — clip by global norm, then AdamW with no decay
  on biases and norm weights (:func:`weight_decay_mask`), on the cosine
  schedule with linear warmup (:func:`cosine_warmup_schedule`, optax's step
  for step: the first update uses the schedule at count 0), zero updates
  under ``flowgnn_encoder`` with ``freeze_gnn`` and ``optax.MultiSteps``
  gradient accumulation: :class:`ClippedAdamW`;
- :func:`make_joint_steps` — ``(train_step, eval_step)``; :func:`eval_step`
  is the one ``JointEngine`` scores with;
- :class:`JointTrainer` — ``train`` (with the denser first-epoch eval
  cadence of :func:`eval_points`), ``evaluate``, ``test``, ``save`` and
  ``load``; :func:`best_threshold_sweep`;
- :func:`save_fusion_epoch` / :func:`load_fusion_epoch` — the fusion state
  dict of one epoch in ``{run_dir}/epoch_{N}/``, written as
  ``train/checkpoint.py`` writes a step: ``state.pt`` and then
  ``meta.json`` into ``epoch_{N}.tmp/``, renamed into place, so
  ``meta.json`` marks a committed epoch. The frozen LLM's weights are never
  written.

Where the JAX package is functional, the port updates in place: the
parameters live in the modules, :class:`JointState` carries the trained
module, its optimizer and the step count.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from deepdfa_tpu_torch.data.graphs import to_device
from deepdfa_tpu_torch.llm.dataset import (GraphJoin, JoinedBatch,
                                           TextExamples, text_batches)
from deepdfa_tpu_torch.llm.fusion import fusion_loss
from deepdfa_tpu_torch.parallel import comm
from deepdfa_tpu_torch.resilience.journal import fsync_dir
from deepdfa_tpu_torch.train.metrics import classification_report

__all__ = ["ClippedAdamW", "JointConfig", "JointState", "JointTrainer",
           "best_threshold_sweep", "commit_state_dir",
           "cosine_warmup_schedule", "eval_points", "eval_step",
           "gnn_freeze_labels", "hidden_states", "joint_optimizer",
           "load_fusion_epoch", "make_joint_steps", "save_fusion_epoch",
           "weight_decay_mask"]


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
    # LineVul-combined mode: the encoder trains with the fusion model
    train_llm: bool = False
    prefetch: int = 1  # no effect in the port (see the module docstring)
    # zero updates under ``flowgnn_encoder`` (freeze_graph_weights)
    freeze_gnn: bool = False

    @property
    def report_avg(self) -> str:
        return "macro" if "bigvul" in self.dataset_style else "weighted"


def hidden_states(llm, batch: JoinedBatch, device) -> torch.Tensor:
    """The LLM's final hidden states ``[b, s, hidden]`` of the batch's text,
    with its explicit pad mask: a ``LlamaModel`` takes ``arange`` positions
    (RoPE is relative, so a left-padded row keeps its real tokens'
    distances), a ``RobertaEncoder`` places its absolute positions from the
    mask."""
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


def commit_state_dir(path: str | Path, state: dict,
                     meta: dict | None = None) -> Path:
    """Write a state dict as the directory ``path``: ``state.pt`` and then
    ``meta.json`` into ``{path}.tmp/``, renamed into place, so ``meta.json``
    marks a committed directory. Returns ``path``."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save({k: v.detach().cpu() for k, v in state.items()},
               tmp / "state.pt")
    (tmp / "meta.json").write_text(json.dumps(meta or {}))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)
    fsync_dir(path.parent)
    return path


def save_fusion_epoch(run_dir: str | Path, epoch: int, state: dict,
                      meta: dict | None = None) -> Path:
    """Write a fusion state dict as ``{run_dir}/epoch_{epoch}`` (committed
    by ``meta.json``, then one rename). Returns the directory."""
    return commit_state_dir(Path(run_dir) / f"epoch_{int(epoch)}", state,
                            dict(epoch=int(epoch), **(meta or {})))


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


# ------------------------------------------------------------- training

def weight_decay_mask(names: Iterable[str]) -> dict[str, bool]:
    """Parameter name → True where AdamW decays it. The reference excludes
    ``bias`` and ``LayerNorm.weight`` (``train.py:242-260``): any name
    ending ``bias`` or ``scale``, and any ``weight`` under a module whose
    name holds ``norm``."""
    def decays(name: str) -> bool:
        parts = name.split(".")
        if parts[-1] in ("bias", "scale"):
            return False
        return not (parts[-1] == "weight"
                    and any("norm" in p.lower() for p in parts[:-1]))

    return {n: decays(n) for n in names}


def gnn_freeze_labels(names: Iterable[str]) -> dict[str, str]:
    """Parameter name → ``"freeze"`` under a ``flowgnn_encoder`` module
    (``freeze_graph_weights``), else ``"train"``; on the bare fusion model's
    names and on the combined ``fusion.*``/``llm.*`` ones."""
    return {n: "freeze" if "flowgnn_encoder" in n.split(".") else "train"
            for n in names}


def cosine_warmup_schedule(lr: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1), 0)`` as a function of the update count, in float32 as
    optax computes it: linear 0 → lr over ``warmup_steps`` (at least 1),
    then cosine lr → 0 over the rest (HF ``get_cosine_schedule_with_warmup``
    parity)."""
    f32 = np.float32
    warmup = max(int(warmup_steps), 1)
    decay = max(int(total_steps), warmup + 1) - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f32(1.0) - f32(count) / f32(warmup)
            return float(f32(-lr) * frac + f32(lr))
        c = f32(min(count - warmup, decay))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * c / f32(decay)))
        return float(f32(lr) * cosine)

    return schedule


class ClippedAdamW:
    """optax's ``chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    eps, weight_decay, mask))`` over the named parameters it is given, in
    place, wrapped in ``MultiSteps(k)`` when ``accumulate`` is k > 1.

    - The global norm runs over these parameters' gradients only; above
      ``max_grad_norm`` every gradient is scaled by ``max_grad_norm / norm``.
    - AdamW (b1 0.9, b2 0.999) on ``torch.optim.AdamW`` with a no-decay
      group where ``decay`` says False; the learning rate of each update is
      ``schedule(count)``, the count of updates made before it.
    - With k > 1, each :meth:`step` folds the gradients into their running
      mean; every k-th applies the update to that mean and starts over
      (``MultiSteps``' default: the mean of k micro-gradients).
    - Parameters not given get no update and no state (optax's
      ``set_to_zero`` in ``multi_transform``).
    - Over a sharded model (``parallel.comm``'s convention): each step
      first sums the gradients over the process groups ``sum_groups`` (the
      ``dp`` and ``sp`` lines, along which the ranks ran other tokens), and
      ``split_groups`` maps a parameter's name to the groups that split it
      (its shard's squares are summed over them), so each distinct element
      counts once in the norm; a group that replicates a parameter is never
      summed over."""

    def __init__(self, named_params: Iterable[tuple[str, nn.Parameter]],
                 schedule: Callable[[int], float], *, max_grad_norm: float,
                 weight_decay: float = 0.0, eps: float = 1e-8,
                 decay: dict[str, bool] | None = None, accumulate: int = 1,
                 sum_groups: Iterable = (),
                 split_groups: dict[str, tuple] | None = None):
        named = list(named_params)
        if not named:
            raise ValueError("ClippedAdamW: no parameters to train")
        self.params = [p for _, p in named]
        self.schedule = schedule
        self.max_grad_norm = float(max_grad_norm)
        self.accumulate = int(accumulate)
        self.sum_groups = [g for g in sum_groups if g is not None]
        self.split = [tuple(g for g in (split_groups or {}).get(n, ())
                            if g is not None) for n, _ in named]
        self.count = 0  # updates applied
        self.mini_step = 0
        self._acc: list[torch.Tensor] | None = None
        groups = [
            {"params": [p for n, p in named if decay is None or decay[n]],
             "weight_decay": weight_decay},
            {"params": [p for n, p in named
                        if decay is not None and not decay[n]],
             "weight_decay": 0.0}]
        self.optimizer = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=0.0, betas=(0.9, 0.999),
            eps=eps)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _sum(self, grads: list[torch.Tensor]) -> None:
        """Sum the gradients over ``sum_groups`` in place, through one flat
        buffer."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        for group in self.sum_groups:
            comm.all_reduce_(flat, group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def _clip(self, grads: list[torch.Tensor]) -> None:
        squares: dict[tuple, torch.Tensor] = {}
        for g, split in zip(grads, self.split):
            sq = torch.sum(g.to(torch.float32) ** 2)
            squares[split] = squares[split] + sq if split in squares else sq
        total = 0
        for split, sq in squares.items():
            for group in split:
                comm.all_reduce_(sq, group)
            total = total + sq
        norm = torch.sqrt(total)
        scale = torch.where(norm < self.max_grad_norm,
                            torch.ones_like(norm), self.max_grad_norm / norm)
        for g in grads:
            g.mul_(scale.to(g.dtype))

    @torch.no_grad()
    def step(self) -> bool:
        """Consume the parameters' gradients (None counts as zero); True
        when an update was applied."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.sum_groups:
            self._sum(grads)
        if self.accumulate > 1:
            n = self.mini_step
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            for acc, g in zip(self._acc, grads):
                acc.add_((g - acc) / (n + 1))
            self.mini_step = (n + 1) % self.accumulate
            if self.mini_step:
                self.zero_grad()
                return False
            grads, self._acc = self._acc, None
        self._clip(grads)
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1
        self.zero_grad()
        return True


def joint_optimizer(cfg: JointConfig, steps_per_epoch: int,
                    model: nn.Module) -> ClippedAdamW:
    """clip → AdamW (no-decay mask) → cosine warmup over the trained
    module's parameters, updates every ``gradient_accumulation_steps``
    batches (``train.py:335-360``); ``warmup = updates // 50``
    (``train.py:238``). With ``cfg.freeze_gnn`` the ``flowgnn_encoder``
    parameters get no update."""
    opt_steps = (cfg.epochs * steps_per_epoch) // cfg.gradient_accumulation_steps
    schedule = cosine_warmup_schedule(cfg.learning_rate, opt_steps // 50,
                                      opt_steps)
    named = list(model.named_parameters())
    if cfg.freeze_gnn:
        labels = gnn_freeze_labels(n for n, _ in named)
        named = [(n, p) for n, p in named if labels[n] == "train"]
    return ClippedAdamW(
        named, schedule, max_grad_norm=cfg.max_grad_norm,
        weight_decay=cfg.weight_decay, eps=cfg.adam_epsilon,
        decay=weight_decay_mask(n for n, _ in named),
        accumulate=cfg.gradient_accumulation_steps)


def eval_points(steps_per_epoch: int, epoch: int,
                cfg: JointConfig) -> set[int]:
    """Step indices (within an epoch) after which to evaluate: the first
    epoch ``first_eval_steps`` times, later ones ``eval_steps`` times
    (``train.py:236-238,366-386``)."""
    per = cfg.first_eval_steps if epoch == 0 else cfg.eval_steps
    stride = max(steps_per_epoch // per, 1)
    return set(range(stride - 1, steps_per_epoch, stride))


def best_threshold_sweep(probs: np.ndarray, labels: np.ndarray, *,
                         macro: bool = True,
                         grid: Iterable[float] | None = None
                         ) -> tuple[float, float]:
    """MSIVD's threshold selection: ``(best_threshold, best_f1)`` over
    ``grid`` (default 0.01 .. 0.99 in steps of 0.01) of the positive
    probabilities; ties keep the lowest threshold."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels)
    ts = (np.round(np.arange(1, 100) / 100.0, 2) if grid is None
          else np.asarray(list(grid), np.float64))
    key = "f1_macro" if macro else "f1_weighted"
    best_t, best_f = float(ts[0]), -1.0
    for t in ts:
        f1 = classification_report(probs, labels, macro=macro,
                                   threshold=float(t))[key]
        if f1 > best_f:
            best_t, best_f = float(t), float(f1)
    return best_t, best_f


@dataclasses.dataclass
class JointState:
    """The trained module (the fusion model; with ``train_llm`` a
    ``ModuleDict`` of ``fusion`` and ``llm``), its optimizer and the count
    of train steps taken."""

    params: nn.Module
    opt_state: ClippedAdamW
    step: int = 0


def _batch_tensors(batch: JoinedBatch, device):
    """(pad mask, labels, example mask) of a joined batch on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (batch.text.pad_mask, batch.text.labels,
                           batch.mask))


def make_joint_steps(llm: nn.Module, fusion: nn.Module,
                     tx: ClippedAdamW | None, train_llm: bool = False,
                     device=None, seed: int = 0
                     ) -> tuple[Callable, Callable]:
    """``(train_step, eval_step)``. ``train_step(state, batch) -> (state,
    loss, probs)`` takes one optimizer step on ``state.params``; its
    dropout draws from ``seed`` and the step count. ``train_llm=False``
    (MSIVD): the LLM runs under ``no_grad``, so no backward is built
    through it. ``train_llm=True``: ``state.params`` is ``{"fusion",
    "llm"}``, gradients flow through the encoder, and the encoder's own
    dropout (RoBERTa's) is on for the step. ``eval_step(params,
    batch) -> (loss, probs)`` runs under ``inference_mode``."""
    dev = torch.device(device) if device is not None else next(
        fusion.parameters()).device

    def parts(params: nn.Module) -> tuple[nn.Module, nn.Module]:
        return (params["fusion"], params["llm"]) if train_llm else (params,
                                                                    llm)

    def train_step(state: JointState, batch: JoinedBatch):
        fus, enc = parts(state.params)
        fus.train()
        # the encoder's own dropout (RoBERTa's HF rates) only on the steps
        # that train it; the frozen LLM runs as in eval
        enc.train(train_llm)
        devices = [dev] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(seed * 1_000_003 + state.step)
            if train_llm:
                hidden = hidden_states(enc, batch, dev)
            else:
                with torch.no_grad():
                    hidden = hidden_states(enc, batch, dev)
            pad, labels, mask = _batch_tensors(batch, dev)
            graphs = to_device(batch.graphs, dev) if fus.use_gnn else None
            loss, probs = fusion_loss(fus(hidden, graphs, token_mask=pad),
                                      labels, mask)
        loss.backward()
        tx.step()
        state.step += 1
        return state, loss.detach(), probs.detach()

    def evaluate(params: nn.Module, batch: JoinedBatch):
        fus, enc = parts(params)
        fus.eval()
        enc.eval()
        return eval_step(enc, fus, batch, dev)

    return train_step, evaluate


@dataclasses.dataclass
class JointTrainer:
    """The ``train``/``evaluate``/``test`` loop (``train.py:211-585``)
    over an LLM and a fusion model already holding their weights, on the
    fusion model's device. The LLM is frozen unless ``cfg.train_llm``."""

    llm: nn.Module
    fusion: nn.Module
    cfg: JointConfig
    join: GraphJoin | None  # None = no_flowgnn mode
    run_dir: Path | None = None

    def __post_init__(self):
        self._steps: tuple[Callable, Callable] | None = None
        self.tx: ClippedAdamW | None = None
        self.num_missing = 0
        self.history: list[dict] = []
        self.device = next(self.fusion.parameters()).device

    def _joined(self, batch) -> JoinedBatch:
        if self.join is not None:
            return self.join.join(batch)
        return JoinedBatch(text=batch, graphs=None, mask=batch.mask)

    def trained_module(self) -> nn.Module:
        """What the optimizer updates: the fusion model, or with
        ``train_llm`` a ``ModuleDict`` of ``fusion`` and ``llm``."""
        if self.cfg.train_llm:
            return nn.ModuleDict({"fusion": self.fusion, "llm": self.llm})
        return self.fusion

    def _build(self, steps_per_epoch: int,
               params: nn.Module | None = None) -> JointState:
        """The optimizer and the steps over ``params`` (default: the
        trainer's modules); returns a fresh :class:`JointState`."""
        params = params if params is not None else self.trained_module()
        if not self.cfg.train_llm:
            self.llm.eval()
        self.tx = joint_optimizer(self.cfg, steps_per_epoch, params)
        self._steps = make_joint_steps(self.llm, self.fusion, self.tx,
                                       train_llm=self.cfg.train_llm,
                                       device=self.device, seed=self.cfg.seed)
        return JointState(params, self.tx, 0)

    def train(self, train_examples: TextExamples,
              eval_examples: TextExamples,
              state: JointState | None = None) -> JointState:
        """``cfg.epochs`` epochs over shuffled batches from ``state`` (a
        fresh one when None), evaluating at :func:`eval_points` and saving
        ``epoch_{N}`` under ``run_dir`` after each epoch."""
        cfg = self.cfg
        n_batches = -(-len(train_examples) // cfg.train_batch_size)
        if state is None:
            state = self._build(n_batches)
        elif self._steps is None or self.tx is not state.opt_state:
            self.tx = state.opt_state
            self._steps = make_joint_steps(
                self.llm, self.fusion, self.tx, train_llm=cfg.train_llm,
                device=self.device, seed=cfg.seed)
        train_step, _ = self._steps
        for epoch in range(cfg.epochs):
            batches = text_batches(train_examples, cfg.train_batch_size,
                                   shuffle=True, seed=cfg.seed + epoch)
            points = eval_points(n_batches, epoch, cfg)
            tr_loss, tr_num = 0.0, 0
            for step, tb in enumerate(batches):
                state, loss, _probs = train_step(state, self._joined(tb))
                tr_loss += float(loss)
                tr_num += 1
                if step in points:
                    self.history.append(
                        {"epoch": epoch, "step": step,
                         **self.evaluate(state.params, eval_examples)})
            self.history.append(
                {"epoch": epoch, "train_loss": tr_loss / max(tr_num, 1)})
            if self.run_dir is not None:
                self.save(state, f"epoch_{epoch}")
        if self.join is not None:
            self.num_missing = self.join.num_missing
        return state

    def _run_eval(self, params: nn.Module, examples: TextExamples
                  ) -> tuple[float, np.ndarray, np.ndarray]:
        if self._steps is None:  # standalone eval (test-only runs)
            self._steps = make_joint_steps(
                self.llm, self.fusion, None, train_llm=self.cfg.train_llm,
                device=self.device, seed=self.cfg.seed)
        _, evaluate = self._steps
        losses, probs_all, labels_all = [], [], []
        for tb in text_batches(examples, self.cfg.eval_batch_size):
            jb = self._joined(tb)
            loss, probs = evaluate(params, jb)
            losses.append(float(loss))
            keep = np.asarray(jb.mask)
            probs_all.append(probs.to("cpu", torch.float64).numpy()[keep])
            labels_all.append(np.asarray(tb.labels)[keep])
        return (float(np.mean(losses)) if losses else 0.0,
                np.concatenate(probs_all) if probs_all else np.zeros((0, 2)),
                np.concatenate(labels_all) if labels_all
                else np.zeros(0, np.int32))

    def _report(self, prefix: str, params: nn.Module,
                examples: TextExamples) -> dict[str, float]:
        loss, probs, labels = self._run_eval(params, examples)
        report = classification_report(
            probs[:, 1] if probs.size else probs.reshape(0), labels,
            macro=self.cfg.report_avg == "macro",
            threshold=self.cfg.best_threshold)
        return {f"{prefix}_loss": loss,
                **{f"{prefix}_{k}": v for k, v in report.items()}}

    def evaluate(self, params: nn.Module,
                 examples: TextExamples) -> dict[str, float]:
        """``evaluate`` parity (``train.py:396-465``): mean loss + report."""
        return self._report("eval", params, examples)

    def test(self, params: nn.Module,
             examples: TextExamples) -> dict[str, float]:
        """``test`` parity (``train.py:467-585``), profiling aside."""
        return self._report("test", params, examples)

    def save(self, state: JointState, name: str) -> Path:
        """The trained module's state dict (the fusion model's; the frozen
        LLM is never written, ``train.py:389-392``) as ``{run_dir}/{name}``,
        committed by ``meta.json``; ``epoch_{N}`` is the format
        ``JointEngine.from_run_dir`` restores."""
        return commit_state_dir(Path(self.run_dir) / name,
                                state.params.state_dict(),
                                {"name": name, "step": state.step})

    def load(self, name: str) -> dict:
        """The state dict saved as ``{run_dir}/{name}`` (CPU tensors), for
        ``load_state_dict`` on the trained module."""
        return load_fusion_epoch(Path(self.run_dir) / name,
                                 map_location="cpu")
