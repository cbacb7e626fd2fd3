"""Training and eval steps and the epoch loop for the GGNN classifier.

The port of ``deepdfa_tpu/train/loop.py``: labels for every
``label_style`` (graph labels are masked segment maxima, so an empty padded
graph slot gets label 0 and weight 0; node and dataflow-solution labels are
per node, weighted by ``node_mask``, and ``dataflow_solution_in`` keeps
only definition nodes, ``cut_nodef``), ``BCEWithLogitsLoss(pos_weight=...)``
in log-sigmoid form, the node-level undersampling of the loss, metric
counts accumulated on the device (per node for the node styles), and the
in-step non-finite guard.

Where the JAX package is functional, this port updates in place: the
parameters live in the model and ``torch.optim.AdamW`` updates them and
its own state. :class:`TrainState` carries the model, the optimizer, the
step's random generator and the step count; a train step returns the same
state object, advanced.

The optimizer is ``optax.adamw``'s: ``AdamW(lr, betas=(0.9, 0.999),
eps=1e-8, weight_decay)`` over every parameter, after
``clip_grad_norm_(grad_clip)`` when ``optim.grad_clip`` is set.
:meth:`Trainer.train_epoch` takes the resilience layer's hooks as the JAX
package's does: the divergence sentinel, the preemption handler, a
mid-epoch skip count, the step watchdog and the training telemetry, and
fires the ``step.nan_grads``, ``preempt.sigterm`` and ``step.hang`` fault
points.

Node undersampling draws its keep mask from the step's
``torch.Generator``, so it is reproducible run to run but not bit for bit
``jax.random.bernoulli``'s: the two packages agree on the keep rate, not
on which nodes are kept.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from contextlib import nullcontext
from typing import Callable, Iterable

import torch
from torch import nn

from deepdfa_tpu_torch.config import ExperimentConfig
from deepdfa_tpu_torch.data.graphs import BatchedGraphs
from deepdfa_tpu_torch.data.prefetch import prefetch_to_device
from deepdfa_tpu_torch.ops.segment import segment_max
from deepdfa_tpu_torch.resilience import faults
from deepdfa_tpu_torch.resilience.preemption import Preempted
from deepdfa_tpu_torch.train.metrics import (ConfusionState, compute_metrics,
                                             update_confusion)

__all__ = [
    "TrainState",
    "Trainer",
    "bce_sums",
    "bce_with_logits",
    "extract_labels",
    "graph_labels",
    "make_eval_step",
    "make_train_step",
    "node_undersample_weights",
]


@dataclasses.dataclass
class TrainState:
    """What a train step reads and advances: the parameters (in ``model``),
    the optimizer and its state, the random generator (advanced once per
    step, as the JAX package splits its key) and the step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    rng: torch.Generator
    step: int = 0


def graph_labels(batch: BatchedGraphs) -> torch.Tensor:
    """Graph-level label = max of node ``_VULN`` per graph slot. An empty
    padded slot's max is ``-inf`` and is clamped to 0 (it carries weight 0,
    but a finite label keeps the loss finite)."""
    vuln = batch.node_feats["_VULN"].float()
    return torch.clamp(segment_max(vuln, batch.node_gidx, batch.max_graphs),
                       min=0.0)


def extract_labels(batch: BatchedGraphs,
                   label_style: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels, weights) for ``label_style``. The weights exclude padding:
    padded graph slots for ``graph``, padding nodes for the node styles,
    and for ``dataflow_solution_in`` also the nodes that define nothing
    (a zero abstract-dataflow id: ``cut_nodef``)."""
    if label_style == "graph":
        return graph_labels(batch), batch.graph_mask.float()
    if label_style == "node":
        return batch.node_feats["_VULN"].float(), batch.node_mask.float()
    if label_style in ("dataflow_solution_in", "dataflow_solution_out"):
        is_in = label_style.endswith("_in")
        labels = batch.node_feats["_DF_IN" if is_in else "_DF_OUT"].float()
        weights = batch.node_mask.float()
        if is_in:
            key = ("_ABS_DATAFLOW" if "_ABS_DATAFLOW" in batch.node_feats
                   else "_ABS_DATAFLOW_datatype")
            weights = weights * (batch.node_feats[key] != 0).float()
        return labels, weights
    raise NotImplementedError(label_style)


def node_undersample_weights(rng: torch.Generator, labels: torch.Tensor,
                             weights: torch.Tensor,
                             factor: float) -> torch.Tensor:
    """The node-level loss undersampling: keep every positive node, keep
    each negative with probability ``factor * n_pos / n_neg`` (clipped to
    [0, 1]), the keep mask drawn from ``rng`` on the host."""
    n_pos = torch.sum(weights * labels)
    n_neg = torch.clamp(torch.sum(weights * (1.0 - labels)), min=1.0)
    p_keep = torch.clamp(factor * n_pos / n_neg, 0.0, 1.0)
    u = torch.rand(labels.shape, generator=rng).to(labels.device)
    keep = (u < p_keep).float()
    return weights * torch.where(labels > 0, torch.ones_like(keep), keep)


def bce_sums(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
             pos_weight: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum-form BCE-with-logits: ``(Σ per·w, Σ w)``, torch
    ``BCEWithLogitsLoss`` semantics with ``pos_weight`` scaling the
    positive term."""
    log_p = torch.nn.functional.logsigmoid(logits)
    log_not_p = torch.nn.functional.logsigmoid(-logits)
    pw = 1.0 if pos_weight is None else pos_weight
    per = -(pw * labels * log_p + (1.0 - labels) * log_not_p)
    return torch.sum(per * weights), torch.sum(weights)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor,
                    pos_weight: float | None = None) -> torch.Tensor:
    """Weighted-mean BCE-with-logits (see :func:`bce_sums`)."""
    num, den = bce_sums(logits, labels, weights, pos_weight)
    return num / torch.clamp(den, min=1.0)


def make_train_step(label_style: str = "graph", pos_weight: float | None = None,
                    grad_clip: float | None = None,
                    sentinel_guard: bool = True,
                    undersample_node_on_loss_factor: float | None = None
                    ) -> Callable:
    """The train step ``(state, batch, metrics, loss_scale=1.0) -> (state,
    metrics, loss, weight_sum)``: forward, masked loss, backward, AdamW
    update, metric counts.

    ``sentinel_guard``: when the loss or any gradient is non-finite the step
    keeps the parameters, the optimizer state and the metrics and reports
    its loss as NaN (one device sync per step decides it). ``loss_scale``
    (exact at 1.0) multiplies the loss, so a NaN scale poisons every
    gradient through the chain rule.

    ``undersample_node_on_loss_factor`` (``label_style="node"`` only):
    reweights the loss by :func:`node_undersample_weights`, drawn from the
    step's generator.
    """
    undersample = (label_style == "node"
                   and undersample_node_on_loss_factor is not None)

    def train_step(state: TrainState, batch: BatchedGraphs,
                   metrics: ConfusionState, loss_scale: float = 1.0):
        # one draw per step, as the JAX package splits its key: the
        # undersampling's keep mask comes from a generator seeded with it
        sub = int(torch.randint(0, 2**62, (1,), generator=state.rng))
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = model(batch)
        labels, weights = extract_labels(batch, label_style)
        if undersample:
            weights = node_undersample_weights(
                torch.Generator().manual_seed(sub), labels, weights,
                undersample_node_on_loss_factor)
        loss = bce_with_logits(logits, labels, weights, pos_weight) * loss_scale
        loss.backward()
        loss = loss.detach()
        new_metrics = update_confusion(metrics, torch.sigmoid(logits.detach()),
                                       labels, weights > 0)
        params = [p for p in model.parameters() if p.grad is not None]
        good = True
        if sentinel_guard:
            finite = [torch.isfinite(loss)] + [torch.isfinite(p.grad).all()
                                               for p in params]
            good = bool(torch.stack(finite).all())
        if good:
            if grad_clip:
                torch.nn.utils.clip_grad_norm_(params, grad_clip)
            state.optimizer.step()
        else:
            new_metrics = metrics
            loss = torch.full_like(loss, float("nan"))
        state.step += 1
        return state, new_metrics, loss, weights.sum()

    return train_step


def make_eval_step(label_style: str = "graph",
                   pos_weight: float | None = None) -> Callable:
    """The eval step ``(model, batch, metrics) -> (metrics, loss, probs,
    labels, weights)``, without gradients."""

    @torch.no_grad()
    def eval_step(model: nn.Module, batch: BatchedGraphs,
                  metrics: ConfusionState):
        model.eval()
        logits = model(batch)
        labels, weights = extract_labels(batch, label_style)
        loss = bce_with_logits(logits, labels, weights, pos_weight)
        probs = torch.sigmoid(logits)
        metrics = update_confusion(metrics, probs, labels, weights > 0)
        return metrics, loss, probs, labels, weights

    return eval_step


def _weighted_mean(losses: list, wsums: list) -> float:
    """Per-example mean over the epoch: per-batch means re-weighted by their
    real (masked-in) example counts. Non-finite batch losses (steps the
    guard skipped) are left out."""
    pairs = [
        (float(l), float(w))
        for l, w in zip(losses, wsums)
        if math.isfinite(float(l))
    ]
    total_w = sum(w for _, w in pairs)
    if total_w == 0:
        return 0.0
    return float(sum(l * w for l, w in pairs)) / total_w


@dataclasses.dataclass
class Trainer:
    """Epoch loop over a segment-layout :class:`GGNN`, a fused-layout
    :class:`GGNNFused` or a megabatch-layout :class:`GGNNMegabatch` (all fed
    :class:`BatchedGraphs`), on the device the model's parameters are on.

    There is no segment twin for oversized buckets: on the card the fused
    and whole-model kernels take every bucket shape the batcher emits, or
    raise. After each
    epoch or evaluation (an epoch that raised included), ``step_ms`` holds
    the host milliseconds of each train step run (each ends at the guard's
    device sync), ``train_seconds`` the epoch's wall time and
    ``n_eval_batches`` counts evaluated batches."""

    model: nn.Module
    cfg: ExperimentConfig
    pos_weight: float | None = None
    # the effective learning rate is optim.lr * lr_scale (see rescale_lr)
    lr_scale: float = 1.0

    def __post_init__(self):
        self.device = next(self.model.parameters()).device
        self.optimizer: torch.optim.Optimizer | None = None
        self.step_ms: list[float] = []
        self.train_seconds = 0.0
        self.n_eval_batches = 0
        o = self.cfg.optim
        pos_weight = self.pos_weight if o.use_weighted_loss else None
        label_style = self.cfg.model.label_style
        self.train_step = make_train_step(
            label_style, pos_weight=pos_weight, grad_clip=o.grad_clip,
            sentinel_guard=self.cfg.resilience.sentinel,
            undersample_node_on_loss_factor=o.undersample_node_on_loss_factor)
        self.eval_step = make_eval_step(label_style, pos_weight=pos_weight)

    @property
    def lr(self) -> float:
        return self.cfg.optim.lr * self.lr_scale

    def rescale_lr(self, factor: float) -> float:
        """Scale the learning rate by ``factor``; AdamW's state does not
        depend on the rate, so a restored optimizer state stays valid.
        Returns the new cumulative scale."""
        self.lr_scale *= float(factor)
        if self.optimizer is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr
        return self.lr_scale

    def steps_for(self, batch) -> tuple[Callable, Callable]:
        """(train_step, eval_step) for this batch: every ported layout
        takes segment-shaped :class:`BatchedGraphs`, every bucket on one
        route."""
        if not isinstance(batch, BatchedGraphs):
            raise TypeError(f"expected BatchedGraphs, got {type(batch).__name__}"
                            " (the dense layout is ROADMAP A10)")
        return self.train_step, self.eval_step

    def init_state(self) -> TrainState:
        """A fresh optimizer over the model's parameters (which
        ``make_model`` initialised from a seed) and a generator seeded with
        ``cfg.seed``."""
        o = self.cfg.optim
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=o.weight_decay)
        rng = torch.Generator().manual_seed(int(self.cfg.seed))
        return TrainState(self.model, self.optimizer, rng, 0)

    def _stream(self, batches: Iterable[BatchedGraphs]):
        return prefetch_to_device(batches, self.device,
                                  size=self.cfg.data.prefetch)

    def _watched(self, step: Callable) -> Callable:
        """``step`` run on a watchdog's worker thread: CUDA's current device
        is per thread, so the worker enters the model's device first."""
        if self.device.type != "cuda":
            return step

        def run(*args):
            with torch.cuda.device(self.device):
                return step(*args)

        return run

    def train_epoch(self, state: TrainState, batches: Iterable[BatchedGraphs],
                    sentinel=None, preemption=None, skip_steps: int = 0,
                    watchdog=None, telemetry=None
                    ) -> tuple[TrainState, dict[str, float], float]:
        """One pass over ``batches``: ``(state, train metrics, mean loss)``.

        ``sentinel``: a :class:`~deepdfa_tpu_torch.resilience.sentinel.
        DivergenceSentinel` observing every step's loss; it raises
        ``DivergenceError`` after ``patience`` consecutive skipped
        (non-finite) steps. The ``step.nan_grads`` fault point poisons a
        step through its ``loss_scale``.

        ``preemption``: a :class:`~deepdfa_tpu_torch.resilience.preemption.
        PreemptionHandler` whose flag is read at every step boundary; once
        set (a real SIGTERM/SIGUSR1, or the ``preempt.sigterm`` fault) the
        loop raises :class:`Preempted` with the state and the batches
        consumed this epoch.

        ``skip_steps``: pass over the first N batches of the deterministic
        stream without running them (the mid-epoch resume after a
        preemption); they are dropped before the prefetcher, so none is
        copied to the card.

        ``watchdog``: a :class:`~deepdfa_tpu_torch.resilience.watchdog.
        HangWatchdog`; every step, its host sync (the guard's) included,
        runs under its deadline, and the ``step.hang`` fault parks a
        cancel-aware wedge there (armed without a watchdog it does nothing).

        ``telemetry``: a :class:`~deepdfa_tpu_torch.obs.telemetry.
        TrainTelemetry`. It only reads clocks: batches, generator and step
        order are untouched, so a telemetered epoch is bitwise a bare one.
        """
        metrics = ConfusionState.zeros(self.device)
        losses, wsums = [], []
        self.step_ms = []
        nan_armed = faults.active("step.nan_grads")
        pre_armed = preemption is not None and faults.active("preempt.sigterm")
        hang_armed = watchdog is not None and faults.active("step.hang")
        t_epoch = time.perf_counter()
        source = iter(batches)
        consumed = sum(1 for _ in itertools.islice(source, max(skip_steps, 0)))
        stream = self._stream(source)
        tracer = telemetry.tracer if telemetry is not None else None
        epoch_cm = (tracer.span("train.epoch", root=True)
                    if tracer is not None else nullcontext())
        try:
            with epoch_cm as epoch_sp:
                parent = None if epoch_sp is None else epoch_sp.ctx
                while True:
                    t_wait = time.time()
                    try:
                        batch = next(stream)
                    except StopIteration:
                        break
                    wait_end = time.time()
                    if pre_armed and faults.fire("preempt.sigterm"):
                        if telemetry is not None:
                            telemetry.record_event(
                                "fault.fired", point="preempt.sigterm",
                                step=consumed)
                        preemption.trigger("injected fault preempt.sigterm")
                    if preemption is not None and preemption.triggered:
                        raise Preempted(state, consumed,
                                        preemption.reason or "preempted")
                    step, _ = self.steps_for(batch)
                    if hang_armed and faults.fire("step.hang"):
                        # a simulated wedged step: parks until the deadline
                        # cancels it, then WatchdogTimeout
                        if telemetry is not None:
                            telemetry.record_event(
                                "fault.fired", point="step.hang",
                                step=consumed)
                        watchdog.call("train_step", lambda cancel: cancel.wait(),
                                      cancel_aware=True)
                    nan_fired = nan_armed and faults.fire("step.nan_grads")
                    if nan_fired and telemetry is not None:
                        telemetry.record_event(
                            "fault.fired", point="step.nan_grads",
                            step=consumed)
                    args = ((state, batch, metrics, float("nan")) if nan_fired
                            else (state, batch, metrics))
                    t_disp, t0 = time.time(), time.perf_counter()
                    if watchdog is not None:
                        state, metrics, loss, wsum = watchdog.call(
                            "train_step", self._watched(step), *args)
                    else:
                        state, metrics, loss, wsum = step(*args)
                    disp_end = time.time()
                    self.step_ms.append((time.perf_counter() - t0) * 1e3)
                    consumed += 1
                    if telemetry is not None:
                        # the bucket's shape fixes every leaf's shape
                        shape_key = (batch.max_graphs, batch.max_nodes,
                                     batch.senders.shape[0])
                        telemetry.observe_step(wait_end - t_wait,
                                               disp_end - t_disp,
                                               shape_key=shape_key)
                        tracer.record("data.wait", t_wait, wait_end,
                                      parent=parent, step=consumed - 1)
                        tracer.record("step.dispatch", t_disp, disp_end,
                                      parent=parent, step=consumed - 1)
                    if sentinel is not None:
                        sentinel.observe(loss)
                    losses.append(loss)
                    wsums.append(wsum)
                if sentinel is not None:
                    sentinel.flush()
                t_sync = time.time()
                out = (state, compute_metrics(metrics, "train_"),
                       _weighted_mean(losses, wsums))
                if tracer is not None:
                    tracer.record("device.sync", t_sync, parent=parent,
                                  n_steps=consumed)
        finally:
            # joins the prefetch thread, also when a step raised
            stream.close()
            self.train_seconds = time.perf_counter() - t_epoch
        return out

    def evaluate(self, model: nn.Module, batches: Iterable[BatchedGraphs],
                 prefix: str = "val_") -> tuple[dict[str, float], float]:
        metrics = ConfusionState.zeros(self.device)
        losses, wsums = [], []
        stream = self._stream(batches)
        try:
            for batch in stream:
                _, estep = self.steps_for(batch)
                metrics, loss, _probs, _labels, weights = estep(model, batch,
                                                                metrics)
                losses.append(loss)
                wsums.append(weights.sum())
                self.n_eval_batches += 1
        finally:
            stream.close()
        mean_loss = _weighted_mean(losses, wsums)
        out = compute_metrics(metrics, prefix)
        out[f"{prefix}loss"] = mean_loss
        return out, mean_loss
