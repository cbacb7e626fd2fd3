"""Data-parallel training over the ``dp`` axis of a mesh.

The port of ``deepdfa_tpu/parallel/dp.py``. Each ``dp`` slot owns one
fixed-shape batch (segment, fused or dense layout: whatever the model
takes), runs the local forward and backward in sum form, and one
all-reduce over the mesh's process group (NCCL on the card, gloo on the
CPU) adds the gradients, the loss sum, the weight sum and the confusion
counts; the step then divides by the global weight sum and takes the
optimizer step, so every rank applies the same update to its replica. A
process holds the slots of its rank (:attr:`Mesh.local_slots`) on its one
device; a mesh without a group holds every slot in this process.

The host stacks ``dp`` same-bucket batches on a leading axis
(:func:`stack_batches`); each process reads its own slots out of the
global stack. Graph node indices are local to each slot's batch, so the
only collective is the one all-reduce.

``accum > 1`` accumulates micro batches (``[dp, accum, ...]`` stacks from
:func:`~deepdfa_tpu_torch.parallel.elastic.stack_elastic`): a ``dp=N/k,
accum=k`` step consumes the same global batch as ``dp=N``. The node
undersampling of micro batch ``i`` of slot ``j`` draws from a
``torch.Generator`` seeded with the step's draw and the stream index
``j·accum + i``; like the single-device step it repeats the JAX package's
keep rate, not its draws.
"""

from __future__ import annotations

import hashlib
from typing import Callable

import numpy as np
import torch
from torch import nn

from deepdfa_tpu_torch.data.graphs import to_device
from deepdfa_tpu_torch.parallel import comm
from deepdfa_tpu_torch.train.loop import (TrainState, bce_sums,
                                          extract_labels,
                                          node_undersample_weights)
from deepdfa_tpu_torch.train.metrics import ConfusionState, update_confusion

__all__ = ["dp_init_state", "make_dp_eval_step", "make_dp_train_step",
           "stack_batches", "take_slot"]


def _stack(batches: list):
    return type(batches[0])(*(
        {k: np.stack([b[i][k] for b in batches], axis=0) for k in field}
        if isinstance(field, dict)
        else np.stack([b[i] for b in batches], axis=0)
        for i, field in enumerate(batches[0])))


def stack_batches(batches: list):
    """Stack ``dp`` same-shape batches along a new leading axis. Either
    layout (:class:`~deepdfa_tpu_torch.data.graphs.BatchedGraphs` or
    :class:`~deepdfa_tpu_torch.data.dense.DenseBatch`); the ``node_mask``
    shape identifies the bucket, and mixed buckets raise."""
    shapes = {tuple(np.shape(b.node_mask)) for b in batches}
    if len(shapes) != 1:
        raise ValueError(
            f"all stacked batches must share one bucket shape, got {shapes}")
    return _stack(batches)


def take_slot(stacked, j: int, i: int | None = None):
    """Slot ``j`` (micro batch ``i``) of a stacked batch."""
    def take(a):
        return a[j] if i is None else a[j][i]

    return type(stacked)(*(
        {k: take(v) for k, v in field.items()} if isinstance(field, dict)
        else take(field) for field in stacked))


def _fold_in(seed: int, index: int) -> int:
    """A generator seed for stream ``index`` of a step drawn as ``seed``."""
    digest = hashlib.blake2b(f"{seed}:{index}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 2


def _local_device(model: nn.Module, mesh) -> torch.device:
    if mesh.shards_llm:
        raise ValueError(f"the GGNN's data parallelism runs over dp alone; "
                         f"mesh {mesh.shape} also has axes that shard the "
                         f"LLM (fsdp, tp, sp)")
    dev = next(model.parameters()).device
    for j in mesh.local_slots:
        slot = mesh.devices[j]
        if slot.type != dev.type or (slot.index or 0) != (dev.index or 0):
            raise ValueError(
                f"slot {j} is on {slot} but the model is on {dev}: a process "
                "trains on one device (one rank per card)")
    return dev


def dp_init_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                  mesh=None, seed: int = 0) -> TrainState:
    """The replicated train state: the model's parameters (broadcast from
    rank 0 of the mesh's group, so every replica starts equal), the
    optimizer and a generator seeded with ``seed``."""
    if mesh is not None and mesh.group is not None and mesh.world > 1:
        import torch.distributed as dist

        src = dist.get_global_rank(mesh.group, 0)
        with torch.no_grad():
            for p in model.parameters():
                if p.is_cuda and dist.get_backend(mesh.group) == "gloo":
                    host = p.detach().cpu()
                    dist.broadcast(host, src, group=mesh.group)
                    p.copy_(host)
                else:
                    dist.broadcast(p.data, src, group=mesh.group)
    return TrainState(model, optimizer,
                      torch.Generator().manual_seed(int(seed)), 0)


def make_dp_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                       mesh, label_style: str = "graph",
                       pos_weight: float | None = None,
                       undersample_node_on_loss_factor: float | None = None,
                       accum: int = 1, grad_clip: float | None = None
                       ) -> Callable:
    """The data-parallel train step ``(state, stacked_batch, metrics) ->
    (state, metrics, loss, weight_sum)``. ``stacked_batch`` has a leading
    ``dp`` axis (and an ``accum`` axis after it when ``accum > 1``); this
    process runs its own slots. The loss and the weight sum are the global
    ones. ``grad_clip`` clips the global gradient's norm before the
    update."""
    if accum < 1:
        raise ValueError("accum must be >= 1")
    dev = _local_device(model, mesh)
    params = [p for p in model.parameters() if p.requires_grad]
    undersample = (label_style == "node"
                   and undersample_node_on_loss_factor is not None)

    def step(state: TrainState, stacked, metrics: ConfusionState):
        sub = int(torch.randint(0, 2**62, (1,), generator=state.rng))
        model.train()
        optimizer.zero_grad(set_to_none=True)
        lsum = torch.zeros((), device=dev)
        wsum = torch.zeros((), device=dev)
        local = ConfusionState.zeros(dev)
        for j in mesh.local_slots:
            for i in range(accum):
                mb = to_device(take_slot(stacked, j, i if accum > 1 else None),
                               dev)
                logits = model(mb)
                labels, weights = extract_labels(mb, label_style)
                if undersample:
                    weights = node_undersample_weights(
                        torch.Generator().manual_seed(
                            _fold_in(sub, j * accum + i)),
                        labels, weights, undersample_node_on_loss_factor)
                ls, ws = bce_sums(logits, labels, weights, pos_weight)
                ls.backward()
                lsum = lsum + ls.detach()
                wsum = wsum + ws.detach()
                local = update_confusion(local, torch.sigmoid(logits.detach()),
                                         labels, weights > 0)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        buf = torch.cat([g.reshape(-1) for g in grads]
                        + [lsum.reshape(1), wsum.reshape(1)]
                        + [c.reshape(1) for c in local])
        buf = comm.all_reduce(buf, mesh.group)
        n = sum(g.numel() for g in grads)
        g_lsum, g_wsum = buf[n], buf[n + 1]
        denom = torch.clamp(g_wsum, min=1.0)
        off = 0
        for p, g in zip(params, grads):
            p.grad = buf[off: off + g.numel()].view_as(p) / denom
            off += g.numel()
        if grad_clip:
            torch.nn.utils.clip_grad_norm_(params, grad_clip)
        optimizer.step()
        delta = buf[n + 2:]
        metrics = ConfusionState(*(m + d for m, d in zip(metrics, delta)))
        state.step += 1
        return state, metrics, g_lsum / denom, g_wsum

    return step


def make_dp_eval_step(model: nn.Module, mesh, label_style: str = "graph",
                      pos_weight: float | None = None) -> Callable:
    """The data-parallel eval step ``(model, stacked_batch, metrics) ->
    (metrics, loss, weight_sum)`` with the global loss, weight sum and
    confusion counts (one all-reduce)."""
    dev = _local_device(model, mesh)

    @torch.no_grad()
    def step(net: nn.Module, stacked, metrics: ConfusionState):
        net.eval()
        lsum = torch.zeros((), device=dev)
        wsum = torch.zeros((), device=dev)
        local = ConfusionState.zeros(dev)
        for j in mesh.local_slots:
            mb = to_device(take_slot(stacked, j), dev)
            logits = net(mb)
            labels, weights = extract_labels(mb, label_style)
            ls, ws = bce_sums(logits, labels, weights, pos_weight)
            lsum, wsum = lsum + ls, wsum + ws
            local = update_confusion(local, torch.sigmoid(logits), labels,
                                     weights > 0)
        buf = comm.all_reduce(torch.stack([lsum, wsum, *local]),
                              mesh.group)
        metrics = ConfusionState(*(m + d for m, d in zip(metrics, buf[2:])))
        return metrics, buf[0] / torch.clamp(buf[1], min=1.0), buf[1]

    return step
