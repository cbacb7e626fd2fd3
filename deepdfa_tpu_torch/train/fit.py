"""``fit``: train the GGNN with per-epoch undersample re-draws, per-epoch
validation, checkpoints and a resumable run record.

The port of ``deepdfa_tpu/train/cli.py``'s ``fit``, its corpus loading and
its batching helpers. Per epoch: re-draw the training subset
(``data/sampler.py``), train through :class:`~.loop.Trainer` on the
segment-layout batches of a corpus-derived bucket ladder (graphs too large
for it go through one overflow bucket, nothing is dropped), validate,
commit a checkpoint (``train/checkpoint.py``), write the run journal and
append the validation F1 to ``tuning.jsonl``. After the last epoch the best
checkpoint is restored and re-validated into ``final_metrics.json``.
``resume=True`` restarts after the last committed epoch, bit-identical to an
uninterrupted run where the device is deterministic.

The port trains on the synthetic corpus only. Telemetry, TensorBoard,
preemption and emergency checkpoints, the watchdog, the elastic mesh block,
divergence rollback, node and dataflow labels and the dense layout are not
ported yet (ROADMAP A4, A3, A10, A11); a config that asks for one raises
``NotImplementedError``. All three ported layouts (segment, fused,
megabatch) train on the same segment batches and buckets; on the card the
megabatch layout's kernel takes every bucket, with no segment twin.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Sequence

import numpy as np

from deepdfa_tpu_torch import resolve_device
from deepdfa_tpu_torch.config import ExperimentConfig
from deepdfa_tpu_torch.data.graphs import (BucketSpec, Graph, GraphBatcher,
                                           _round_up, derive_buckets)
from deepdfa_tpu_torch.data.sampler import epoch_indices, positive_weight
from deepdfa_tpu_torch.models import make_model
from deepdfa_tpu_torch.resilience.journal import RunJournal, atomic_write_text
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
from deepdfa_tpu_torch.train.loop import TrainState, Trainer

logger = logging.getLogger("deepdfa_tpu_torch")

__all__ = ["fit", "load_corpus"]


def _synthetic_corpus(cfg: ExperimentConfig) -> dict[str, list[Graph]]:
    from deepdfa_tpu_torch.data.synthetic import random_dataset

    n = 600 if not cfg.data.sample else 200
    graphs = random_dataset(n, seed=cfg.data.seed, input_dim=cfg.input_dim)
    rng = np.random.default_rng(cfg.data.seed)
    assign = rng.permutation(n)
    n_val, n_test = int(n * 0.1), int(n * 0.2)
    val_ids = set(assign[:n_val].tolist())
    test_ids = set(assign[n_val:n_test].tolist())
    out: dict[str, list[Graph]] = {"train": [], "val": [], "test": []}
    for g in graphs:
        part = "val" if g.gid in val_ids else "test" if g.gid in test_ids else "train"
        out[part].append(g)
    return out


def load_corpus(cfg: ExperimentConfig) -> dict[str, list[Graph]]:
    """{split: [Graph]}: the deterministic synthetic corpus (the JAX
    package's fallback when no materialised shards exist)."""
    logger.warning(
        "the port reads no materialised shards yet (ROADMAP A4): training "
        "on the synthetic corpus (seed %d)", cfg.data.seed)
    return _synthetic_corpus(cfg)


def _batcher(cfg: ExperimentConfig, graphs: list[Graph] | None = None):
    """Fixed-shape batcher for every ported layout (the fused and megabatch
    layouts consume segment batches). With ``auto_buckets`` and a corpus to
    measure, budgets come from corpus statistics capped by the configured
    ceilings."""
    b = cfg.data.batch
    if b.auto_buckets and graphs:
        buckets = [
            BucketSpec(
                max_graphs=min(s.max_graphs, b.batch_graphs + 1),
                max_nodes=min(s.max_nodes, b.max_nodes),
                max_edges=min(s.max_edges, b.max_edges),
            )
            for s in derive_buckets(graphs, b.batch_graphs)
        ]
        batcher = GraphBatcher(buckets, drop_oversize=False,
                               collect_oversize=b.drop_oversize)
    else:
        batcher = GraphBatcher(
            [BucketSpec(b.batch_graphs + 1, b.max_nodes, b.max_edges)],
            drop_oversize=False,
            collect_oversize=b.drop_oversize,
        )
    return _with_overflow_bucket(batcher, graphs)


def _overflow_bucket_for(graphs: Sequence[Graph]) -> BucketSpec:
    """One rescue graph per overflow batch, sized to the largest oversize
    graph."""
    mn = _round_up(max(g.n_nodes for g in graphs) + 2)
    me = max(_round_up(max(g.n_edges for g in graphs)), 128)
    return BucketSpec(max_graphs=2, max_nodes=mn, max_edges=me)


def _with_overflow_bucket(batcher: GraphBatcher, graphs):
    """Pre-size the overflow bucket from the whole corpus, so its shape is
    fixed across epochs and splits."""
    if graphs:
        over = _oversize_upfront(batcher, graphs)
        if over:
            batcher.overflow_bucket = _overflow_bucket_for(over)
    return batcher


def _oversize_upfront(batcher: GraphBatcher, graphs: list[Graph]) -> list[Graph]:
    """The graphs the batcher would route to its oversize list."""
    return [g for g in graphs if not batcher.big.fits(1, g.n_nodes, g.n_edges)]


def _overflow_batches(batcher: GraphBatcher, leftover: list[Graph]):
    if not leftover:
        return
    bucket = batcher.overflow_bucket
    if bucket is None or not all(
        bucket.fits(1, g.n_nodes, g.n_edges) for g in leftover
    ):
        bucket = _overflow_bucket_for(leftover)
    seg = GraphBatcher([bucket], drop_oversize=False)
    yield from seg.batches(leftover)


def _batch_stream(batcher: GraphBatcher, graphs: list[Graph],
                  shuffle_seed: int | None = None):
    """All batches for one pass: the bucket ladder's batches plus the
    oversize graphs through the overflow bucket, so every graph is seen.
    Eval passes stream the overflow last; training passes (``shuffle_seed``)
    interleave the overflow batches at seeded-random points of the stream,
    so the largest graphs are not always trained last."""
    if shuffle_seed is None:
        yield from batcher.batches(graphs)
        yield from _overflow_batches(batcher, list(batcher.oversize_graphs))
        return

    over = _oversize_upfront(batcher, graphs)
    if not over:
        yield from batcher.batches(graphs)
        return
    over_gids = {g.gid for g in over}
    keep = [g for g in graphs if g.gid not in over_gids]
    overflow = list(_overflow_batches(batcher, over))
    rng = np.random.default_rng(shuffle_seed)
    thresholds = np.sort(rng.random(len(overflow)))
    oi = 0
    consumed = 0
    for b in batcher.batches(keep):
        frac = consumed / max(len(keep), 1)
        while oi < len(overflow) and thresholds[oi] <= frac:
            yield overflow[oi]
            oi += 1
        yield b
        consumed += int(np.asarray(b.graph_mask).sum())
    while oi < len(overflow):
        yield overflow[oi]
        oi += 1
    # keep the routing counters honest for _oversize_stats
    batcher.oversize_graphs = list(over)


def _oversize_stats(batcher: GraphBatcher, suffix: str = "") -> dict[str, int]:
    """Routing counters of the last pass (``n_dropped`` stays 0 in trainer
    configurations)."""
    return {
        f"n_dropped{suffix}": int(batcher.n_dropped),
        f"n_oversize_fallback{suffix}": len(batcher.oversize_graphs),
    }


def _epoch_graphs(train: list[Graph], labels: np.ndarray,
                  cfg: ExperimentConfig, epoch: int) -> list[Graph]:
    idx = epoch_indices(
        labels,
        undersample=cfg.data.undersample,
        oversample=cfg.data.oversample,
        seed=cfg.data.seed,
        epoch=epoch,
    )
    return [train[i] for i in idx]


def _aux(state: TrainState) -> dict:
    """The trainer state beyond the parameters: what a bit-identical resume
    needs."""
    return {"optimizer": state.optimizer.state_dict(),
            "rng": state.rng.get_state(), "step": state.step}


def fit(cfg: ExperimentConfig, run_dir, resume: bool = False,
        device=None) -> dict[str, float]:
    """Train ``cfg`` into ``run_dir`` on ``device`` (``cuda`` unless the
    caller names another) and return the best checkpoint's validation
    metrics with the routing counters (also in ``final_metrics.json``).

    ``run_dir`` receives ``checkpoints/``, ``journal.json`` (after every
    epoch; its ``timing`` block holds this process's train steps, their
    host milliseconds, the epochs' train seconds and the evaluated batches),
    ``tuning.jsonl`` and ``final_metrics.json``. ``resume=True`` restores
    the newest restorable checkpoint and continues after its epoch; without
    a journal and a checkpoint it starts fresh."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    dev = resolve_device(device)
    corpus = load_corpus(cfg)
    train, val = corpus["train"], corpus["val"]
    train_labels = np.array([int(g.node_feats["_VULN"].max()) for g in train])
    pos_weight = positive_weight(train_labels)
    logger.info("corpus: train=%d val=%d test=%d pos_weight=%.2f",
                len(train), len(val), len(corpus["test"]), pos_weight)

    model = make_model(cfg.model, cfg.input_dim, device=dev, seed=cfg.seed)
    trainer = Trainer(model, cfg, pos_weight=pos_weight)
    batcher = _batcher(cfg, train + val)
    state = trainer.init_state()
    ckpts = CheckpointManager(run_dir / "checkpoints", cfg.checkpoint)
    journal = RunJournal(run_dir / "journal.json")
    tuning_file = run_dir / "tuning.jsonl"

    start_epoch = 0
    if resume:
        rec = journal.read()
        if rec is None or ckpts.latest_step() is None:
            logger.warning("resume: no journal/checkpoint under %s — starting "
                           "fresh", run_dir)
        else:
            # the checkpoint's recorded epoch (its commit is atomic) decides
            # where training restarts
            step, meta, params, aux = ckpts.restore_resume(map_location=dev)
            model.load_state_dict(params)
            state.optimizer.load_state_dict(aux["optimizer"])
            # a generator's state is a CPU byte tensor wherever it was loaded
            state.rng.set_state(aux["rng"].cpu())
            state.step = int(aux["step"])
            start_epoch = int(meta.get("epoch", -1)) + 1
            lr_scale = float(rec.get("lr_scale", 1.0))
            if lr_scale != trainer.lr_scale:
                trainer.rescale_lr(lr_scale / trainer.lr_scale)
            logger.info("resume: restored step %d, epochs %d..%d", step,
                        start_epoch, cfg.optim.max_epochs - 1)

    last_val: dict[str, float] = {}
    route: dict[str, int] = {}
    timing = {"train_steps": 0, "train_seconds": 0.0, "step_ms": [],
              "eval_batches": 0}
    for epoch in range(start_epoch, cfg.optim.max_epochs):
        epoch_gs = _epoch_graphs(train, train_labels, cfg, epoch)
        state, train_m, train_loss = trainer.train_epoch(
            state, _batch_stream(batcher, epoch_gs, shuffle_seed=cfg.seed + epoch))
        timing["train_steps"] += len(trainer.step_ms)
        timing["step_ms"] += trainer.step_ms
        timing["train_seconds"] += trainer.train_seconds
        route = _oversize_stats(batcher, "_train")
        val_m, val_loss = trainer.evaluate(state.model, _batch_stream(batcher, val))
        route |= _oversize_stats(batcher, "_val")
        timing["eval_batches"] = trainer.n_eval_batches
        last_val = val_m
        logger.info(
            "epoch %d: train_loss=%.4f train_F1=%.4f val_loss=%.4f val_F1=%.4f"
            " oversize_fallback=%d/%d (train/val)", epoch, train_loss,
            train_m["train_F1Score"], val_loss, val_m["val_F1Score"],
            route["n_oversize_fallback_train"], route["n_oversize_fallback_val"])
        ckpts.save(state.step, state.model.state_dict(),
                   metrics={"val_loss": val_loss,
                            "val_F1Score": val_m["val_F1Score"]},
                   epoch=epoch, aux=_aux(state))
        journal.write(
            epoch=epoch, global_step=state.step, seed=cfg.seed,
            sampler={"seed": cfg.data.seed, "undersample": cfg.data.undersample,
                     "oversample": cfg.data.oversample, "epoch": epoch},
            best_metric=ckpts.best_metric(), lr_scale=trainer.lr_scale,
            timing=timing)
        with open(tuning_file, "a") as f:
            f.write(json.dumps({"epoch": epoch,
                                "val_F1Score": val_m["val_F1Score"]}) + "\n")

    # post-fit: restore the best checkpoint and re-validate
    best_step = ckpts.best_step()
    if best_step is not None:
        model.load_state_dict(ckpts.restore(best_step, map_location=dev))
        final_m, final_loss = trainer.evaluate(model, _batch_stream(batcher, val))
        timing["eval_batches"] = trainer.n_eval_batches
        logger.info("best ckpt step=%d: val_loss=%.4f val_F1=%.4f", best_step,
                    final_loss, final_m["val_F1Score"])
        last_val = final_m
    with open(tuning_file, "a") as f:
        f.write(json.dumps({"final": True,
                            "val_F1Score": last_val.get("val_F1Score")}) + "\n")
    last_val = dict(last_val) | route
    last_val["lr_scale"] = trainer.lr_scale
    journal.write(epoch=cfg.optim.max_epochs - 1, global_step=state.step,
                  seed=cfg.seed, best_metric=ckpts.best_metric(),
                  lr_scale=trainer.lr_scale, completed=True, timing=timing)
    atomic_write_text(run_dir / "final_metrics.json",
                      json.dumps(last_val, indent=2))
    return last_val
