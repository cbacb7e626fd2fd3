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
``resume=True`` restarts after the last committed epoch, or inside the epoch
an emergency checkpoint recorded, bit-identical to an uninterrupted run where
the device is deterministic.

Resilience, as the JAX package's ``fit``: the divergence sentinel rolls a
diverged run back to its last good checkpoint with a learning-rate backoff
(or re-initialises it before the first); a preemption notice (SIGTERM,
SIGUSR1 or the ``preempt.sigterm`` fault) commits an emergency checkpoint
and exits with rc 75 (:class:`PreemptedExit`); the step watchdog turns a
wedged step into a journaled abort. The training telemetry (spans into
``<run>/traces/``, the flight recorder, SIGUSR2, the optional
``serve.obs.train_port`` endpoint) and TensorBoard scalars (when
``torch.utils.tensorboard`` imports) report the run.

Data: the materialised shards and ``splits.json`` under
``processed_dir()/{dsname}/shards[_sample]`` (written by
``python -m deepdfa_tpu_torch.preprocess`` or the JAX package's
``scripts/preprocess.py``), re-partitioned at load time by a named split
when ``data.split`` names one; without shards, a deterministic synthetic
corpus (with a warning). Every ``label_style`` trains: graph labels, node
labels and the dataflow solutions (shards built with the solver-label
flag). The segment, fused and megabatch layouts train on the same segment
batches and buckets (on the card the fused and megabatch kernels take
every bucket, with no segment twin). The dense layout trains on
:class:`~deepdfa_tpu_torch.data.dense.DenseBatcher` batches at
corpus-derived per-graph budgets, capped at ``max_nodes / batch_graphs``;
the graphs over the cap go through the overflow bucket as segment batches,
which the trainer's segment twin (the same parameters) scores.

Every checkpoint's ``meta.json`` and the journal carry the
:func:`~deepdfa_tpu_torch.parallel.elastic.mesh_block` of the run; a
resume across a changed topology goes through
:func:`~deepdfa_tpu_torch.parallel.elastic.elastic_restore` and reports
``resharded`` in ``final_metrics.json``.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Sequence

import numpy as np

from deepdfa_tpu_torch import resolve_device, utils
from deepdfa_tpu_torch.config import ExperimentConfig
from deepdfa_tpu_torch.data.graphs import (BucketSpec, Graph, GraphBatcher,
                                           _round_up, derive_buckets,
                                           load_shards)
from deepdfa_tpu_torch.data.sampler import epoch_indices, positive_weight
from deepdfa_tpu_torch.models import make_model
from deepdfa_tpu_torch.models.ggnn import init_params
from deepdfa_tpu_torch.parallel.elastic import elastic_restore, mesh_block
from deepdfa_tpu_torch.resilience.journal import RunJournal, atomic_write_text
from deepdfa_tpu_torch.resilience.preemption import (Preempted, PreemptedExit,
                                                     PreemptionHandler)
from deepdfa_tpu_torch.resilience.sentinel import (DivergenceError,
                                                   DivergenceSentinel)
from deepdfa_tpu_torch.resilience.watchdog import HangWatchdog, WatchdogTimeout
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


def _named_split_corpus(graphs: list[Graph], split: str) -> dict[str, list[Graph]]:
    """The shards re-partitioned by a named split file (the reference's
    cross-project folds): the shards and their vocabulary stay as
    preprocessed, only the partition changes."""
    from deepdfa_tpu_torch.data import ingest

    smap = ingest.named_splits(split)
    by_gid = {g.gid: g for g in graphs}
    id_splits, missing = ingest.partition_ids(sorted(by_gid), smap)
    if sum(len(v) for v in id_splits.values()) == 0:
        raise ValueError(
            f"named split {split!r} matched NONE of the {len(by_gid)} shard "
            "graph ids — wrong split file for this corpus?")
    if missing:
        logger.warning("%d graphs not in named split %r dropped", missing,
                       split)
    return {part: [by_gid[i] for i in ids_] for part, ids_ in id_splits.items()}


def load_corpus(cfg: ExperimentConfig) -> dict[str, list[Graph]]:
    """{split: [Graph]} from the materialised shards of ``cfg.data.dsname``,
    or the deterministic synthetic corpus when there are none."""
    sample_text = "_sample" if cfg.data.sample else ""
    shard_dir = utils.processed_dir() / cfg.data.dsname / f"shards{sample_text}"
    splits_file = shard_dir / "splits.json"
    if not splits_file.exists():
        logger.warning("no materialised shards at %s — using the synthetic "
                       "corpus (seed %d)", shard_dir, cfg.data.seed)
        return _synthetic_corpus(cfg)
    graphs = load_shards(shard_dir)
    if cfg.data.split not in ("fixed", "random"):
        return _named_split_corpus(graphs, cfg.data.split)
    splits = {k: set(v) for k, v in json.loads(splits_file.read_text()).items()}
    # split-leakage guard: train/val/test id sets must be pairwise disjoint
    for a in ("train", "val", "test"):
        for b in ("train", "val", "test"):
            if a < b and splits.get(a, set()) & splits.get(b, set()):
                overlap = sorted(splits[a] & splits[b])[:5]
                raise ValueError(
                    f"split leakage: {a}∩{b} non-empty (e.g. {overlap}) in "
                    f"{splits_file}")
    out: dict[str, list[Graph]] = {"train": [], "val": [], "test": []}
    missing = 0
    for g in graphs:
        for part in out:
            if g.gid in splits.get(part, ()):
                out[part].append(g)
                break
        else:
            missing += 1
    if missing:
        logger.warning("%d graphs without split assignment dropped", missing)
    return out


def _batcher(cfg: ExperimentConfig, graphs: list[Graph] | None = None):
    """Fixed-shape batcher for the configured layout (the fused and
    megabatch layouts consume segment batches). With ``auto_buckets`` and a
    corpus to measure, budgets come from corpus statistics capped by the
    configured ceilings."""
    b = cfg.data.batch
    if cfg.model.layout == "dense":
        from deepdfa_tpu_torch.data.dense import (DenseBatcher,
                                                  derive_dense_sizes)

        # the per-graph ceiling from the TOTAL node budget: a batch never
        # holds more than max_nodes slots, whatever the corpus's tail
        cap = max(b.max_nodes // max(b.batch_graphs, 1), 8)
        if b.auto_buckets and graphs:
            # as many shapes as full batches are expected (at most 6): the
            # occupancy of the optimal split assumes batches fill
            k = int(np.clip(round(len(graphs) / max(b.batch_graphs, 1)),
                            1, 6))
            sizes = sorted({min(s, cap)
                            for s in derive_dense_sizes(graphs, k=k)})
        else:
            sizes = [cap]
        # oversize graphs are collected for the overflow bucket (never
        # dropped); drop_oversize=False keeps the strict raise
        return _with_overflow_bucket(
            DenseBatcher(max_graphs=b.batch_graphs, nodes_per_graph=sizes,
                         drop_oversize=False,
                         collect_oversize=b.drop_oversize),
            graphs)
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


def _with_overflow_bucket(batcher, graphs):
    """Pre-size the overflow bucket from the whole corpus, so its shape is
    fixed across epochs and splits."""
    if graphs:
        over = _oversize_upfront(batcher, graphs)
        if over:
            batcher.overflow_bucket = _overflow_bucket_for(over)
    return batcher


def _oversize_upfront(batcher, graphs: list[Graph]) -> list[Graph]:
    """The graphs the batcher would route to its oversize list."""
    if hasattr(batcher, "big"):  # segment batches
        return [g for g in graphs
                if not batcher.big.fits(1, g.n_nodes, g.n_edges)]
    return [g for g in graphs if g.n_nodes > batcher.nodes_per_graph]


def _overflow_batches(batcher, leftover: list[Graph]):
    if not leftover:
        return
    bucket = batcher.overflow_bucket
    if bucket is None or not all(
        bucket.fits(1, g.n_nodes, g.n_edges) for g in leftover
    ):
        bucket = _overflow_bucket_for(leftover)
    seg = GraphBatcher([bucket], drop_oversize=False)
    yield from seg.batches(leftover)


def _batch_stream(batcher, graphs: list[Graph],
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


def _oversize_stats(batcher, suffix: str = "") -> dict[str, int]:
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


def _tb_writer(run_dir: Path):
    """TensorBoard scalars (the reference's ``MyTensorBoardLogger``,
    ``my_tb.py:5-8``); optional: the jsonl/json files are the primary
    record."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=str(run_dir / "tb"))


def _telemetry(cfg: ExperimentConfig, run_dir: Path):
    """``(TrainTelemetry, its server or None, the previous SIGUSR2
    handler)`` for ``serve.obs.trace``, else ``(None, None, None)``: step
    spans journaled into ``<run>/traces/``, the flight recorder dumping
    into the run dir (on SIGUSR2 too), the trainer's SLOs and the optional
    ``/metrics``, ``/healthz``, ``/slo`` endpoint."""
    obs = cfg.serve.obs
    if not obs.trace:
        return None, None, None
    from deepdfa_tpu_torch.obs import (FlightRecorder, SLOEngine,
                                       TelemetryServer, Tracer, TrainTelemetry,
                                       install_sigusr2, train_specs)

    flight = FlightRecorder(
        capacity=obs.flight_events, proc="train",
        dump_dir=Path(obs.flight_dir) if obs.flight_dir else run_dir)
    slo = SLOEngine(
        train_specs(step_ms=obs.slo_step_ms, mfu_floor=obs.slo_mfu_floor),
        fast_window_s=obs.slo_fast_window_s,
        slow_window_s=obs.slo_slow_window_s,
        burn_threshold=obs.slo_burn_threshold, flight=flight)
    telemetry = TrainTelemetry(tracer=Tracer(
        proc="train", max_spans=obs.trace_buffer,
        slow_ms=0.0,  # journal every epoch root, capped by max_exemplars
        exemplar_dir=(Path(obs.trace_dir) if obs.trace_dir
                      else run_dir / "traces"),
        max_exemplars=obs.max_exemplars), slo=slo, flight=flight)
    prev_usr2 = install_sigusr2(flight)  # None off the main thread
    server = None
    if obs.train_port >= 0:
        server = TelemetryServer(telemetry, port=obs.train_port).start()
        logger.info("trainer telemetry on :%d (/metrics, /healthz, /slo)",
                    server.port)
    return telemetry, server, prev_usr2


def fit(cfg: ExperimentConfig, run_dir, resume: bool = False,
        device=None) -> dict[str, float]:
    """Train ``cfg`` into ``run_dir`` on ``device`` (``cuda`` unless the
    caller names another) and return the best checkpoint's validation
    metrics with the routing counters, ``n_rollbacks``, ``lr_scale``,
    ``resharded`` and the sentinel's step counts (also in
    ``final_metrics.json``).

    ``run_dir`` receives ``checkpoints/``, ``journal.json`` (after every
    epoch; its ``timing`` block holds this process's train steps, their
    host milliseconds, the epochs' train seconds and the evaluated batches),
    ``tuning.jsonl``, ``final_metrics.json``, ``traces/`` and ``tb/``.
    ``resume=True`` restores the newest restorable checkpoint and continues
    after its epoch, or inside it after an emergency checkpoint; without a
    journal and a checkpoint it starts fresh. A preemption raises
    :class:`PreemptedExit` (rc 75) after the emergency commit; a wedged
    step raises :class:`WatchdogTimeout` after journaling it; a divergence
    past ``max_rollbacks`` raises :class:`DivergenceError`."""
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
    res = cfg.resilience
    sentinel = (DivergenceSentinel(patience=res.sentinel_patience,
                                   lag=res.sentinel_lag)
                if res.sentinel else None)

    # the run's topology, in every meta.json and journal record
    topology = mesh_block(device=dev)

    def restore(reason: str) -> tuple[TrainState, dict]:
        """The newest restorable checkpoint into the model, the optimizer
        and the generator; walks past a corrupt newest step. A checkpoint
        recorded under another topology is gathered to the host and placed
        again (``meta["_resharded"]``): bitwise the saved values."""
        step, meta, params, aux, resharded = elastic_restore(
            ckpts, device=dev, map_location=dev)
        if resharded:
            logger.warning("%s: mesh changed since checkpoint (%s -> %s) — "
                           "host-gathered and re-placed the state", reason,
                           meta.get("mesh"), topology)
        model.load_state_dict(params)
        state.optimizer.load_state_dict(aux["optimizer"])
        # load_state_dict restores each group's saved lr: the current
        # backoff decides it
        for group in state.optimizer.param_groups:
            group["lr"] = trainer.lr
        # a generator's state is a CPU byte tensor wherever it was loaded
        state.rng.set_state(aux["rng"].cpu())
        state.step = int(aux["step"])
        logger.info("%s: restored checkpoint step=%d (epoch %s)", reason,
                    step, meta.get("epoch"))
        return state, dict(meta, _resharded=resharded)

    start_epoch = 0
    n_rollbacks = 0
    pre_skip = 0  # mid-epoch resume: batches of start_epoch already run
    resharded = False
    if resume:
        rec = journal.read()
        if rec is None or ckpts.latest_step() is None:
            logger.warning("resume: no journal/checkpoint under %s — starting "
                           "fresh", run_dir)
        else:
            # the run-level extras the journal carries: rollbacks, the LR
            # backoff and the sentinel's counts
            n_rollbacks = int(rec.get("rollbacks", 0))
            lr_scale = float(rec.get("lr_scale", 1.0))
            if lr_scale != trainer.lr_scale:
                trainer.rescale_lr(lr_scale / trainer.lr_scale)
            if sentinel is not None:
                sentinel.n_steps = int(rec.get("sentinel_steps", 0))
                sentinel.n_bad = int(rec.get("sentinel_bad_steps", 0))
            # the checkpoint's recorded epoch (its commit is atomic) decides
            # where training restarts
            state, meta = restore("resume")
            resharded = bool(meta["_resharded"])
            ckpt_epoch = int(meta.get("epoch", -1))
            pre = meta.get("preempted")
            if pre:
                # an emergency checkpoint: re-enter the same epoch and skip
                # the batches it already ran
                start_epoch = ckpt_epoch
                pre_skip = int(pre.get("steps_done", 0))
                logger.info("resume after preemption (%s): re-entering epoch "
                            "%d at step offset %d", pre.get("reason"),
                            start_epoch, pre_skip)
            else:
                start_epoch = ckpt_epoch + 1
            logger.info("resume: epochs %d..%d (rollbacks=%d lr_scale=%.3g)",
                        start_epoch, cfg.optim.max_epochs - 1, n_rollbacks,
                        trainer.lr_scale)

    def run_record() -> dict:
        return dict(seed=cfg.seed, lr_scale=trainer.lr_scale,
                    rollbacks=n_rollbacks, mesh=topology,
                    **(sentinel.stats() if sentinel is not None else {}))

    tb = _tb_writer(run_dir)
    preemption = PreemptionHandler().install() if res.emergency_ckpt else None
    watchdog = (HangWatchdog(res.step_deadline_s)
                if res.step_deadline_s > 0 else None)
    telemetry, telemetry_server, prev_usr2 = _telemetry(cfg, run_dir)
    last_val: dict[str, float] = {}
    route: dict[str, int] = {}
    timing = {"train_steps": 0, "train_seconds": 0.0, "step_ms": [],
              "eval_batches": 0}
    epoch = start_epoch

    def account() -> None:
        """The last epoch's steps into ``timing``: every step run, those of
        an epoch that raised included."""
        timing["train_steps"] += len(trainer.step_ms)
        timing["step_ms"] += trainer.step_ms
        timing["train_seconds"] += trainer.train_seconds

    try:
        while epoch < cfg.optim.max_epochs:
            epoch_gs = _epoch_graphs(train, train_labels, cfg, epoch)
            # a rollback retry of the re-entered epoch restores the same
            # emergency checkpoint, so the offset stays valid
            skip = pre_skip if epoch == start_epoch else 0
            if telemetry is not None:
                telemetry.observe_epoch(epoch)
            try:
                state, train_m, train_loss = trainer.train_epoch(
                    state, _batch_stream(batcher, epoch_gs,
                                         shuffle_seed=cfg.seed + epoch),
                    sentinel=sentinel, preemption=preemption,
                    skip_steps=skip, watchdog=watchdog, telemetry=telemetry)
            except Preempted as p:
                account()
                # count the lagged losses of the steps already run, so the
                # resumed run's counts continue a straight run's
                while sentinel is not None:
                    try:
                        sentinel.flush()
                        break
                    except DivergenceError:
                        continue
                state = p.state
                elapsed = ckpts.save_emergency(
                    state.step, state.model.state_dict(), epoch=epoch,
                    aux=_aux(state), steps_done=p.steps_done, reason=p.reason,
                    mesh=topology)
                within = elapsed <= res.preempt_deadline_s
                logger.log(
                    logging.INFO if within else logging.ERROR,
                    "emergency checkpoint step=%d committed in %.2fs "
                    "(deadline %.0fs%s) — epoch %d, %d step(s) done, rc=%d",
                    state.step, elapsed, res.preempt_deadline_s,
                    "" if within else " EXCEEDED", epoch, p.steps_done,
                    PreemptedExit().code)
                journal.write(
                    epoch=epoch, global_step=state.step, preempted=p.reason,
                    preempted_steps_done=p.steps_done,
                    emergency_commit_s=elapsed,
                    emergency_deadline_s=res.preempt_deadline_s,
                    timing=timing, **run_record())
                raise PreemptedExit(p.reason) from None
            except WatchdogTimeout as wt:
                account()
                # a wedged step: journal the timeout and abort. The flight
                # recorder dumps its ring first: the last events around the
                # wedge are the post-mortem an aborted process cannot rebuild
                if telemetry is not None:
                    telemetry.record_event(
                        "watchdog.timeout", point=wt.point,
                        deadline_s=wt.deadline_s, epoch=epoch,
                        step=state.step)
                    telemetry.flight.dump("watchdog_timeout")
                journal.write(
                    epoch=epoch, global_step=state.step,
                    watchdog_timeout={"point": wt.point,
                                      "deadline_s": wt.deadline_s},
                    timing=timing, **run_record())
                logger.error("%s — aborting (journaled)", wt)
                raise
            except DivergenceError as err:
                account()
                n_rollbacks += 1
                sentinel.reset()
                if n_rollbacks > res.max_rollbacks:
                    logger.error("divergence persisted past %d rollbacks — "
                                 "aborting", res.max_rollbacks)
                    raise
                trainer.rescale_lr(res.lr_backoff)
                if ckpts.latest_step() is not None:
                    state, _ = restore(f"rollback ({err})")
                else:
                    logger.warning("diverged before the first checkpoint — "
                                   "re-initialising")
                    # the parameters as make_model(seed=cfg.seed) draws
                    # them, a fresh AdamW and a freshly seeded generator
                    init_params(model, cfg.seed)
                    state = trainer.init_state()
                logger.warning("rollback %d/%d: lr_scale=%.3g, retrying "
                               "epoch %d", n_rollbacks, res.max_rollbacks,
                               trainer.lr_scale, epoch)
                if telemetry is not None:
                    telemetry.record_event(
                        "sentinel.rollback", rollback=n_rollbacks,
                        epoch=epoch, lr_scale=trainer.lr_scale)
                continue
            account()
            route = _oversize_stats(batcher, "_train")
            val_m, val_loss = trainer.evaluate(state.model,
                                               _batch_stream(batcher, val))
            route |= _oversize_stats(batcher, "_val")
            timing["eval_batches"] = trainer.n_eval_batches
            last_val = val_m
            logger.info(
                "epoch %d: train_loss=%.4f train_F1=%.4f val_loss=%.4f "
                "val_F1=%.4f oversize_fallback=%d/%d (train/val)", epoch,
                train_loss, train_m["train_F1Score"], val_loss,
                val_m["val_F1Score"], route["n_oversize_fallback_train"],
                route["n_oversize_fallback_val"])
            if tb is not None:
                for k, v in {"train_loss": train_loss, "val_loss": val_loss,
                             **train_m, **val_m}.items():
                    tb.add_scalar(k, v, epoch)
            t_ckpt = time.time()
            ckpts.save(state.step, state.model.state_dict(),
                       metrics={"val_loss": val_loss,
                                "val_F1Score": val_m["val_F1Score"]},
                       epoch=epoch, aux=_aux(state), mesh=topology)
            if telemetry is not None:
                telemetry.tracer.record("ckpt.commit", t_ckpt,
                                        step=state.step, epoch=epoch)
                telemetry.record_event("ckpt.commit", step=state.step,
                                       epoch=epoch)
            journal.write(
                epoch=epoch, global_step=state.step,
                sampler={"seed": cfg.data.seed,
                         "undersample": cfg.data.undersample,
                         "oversample": cfg.data.oversample, "epoch": epoch},
                best_metric=ckpts.best_metric(), resharded=resharded,
                timing=timing,
                **({"telemetry": telemetry.epoch_stats()}
                   if telemetry is not None else {}),
                **run_record())
            with open(tuning_file, "a") as f:
                f.write(json.dumps({"epoch": epoch,
                                    "val_F1Score": val_m["val_F1Score"]})
                        + "\n")
            if preemption is not None and preemption.triggered:
                # the notice landed during validation or the checkpoint:
                # this epoch's checkpoint is committed, so exit resumable
                # without an emergency save
                journal.write(
                    epoch=epoch, global_step=state.step,
                    preempted=preemption.reason, preempted_steps_done=0,
                    emergency_commit_s=0.0,
                    emergency_deadline_s=res.preempt_deadline_s,
                    timing=timing, **run_record())
                logger.info("preemption (%s) at epoch boundary — epoch %d "
                            "checkpoint already committed", preemption.reason,
                            epoch)
                raise PreemptedExit(preemption.reason)
            epoch += 1
    finally:
        if preemption is not None:
            preemption.uninstall()
        if telemetry_server is not None:
            telemetry_server.stop()
        if prev_usr2 is not None:
            import signal

            signal.signal(signal.SIGUSR2, prev_usr2)
        if tb is not None:
            tb.close()

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
    # the last train epoch's and the final val pass's routing counters
    last_val = dict(last_val) | route
    last_val["n_rollbacks"] = n_rollbacks
    last_val["lr_scale"] = trainer.lr_scale
    last_val["resharded"] = int(resharded)
    if sentinel is not None:
        last_val |= sentinel.stats()
    journal.write(epoch=cfg.optim.max_epochs - 1, global_step=state.step,
                  best_metric=ckpts.best_metric(), resharded=resharded,
                  completed=True, timing=timing, **run_record())
    atomic_write_text(run_dir / "final_metrics.json",
                      json.dumps(last_val, indent=2))
    return last_val
