"""The trainer's command line: ``python -m deepdfa_tpu_torch.train.cli``.

The port of ``deepdfa_tpu/train/cli.py``. Commands:

- ``fit``: :func:`~deepdfa_tpu_torch.train.fit.fit` (``--resume``
  continues a run from its newest good checkpoint, inside the epoch an
  emergency checkpoint recorded); a preempted fit exits with rc 75.
- ``test``: restore the best (else the latest) checkpoint and evaluate the
  test split: overall, positive-only and negative-only metrics, the
  classification report, for node-label models the statement ranking's
  ``statement_hit@1..10``, ``pr.csv`` and ``pr_binned.csv`` (pandas'
  ``to_csv`` bytes), the confusion matrix logged, ``test_metrics.json``.
  With ``profile=true`` / ``time=true``, ``profiledata.jsonl`` (FLOPs of
  each batch's step, counted once per step and batch shapes) and
  ``timedata.jsonl`` (its synchronized wall time) and the ``profile_*``
  keys of their aggregate (:mod:`deepdfa_tpu_torch.train.profiling`);
  with ``trace=true``, a ``torch.profiler`` Chrome trace of the test loop
  (host and card) in ``<run-dir>/trace/trace.json``.
- ``analyze``: per-split feature and dataflow-solution coverage, the label
  balance and, from ``hashes.csv.gz``, the feature-variant grid;
  ``coverage.json``.
- ``predict --source <C file or dir>``: ``predict_paths`` with the restored
  checkpoint; ``predictions.json``.
- ``export``: :func:`export_model`, the trained GGNN as a ``torch.export``
  artifact in ``<run-dir>/export`` (:mod:`deepdfa_tpu_torch.serving`).
- ``trace export``: the run's trace exemplars as one Chrome trace-event
  JSON.
- ``serve``: :func:`~deepdfa_tpu_torch.serve.server.serve_command` (the
  HTTP service, from ``--ckpt-dir`` or ``--artifact``);
- ``scan <target> [--source ...]``: :func:`~deepdfa_tpu_torch.scan.
  scan_command` (``--workers``, ``--cache-dir``, ``--cascade``,
  ``--interproc``); both also have entry points of their own (``python -m
  deepdfa_tpu_torch.serve.server``, ``python -m deepdfa_tpu_torch.scan``);
- ``bench [ledger] [--check] [--trend] [--ledger-dir PATH ...]``: the
  perf-regression ledger's verdicts over bench artifacts
  (:func:`deepdfa_tpu_torch.obs.ledger.main`; ``--check`` exits 1 on a
  regression). The port's own bench stages are not written yet (ROADMAP:
  its first benchmark).

Every command runs on ``--device`` (``cuda`` unless another is named).
Config: layered JSON/YAML files (``--config``, later wins) and dotted
``--set key=value`` overrides. Each run logs to ``<run-dir>/run.log``,
renamed ``run.log.error`` when ``fit``, ``test`` or ``analyze`` crashes
(``main_cli.py:322-336``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
from pathlib import Path
from typing import Sequence

import numpy as np

from deepdfa_tpu_torch import resolve_device, utils
from deepdfa_tpu_torch.config import ExperimentConfig
from deepdfa_tpu_torch.data.graphs import Graph
from deepdfa_tpu_torch.resilience.journal import atomic_write_text
from deepdfa_tpu_torch.train.fit import (_batch_stream, _batcher,
                                         _oversize_stats, fit, load_corpus)

__all__ = ["COMMANDS", "COVERAGE_GRID_LIMITS", "analyze", "coverage",
           "export_model", "main", "predict", "test", "trace_export",
           "variant_coverage", "write_curve"]

logger = logging.getLogger("deepdfa_tpu_torch")

COMMANDS = ("fit", "test", "analyze", "predict", "export", "serve", "trace",
            "bench", "scan")

# commands routinely pointed at a fit run dir: they read its config.json as
# the base layer, never overwrite it, and never mark the run as crashed
_READERS = ("predict", "export", "serve", "scan")


def _shard_dir(cfg: ExperimentConfig) -> Path:
    sample = "_sample" if cfg.data.sample else ""
    return utils.processed_dir() / cfg.data.dsname / f"shards{sample}"


def _restore_state(ckpts) -> dict:
    """The best checkpoint's state dict, else the latest: one rule, so
    ``test``, ``predict`` and ``export`` load the same weights."""
    if ckpts.best_step() is not None:
        return ckpts.restore_best(map_location="cpu")
    return ckpts.restore_latest(map_location="cpu")


# ---------------------------------------------------------------------------
# test


def write_curve(path: Path, curve) -> bytes:
    """A (precision, recall, thresholds) curve as the bytes pandas'
    ``DataFrame.to_csv`` writes for it (a leading unnamed index column)."""
    from deepdfa_tpu_torch.data.table import Rows, write_csv

    columns = ("precision", "recall", "thresholds")
    return write_csv(path, Rows(
        [dict(zip(columns, map(float, row))) for row in zip(*curve)],
        list(columns)))


def test(cfg: ExperimentConfig, run_dir: Path, ckpt_dir: Path | None = None,
         device=None) -> dict[str, float]:
    """Evaluate the best (else the latest) checkpoint under ``ckpt_dir``
    (default ``<run-dir>/checkpoints``; none evaluates the fresh init, with
    a warning) on the test split, on ``device``. Writes
    ``test_metrics.json``, ``pr.csv`` and ``pr_binned.csv`` into
    ``run_dir`` and returns the metrics; ``cfg.profile``, ``cfg.time`` and
    ``cfg.trace`` add the profiling files, ``profile_*`` keys and the trace
    (module docstring). The ``test_*`` metrics do not depend on them."""
    from deepdfa_tpu_torch.data.prefetch import prefetch_to_device
    from deepdfa_tpu_torch.models import make_model
    from deepdfa_tpu_torch.train import metrics as M
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
    from deepdfa_tpu_torch.train.loop import Trainer, _weighted_mean

    dev = resolve_device(device)
    test_graphs = load_corpus(cfg)["test"]
    model = make_model(cfg.model, cfg.input_dim, device=dev, seed=cfg.seed)
    trainer = Trainer(model, cfg)
    batcher = _batcher(cfg, test_graphs)
    ckpts = CheckpointManager(ckpt_dir or run_dir / "checkpoints",
                              cfg.checkpoint)
    if ckpts.latest_step() is not None:
        model.load_state_dict(_restore_state(ckpts))
        logger.info("restored checkpoint")
    else:
        logger.warning("no checkpoint found — evaluating fresh init")

    overall = M.ConfusionState.zeros(dev)
    pos = M.ConfusionState.zeros(dev)
    neg = M.ConfusionState.zeros(dev)
    all_probs, all_labels = [], []
    statement_items = []  # node labels: (probs, labels) per function
    losses, wsums = [], []
    n_graphs_scored = 0  # must equal len(test_graphs): no silent truncation
    profiler = None
    # FLOPs are a property of (step, batch shapes): the dense primary step,
    # each dense size and the segment fallback all differ — cached per key,
    # never one step's FLOPs attributed to another's batches
    flops_cache: dict[tuple, float | None] = {}
    if cfg.profile or cfg.time:
        from deepdfa_tpu_torch.train.profiling import StepProfiler

        profiler = StepProfiler(run_dir)
    tracer = _start_trace(dev) if cfg.trace else None
    stream = prefetch_to_device(_batch_stream(batcher, test_graphs), dev,
                                size=cfg.data.prefetch)
    try:
        for batch in stream:
            _, eval_step = trainer.steps_for(batch)
            n_real = int(batch.graph_mask.sum())
            n_graphs_scored += n_real
            if profiler is None:
                overall, loss, probs, labels, weights = eval_step(
                    model, batch, overall)
            else:
                # the first batch of each key is counted as it runs (the
                # counter changes no value, so test_* are the unprofiled
                # run's)
                key = (id(eval_step), _shapes(batch))
                count = cfg.profile and key not in flops_cache
                overall, loss, probs, labels, weights = profiler.step(
                    eval_step, model, batch, overall, batch_size=n_real,
                    flops=flops_cache.get(key), count=count)
                if count:
                    flops_cache[key] = profiler.last_flops
            pos, neg = M.update_confusion_by_class(pos, neg, probs, labels,
                                                   weights > 0)
            losses.append(float(loss))
            wsums.append(float(weights.sum()))
            keep = (weights > 0).cpu().numpy()
            p_np, l_np = probs.cpu().numpy(), labels.cpu().numpy()
            all_probs.append(p_np[keep])
            all_labels.append(l_np[keep])
            if cfg.model.label_style == "node":
                flat = hasattr(batch, "node_gidx")
                if flat:
                    gidx = batch.node_gidx.cpu().numpy()
                for gi in range(n_real):
                    if flat:  # segment layout: flat node rows
                        sel = (gidx == gi) & keep
                        p_g, l_g = p_np[sel], l_np[sel]
                    else:  # dense layout: [G, n] rows, one per graph
                        sel = keep[gi]
                        p_g, l_g = p_np[gi][sel], l_np[gi][sel]
                    if sel.any():
                        statement_items.append((p_g, l_g.astype(int)))
    finally:
        stream.close()
        if tracer is not None:
            _stop_trace(tracer, run_dir / "trace")

    probs = np.concatenate(all_probs)
    labels = np.concatenate(all_labels)
    results = {"test_loss": _weighted_mean(losses, wsums)}
    results |= _oversize_stats(batcher)
    results["n_graphs_scored"] = n_graphs_scored
    if n_graphs_scored != len(test_graphs):
        logger.warning("scored %d of %d test graphs — the batcher truncated "
                       "the corpus", n_graphs_scored, len(test_graphs))
    results |= M.compute_metrics(overall, "test_")
    results |= M.compute_metrics(pos, "test_pos_")
    results |= M.compute_metrics(neg, "test_neg_")
    results |= {f"report_{k}": v for k, v in
                M.classification_report(probs, labels).items()}
    if statement_items:
        topk = M.eval_statements_list(statement_items)
        results |= {f"statement_hit@{k}": v for k, v in topk.items()}
        logger.info("statement top-k hit rates: %s",
                    {k: round(v, 4) for k, v in topk.items()})

    write_curve(run_dir / "pr.csv", M.pr_curve(probs, labels.astype(int)))
    write_curve(run_dir / "pr_binned.csv",
                M.binned_pr_curve(probs, labels.astype(int), bins=100))
    logger.info("confusion matrix:\n%s", M.confusion_matrix(probs, labels))
    logger.info("test metrics: %s", {k: round(v, 4) for k, v in
                                     results.items() if k.startswith("test_")})
    if profiler is not None:
        from deepdfa_tpu_torch.train.profiling import report

        profiler.flush()
        prof = report(run_dir)
        results |= {f"profile_{k}": v for k, v in prof.items()}
        logger.info("profiling: %s", prof)
    atomic_write_text(run_dir / "test_metrics.json",
                      json.dumps(results, indent=2))
    return results


def _shapes(batch) -> tuple:
    """The shape and type of every tensor of a batch, in a fixed order."""
    from torch.utils import _pytree

    return tuple((tuple(t.shape), str(t.dtype))
                 for t in _pytree.tree_leaves(batch))


# tiny kernels run at the start of a trace on the card: in a process some
# minutes old a session can lose its first few dozen kernel records (the
# first records after the start, whatever the pause before them; seen with
# torch 2.11 on an H100), so these take that loss, not the test loop's
TRACE_LEAD_KERNELS = 256


def _start_trace(dev):
    """A ``torch.profiler`` session recording host activity and, on the
    card, the device's (the JAX package's ``jax.profiler.start_trace``),
    led by :data:`TRACE_LEAD_KERNELS` tiny kernels on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    if dev.type == "cuda":
        lead = torch.zeros(1, device=dev)
        for _ in range(TRACE_LEAD_KERNELS):
            lead.add_(1)
        torch.cuda.synchronize(dev)
    return prof


def _stop_trace(prof, out_dir: Path) -> Path:
    """End the session and write its Chrome trace under ``out_dir``."""
    prof.__exit__(None, None, None)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    logger.info("device trace written to %s", path)
    return path


# ---------------------------------------------------------------------------
# analyze

# dbize_absdf.py:21-45's feature-variant grid: limit_all values x single
# subkeys (analyze reports the whole grid in one pass)
COVERAGE_GRID_LIMITS = (1, 10, 100, 500, 1000, 5000, 10000)


def coverage(graphs: list[Graph], feat: str = "_ABS_DATAFLOW") -> dict:
    """Feature and dataflow-solution coverage of one split, the reference's
    per-dataset printout (``get_coverage``, ``main_cli.py:192-313``):
    per-graph def/known/unknown/nodef counts aggregated micro
    (token-weighted) and macro (graph-weighted), the graphs without defs
    and with unknowns, and, when the shards carry the reaching-definition
    solution bits (``_DF_IN``), the solution proportions over all nodes and
    over definition nodes (NaN for def-free graphs, counted)."""
    defs, known, unknown, nodef, nodes = [], [], [], [], []
    vul_nodes = vul_graphs = 0
    skipped_feat = skipped_sol = 0
    prop, prop_nz = [], []
    for g in graphs:
        vul_nodes += int(g.node_feats["_VULN"].sum())
        vul_graphs += int(g.node_feats["_VULN"].max() > 0)
        ids = g.node_feats.get(feat)
        if ids is None:
            skipped_feat += 1
            continue
        nodes.append(ids.size)
        defs.append(int((ids > 0).sum()))
        nodef.append(int((ids == 0).sum()))
        known.append(int((ids > 1).sum()))
        unknown.append(int((ids == 1).sum()))
        sol = g.node_feats.get("_DF_IN")
        if sol is None:
            skipped_sol += 1
        else:
            prop.append(float(np.mean(sol)))
            nz = sol[ids > 0]
            prop_nz.append(float(np.mean(nz)) if nz.size else float("nan"))

    n = np.array(nodes, dtype=float)
    d = np.array(defs, dtype=float)
    k = np.array(known, dtype=float)
    u = np.array(unknown, dtype=float)
    nd = np.array(nodef, dtype=float)
    has_defs = d > 0

    def safe(num, den) -> float:
        return float(num / den) if den else 0.0

    out: dict = {
        "graphs": len(graphs),
        "graphs_with_features": int(len(d)),
        "skipped_feat": skipped_feat,
        "skipped_sol": skipped_sol,
        "nodes": int(n.sum()),
        "avg_num_nodes": float(n.mean()) if n.size else 0.0,
        "graphs_without_defs": int((~has_defs).sum()),
        "graphs_with_unknown": int((u > 0).sum()),
        "avg_num_nodef": float(nd.mean()) if nd.size else 0.0,
        "avg_num_def": float(d.mean()) if d.size else 0.0,
        "avg_num_known": float(k.mean()) if k.size else 0.0,
        "avg_num_unknown": float(u.mean()) if u.size else 0.0,
        "pct_def_nodes_macro": float(np.mean(d / n)) if n.size else 0.0,
        "pct_nodes_known_micro": safe(k.sum(), n.sum()),
        "pct_nodes_unknown_micro": safe(u.sum(), n.sum()),
        "pct_nodes_known_macro": float(np.mean(k / n)) if n.size else 0.0,
        "pct_nodes_unknown_macro": float(np.mean(u / n)) if n.size else 0.0,
        "pct_def_known_micro": safe(k.sum(), d.sum()),
        "pct_def_unknown_micro": safe(u.sum(), d.sum()),
        "pct_def_known_micro_graphs_with_defs": safe(
            k[has_defs].sum(), d[has_defs].sum()),
        "pct_def_unknown_micro_graphs_with_defs": safe(
            u[has_defs].sum(), d[has_defs].sum()),
        "pct_def_known_macro_graphs_with_defs": (
            float(np.mean(k[has_defs] / d[has_defs])) if has_defs.any()
            else 0.0),
        "pct_def_unknown_macro_graphs_with_defs": (
            float(np.mean(u[has_defs] / d[has_defs])) if has_defs.any()
            else 0.0),
        "pct_vul_nodes": safe(vul_nodes, n.sum()),
        "pct_vul_graphs": safe(vul_graphs, len(graphs)),
        # the flat aliases of the JAX package's earlier analyzer
        "pct_def_nodes": safe(d.sum(), n.sum()),
        "pct_known_defs": safe(k.sum(), d.sum()),
        "pct_unknown_defs": safe(u.sum(), d.sum()),
    }
    if prop:
        pz = np.array(prop_nz, dtype=float)
        valid = pz[~np.isnan(pz)]
        out["solution"] = {
            "avg_proportion_dataflow": float(np.mean(prop)),
            "avg_proportion_definitions_dataflow": (
                float(np.mean(valid)) if valid.size else 0.0),
            "num_proportion_definitions_nan": int(np.isnan(pz).sum()),
            "pct_proportion_definitions_nan": safe(
                int(np.isnan(pz).sum()), len(pz)),
        }
    return out


def variant_coverage(hash_rows: list[dict], splits: dict[str, set[int]],
                     limits: Sequence[int] = COVERAGE_GRID_LIMITS
                     ) -> dict[str, dict[str, float]]:
    """Per-feature-variant definition coverage over the limit_all x subkey
    grid (the 28 ``nodes_feat_*`` variants of ``dbize_absdf.py:21-45``):
    for each single-subkey vocabulary rebuilt from the train split at each
    limit, the share of each split's definitions whose combined hash is
    known (feature id >= 2). ``hash_rows``: the stage-2 hash table's rows
    (``graph_id``, ``node_id``, ``hash`` JSON)."""
    from deepdfa_tpu_torch.config import ALL_SUBKEYS, FeatureConfig
    from deepdfa_tpu_torch.data.vocab import build_vocab

    # parse each hash once and slice each split once, outside the grid
    parsed = [{"graph_id": int(r["graph_id"]),
               "hash_dict": json.loads(r["hash"])} for r in hash_rows]
    split_rows = {part: [r["hash_dict"] for r in parsed
                         if r["graph_id"] in ids]
                  for part, ids in splits.items()}
    out: dict[str, dict[str, float]] = {}
    train_ids = splits.get("train", set())
    for sk in ALL_SUBKEYS:
        for limit in limits:
            fcfg = FeatureConfig(subkeys=(sk,), limit_all=limit,
                                 limit_subkeys=limit)
            voc = build_vocab(parsed, train_ids, fcfg)
            stats: dict[str, float] = {}
            for part, dicts in split_rows.items():
                if not dicts:
                    stats[part] = 0.0
                    continue
                fids = np.array([voc.feature_id_from_dict(h) for h in dicts])
                stats[part] = float((fids >= 2).mean())
            out[f"{sk}_all_limitall_{limit}_limitsubkeys_{limit}"] = stats
    return out


def analyze(cfg: ExperimentConfig, run_dir: Path) -> dict:
    """The reference's ``--analyze_dataset`` (``get_coverage``): per-split
    feature and solution coverage, the label balance and, when the shard
    dir holds ``hashes.csv.gz`` and ``splits.json``, the feature-variant
    grid. A shard dir holding only ``hashes.parquet`` raises
    ``ValueError`` (the port reads no parquet). Writes ``coverage.json``."""
    from deepdfa_tpu_torch.data.table import read_csv

    corpus = load_corpus(cfg)
    out: dict = {"splits": {}}
    n_vul = {p: sum(int(g.node_feats["_VULN"].max() > 0) for g in gs)
             for p, gs in corpus.items()}
    out["vul_distribution"] = {
        p: {"vul": n_vul[p], "nonvul": len(gs) - n_vul[p], "total": len(gs)}
        for p, gs in corpus.items()}
    for part, graphs in corpus.items():
        stats = coverage(graphs)
        logger.info("%s coverage: %s", part, {
            k: round(v, 4) if isinstance(v, float) else v
            for k, v in stats.items() if not isinstance(v, dict)})
        out["splits"][part] = stats

    shard_dir = _shard_dir(cfg)
    csv_path = shard_dir / "hashes.csv.gz"
    splits_file = shard_dir / "splits.json"
    if (shard_dir / "hashes.parquet").exists() and not csv_path.exists():
        raise ValueError(
            f"{shard_dir} holds the hash table as hashes.parquet only; the "
            "port reads hashes.csv.gz (re-run the preprocess without "
            "pyarrow, or python -m deepdfa_tpu_torch.preprocess)")
    if csv_path.exists() and splits_file.exists():
        splits = {k: set(v) for k, v in
                  json.loads(splits_file.read_text()).items()}
        out["variants"] = variant_coverage(
            read_csv(csv_path, str_columns=("hash",)), splits)
        for name, stats in out["variants"].items():
            logger.info("variant %s: %s", name,
                        {k: round(v, 4) for k, v in stats.items()})
    else:
        out["variants"] = None
        logger.info("no hashes.csv.gz under %s — variant grid skipped",
                    shard_dir)
    atomic_write_text(run_dir / "coverage.json", json.dumps(out, indent=2))
    return out


# ---------------------------------------------------------------------------
# predict, export, trace


def predict(cfg: ExperimentConfig, run_dir: Path, sources: Sequence[str],
            ckpt_dir: Path | None = None, top_k: int = 5,
            saliency: str = "occlusion", shard_dir: Path | None = None,
            device=None) -> dict:
    """Score raw C files with the best (else the latest) checkpoint under
    ``ckpt_dir`` (default ``<run-dir>/checkpoints``) on ``device``:
    per-function vulnerability probabilities and ranked statements
    (:func:`~deepdfa_tpu_torch.predict.predict_paths`), in the fused layout
    (every round on B1; checkpoints move between layouts). Vocabularies
    from ``shard_dir`` (default: the config's processed dataset dir).
    Writes ``predictions.json``, prints and returns the report."""
    from deepdfa_tpu_torch.models import make_model
    from deepdfa_tpu_torch.predict import load_vocabs, predict_paths
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager

    dev = resolve_device(device)
    vocabs = load_vocabs(shard_dir or _shard_dir(cfg))
    ckpt_dir = Path(ckpt_dir) if ckpt_dir else run_dir / "checkpoints"
    ckpts = CheckpointManager(ckpt_dir, cfg.checkpoint)
    if ckpts.latest_step() is None:
        raise FileNotFoundError(
            f"no checkpoint under {ckpt_dir} — predict scores with a TRAINED "
            "model; run fit first")
    if cfg.model.layout != "fused":
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, layout="fused"))
    model = make_model(cfg.model, cfg.input_dim, device=dev)
    model.load_state_dict(_restore_state(ckpts))
    report = predict_paths(sources, cfg=cfg, model=model, vocabs=vocabs,
                           top_k=top_k, saliency=saliency)
    atomic_write_text(run_dir / "predictions.json",
                      json.dumps(report, indent=2))
    print(json.dumps(report), flush=True)
    return report


def export_model(cfg: ExperimentConfig, run_dir: Path,
                 ckpt_dir: Path | None = None,
                 shard_dir: Path | None = None, device=None) -> dict:
    """Write the trained scoring forward of a ``train.fit`` run to
    ``run_dir/export`` (``model.pt2`` + ``manifest.json``), parameters
    inside, loadable without the model code. Restores the best checkpoint,
    else the latest, as ``test`` and ``predict`` do, into the fused
    layout, and traces it on ``device`` (``cuda`` unless the caller names
    another) at the config's ceiling shapes. The manifest records the
    checkpoint's provenance and the content hash of the vocabularies in
    ``shard_dir`` (default: the config's processed dataset dir; none
    readable gives ``vocab_hash`` null). Prints and returns ``{"export_dir",
    "pt2_bytes", **provenance}``."""
    from deepdfa_tpu_torch.models import make_model
    from deepdfa_tpu_torch.pipeline import load_vocabs, vocab_content_hash
    from deepdfa_tpu_torch.serving import export_ggnn
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager

    run_dir = Path(run_dir)
    ckpt_dir = Path(ckpt_dir) if ckpt_dir else run_dir / "checkpoints"
    dev = resolve_device(device)
    ckpts = CheckpointManager(ckpt_dir, cfg.checkpoint)
    if ckpts.latest_step() is None:
        raise FileNotFoundError(
            f"no checkpoint under {ckpt_dir} — export serializes a TRAINED "
            "model; run fit first")
    best = ckpts.best_step()
    state = _restore_state(ckpts)
    provenance = {
        "checkpoint_dir": str(ckpt_dir),
        "restored": "best" if best is not None else "latest",
        "step": int(best if best is not None else ckpts.latest_step()),
    }
    # stale-artifact guard: the training vocabularies' content hash
    shard_dir = shard_dir or _shard_dir(cfg)
    vocab_hash = None
    try:
        vocab_hash = vocab_content_hash(load_vocabs(shard_dir))
    except (FileNotFoundError, ValueError):
        logger.warning("no readable vocab.json under %s — manifest carries "
                       "vocab_hash=null", shard_dir)
    mcfg = dataclasses.replace(cfg.model, layout="fused")
    model = make_model(mcfg, cfg.input_dim, device="cpu")
    out = export_ggnn(dataclasses.replace(cfg, model=mcfg), state,
                      run_dir / "export", model=model, provenance=provenance,
                      vocab_hash=vocab_hash, device=dev)
    result = {"export_dir": str(out),
              "pt2_bytes": (out / "model.pt2").stat().st_size, **provenance}
    print(json.dumps(result), flush=True)
    return result


def trace_export(src: Path, out: Path | None = None) -> dict:
    """Collect the ``event=trace`` exemplar records under ``src`` (a run
    dir, a trace dir or one file) into one Chrome trace-event JSON, for
    Perfetto or ``chrome://tracing``."""
    from deepdfa_tpu_torch.obs import chrome_trace, load_trace_records

    records = load_trace_records(src)
    spans = [s for rec in records for s in rec.get("spans", [])]
    trace = chrome_trace(spans)
    if out is None:
        out = (src / "trace_events.json" if src.is_dir()
               else src.with_suffix(".chrome.json"))
    atomic_write_text(Path(out), json.dumps(trace, indent=2))
    summary = {"trace_records": len(records), "spans": len(spans),
               "out": str(out)}
    print(json.dumps(summary), flush=True)
    return summary


# ---------------------------------------------------------------------------
# entry


def _parser():
    import argparse

    parser = argparse.ArgumentParser(prog="deepdfa-tpu-torch")
    parser.add_argument("command", choices=COMMANDS)
    parser.add_argument("subcommand", nargs="?", default=None,
                        help="trace: 'export' (the default); bench: "
                             "'ledger' (the default); scan: the file or "
                             "directory to scan")
    parser.add_argument("--out", default=None,
                        help="trace export: output path (default: "
                             "<run-dir>/trace_events.json)")
    parser.add_argument("--config", action="append", default=[],
                        help="layered config files (later files win)")
    parser.add_argument("--set", action="append", default=[], dest="overrides",
                        help="dotted overrides, e.g. --set optim.max_epochs=3")
    parser.add_argument("--run-dir", default=None)
    parser.add_argument("--resume", action="store_true",
                        help="fit: resume from the run dir's newest good "
                             "checkpoint and journal (fresh run if none)")
    parser.add_argument("--ckpt-dir", default=None,
                        help="checkpoint dir for test/predict/export "
                             "(default: <run-dir>/checkpoints)")
    parser.add_argument("--shard-dir", default=None,
                        help="shard dir holding vocab.json (default: the "
                             "config's processed dataset dir)")
    parser.add_argument("--source", action="append", default=[],
                        help="predict/scan: C file or directory (repeatable)")
    parser.add_argument("--workers", type=int, default=4,
                        help="scan: extraction-pool worker count")
    parser.add_argument("--cache-dir", default=None,
                        help="scan: extraction-cache dir (default: "
                             "<run-dir>/extract_cache)")
    parser.add_argument("--artifact", default=None,
                        help="serve/scan: an exported artifact dir (train.cli "
                             "export) instead of a checkpoint")
    parser.add_argument("--cascade", action="store_true",
                        help="scan: rescore borderline-band functions "
                             "through the tier-2 joint engine (needs "
                             "serve.cascade.joint_dir)")
    parser.add_argument("--interproc", action="store_true",
                        help="scan: also score the target as one unit and "
                             "report cross-function taint flows")
    parser.add_argument("--top-k", type=int, default=5,
                        help="predict: statements ranked per function")
    parser.add_argument("--saliency", choices=("occlusion", "gate"),
                        default="occlusion",
                        help="predict statement ranking: occlusion = per-"
                             "statement evidence drop; gate = readout "
                             "attention, one forward")
    parser.add_argument("--check", action="store_true",
                        help="bench ledger: exit non-zero when the latest "
                             "entry of any series regressed past its band")
    parser.add_argument("--trend", action="store_true",
                        help="bench ledger: print per-series sparkline "
                             "trends")
    parser.add_argument("--ledger-dir", action="append", default=[],
                        help="bench ledger: artifact file or directory to "
                             "ingest (repeatable; default: the working "
                             "directory)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    return parser


def main(argv=None) -> dict:
    """``python -m deepdfa_tpu_torch.train.cli <command>`` with the JAX
    package's flags plus ``--shard-dir`` and ``--device``. A preempted
    ``fit`` raises :class:`~deepdfa_tpu_torch.resilience.preemption.
    PreemptedExit` (exit code 75)."""
    from deepdfa_tpu_torch.config import load_config, to_json
    from deepdfa_tpu_torch.serve.server import parse_overrides

    parser = _parser()
    args = parser.parse_args(argv)
    if args.command == "predict" and not args.source:
        parser.error("predict requires at least one --source")
    if args.command == "trace":
        # a reporting path: no config, no run-dir creation, no logging
        if (args.subcommand or "export") != "export":
            parser.error(f"unknown trace subcommand {args.subcommand!r}")
        if not args.run_dir:
            parser.error("trace export requires --run-dir")
        return trace_export(Path(args.run_dir),
                            Path(args.out) if args.out else None)
    if args.command == "bench":
        # a reporting path, as trace: no config, no run dir, no logging
        if (args.subcommand or "ledger") != "ledger":
            parser.error(f"unknown bench subcommand {args.subcommand!r}")
        from deepdfa_tpu_torch.obs import ledger

        ledger_argv = list(args.ledger_dir)
        if args.check:
            ledger_argv.append("--check")
        if args.trend:
            ledger_argv.append("--trend")
        rc = ledger.main(ledger_argv)
        if rc:
            raise SystemExit(rc)
        return {"command": "bench", "subcommand": "ledger", "rc": rc}
    if args.command == "export" and not args.run_dir:
        parser.error("export requires --run-dir")

    layers = list(args.config)
    if args.command in _READERS and args.run_dir:
        # the run's own recorded config is the base layer
        saved = Path(args.run_dir) / "config.json"
        if saved.exists():
            layers.insert(0, saved)
    cfg = load_config(*layers, overrides=parse_overrides(args.overrides))
    utils.seed_all(cfg.seed)
    run_id = cfg.run_name or utils.get_run_id([args.command])
    run_dir = (Path(args.run_dir) if args.run_dir
               else utils.get_dir(utils.storage_dir() / "runs" / run_id))
    run_dir.mkdir(parents=True, exist_ok=True)
    log_file = run_dir / "run.log"
    handlers = [logging.StreamHandler(sys.stderr), logging.FileHandler(log_file)]
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        handlers=handlers, force=True)
    if (args.command not in _READERS
            or not (run_dir / "config.json").exists()):
        atomic_write_text(run_dir / "config.json", to_json(cfg))
    logger.info("run %s: %s device=%s", run_id, args.command,
                args.device or "cuda")
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else None
    shard_dir = Path(args.shard_dir) if args.shard_dir else None
    try:
        if args.command == "fit":
            return fit(cfg, run_dir, resume=args.resume, device=args.device)
        if args.command == "test":
            return test(cfg, run_dir, ckpt_dir, device=args.device)
        if args.command == "predict":
            return predict(cfg, run_dir, args.source, ckpt_dir,
                           top_k=args.top_k, saliency=args.saliency,
                           shard_dir=shard_dir, device=args.device)
        if args.command == "export":
            return export_model(cfg, run_dir, ckpt_dir, shard_dir=shard_dir,
                                device=args.device)
        if args.command == "serve":
            from deepdfa_tpu_torch.serve.server import serve_command

            return serve_command(cfg, run_dir=run_dir, ckpt_dir=ckpt_dir,
                                 artifact=args.artifact, shard_dir=shard_dir,
                                 device=args.device)
        if args.command == "scan":
            from deepdfa_tpu_torch.scan import scan_command

            targets = (([args.subcommand] if args.subcommand else [])
                       + list(args.source))
            return scan_command(
                cfg, run_dir, targets, ckpt_dir=ckpt_dir,
                artifact=args.artifact, workers=args.workers,
                cache_dir=Path(args.cache_dir) if args.cache_dir else None,
                cascade=args.cascade, interproc=args.interproc,
                shard_dir=shard_dir, device=args.device)
        return analyze(cfg, run_dir)
    except Exception:
        # the crash marker (main_cli.py:324-336), not for the commands
        # pointed at a fit run dir: a failed predict must not mark the
        # trained run as crashed
        for h in handlers:
            h.close()
        if args.command not in _READERS:
            log_file.rename(log_file.with_suffix(".log.error"))
        raise


if __name__ == "__main__":
    main()
