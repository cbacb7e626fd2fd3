"""The learned-dataflow experiment: the GGNN's dataflow structure is
load-bearing for classification (the source paper's thesis: union
aggregation as a differentiable dataflow lattice).

A copy of ``scripts/dataflow_experiment.py``: the same flags and the same
JSON keys, run as ``python -m deepdfa_tpu_torch.dataflow_experiment`` on
``--device`` (``cuda`` unless another is named). The model is the JAX
script's: the golden GGNN in the ``segment`` layout (the layout ``taps``
needs), so the experiment launches no hand-written kernel.

Corpus: ``demo_hard`` (``data/codegen.generate_hard_function``):
vulnerable and fixed functions are built from the same statement multiset;
the class is decided only by which definition of the copy bound reaches
the ``memcpy`` (clamp-dominates against re-tainted-after-clamp). Any
bag-of-features model is at chance by construction.

Reports, as one JSON line:
  - ``feature_lr_f1``      logistic regression on per-graph feature
                           histograms (the no-graph baseline, numpy only)
  - ``ggnn_f1``            golden-config GGNN, graph label
  - ``dfa_node_f1_sum``    GGNN trained to predict the reaching-definition
                           solver's OUT sets
  - ``dfa_node_f1_union_relu``  the same with the union (lattice)
                           aggregator

``--chain-sweep L1,L2``, ``--rescue L1,L2`` and ``--union-pretrain L1,L2``
run the script's sweeps over ``demo_order{L}`` instead. Every corpus is
built by :func:`deepdfa_tpu_torch.preprocess.main` into the storage root
(``DEEPDFA_STORAGE``).

Usage: python -m deepdfa_tpu_torch.dataflow_experiment [--n 400]
[--epochs 25] [--device cpu] (the fits' epoch lines go to stderr)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
from pathlib import Path

__all__ = ["chain_sweep", "feature_lr_baseline", "grad_norms_per_step",
           "main", "rescue", "run_ggnn", "union_pretrain"]


def _build(argv: list[str], n: int) -> None:
    """A corpus through the port's preprocess; the experiment refuses a
    build that does not hold ``n`` graphs."""
    from deepdfa_tpu_torch import preprocess

    summary = preprocess.main(argv)
    if summary.get("graphs") != n:
        raise RuntimeError(f"corpus build mismatch for {argv[1]}: "
                           f"{summary} vs n={n}")


def _hard_cfg(cfg, dsname: str = "demo_hard", **model_overrides):
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, dsname=dsname),
        model=dataclasses.replace(cfg.model, **model_overrides),
    )


def feature_lr_baseline(seed: int = 0) -> dict:
    """Logistic regression (numpy, full-batch gradient descent) on
    per-graph bag-of-feature histograms: everything the GGNN sees except
    the graph structure."""
    import numpy as np
    import torch

    from deepdfa_tpu_torch.config import ExperimentConfig
    from deepdfa_tpu_torch.train.fit import load_corpus
    from deepdfa_tpu_torch.train.metrics import (ConfusionState,
                                                 compute_metrics,
                                                 update_confusion)

    corpus = load_corpus(_hard_cfg(ExperimentConfig()))
    keys = sorted(
        k for k in corpus["train"][0].node_feats if k.startswith("_ABS_DATAFLOW")
    )
    dims = {
        k: max(int(g.node_feats[k].max())
               for part in corpus.values() for g in part) + 1
        for k in keys
    }

    def featurize(graphs):
        X = np.zeros((len(graphs), sum(dims.values())), np.float64)
        y = np.zeros(len(graphs), np.int32)
        for i, g in enumerate(graphs):
            off = 0
            for k in keys:
                ids = g.node_feats[k]
                X[i, off:off + dims[k]] = np.bincount(ids, minlength=dims[k])
                off += dims[k]
            y[i] = int(g.node_feats["_VULN"].max())
        X /= np.maximum(X.sum(axis=1, keepdims=True), 1.0)  # length-invariant
        return X, y

    Xtr, ytr = featurize(corpus["train"])
    Xte, yte = featurize(corpus["test"])
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.01, Xtr.shape[1])
    b = 0.0
    for _ in range(3000):  # full-batch gradient descent with L2
        p = 1 / (1 + np.exp(-(Xtr @ w + b)))
        grad_w = Xtr.T @ (p - ytr) / len(ytr) + 1e-4 * w
        grad_b = float(np.mean(p - ytr))
        w -= 1.0 * grad_w
        b -= 1.0 * grad_b
    probs = 1 / (1 + np.exp(-(Xte @ w + b)))
    # the GGNN's metric implementation and zero-division convention, on
    # float32 probabilities as the JAX package's counts take them
    m = compute_metrics(update_confusion(
        ConfusionState.zeros(), torch.as_tensor(probs, dtype=torch.float32),
        torch.from_numpy(yte), torch.ones(len(yte), dtype=torch.bool)))
    train_p = 1 / (1 + np.exp(-(Xtr @ w + b)))
    train_acc = float(np.mean((train_p > 0.5) == ytr))
    return {"feature_lr_f1": round(float(m["F1Score"]), 4),
            "feature_lr_acc": round(float(m["Accuracy"]), 4),
            "feature_lr_train_acc": round(train_acc, 4)}


def run_ggnn(run_dir: Path, epochs: int, dsname: str = "demo_hard",
             device=None, **model_overrides) -> dict:
    """``fit`` then ``test`` of the golden GGNN (segment layout) on
    ``dsname`` for ``epochs``; the test metrics."""
    from deepdfa_tpu_torch.config import ExperimentConfig
    from deepdfa_tpu_torch.train import cli
    from deepdfa_tpu_torch.train.fit import fit

    cfg = _hard_cfg(ExperimentConfig(), dsname=dsname, **model_overrides)
    cfg = dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, max_epochs=epochs))
    run_dir.mkdir(parents=True, exist_ok=True)
    fit(cfg, run_dir, device=device)
    return cli.test(cfg, run_dir, device=device)


def chain_sweep(args) -> dict:
    """Union-against-sum separation curves (superseded by ``--rescue`` for
    conclusions: its 25-epoch budget stops inside the optimization
    plateau). For each def→def CFG distance L, train the golden GGNN on
    ``demo_order{L}`` with aggregation sum and ``union_relu`` at the golden
    depth (``n_steps`` 5) and at a chain-covering depth (L + 3)."""
    depths = [int(x) for x in args.chain_sweep.split(",")]
    out = Path(args.out)
    curves: dict = {"n": args.n, "epochs": args.epochs, "depths": depths,
                    "runs": {}}
    for L in depths:
        ds = f"demo_order{L}"
        _build(["--dataset", ds, "--n", str(args.n), "--seed",
                str(args.seed), "--overwrite"], args.n)
        for agg in ("sum", "union_relu"):
            for steps in sorted({5, L + 3}):
                key = f"L{L}_{agg}_n{steps}"
                r = run_ggnn(out / key, args.epochs, dsname=ds,
                             device=args.device, aggregation=agg,
                             n_steps=steps)
                curves["runs"][key] = {
                    "f1": round(float(r["test_F1Score"]), 4),
                    "acc": round(float(r["test_Accuracy"]), 4),
                }
                print(f"{key}: {curves['runs'][key]}", file=sys.stderr)
    print(json.dumps(curves))
    return curves


def grad_norms_per_step(model, batch, cfg) -> list[float]:
    """|dL/dh_t| for each message-passing step on one batch (on the
    model's device): the gradient of the graph-label BCE with respect to
    ``n_steps`` zero ``taps`` added after each round (segment layout)."""
    import torch

    from deepdfa_tpu_torch.config import ALL_SUBKEYS
    from deepdfa_tpu_torch.train.loop import bce_with_logits, graph_labels

    lab = graph_labels(batch)
    w = batch.graph_mask.float()
    width = cfg.model.hidden_dim * (
        len(ALL_SUBKEYS) if cfg.model.concat_all_absdf else 1)
    taps = [torch.zeros(batch.node_mask.shape[0], width,
                        device=batch.node_mask.device, requires_grad=True)
            for _ in range(cfg.model.n_steps)]
    model.eval()
    with torch.enable_grad():
        loss = bce_with_logits(model(batch, taps=taps), lab, w, None)
        grads = torch.autograd.grad(loss, taps)
    return [float(torch.linalg.norm(g)) for g in grads]


def _train_with_curve(dsname: str, epochs: int, seed: int = 0,
                     probe_grads: bool = True, warm_start: dict | None = None,
                     return_params: bool = False,
                     freeze_encoder: bool = False, device=None,
                     **model_overrides):
    """Train the golden GGNN on ``dsname`` recording the per-epoch curve,
    the plateau length (the first epoch with train accuracy ≥ 0.7), the
    validation logit/label correlation (which rises well before the
    accuracy does) and the per-step gradient norms dL/dh_t through the
    unrolled GRU chain (through ``taps``, segment layout), at epochs 0,
    epochs // 4 and the last.

    ``warm_start``: a donor state dict whose encoder (embeddings and
    message passing) replaces the fresh one, head and pooling kept fresh
    (``encoder_partial_load``). ``freeze_encoder``: only the head and the
    pooling train (``frozen_encoder_optimizer``)."""
    import numpy as np
    import torch

    from deepdfa_tpu_torch import resolve_device
    from deepdfa_tpu_torch.config import ExperimentConfig
    from deepdfa_tpu_torch.data.graphs import to_device
    from deepdfa_tpu_torch.data.sampler import positive_weight
    from deepdfa_tpu_torch.models import make_model
    from deepdfa_tpu_torch.train.checkpoint import (encoder_partial_load,
                                                    frozen_encoder_optimizer)
    from deepdfa_tpu_torch.train.fit import (_batch_stream, _batcher,
                                             _epoch_graphs, load_corpus)
    from deepdfa_tpu_torch.train.loop import Trainer, graph_labels

    dev = resolve_device(device)
    cfg = _hard_cfg(ExperimentConfig(), dsname=dsname, **model_overrides)
    cfg = dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, max_epochs=epochs))
    corpus = load_corpus(cfg)
    train, val, test = corpus["train"], corpus["val"], corpus["test"]
    labels = np.array([int(g.node_feats["_VULN"].max()) for g in train])
    batcher = _batcher(cfg, train + val + test)
    model = make_model(cfg.model, cfg.input_dim, device=dev, seed=cfg.seed)
    trainer = Trainer(model, cfg, pos_weight=positive_weight(labels))
    if warm_start is not None:
        # encoder transfer; the head and pooling keep their fresh values
        # (the freeze_graph predicate, train/checkpoint.py is_head_key)
        model.load_state_dict(encoder_partial_load(model.state_dict(),
                                                   warm_start))
    state = trainer.init_state()
    if freeze_encoder:
        # head-only training: the encoder leaves the optimizer
        o = cfg.optim
        trainer.optimizer = state.optimizer = frozen_encoder_optimizer(
            model, lambda params: torch.optim.AdamW(
                params, lr=trainer.lr, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=o.weight_decay))

    def val_batch():
        return to_device(next(iter(_batch_stream(batcher, val))), dev)

    def probe() -> list[float]:
        return [round(x, 6)
                for x in grad_norms_per_step(model, val_batch(), cfg)]

    curve = []
    breakthrough = None
    grad_trace = {}
    for epoch in range(epochs):
        egs = _epoch_graphs(train, labels, cfg, epoch)
        state, tm, tloss = trainer.train_epoch(
            state, _batch_stream(batcher, egs, shuffle_seed=seed + epoch))
        vm, _ = trainer.evaluate(model, _batch_stream(batcher, val))
        row = {
            "epoch": epoch,
            "train_acc": round(float(tm["train_Accuracy"]), 4),
            "val_acc": round(float(vm["val_Accuracy"]), 4),
            "val_f1": round(float(vm["val_F1Score"]), 4),
            "train_loss": round(float(tloss), 5),
        }
        curve.append(row)
        if breakthrough is None and row["train_acc"] >= 0.7:
            breakthrough = epoch
        if probe_grads and epoch in (0, epochs // 4, epochs - 1):
            grad_trace[str(epoch)] = probe()
        # early stop once converged well past the plateau (the plateau
        # length is the quantity of interest)
        if len(curve) >= 10 and all(
            r["train_acc"] >= 0.99 and r["val_acc"] >= 0.99
            for r in curve[-10:]
        ):
            if probe_grads and str(epoch) not in grad_trace:
                grad_trace[str(epoch)] = probe()
            break

    test_m, _ = trainer.evaluate(model, _batch_stream(batcher, test),
                                 prefix="test_")
    corr = None
    # a graph-label diagnostic (per-node styles emit per-node logits)
    if cfg.model.label_style == "graph":
        b = val_batch()
        model.eval()
        with torch.no_grad():
            logits = model(b).cpu().numpy()
        lab = graph_labels(b).cpu().numpy()
        mask = b.graph_mask.cpu().numpy().astype(bool)
        if mask.sum() > 2:
            c = float(np.corrcoef(logits[mask], lab[mask])[0, 1])
            corr = c if np.isfinite(c) else None  # constant → NaN
    result = {
        "test_f1": round(float(test_m["test_F1Score"]), 4),
        "test_acc": round(float(test_m["test_Accuracy"]), 4),
        "breakthrough_epoch": breakthrough,
        "val_logit_label_corr": round(corr, 4) if corr is not None else None,
        "grad_norm_per_step": grad_trace,
        "curve_tail": curve[-3:],
        "curve_every4": curve[::4],
    }
    if return_params:
        return result, {k: v.detach().clone()
                        for k, v in model.state_dict().items()}
    return result


def rescue(args) -> dict:
    """The chain-depth collapse re-examined with optimization diagnostics:
    for each L, sum and ``union_relu`` at the golden depth (``n_steps`` 5)
    with an epoch budget past the plateau; per run the breakthrough epoch,
    the gradient-norm traces, the test F1 and the logit/label
    correlation."""
    depths = [int(x) for x in args.rescue.split(",")]
    out: dict = {"n": args.n, "epochs": args.epochs, "depths": depths,
                 "n_steps": 5, "runs": {}}
    for L in depths:
        ds = f"demo_order{L}"
        _build(["--dataset", ds, "--n", str(args.n), "--seed",
                str(args.seed), "--overwrite"], args.n)
        for agg in ("sum", "union_relu"):
            key = f"L{L}_{agg}"
            out["runs"][key] = _train_with_curve(
                ds, args.epochs, seed=args.seed, device=args.device,
                aggregation=agg, n_steps=5)
            print(f"{key}: f1={out['runs'][key]['test_f1']} "
                  f"breakthrough={out['runs'][key]['breakthrough_epoch']}",
                  file=sys.stderr)
    print(json.dumps(out))
    return out


def union_pretrain(args) -> dict:
    """Node-level reaching-definition supervision as pretraining for
    ``union_relu``, then the encoder transferred under a fresh graph head,
    trained whole (warm start) and with the encoder frozen."""
    depths = [int(x) for x in args.union_pretrain.split(",")]
    out: dict = {"n": args.n, "epochs": args.epochs, "depths": depths,
                 "n_steps": 5, "aggregation": "union_relu", "runs": {}}
    for L in depths:
        ds = f"demo_order{L}"
        _build(["--dataset", ds, "--n", str(args.n), "--seed",
                str(args.seed), "--dataflow-labels", "--overwrite"], args.n)
        stage1, donor = _train_with_curve(
            ds, 15, seed=args.seed, device=args.device,
            aggregation="union_relu", n_steps=5,
            label_style="dataflow_solution_out", probe_grads=False,
            return_params=True)
        warm = _train_with_curve(
            ds, args.epochs, seed=args.seed, device=args.device,
            aggregation="union_relu", n_steps=5, warm_start=donor)
        frozen = _train_with_curve(
            ds, args.epochs, seed=args.seed, device=args.device,
            aggregation="union_relu", n_steps=5, warm_start=donor,
            freeze_encoder=True)
        out["runs"][f"L{L}"] = {
            "node_pretrain": stage1,
            "graph_warmstart": warm,
            "graph_warmstart_frozen": frozen,
        }
        print(f"L{L}: pretrain_node_f1={stage1['test_f1']} "
              f"warmstart_graph_f1={warm['test_f1']} "
              f"frozen_graph_f1={frozen['test_f1']} "
              f"breakthrough={warm['breakthrough_epoch']}/"
              f"{frozen['breakthrough_epoch']}", file=sys.stderr)
    print(json.dumps(out))
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m deepdfa_tpu_torch.dataflow_experiment")
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/dataflow_experiment")
    ap.add_argument("--chain-sweep", default=None, metavar="L1,L2,...",
                    help="run the union-vs-sum chain-depth separation sweep "
                         "instead of the standard experiment")
    ap.add_argument("--rescue", default=None, metavar="L1,L2,...",
                    help="run the plateau-aware rescue sweep with "
                         "optimization diagnostics (use --epochs >= 150)")
    ap.add_argument("--union-pretrain", default=None, metavar="L1,L2,...",
                    help="node-level reaching-definition pretraining -> "
                         "graph-head transfer for the union_relu aggregator "
                         "(use --epochs >= 150 for the graph stage)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if args.union_pretrain:
        return union_pretrain(args)
    if args.rescue:
        return rescue(args)
    if args.chain_sweep:
        return chain_sweep(args)

    # --overwrite: a stale shard dir from another --n/--seed (or one built
    # without --dataflow-labels) must never serve this experiment
    _build(["--dataset", "demo_hard", "--n", str(args.n), "--seed",
            str(args.seed), "--dataflow-labels", "--overwrite"], args.n)

    results = {}
    results |= feature_lr_baseline(seed=args.seed)

    out = Path(args.out)
    g = run_ggnn(out / "graph", args.epochs, device=args.device)
    results["ggnn_f1"] = round(float(g["test_F1Score"]), 4)
    results["ggnn_acc"] = round(float(g.get("test_Accuracy", float("nan"))), 4)

    for agg in ("sum", "union_relu"):
        r = run_ggnn(out / f"dfa_{agg}", max(args.epochs // 2, 5),
                     device=args.device,
                     label_style="dataflow_solution_out", aggregation=agg)
        results[f"dfa_node_f1_{agg}"] = round(float(r["test_F1Score"]), 4)

    results["n"] = args.n
    results["margin_vs_feature_baseline"] = round(
        results["ggnn_f1"] - results["feature_lr_f1"], 4)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    # each fit's epoch lines (train loss, validation F1) on stderr
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
