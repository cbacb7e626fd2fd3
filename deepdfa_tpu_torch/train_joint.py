"""Joint LLM + GGNN training: the reference's ``train.py`` command surface.

A copy of ``scripts/train_joint.py``: the same flags and the same JSON
keys, run as ``python -m deepdfa_tpu_torch.train_joint`` on ``--device``
(``cuda`` unless another is named). Two weight sources:

- ``--hf-checkpoint DIR``: a local HF CodeLlama (or, with ``--encoder
  roberta``, CodeBERT) checkpoint, converted with no renaming and
  tokenized by ``transformers``, which must be installed (an error names
  it otherwise);
- default: a tiny seeded model and the hash tokenizer over the generated
  demo corpus; ``--preset`` takes a preset's model and joint config
  (``linevul``/``linevul_fusion`` run CodeBERT-base width on seeded
  weights).

``--encoder roberta`` (or a LineVul preset) trains the encoder with the
fusion head (``train_llm``, LineVul fine-tunes CodeBERT end to end) and
pools the CLS row; ``--encoder`` contradicting the preset's
``encoder_family`` is refused. ``--freeze-graph CKPT_DIR`` loads a fit
run's GGNN encoder into the fusion model and freezes it (the reference's
freeze-transfer, ``main_cli.py:136-145``). Graphs come from the shards of
``python -m deepdfa_tpu_torch.preprocess`` for the same dataset, joined by
function id.

``--predict-source PATH`` (repeatable) scans raw C files or directories
with the newest ``epoch_*`` checkpoint under ``--output_dir``: every
function is parsed, encoded against the dataset's shard vocabularies and
its own source span tokenized, and scored by the trained joint model; the
per-function probabilities (and a row per file or function that could not
be scored) go to ``predictions.json`` and stdout. The model flags must
match the training run's, as for ``--do_test``.

Usage:
  python -m deepdfa_tpu_torch.preprocess --dataset demo --n 200
  python -m deepdfa_tpu_torch.train_joint --dataset demo --do_train
      --do_test --epochs 2 [--device cpu]
  python -m deepdfa_tpu_torch.train_joint --preset linevul_fusion
      --freeze-graph RUN/checkpoints --do_train
  python -m deepdfa_tpu_torch.train_joint --dataset demo --output_dir RUN
      --predict-source tests/fixtures/realworld
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

__all__ = ["hf_encoder", "main", "scan_sources", "split_examples"]


def split_examples(examples, seed: int):
    """(train, eval, test): a seeded permutation cut 80/10/10, as the JAX
    script cuts it."""
    import numpy as np

    n = len(examples)
    perm = np.random.default_rng(seed).permutation(n)
    cut_val, cut_test = int(n * 0.8), int(n * 0.9)
    pick = lambda sl: type(examples)(*(np.asarray(a)[perm[sl]]  # noqa: E731
                                       for a in examples))
    return (pick(slice(0, cut_val)), pick(slice(cut_val, cut_test)),
            pick(slice(cut_test, None)))


def hf_encoder(encoder_family: str, llm_cfg, hf: str, device):
    """(model config, encoder) of the local HF checkpoint ``hf``: CodeBERT
    for ``"roberta"`` (its ``config.json``), else CodeLlama with the
    architecture from ``config.json`` and ``lora_rank``, ``attn_impl`` and
    ``dtype`` from ``llm_cfg`` (fresh adapters grafted on)."""
    if encoder_family == "roberta":
        from deepdfa_tpu_torch.llm.convert import load_torch_state
        from deepdfa_tpu_torch.llm.roberta import (RobertaConfig,
                                                   build_roberta,
                                                   convert_hf_roberta)

        cfg = RobertaConfig.from_hf_dict(
            json.loads((Path(hf) / "config.json").read_text()))
        model = build_roberta(cfg, device, seed=None)
        model.load_state_dict(convert_hf_roberta(load_torch_state(hf)))
        return cfg, model
    from deepdfa_tpu_torch.finetune_llm import hf_llama
    from deepdfa_tpu_torch.llm.llama import LlamaModel

    model = hf_llama(hf, device, cls=LlamaModel,
                     lora_rank=llm_cfg.lora_rank,
                     lora_alpha=llm_cfg.lora_alpha,
                     attn_impl=llm_cfg.attn_impl, dtype=llm_cfg.dtype)
    return model.cfg, model


def scan_sources(paths, vocabs, use_gnn: bool):
    """``(functions, ids, meta, graphs, errors)`` of the C files under
    ``paths``: each function's source span, its id, ``{"file",
    "function"}``, its graph (with ``use_gnn``) and an error row for each
    file or function that cannot be scored."""
    from deepdfa_tpu_torch.cpg.features import add_dependence_edges
    from deepdfa_tpu_torch.cpg.frontend import FrontendError, parse_functions
    from deepdfa_tpu_torch.pipeline import encode_cpg
    from deepdfa_tpu_torch.predict import collect_sources

    funcs, ids, meta, graphs, errors = [], [], [], [], []
    for src_path in paths:
        found = collect_sources([src_path])
        if not found:
            # a .c-less directory must not read as a clean scan of nothing
            errors.append({"file": str(src_path),
                           "error": "directory contains no .c files "
                                    "(the frontend parses C11 only)"})
            continue
        for file_name, text in found:
            # one pathological file must not abort the scan
            try:
                src_lines = text.splitlines()
                for fname, cpg in parse_functions(text):
                    cpg = add_dependence_edges(cpg)
                    gid = len(funcs)
                    g = None
                    if use_gnn:
                        g, _ = encode_cpg(cpg, gid, vocabs)
                        if g is None:
                            errors.append(
                                {"file": file_name, "function": fname,
                                 "error": "no CFG nodes survived selection"})
                            continue
                    # the LLM reads the function's own source span
                    lines = [n.line for n in cpg.nodes.values() if n.line]
                    lo, hi = ((min(lines), max(lines)) if lines
                              else (1, len(src_lines)))
                    funcs.append("\n".join(src_lines[max(lo - 1, 0):hi]))
                    ids.append(gid)
                    if use_gnn:
                        graphs.append(g)
                    meta.append({"file": file_name, "function": fname})
            except (FrontendError, SyntaxError, ValueError) as e:
                errors.append({"file": file_name,
                               "error": f"{type(e).__name__}: {e}"})
    return funcs, ids, meta, graphs, errors


def _newest_epoch(run_dir, what: str) -> Path:
    saved = sorted(Path(run_dir).glob("epoch_*"),
                   key=lambda p: int(p.name.split("_")[1]))
    if not saved:
        raise SystemExit(f"{what} needs an epoch_* checkpoint under "
                         f"{run_dir}")
    return saved[-1]


def _freeze_graph_cfg(ckpt_dir: str):
    """The fit run's GGNN config (``config.json`` beside ``checkpoints/``),
    else the golden one."""
    from deepdfa_tpu_torch.config import GGNNConfig

    cfg_file = Path(ckpt_dir).parent / "config.json"
    if not cfg_file.exists():
        return GGNNConfig()
    saved = json.loads(cfg_file.read_text()).get("model", {})
    names = {f.name for f in dataclasses.fields(GGNNConfig)}
    return GGNNConfig(**{k: v for k, v in saved.items() if k in names})


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m deepdfa_tpu_torch.train_joint")
    parser.add_argument("--dataset", default="demo")
    parser.add_argument("--preset", default=None,
                        help="one of llm.presets.PRESETS")
    parser.add_argument("--hf-checkpoint", default=None,
                        help="local HF model dir")
    parser.add_argument("--do_train", action="store_true")
    parser.add_argument("--do_test", action="store_true")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--block_size", type=int, default=None)
    parser.add_argument("--train_batch_size", type=int, default=None)
    parser.add_argument("--eval_batch_size", type=int, default=None)
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--no_flowgnn", action="store_true")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--sample", action="store_true")
    parser.add_argument("--encoder", choices=["llama", "roberta"],
                        default=None,
                        help="encoder stack (default: the preset's "
                             "encoder_family, else llama)")
    parser.add_argument("--freeze-graph", default=None, metavar="CKPT_DIR",
                        help="checkpoint dir of a fit run: load its GGNN "
                             "encoder into the fusion model and freeze it")
    parser.add_argument("--predict-source", action="append", default=[],
                        metavar="PATH",
                        help="scan raw C files/dirs with the trained joint "
                             "checkpoint under --output_dir: per-function "
                             "vulnerability probability")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if args.predict_source:
        if args.do_train or args.do_test:
            parser.error("--predict-source is a standalone scan over the "
                         "given files (their labels are unknown) — run "
                         "training/testing separately")
        if not args.output_dir:
            parser.error("--predict-source needs --output_dir pointing at "
                         "the trained joint run (its epoch_* checkpoint)")

    from deepdfa_tpu_torch import resolve_device, utils
    from deepdfa_tpu_torch.config import FeatureConfig, GGNNConfig
    from deepdfa_tpu_torch.data.graphs import load_shards
    from deepdfa_tpu_torch.llm.dataset import (GraphJoin, HashTokenizer,
                                               encode_functions)
    from deepdfa_tpu_torch.llm.fusion import build_fusion
    from deepdfa_tpu_torch.llm.joint import JointConfig, JointTrainer
    from deepdfa_tpu_torch.llm.llama import build_llama, tiny_llama
    from deepdfa_tpu_torch.llm.roberta import build_roberta

    device = resolve_device(args.device)
    encoder_family = args.encoder
    if args.preset:
        from deepdfa_tpu_torch.llm.presets import PRESETS

        preset = PRESETS[args.preset]
        jcfg, llm_cfg = preset.joint, preset.llm
        if encoder_family and encoder_family != preset.encoder_family:
            # a preset's model config belongs to its stack
            raise SystemExit(
                f"--encoder {encoder_family} contradicts preset "
                f"{args.preset!r} (encoder_family={preset.encoder_family})")
        encoder_family = preset.encoder_family
    else:
        jcfg, llm_cfg = JointConfig(), tiny_llama(vocab_size=2048)
    encoder_family = encoder_family or "llama"
    updates = {k: v for k, v in {
        "epochs": args.epochs, "block_size": args.block_size,
        "train_batch_size": args.train_batch_size,
        "eval_batch_size": args.eval_batch_size,
        "learning_rate": args.learning_rate, "seed": args.seed,
        "dataset_style": args.dataset}.items() if v is not None}
    if args.no_flowgnn:
        updates["use_gnn"] = False
    jcfg = dataclasses.replace(jcfg, **updates)
    if encoder_family == "roberta":
        # LineVul fine-tunes CodeBERT end to end whatever the weights' source
        jcfg = dataclasses.replace(jcfg, train_llm=True)
        if not args.preset and not args.hf_checkpoint:
            from deepdfa_tpu_torch.llm.roberta import tiny_roberta

            # the position table covers --block_size (RoBERTa positions
            # start at pad_token_id + 1)
            llm_cfg = tiny_roberta(vocab_size=2048,
                                   max_position_embeddings=jcfg.block_size + 4)
    if args.freeze_graph:
        if not jcfg.use_gnn:
            raise SystemExit("--freeze-graph requires the GNN branch (drop "
                             "--no_flowgnn / use a use_gnn preset)")
        jcfg = dataclasses.replace(jcfg, freeze_gnn=True)

    suffix = "_sample" if args.sample else ""
    shard_dir = utils.processed_dir() / args.dataset / f"shards{suffix}"
    scan_meta = scan_graphs = None
    if args.predict_source:
        vocabs = None
        if jcfg.use_gnn:  # a --no_flowgnn checkpoint never needed shards
            from deepdfa_tpu_torch.pipeline import load_vocabs

            vocabs = load_vocabs(shard_dir)
            voc_dim = next(iter(vocabs.values())).input_dim
            if voc_dim != FeatureConfig().input_dim:
                raise SystemExit(
                    f"vocab input_dim {voc_dim} != config input_dim "
                    f"{FeatureConfig().input_dim} — the checkpoint and the "
                    "shard dir disagree")
        funcs, ids, scan_meta, scan_graphs, scan_errors = scan_sources(
            args.predict_source, vocabs, jcfg.use_gnn)
        labels = [0] * len(funcs)  # unknown: what is being predicted
        if not funcs:
            out = {"results": scan_errors, "n_scored": 0,
                   "n_errors": len(scan_errors)}
            print(json.dumps(out))
            return out
    elif args.dataset == "demo":
        from deepdfa_tpu_torch.data.codegen import demo_corpus

        rows = demo_corpus(60 if args.sample else 200, seed=0)
    else:
        from deepdfa_tpu_torch.data import ingest

        rows = ingest.ds(args.dataset, sample=args.sample)
    if not args.predict_source:
        funcs = [r["before"] for r in rows]
        labels = [int(r["vul"]) for r in rows]
        ids = [int(r["id"]) for r in rows]

    if args.hf_checkpoint:
        from deepdfa_tpu_torch.finetune_llm import hf_tokenizer

        tokenizer = hf_tokenizer(args.hf_checkpoint)
        llm_cfg, llm = hf_encoder(encoder_family, llm_cfg,
                                  args.hf_checkpoint, device)
    else:
        build = build_roberta if encoder_family == "roberta" else build_llama
        llm = build(llm_cfg, device, seed=0)
        tokenizer = HashTokenizer(vocab_size=llm_cfg.vocab_size)
    examples = encode_functions(funcs, labels, tokenizer, jcfg.block_size,
                                indices=ids)
    if scan_meta is not None:  # scan mode: every parsed function is scored
        train_ex = eval_ex = test_ex = examples
    else:
        train_ex, eval_ex, test_ex = split_examples(examples, jcfg.seed)

    join = None
    if jcfg.use_gnn and scan_graphs is not None:
        from deepdfa_tpu_torch.data.graphs import _round_up

        # budgets for the worst batch: eval_batch_size copies of the
        # largest scanned function
        mn = max(g.n_nodes for g in scan_graphs)
        me = max(g.n_edges for g in scan_graphs)
        join = GraphJoin(
            graphs={int(g.gid): g for g in scan_graphs},
            max_nodes=max(4096, _round_up(mn * jcfg.eval_batch_size + 2)),
            max_edges=max(8192, _round_up(me * jcfg.eval_batch_size)))
    elif jcfg.use_gnn:
        if not shard_dir.exists():
            raise SystemExit(
                f"no shards at {shard_dir} — run python -m "
                f"deepdfa_tpu_torch.preprocess --dataset {args.dataset} "
                f"first (or pass --no_flowgnn)")
        join = GraphJoin(graphs={int(g.gid): g
                                 for g in load_shards(shard_dir)})

    gnn_cfg = (_freeze_graph_cfg(args.freeze_graph) if args.freeze_graph
               else GGNNConfig())
    fusion = build_fusion(
        gnn_cfg, FeatureConfig().input_dim, llm_cfg.hidden_size,
        use_gnn=jcfg.use_gnn, dropout_rate=0.1,
        # bidirectional encoders summarise into the CLS (first real)
        # token, causal decoders into the last
        pool="cls" if encoder_family == "roberta" else "last",
        device=device, seed=jcfg.seed)
    run_dir = Path(args.output_dir) if args.output_dir else utils.get_dir(
        utils.storage_dir() / "joint_runs" / utils.get_run_id())
    trainer = JointTrainer(llm, fusion, jcfg, join, run_dir=run_dir)

    out: dict = {"run_dir": str(run_dir), "n_train": len(train_ex)}
    state = None
    if args.freeze_graph:
        from deepdfa_tpu_torch.train.checkpoint import (CheckpointManager,
                                                        encoder_partial_load)

        state = trainer._build(-(-len(train_ex) // jcfg.train_batch_size))
        ckpts = CheckpointManager(args.freeze_graph)
        restored = (ckpts.restore_best(map_location="cpu")
                    if ckpts.best_step() is not None
                    else ckpts.restore_latest(map_location="cpu"))
        enc = fusion.flowgnn_encoder
        enc.load_state_dict(encoder_partial_load(enc.state_dict(), restored))
        out["freeze_graph"] = str(args.freeze_graph)
    if args.do_train:
        state = trainer.train(train_ex, eval_ex, state=state)
        out["history"] = trainer.history
        out["num_missing"] = trainer.num_missing
    if args.do_test:
        if state is not None:
            params = state.params
        else:  # the newest epoch_* of the run (--load_checkpoint parity)
            newest = _newest_epoch(run_dir, "--do_test without --do_train")
            params = trainer.trained_module()
            params.load_state_dict(trainer.load(newest.name))
        out |= trainer.test(params, test_ex)
    if args.predict_source:
        newest = _newest_epoch(run_dir, "--predict-source")
        params = trainer.trained_module()
        params.load_state_dict(trainer.load(newest.name))
        _loss, probs, _labels = trainer._run_eval(params, examples)
        # _run_eval keeps the masked-in rows in batch order, and every
        # scanned function owns its graph, so probs align with scan_meta
        if len(probs) != len(scan_meta):
            raise RuntimeError(
                f"scan alignment broke: {len(probs)} probabilities for "
                f"{len(scan_meta)} functions (missing graphs?)")
        results = [{**meta, "vulnerable_probability": round(float(p), 6)}
                   for meta, p in zip(scan_meta, probs[:, 1])] + scan_errors
        out = {"results": results, "n_scored": len(scan_meta),
               "n_errors": len(scan_errors), "checkpoint": newest.name,
               "run_dir": str(run_dir)}
        (run_dir / "predictions.json").write_text(json.dumps(out, indent=2))
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
