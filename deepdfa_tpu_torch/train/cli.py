"""The trainer's command line: ``python -m deepdfa_tpu_torch.train.cli``.

The port of ``deepdfa_tpu/train/cli.py``, one command so far:

- ``export --run-dir <fit run>``: :func:`export_model`, the run's trained
  GGNN as a ``torch.export`` artifact in ``<run-dir>/export``
  (:mod:`deepdfa_tpu_torch.serving`), served by ``python -m
  deepdfa_tpu_torch.serve.server --artifact`` and scanned by
  ``python -m deepdfa_tpu_torch.scan --artifact``.

``fit``, ``test``, ``analyze``, ``predict``, ``trace`` and ``bench`` raise
"ROADMAP A4"; ``serve`` and ``scan`` have entry points of their own.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path

from deepdfa_tpu_torch.config import ExperimentConfig

__all__ = ["COMMANDS", "export_model", "main"]

logger = logging.getLogger(__name__)

# the JAX package's commands; only export is ported
COMMANDS = ("fit", "test", "analyze", "predict", "export", "serve", "trace",
            "bench", "scan")


def export_model(cfg: ExperimentConfig, run_dir: Path,
                 ckpt_dir: Path | None = None,
                 shard_dir: Path | None = None, device=None) -> dict:
    """Write the trained scoring forward of a ``train.fit`` run to
    ``run_dir/export`` (``model.pt2`` + ``manifest.json``), parameters
    inside, loadable without the model code. Restores the best checkpoint,
    else the latest, as ``from_checkpoint`` and predict do, into the fused
    layout, and traces it on ``device`` (``cuda`` unless the caller names
    another) at the config's ceiling shapes. The manifest records the
    checkpoint's provenance and the content hash of the vocabularies in
    ``shard_dir`` (default: the config's processed dataset dir; none
    readable gives ``vocab_hash`` null). Prints and returns ``{"export_dir",
    "pt2_bytes", **provenance}``."""
    from deepdfa_tpu_torch import resolve_device, utils
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
    state = (ckpts.restore_best(map_location="cpu") if best is not None
             else ckpts.restore_latest(map_location="cpu"))
    provenance = {
        "checkpoint_dir": str(ckpt_dir),
        "restored": "best" if best is not None else "latest",
        "step": int(best if best is not None else ckpts.latest_step()),
    }
    # stale-artifact guard: the training vocabularies' content hash
    if shard_dir is None:
        sample = "_sample" if cfg.data.sample else ""
        shard_dir = utils.processed_dir() / cfg.data.dsname / f"shards{sample}"
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


def main(argv=None) -> dict:
    """``python -m deepdfa_tpu_torch.train.cli export --run-dir <fit run>``
    with the JAX package's ``--config``, ``--set`` and ``--ckpt-dir``,
    plus ``--shard-dir`` and ``--device``. A run dir's ``config.json``,
    when it has one, is the base config layer."""
    import argparse

    from deepdfa_tpu_torch.config import load_config
    from deepdfa_tpu_torch.serve.server import parse_overrides

    parser = argparse.ArgumentParser(prog="deepdfa-tpu-torch")
    parser.add_argument("command", choices=COMMANDS)
    parser.add_argument("--config", action="append", default=[],
                        help="layered config files (later files win)")
    parser.add_argument("--set", action="append", default=[], dest="overrides",
                        help="dotted overrides, e.g. --set model.n_steps=5")
    parser.add_argument("--run-dir", default=None,
                        help="the fit run dir (export writes <run-dir>/export)")
    parser.add_argument("--ckpt-dir", default=None,
                        help="checkpoint dir (default: <run-dir>/checkpoints)")
    parser.add_argument("--shard-dir", default=None,
                        help="shard dir holding vocab.json (default: the "
                             "config's processed dataset dir)")
    parser.add_argument("--device", default=None,
                        help="torch device the export traces on "
                             "(default: cuda)")
    args = parser.parse_args(argv)
    if args.command != "export":
        raise NotImplementedError(
            f"the {args.command!r} command is not ported yet: ROADMAP A4 "
            "(serve and scan: python -m deepdfa_tpu_torch.serve.server, "
            "python -m deepdfa_tpu_torch.scan)")
    if not args.run_dir:
        parser.error("export requires --run-dir")
    layers = list(args.config)
    saved = Path(args.run_dir) / "config.json"
    if saved.exists():
        layers.insert(0, saved)
    cfg = load_config(*layers, overrides=parse_overrides(args.overrides))
    logging.basicConfig(level=logging.INFO)
    return export_model(
        cfg, Path(args.run_dir),
        ckpt_dir=Path(args.ckpt_dir) if args.ckpt_dir else None,
        shard_dir=Path(args.shard_dir) if args.shard_dir else None,
        device=args.device)


if __name__ == "__main__":
    main()
