#!/usr/bin/env python
"""Convert checkpoints of the JAX package (orbax) into the PyTorch port's.

Runs where the JAX run is, with both packages importable: it restores each
orbax tree with the JAX package's own readers and writes the port's
formats through the port's writers (the port's machine has no JAX, so
neither package holds this script).

- ``ggnn SRC_RUN DST_RUN``: the GGNN steps of a ``train.cli fit`` run
  (``SRC_RUN/checkpoints/{step:08d}/``, orbax ``state`` + ``aux`` and the
  ``meta.json`` sidecar) into ``DST_RUN/checkpoints`` through the port's
  ``CheckpointManager.save`` (``state.pt``, ``aux.pt``, ``meta.json``
  last, one rename): the parameters through ``bridge.flax_to_torch``;
  ``aux.pt`` holds the optax AdamW moments and count as a
  ``torch.optim.AdamW`` state dict, the step, and the generator state the
  port's ``fit`` seeds (a JAX PRNG key has no ``torch.Generator``
  equivalent, so random draws after a resume differ from the JAX run's);
  ``meta.json`` keeps the epoch, the metrics and the mesh. The run's
  ``journal.json`` and ``config.json`` are copied, so ``python -m
  deepdfa_tpu_torch.train.cli fit --resume --run-dir DST_RUN`` continues
  the run. ``--step N`` converts that step alone.
- ``lora SRC DST``: a LoRA adapter directory of ``LoraFinetuner.
  save_adapters`` into the port's (``state.pt`` + ``meta.json``), through
  ``bridge.llama_flax_to_torch``: ``LoraFinetuner.load_adapters`` reads it.
- ``fusion SRC DST``: a fusion checkpoint of ``JointTrainer.save``
  (``epoch_N``; the MSIVD fusion model, not a ``train_llm`` run's), or a
  run directory holding several, into the port's ``epoch_N`` directories
  through ``bridge.fusion_flax_to_torch``: ``JointEngine.from_run_dir``
  restores it.

The model configuration (the GGNN's widths, the feature vocabulary's size)
comes from ``--config`` (default ``SRC_RUN/config.json`` where the run
wrote one) and ``--set key=value`` overrides, as ``train.cli`` takes them.

Usage::

    python convert_jax_checkpoint.py ggnn runs/jax_fit runs/port_fit
    python convert_jax_checkpoint.py lora run/adapters_epoch_0 out/adapters
    python convert_jax_checkpoint.py fusion joint_run port_joint_run \\
        --set data.feature.limit_all=1000
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

__all__ = ["convert_fusion", "convert_ggnn", "convert_lora", "main"]


def _restore(path: Path):
    """An orbax tree as nested dicts of numpy arrays (None leaves, which
    ``split_lora`` leaves for the base, dropped)."""
    import jax
    import orbax.checkpoint as ocp

    tree = ocp.PyTreeCheckpointer().restore(Path(path).absolute())
    return _prune(jax.tree.map(np.asarray, tree))


def _prune(node):
    if isinstance(node, dict):
        out = {k: _prune(v) for k, v in node.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    if isinstance(node, (list, tuple)):
        return [_prune(v) for v in node]
    if node is None or (isinstance(node, np.ndarray) and node.dtype == object
                        and node.shape == () and node.item() is None):
        return None
    return node


def _adam_state(opt_state):
    """The ``{count, mu, nu}`` node of an optax AdamW state (inside the
    chain with or without the global-norm clip)."""
    if isinstance(opt_state, dict):
        if {"mu", "nu", "count"} <= set(opt_state):
            return opt_state
        nodes = opt_state.values()
    elif isinstance(opt_state, (list, tuple)):
        nodes = opt_state
    else:
        return None
    for node in nodes:
        found = _adam_state(node)
        if found is not None:
            return found
    return None


def _config(src: Path, config: str | None, sets: list[str]):
    from deepdfa_tpu_torch.config import load_config
    from deepdfa_tpu_torch.serve.server import parse_overrides

    layers = [config] if config else [
        p for p in (src / "config.json",) if p.is_file()]
    return load_config(*layers, overrides=parse_overrides(sets))


def convert_ggnn(src: str | Path, dst: str | Path, cfg,
                 step: int | None = None) -> list[int]:
    """Every committed step of the JAX run ``src`` (or ``step`` alone) as
    a step of the port's run ``dst``; returns the steps written."""
    import torch

    from deepdfa_tpu.train.checkpoint import CheckpointManager as JaxManager
    from deepdfa_tpu_torch import bridge
    from deepdfa_tpu_torch.models import make_model
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
    from deepdfa_tpu_torch.train.loop import Trainer

    src, dst = Path(src), Path(dst)
    jax_ckpts = JaxManager(src / "checkpoints", cfg.checkpoint)
    steps = jax_ckpts.steps if step is None else [int(step)]
    if not steps:
        raise FileNotFoundError(f"no committed step under {src}/checkpoints")
    out = CheckpointManager(dst / "checkpoints", cfg.checkpoint)
    written = []
    for s in steps:
        meta = jax_ckpts.meta(s)
        params = _restore(jax_ckpts.dir / f"{s:08d}" / "state")["params"]
        aux = _restore(jax_ckpts.dir / f"{s:08d}" / "aux")
        state = bridge.flax_to_torch(params, cfg.model, cfg.input_dim)
        model = make_model(cfg.model, cfg.input_dim, device="cpu")
        model.load_state_dict(state)
        trainer = Trainer(model, cfg)
        train_state = trainer.init_state()
        adam = _adam_state(aux["opt_state"])
        if adam is None:
            raise ValueError(f"step {s}: no AdamW moments in its aux payload")
        mu = bridge.flax_to_torch(adam["mu"], cfg.model, cfg.input_dim)
        nu = bridge.flax_to_torch(adam["nu"], cfg.model, cfg.input_dim)
        count = float(np.asarray(adam["count"]))
        for name, p in model.named_parameters():
            train_state.optimizer.state[p] = {
                "step": torch.tensor(count), "exp_avg": mu[name].clone(),
                "exp_avg_sq": nu[name].clone()}
        new_aux = {"optimizer": train_state.optimizer.state_dict(),
                   "rng": train_state.rng.get_state(),
                   "step": int(np.asarray(aux["step"]))}
        out.save(s, state, metrics=meta.get("metrics"),
                 epoch=meta.get("epoch"), aux=new_aux,
                 preempted=meta.get("preempted"), force=True,
                 mesh=meta.get("mesh"))
        written.append(s)
    for name in ("journal.json", "config.json"):
        if (src / name).is_file():
            shutil.copyfile(src / name, dst / name)
    return written


def convert_lora(src: str | Path, dst: str | Path) -> Path:
    """A JAX adapter directory as the port's (``dst`` is written as
    ``LoraFinetuner.save_adapters`` writes ``{run_dir}/{name}``)."""
    from deepdfa_tpu_torch import bridge
    from deepdfa_tpu_torch.llm.joint import commit_state_dir

    adapters = bridge.llama_flax_to_torch(_restore(src))
    return commit_state_dir(dst, adapters, {"adapters": sorted(adapters)})


def convert_fusion(src: str | Path, dst: str | Path, cfg) -> list[Path]:
    """A JAX fusion checkpoint (or a run directory of ``epoch_N`` ones) as
    the port's ``epoch_N`` directories; returns them."""
    from deepdfa_tpu_torch import bridge
    from deepdfa_tpu_torch.llm.joint import commit_state_dir

    src, dst = Path(src), Path(dst)
    epochs = sorted(p for p in src.iterdir()
                    if p.is_dir() and re.fullmatch(r"epoch_\d+", p.name))
    pairs = ([(p, dst / p.name) for p in epochs] if epochs
             else [(src, dst)])
    written = []
    for s, d in pairs:
        tree = _restore(s)
        if "fusion" in tree:
            raise ValueError(f"{s} holds a train_llm run's fusion model and "
                             "encoder: only the MSIVD fusion model converts")
        state = bridge.fusion_flax_to_torch(tree, cfg.model, cfg.input_dim)
        m = re.fullmatch(r"epoch_(\d+)", d.name)
        meta = {"name": d.name, **({"epoch": int(m.group(1))} if m else {})}
        written.append(commit_state_dir(d, state, meta))
    return written


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Convert JAX (orbax) checkpoints into the PyTorch "
                    "port's format.")
    ap.add_argument("kind", choices=("ggnn", "lora", "fusion"))
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--step", type=int, default=None,
                    help="ggnn: convert this step alone")
    ap.add_argument("--config", default=None,
                    help="the run's config (default SRC/config.json)")
    ap.add_argument("--set", action="append", default=[], dest="overrides")
    args = ap.parse_args(argv)
    src = Path(args.src)
    if args.kind == "ggnn":
        cfg = _config(src, args.config, args.overrides)
        out = {"steps": convert_ggnn(src, args.dst, cfg, args.step)}
    elif args.kind == "lora":
        out = {"path": str(convert_lora(src, args.dst))}
    else:
        cfg = _config(src, args.config, args.overrides)
        out = {"paths": [str(p) for p in convert_fusion(src, args.dst, cfg)]}
    result = {"kind": args.kind, "src": str(src), "dst": str(args.dst), **out}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
