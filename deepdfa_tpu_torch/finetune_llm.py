"""Self-instruct multitask LoRA fine-tuning: BASELINE config #4.

A copy of ``scripts/finetune_llm.py``: the same flags and the same JSON
keys, run as ``python -m deepdfa_tpu_torch.finetune_llm`` on ``--device``
(``cuda`` unless another is named). It produces the adapter checkpoints
(``{output_dir}/adapters_epoch_{N}/``) that a ``finetuned`` joint preset
starts from.

Two weight sources:

- ``--hf-checkpoint DIR`` (with ``--preset diversevul_multitask``): a
  local HF CodeLlama checkpoint, converted with no renaming
  (:mod:`~deepdfa_tpu_torch.llm.convert`), fresh adapters grafted on
  (``A`` N(0, 1/rank), ``B`` zero), tokenized by ``transformers``, which
  must be installed (an error names it otherwise), tuned on the dataset's
  multitask dialogues (detection, CWE type, explanation; response-only
  loss);
- default: a tiny seeded model and the hash tokenizer over the generated
  demo corpus, whose explanation column comes from the planted bug's
  removed line (the generator plants the bug, so that line is the ground
  truth).

Usage: python -m deepdfa_tpu_torch.finetune_llm --dataset demo --sample
[--epochs 2] [--device cpu]
       python -m deepdfa_tpu_torch.finetune_llm --preset
       diversevul_multitask --hf-checkpoint DIR [--data-file FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

__all__ = ["demo_rows", "graft_adapters", "hf_llama", "hf_tokenizer", "main",
           "multitask_examples"]


def demo_rows(n: int, seed: int = 0) -> list[dict]:
    """The demo corpus with ``cwe`` and ``message`` columns: CWE-787 and
    ``"out-of-bounds write at line {L}: {text}"`` of the planted bug's
    removed line for a vulnerable row, empty otherwise."""
    from deepdfa_tpu_torch.data.codegen import demo_corpus

    rows = demo_corpus(n, seed=seed)
    for row in rows:
        vul, removed = row["vul"], row["removed"]
        row["cwe"] = "CWE-787" if vul else ""
        row["message"] = ""
        if vul and removed:
            lines = str(row["before"]).splitlines()
            ln = int(removed[0])  # 1-based line of the planted bug
            text = lines[ln - 1].strip() if 0 < ln <= len(lines) else ""
            row["message"] = f"out-of-bounds write at line {ln}: {text}"
    return rows


def multitask_examples(rows: list[dict], tokenizer, block_size: int):
    """:class:`~deepdfa_tpu_torch.llm.selfinstruct.LMExamples` of the
    rows' multitask dialogues (``before``, ``vul``, ``cwe``, ``message``,
    ``id``)."""
    from deepdfa_tpu_torch.llm.selfinstruct import encode_multitask

    return encode_multitask(
        [r["before"] for r in rows], [r["vul"] for r in rows], tokenizer,
        block_size, cwes=[r.get("cwe", "") for r in rows],
        explanations=[r.get("message", "") for r in rows],
        indices=[r["id"] for r in rows])


def graft_adapters(model, seed: int = 1) -> list[str]:
    """Draw every LoRA adapter of ``model`` in place (``lora_a`` N(0,
    1/rank), ``lora_b`` zero: the adapters start as a no-op), on the
    model's device from ``seed``; returns their names."""
    import torch

    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    names = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_a"):
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            elif name.endswith("lora_b"):
                p.zero_()
            else:
                continue
            names.append(name)
    return names


def hf_tokenizer(ckpt_dir: str):
    """The checkpoint's tokenizer through ``transformers``; without the
    package the run stops, naming it."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise SystemExit(
            f"--hf-checkpoint needs the checkpoint's tokenizer from the "
            f"'transformers' package, which does not import here ({e})")
    return AutoTokenizer.from_pretrained(ckpt_dir)


def hf_llama(ckpt_dir, device, cls=None, **overrides):
    """The local HF CodeLlama checkpoint ``ckpt_dir`` as ``cls``
    (``LlamaForCausalLM`` by default; ``LlamaModel`` drops the LM head) on
    ``device``: the architecture from its ``config.json`` with
    ``overrides`` (``lora_rank`` and the like) laid over it, fresh
    adapters grafted on. Returns the model."""
    from deepdfa_tpu_torch.llm.convert import (convert_state_dict,
                                               load_hf_config,
                                               load_torch_state)
    from deepdfa_tpu_torch.llm.llama import (LlamaForCausalLM, LlamaModel,
                                             build_llama)

    cls = cls or LlamaForCausalLM
    cfg = dataclasses.replace(load_hf_config(ckpt_dir), **overrides)
    model = build_llama(cfg, device, seed=None, cls=cls)
    missing, unexpected = model.load_state_dict(convert_state_dict(
        load_torch_state(ckpt_dir), bare=cls is LlamaModel), strict=False)
    grafted = graft_adapters(model)
    if unexpected or sorted(missing) != sorted(grafted):
        raise ValueError(
            f"{ckpt_dir}: the checkpoint does not fit the model: missing "
            f"{sorted(set(missing) - set(grafted))}, unexpected "
            f"{sorted(unexpected)}")
    return model


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m deepdfa_tpu_torch.finetune_llm")
    parser.add_argument("--dataset", default="demo")
    parser.add_argument("--preset", default=None,
                        help="one of llm.selfinstruct.FINETUNE_PRESETS")
    parser.add_argument("--hf-checkpoint", default=None)
    parser.add_argument("--data-file", default=None,
                        help="dataset file override (e.g. diversevul.json)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--block_size", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--lora_rank", type=int, default=None)
    parser.add_argument("--sample", action="store_true")
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from deepdfa_tpu_torch import resolve_device, utils
    from deepdfa_tpu_torch.llm.dataset import HashTokenizer
    from deepdfa_tpu_torch.llm.finetune import FinetuneConfig, LoraFinetuner
    from deepdfa_tpu_torch.llm.llama import (LlamaForCausalLM, build_llama,
                                             tiny_llama)
    from deepdfa_tpu_torch.llm.selfinstruct import FINETUNE_PRESETS

    device = resolve_device(args.device)
    preset = FINETUNE_PRESETS[args.preset] if args.preset else None
    dataset = args.dataset if preset is None else preset.dataset
    block_size = args.block_size or (preset.block_size if preset else 128)
    lora_rank = args.lora_rank or (preset.lora_rank if preset else 4)
    lr = args.learning_rate or (preset.learning_rate if preset else 1e-3)
    epochs = args.epochs or (preset.epochs if preset else 1)
    batch_size = args.batch_size or (preset.batch_size if preset else 4)

    if dataset == "demo":
        rows = demo_rows(40 if args.sample else 160)
    else:
        from deepdfa_tpu_torch.data import ingest

        kw = {}
        if args.data_file:  # the readers name their source by format
            kw = {"csv_path" if dataset == "bigvul" else "json_path":
                  args.data_file}
        rows = ingest.ds(dataset, sample=args.sample, **kw)

    if args.hf_checkpoint:
        tokenizer = hf_tokenizer(args.hf_checkpoint)
        model = hf_llama(args.hf_checkpoint, device, lora_rank=lora_rank)
    else:
        cfg = tiny_llama(vocab_size=2048, lora_rank=lora_rank)
        tokenizer = HashTokenizer(vocab_size=cfg.vocab_size)
        model = build_llama(cfg, device, seed=0, cls=LlamaForCausalLM)

    examples = multitask_examples(rows, tokenizer, block_size)
    run_dir = Path(args.output_dir) if args.output_dir else utils.get_dir(
        utils.storage_dir() / "finetune_runs" / utils.get_run_id())
    tuner = LoraFinetuner(model, FinetuneConfig(
        learning_rate=lr, epochs=epochs, batch_size=batch_size), run_dir)
    _, losses = tuner.train(examples)

    frac = float(examples.loss_mask.sum() / max(examples.pad_mask.sum(), 1))
    out = {
        "run_dir": str(run_dir),
        "preset": args.preset,
        "dataset": dataset,
        "n_examples": len(examples),
        "block_size": block_size,
        "lora_rank": lora_rank,
        "epoch_losses": losses,
        "frac_tokens_graded": round(frac, 4),
        "adapters": str(run_dir / f"adapters_epoch_{epochs - 1}"),
    }
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
