"""Joint-model launch presets.

The five CodeLlama presets of ``deepdfa_tpu/llm/presets.py`` (the MSIVD
launch scripts) as structured configs. ``finetuned`` marks presets that
start from a LoRA-finetuned model. The JAX package's mesh suggestions are
not carried (multi-GPU is ROADMAP A11). The two LineVul presets
(``linevul``, ``linevul_fusion``) run the RoBERTa encoder, which is not
ported yet: looking them up raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

from deepdfa_tpu_torch.llm.joint import JointConfig
from deepdfa_tpu_torch.llm.llama import LlamaConfig, codellama_7b, codellama_13b

__all__ = ["JointPreset", "PRESETS"]


@dataclasses.dataclass(frozen=True)
class JointPreset:
    name: str
    llm: LlamaConfig
    joint: JointConfig
    finetuned: bool  # load LoRA-finetuned weights first (--finetuned_path)
    dataset: str  # reference data family the preset targets
    encoder_family: str = "llama"


_NOT_PORTED = ("linevul", "linevul_fusion")


class _Presets(dict):
    def __missing__(self, name):
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"preset {name!r} runs the RoBERTa encoder (llm/roberta.py), "
                "which is not ported yet (ROADMAP A12)")
        raise KeyError(name)


PRESETS: dict[str, JointPreset] = _Presets({p.name: p for p in [
    # bigvul_ft_bigvul.sh — CodeLlama-7B finetuned, Big-Vul
    JointPreset(
        name="bigvul_ft_bigvul", llm=codellama_7b(),
        joint=JointConfig(block_size=256, epochs=5, train_batch_size=4,
                          eval_batch_size=4, learning_rate=1e-4,
                          dataset_style="bigvul"),
        finetuned=True, dataset="bigvul"),
    # pretrained_bigvul.sh — 13B pretrained, Big-Vul
    JointPreset(
        name="pretrained_bigvul", llm=codellama_13b(),
        joint=JointConfig(block_size=350, epochs=1, train_batch_size=8,
                          eval_batch_size=8, learning_rate=1e-4,
                          dataset_style="bigvul"),
        finetuned=False, dataset="bigvul"),
    # pb_ft_pb.sh — 13B + LoRA, PreciseBugs, long blocks (ring attention
    # on the TPU: its LLM config asks for attn_impl="ring")
    JointPreset(
        name="pb_ft_pb", llm=codellama_13b(lora_rank=16, attn_impl="ring"),
        joint=JointConfig(block_size=2048, epochs=1, train_batch_size=4,
                          eval_batch_size=4, learning_rate=1e-6,
                          dataset_style="precisebugs"),
        finetuned=True, dataset="precisebugs"),
    # pb_ft_pb_noexpl.sh — 13B-Instruct, no GNN
    JointPreset(
        name="pb_ft_pb_noexpl", llm=codellama_13b(),
        joint=JointConfig(block_size=1024, epochs=3, train_batch_size=6,
                          eval_batch_size=6, learning_rate=1e-6,
                          dataset_style="precisebugs", use_gnn=False),
        finetuned=True, dataset="precisebugs"),
    # pretrained_pb.sh — 13B pretrained, no GNN
    JointPreset(
        name="pretrained_pb", llm=codellama_13b(),
        joint=JointConfig(block_size=1024, epochs=5, train_batch_size=4,
                          eval_batch_size=4, learning_rate=1e-5,
                          dataset_style="precisebugs", use_gnn=False),
        finetuned=False, dataset="precisebugs"),
]})
