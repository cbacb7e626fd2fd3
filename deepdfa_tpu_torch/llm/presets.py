"""Joint-model launch presets.

The presets of ``deepdfa_tpu/llm/presets.py`` as structured configs: the
five CodeLlama ones (the MSIVD launch scripts) and the two LineVul ones of
BASELINE config #3 (``linevul``: CodeBERT alone; ``linevul_fusion``:
CodeBERT fine-tuned with the frozen pretrained GGNN, CLS ⊕ pooled graph),
whose ``llm`` is a :class:`~deepdfa_tpu_torch.llm.roberta.RobertaConfig`
and ``encoder_family`` ``"roberta"``. ``finetuned`` marks presets that
start from a LoRA-finetuned model; ``mesh`` is the JAX package's mesh for
the preset (:class:`~deepdfa_tpu_torch.config.MeshConfig`, for
:func:`~deepdfa_tpu_torch.parallel.mesh.build_mesh` and the sharded LLM).
"""

from __future__ import annotations

import dataclasses

from deepdfa_tpu_torch.config import MeshConfig
from deepdfa_tpu_torch.llm.joint import JointConfig
from deepdfa_tpu_torch.llm.llama import LlamaConfig, codellama_7b, codellama_13b
from deepdfa_tpu_torch.llm.roberta import RobertaConfig, codebert_base

__all__ = ["JointPreset", "PRESETS"]


@dataclasses.dataclass(frozen=True)
class JointPreset:
    name: str
    llm: LlamaConfig | RobertaConfig  # RobertaConfig for "roberta"
    joint: JointConfig
    finetuned: bool  # load LoRA-finetuned weights first (--finetuned_path)
    mesh: MeshConfig
    dataset: str  # reference data family the preset targets
    # the stack under the fusion head: "llama" (causal, MSIVD) or "roberta"
    # (bidirectional CodeBERT, the LineVul configs)
    encoder_family: str = "llama"


PRESETS: dict[str, JointPreset] = {p.name: p for p in [
    # bigvul_ft_bigvul.sh — CodeLlama-7B finetuned, Big-Vul
    JointPreset(
        name="bigvul_ft_bigvul", llm=codellama_7b(),
        joint=JointConfig(block_size=256, epochs=5, train_batch_size=4,
                          eval_batch_size=4, learning_rate=1e-4,
                          dataset_style="bigvul"),
        finetuned=True,
        mesh=MeshConfig(dp=-1, fsdp=1, tp=1, sp=1), dataset="bigvul"),
    # pretrained_bigvul.sh — 13B pretrained, Big-Vul
    JointPreset(
        name="pretrained_bigvul", llm=codellama_13b(),
        joint=JointConfig(block_size=350, epochs=1, train_batch_size=8,
                          eval_batch_size=8, learning_rate=1e-4,
                          dataset_style="bigvul"),
        finetuned=False,
        mesh=MeshConfig(dp=-1, fsdp=2, tp=1, sp=1), dataset="bigvul"),
    # pb_ft_pb.sh — 13B + LoRA, PreciseBugs, long blocks (ring attention
    # on the TPU: its LLM config asks for attn_impl="ring")
    JointPreset(
        name="pb_ft_pb", llm=codellama_13b(lora_rank=16, attn_impl="ring"),
        joint=JointConfig(block_size=2048, epochs=1, train_batch_size=4,
                          eval_batch_size=4, learning_rate=1e-6,
                          dataset_style="precisebugs"),
        finetuned=True,
        mesh=MeshConfig(dp=1, fsdp=2, tp=1, sp=-1), dataset="precisebugs"),
    # pb_ft_pb_noexpl.sh — 13B-Instruct, no GNN
    JointPreset(
        name="pb_ft_pb_noexpl", llm=codellama_13b(),
        joint=JointConfig(block_size=1024, epochs=3, train_batch_size=6,
                          eval_batch_size=6, learning_rate=1e-6,
                          dataset_style="precisebugs", use_gnn=False),
        finetuned=True,
        mesh=MeshConfig(dp=-1, fsdp=2, tp=1, sp=1), dataset="precisebugs"),
    # pretrained_pb.sh — 13B pretrained, no GNN
    JointPreset(
        name="pretrained_pb", llm=codellama_13b(),
        joint=JointConfig(block_size=1024, epochs=5, train_batch_size=4,
                          eval_batch_size=4, learning_rate=1e-5,
                          dataset_style="precisebugs", use_gnn=False),
        finetuned=False,
        mesh=MeshConfig(dp=-1, fsdp=2, tp=1, sp=1), dataset="precisebugs"),
    # BASELINE config #3a — LineVul alone: fine-tuned CodeBERT classifier
    # (msr_train_linevul.sh: block 512, batch 16, lr 2e-5, 10 epochs)
    JointPreset(
        name="linevul", llm=codebert_base(),
        joint=JointConfig(block_size=512, epochs=10, train_batch_size=16,
                          eval_batch_size=16, learning_rate=2e-5,
                          dataset_style="bigvul", use_gnn=False,
                          train_llm=True),
        finetuned=False,
        mesh=MeshConfig(dp=-1, fsdp=1, tp=1, sp=1), dataset="bigvul", encoder_family="roberta"),
    # BASELINE config #3b — DeepDFA + LineVul (msr_train_combined.sh):
    # CodeBERT fine-tuned end to end, the pretrained GGNN frozen
    # (main_cli.py:136-145), CLS ⊕ pooled-graph head
    JointPreset(
        name="linevul_fusion", llm=codebert_base(),
        joint=JointConfig(block_size=512, epochs=10, train_batch_size=16,
                          eval_batch_size=16, learning_rate=2e-5,
                          dataset_style="bigvul", use_gnn=True,
                          train_llm=True, freeze_gnn=True),
        finetuned=False,
        mesh=MeshConfig(dp=-1, fsdp=1, tp=1, sp=1), dataset="bigvul", encoder_family="roberta"),
]}
