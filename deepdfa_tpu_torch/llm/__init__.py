"""The LLM tier: CodeLlama, LoRA fine-tuning, the fusion head, the joint
trainer and the joint rescorer.

The port of ``deepdfa_tpu/llm/``: ``llama.py`` (the decoder with
``attn_impl`` ``"full"`` or ``"flash"`` — the latter on kernels B6 forward
and B6b backward — and int8-resident projections on kernel B5),
``lora.py``, ``finetune.py`` (``LoraFinetuner``), ``quant.py``,
``convert.py`` (HF checkpoints from a local directory), ``fusion.py``,
``dataset.py``, ``joint.py`` (``JointTrainer`` and the evaluation step),
``joint_engine.py`` (``JointEngine``, the cascade's tier 2),
``presets.py`` (the CodeLlama and LineVul presets), ``generate.py`` (batch
generation on the KV cache), ``selfinstruct.py`` (the multitask
self-instruct data) and ``roberta.py`` (the CodeBERT encoder of LineVul).
``dataset.GraphJoin`` joins segment or dense graph batches. Over a mesh
the decoder runs sharded (``fsdp``, ``tp``, ``sp`` with ring attention)
and ``JointEngine.from_run_dir(mesh=)`` scores on it.
"""
