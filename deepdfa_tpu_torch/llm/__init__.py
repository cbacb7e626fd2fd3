"""The LLM tier: CodeLlama, the fusion head and the joint rescorer.

The port of the serving half of ``deepdfa_tpu/llm/``: ``llama.py`` (the
decoder with ``attn_impl`` ``"full"`` or ``"flash"`` — the latter on kernel
B6 — and int8-resident projections on kernel B5), ``lora.py``, ``quant.py``,
``convert.py`` (HF checkpoints from a local directory), ``fusion.py``,
``dataset.py``, ``joint.py`` (the evaluation step), ``joint_engine.py``
(``JointEngine``, the cascade's tier 2) and ``presets.py``. Training the
fusion head, LoRA fine-tuning, generation, RoBERTa and the ring attention
are not ported yet (ROADMAP A12).
"""
