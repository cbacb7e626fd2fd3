"""Batch text generation with the KV cache.

The port of ``deepdfa_tpu/llm/generate.py`` (the reference's
``hf_inference`` helper: batch generation over padded prompts, sampling on
by default, stop at eos, only the new suffix returned):

- one single-token decode step per position, ``prompt_len +
  max_new_tokens - 1`` of them: prompt positions teacher-force the next
  token from the prompt, later ones feed back the sampled token (no
  separate prefill, as in the JAX package's ``lax.scan``);
- left-padded prompts make positions uniform across the batch; a pad
  token's slot is marked invalid in the cache, so no later step attends to
  it;
- rows that emitted eos keep stepping, and their later tokens are
  overwritten with eos;
- the cache (:class:`~deepdfa_tpu_torch.llm.llama.KVCache`) holds
  ``prompt_len + max_new_tokens`` slots, not ``max_position_embeddings``:
  the JAX package's cache of 16,384 slots would be 34.4 GB at CodeLlama-7B
  and batch 4, all of it read on every step; masked slots add exact zeros,
  so the tokens are the same.

Sampling draws from an explicit ``torch.Generator`` (``torch.multinomial``
over the softmax); it cannot give ``jax.random.categorical``'s draws from
the same seed. Greedy decoding (``do_sample=False`` or ``temperature <=
0``) is the same function in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deepdfa_tpu_torch.llm.llama import KVCache

__all__ = ["GenerateConfig", "generate", "sample_tokens"]


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    """Defaults mirror ``hf_inference``: ``max_new_tokens=512,
    do_sample=True``."""

    max_new_tokens: int = 512
    do_sample: bool = True
    temperature: float = 0.8
    top_k: int = 0  # 0 = full distribution
    eos_token_id: int = 2


def filtered_logits(logits: torch.Tensor,
                    cfg: GenerateConfig) -> torch.Tensor:
    """Logits over the temperature, with every logit below the ``top_k``-th
    largest of its row set to -inf (ties at the ``top_k``-th stay, as in the
    JAX package's ``_sample``)."""
    logits = logits / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -cfg.top_k][..., None]
        logits = torch.where(logits >= kth, logits,
                             torch.full_like(logits, float("-inf")))
    return logits


def sample_tokens(logits: torch.Tensor, cfg: GenerateConfig,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Next tokens ``[b]`` of float32 logits ``[b, vocab]``: the argmax
    when not sampling, else one draw per row from the softmax of
    :func:`filtered_logits` by ``generator``."""
    if not cfg.do_sample or cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filtered_logits(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(model, input_ids, pad_mask,
             cfg: GenerateConfig = GenerateConfig(),
             generator: torch.Generator | None = None,
             scores: list | None = None) -> np.ndarray:
    """The generated suffix ``[b, max_new_tokens]`` (int32 numpy) of the
    left-padded prompts ``input_ids`` ``[b, s]`` (``pad_mask`` True = real
    token), eos-padded after each row finishes. ``model`` is a
    ``LlamaForCausalLM`` holding its weights; the prompts go to its
    device. ``scores``, when given, receives the float32 logits ``[b,
    vocab]`` of each generation position (HF's ``output_scores``), on the
    model's device."""
    dev = next(model.parameters()).device
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=dev)
    mask = torch.as_tensor(np.asarray(pad_mask), dtype=torch.bool, device=dev)
    b, s = ids.shape
    total = s + cfg.max_new_tokens - 1
    if total + 1 > model.cfg.max_position_embeddings:
        raise ValueError(
            f"prompt {s} + max_new_tokens {cfg.max_new_tokens} exceeds "
            f"max_position_embeddings {model.cfg.max_position_embeddings}")
    cache = KVCache.empty(model.cfg, b, s + cfg.max_new_tokens, dev)
    eos = torch.full((b,), cfg.eos_token_id, dtype=torch.long, device=dev)
    tok = torch.zeros(b, dtype=torch.long, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    out = []
    for t in range(total):
        in_prompt = t < s
        cur = ids[:, t] if in_prompt else tok
        valid = mask[:, t] if in_prompt else torch.ones_like(done)
        logits, cache = model(cur[:, None], valid[:, None], decode=True,
                              cache=cache)
        nxt = sample_tokens(logits[:, 0, :], cfg, generator)
        tok = torch.where(done, eos, nxt)
        if t >= s - 1:  # generation positions: t = s-1 predicts token s
            done = done | (nxt == cfg.eos_token_id)
            out.append(tok)
            if scores is not None:
                scores.append(logits[:, 0, :])
    return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
