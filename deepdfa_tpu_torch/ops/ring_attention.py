"""Plain softmax attention on one device.

The single-device part of ``deepdfa_tpu/ops/ring_attention.py``:
:func:`full_attention` (the LLM's ``attn_impl="full"`` and the path of a
sequence that is not a multiple of 128 under ``"flash"``) and
:func:`_repeat_kv`. Scores are float32, masked entries take ``_NEG_INF``
(a large negative number, not ``-inf``, so no NaN arises), and a query row
with no unmasked key returns zeros. The sequence-sharded ring itself waits
for multi-GPU (ROADMAP A11b).
"""

from __future__ import annotations

import torch

__all__ = ["full_attention"]

_NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: repeat KV heads to match query heads. [b, s, h_kv, d] ->
    [b, s, h, d]."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, kv_mask: torch.Tensor | None = None,
                   q_positions: torch.Tensor | None = None,
                   kv_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Plain softmax attention, float32 scores.

    q: [b, sq, h, d]; k/v: [b, sk, h_kv, d]; kv_mask: [b, sk] (True =
    attend). Positions default to ``arange`` and only matter for causal
    masking. The weights are rounded to ``v``'s type before the product
    with ``v``; the output is in ``q``'s type."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * d ** -0.5
    if causal:
        qpos = (torch.arange(sq, device=q.device) if q_positions is None
                else q_positions)
        kpos = (torch.arange(sk, device=q.device) if kv_positions is None
                else kv_positions)
        causal_mask = kpos[None, :] <= qpos[:, None]  # [sq, sk]
        scores = torch.where(causal_mask[None, None], scores,
                             torch.full_like(scores, _NEG_INF))
    if kv_mask is not None:
        scores = torch.where(kv_mask[:, None, None, :].bool(), scores,
                             torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    if kv_mask is not None:
        # fully-masked query rows would softmax to uniform over _NEG_INF
        # scores; return zeros for them instead
        row_valid = torch.any(scores > _NEG_INF / 2, dim=-1)  # [b, h, q]
        probs = torch.where(row_valid[..., None], probs,
                            torch.zeros_like(probs))
    out = torch.einsum("bhqk,bkhd->bqhd",
                       probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(v.dtype).to(q.dtype)
