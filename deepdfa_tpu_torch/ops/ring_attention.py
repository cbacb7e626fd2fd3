"""Plain softmax attention, on one device and sequence-sharded as a ring.

The port of ``deepdfa_tpu/ops/ring_attention.py``:

- :func:`full_attention`, the LLM's ``attn_impl="full"`` and the path of a
  sequence that is not a multiple of 128 under ``"flash"``;
- :func:`ring_attention`, one rank's part of ``attn_impl="ring"``: the
  sequence is split over the ranks of an ``sp`` process group, each holding
  one contiguous block of queries, keys and values; the key/value blocks
  travel around the ring (one ``batch_isend_irecv`` a step,
  :func:`~deepdfa_tpu_torch.parallel.comm.ring_pass`) while each rank
  merges them into its queries' online softmax in float32, the causal mask
  taken from global positions;
- :func:`ring_attention_sharded`, the same from whole tensors: each rank
  takes its ``dp``/``sp`` block and the result is gathered back.

Scores are float32, masked entries take ``_NEG_INF`` (a large negative
number, not ``-inf``, so no NaN arises), GQA repeats the key/value heads
(:func:`_repeat_kv`), and a query row with no unmasked key returns zeros
(and zero gradients).
The ring is plain torch, as it is plain jnp in the JAX package. Its
backward is autograd through the ring: ``ring_pass`` hands each key/value
block's gradient back to the rank it came from, as ``jax.grad`` of the JAX
ring's ``lax.ppermute`` does. Autograd keeps each step's scores
(``[b, h, s_loc, s_loc]`` float32 a step) for the backward; a blockwise
backward that recomputes them is ROADMAP speed work.
"""

from __future__ import annotations

import torch

from deepdfa_tpu_torch.parallel import comm

__all__ = ["full_attention", "ring_attention", "ring_attention_sharded"]

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


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group=None, causal: bool = True,
                   kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """One rank's ring attention over the ``sp`` process group ``group``
    (None: one rank, the whole sequence here).

    q: [b, s_loc, h, d]; k/v: [b, s_loc, h_kv, d]; kv_mask: [b, s_loc] (this
    rank's blocks: rank ``i`` of ``n`` holds global positions ``[i·s_loc,
    (i+1)·s_loc)``). Each of the ``n`` steps scores the key block in hand,
    merges it into the running maximum, sum and output, and passes the
    block (keys, values, mask) on to the next rank. The output is in
    ``q``'s type."""
    import torch.distributed as dist

    n = 1 if group is None else dist.get_world_size(group)
    idx = 0 if group is None else dist.get_rank(group)
    b, s_loc, h, d = q.shape
    n_rep = h // k.shape[2]
    qf = q.to(torch.float32)
    local = torch.arange(s_loc, device=q.device)
    q_pos = idx * s_loc + local
    m = torch.full((b, h, s_loc), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    m_blk = (torch.ones((b, s_loc), dtype=torch.uint8, device=q.device)
             if kv_mask is None else kv_mask.to(torch.uint8))
    for j in range(n):
        src = (idx - j) % n  # the rank this key/value block started on
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, _repeat_kv(
            k_blk, n_rep).to(torch.float32)) * d ** -0.5
        allowed = m_blk.bool()[:, None, None, :]  # [b, 1, 1, k]
        if causal:
            k_pos = src * s_loc + local
            allowed = allowed & (k_pos[None, :] <= q_pos[:, None])[None, None]
        scores = torch.where(allowed, scores, torch.full_like(scores,
                                                              _NEG_INF))
        # online softmax (the flash recurrence) in float32; p is zeroed on
        # disallowed keys explicitly: a row with no key so far has
        # m_new == _NEG_INF, where exp(scores - m_new) would be 1
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None]) * allowed
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, _repeat_kv(
            v_blk, n_rep).to(torch.float32))
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
        if j < n - 1:
            k_blk, v_blk, m_blk = comm.ring_pass((k_blk, v_blk, m_blk), group)
    l_t = l.transpose(1, 2)[..., None]  # [b, q, h, 1]
    out = torch.where(l_t > 0, acc / torch.clamp(l_t, min=1e-30),
                      torch.zeros_like(acc))
    return out.to(q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh, *, causal: bool = True,
                           kv_mask: torch.Tensor | None = None,
                           batch_axis: str = "dp",
                           seq_axis: str = "sp") -> torch.Tensor:
    """Whole-tensor entry point over ``mesh`` (a :class:`~deepdfa_tpu_torch.
    parallel.mesh.Mesh` with one device per rank): this rank takes its block
    of the batch over ``batch_axis`` and of the sequence over ``seq_axis``,
    runs :func:`ring_attention` over the ``seq_axis`` group, and every rank
    gets the whole output back (whose backward hands each rank its own
    block's gradient: ``comm``'s convention)."""
    for axis in (batch_axis, seq_axis):
        if mesh.axes[axis] > 1 and axis not in mesh.groups:
            raise ValueError(f"{axis}={mesh.axes[axis]} needs one process "
                             f"per device (a mesh over a process group)")
    rows = mesh.block(q.shape[0], batch_axis, "the batch")
    cols = mesh.block(q.shape[1], seq_axis, "the sequence")
    mask = None if kv_mask is None else kv_mask[rows, cols]
    out = ring_attention(q[rows, cols], k[rows, cols], v[rows, cols],
                         group=mesh.groups.get(seq_axis), causal=causal,
                         kv_mask=mask)
    out = comm.all_gather(out, mesh.groups.get(seq_axis), dim=1)
    return comm.all_gather(out, mesh.groups.get(batch_axis), dim=0)
