"""The collectives of the sharded LLM over ``torch.distributed`` groups.

Each takes the process group of one mesh axis (None: the axis has one
member, and the call returns its input). NCCL takes CUDA tensors as they
are; gloo, which ranks sharing one card use, takes host tensors only for
point-to-point calls, so every CUDA tensor is staged through host memory
there (the computation around the call stays on the card).
"""

from __future__ import annotations

import torch

__all__ = ["all_gather", "all_reduce", "ring_pass"]


def _staged(x: torch.Tensor, group) -> bool:
    import torch.distributed as dist

    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group``'s ranks in place and return it (every
    caller passes a buffer it has just made)."""
    import torch.distributed as dist

    if group is None:
        return x
    if _staged(x, group):
        host = x.cpu()
        dist.all_reduce(host, group=group)
        return x.copy_(host)
    dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``group``'s ranks' ``x`` concatenated along ``dim`` in rank order."""
    import torch.distributed as dist

    if group is None:
        return x
    src = (x.cpu() if _staged(x, group) else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def ring_pass(tensors: tuple, group) -> tuple:
    """Send ``tensors`` to the next rank of ``group`` and return those the
    previous rank sent (one ``batch_isend_irecv``)."""
    import torch.distributed as dist

    if group is None:
        return tensors
    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    staged = [(t.cpu() if _staged(t, group) else t).contiguous()
              for t in tensors]
    bufs = [torch.empty_like(t) for t in staged]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in staged]
    ops += [dist.P2POp(dist.irecv, b, prv, group) for b in bufs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(b.to(t.device) for b, t in zip(bufs, tensors))
