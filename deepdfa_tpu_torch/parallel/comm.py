"""The collectives of the sharded LLM over ``torch.distributed`` groups,
with their backward.

Each takes the process group of one mesh axis (None: the axis has one
member, and the call returns its input). NCCL takes CUDA tensors as they
are; gloo, which ranks sharing one card use, takes host tensors only for
point-to-point calls, so every CUDA tensor is staged through host memory
there (the computation around the call stays on the card).

The gradient convention of the sharded path: every rank holds the same,
whole loss, and a rank's backward gives that loss's gradient through its
own share of the work. So each collective's backward depends on how the
ranks of its group use what it returns:

- :func:`all_reduce` (the row-parallel sum, and the finetuner's sum of the
  blocks' loss parts): its output is used alike on every rank, so the
  backward is the identity;
- :func:`copy` (the input of a column-parallel block over ``tp``): the
  identity forward; each rank uses the copy for its own heads or columns,
  so the backward sums the gradients over the group;
- :func:`all_gather` with ``grad="slice"`` (the default: the weights'
  ``fsdp`` gathers, the vocabulary's ``tp`` gather, the whole outputs of
  ``gather_tokens``): every rank goes on to do the same work with the
  gathered tensor, so the backward hands back this rank's slice of the
  gradient; with ``grad="sum"`` (the keys and values gathered over ``sp``
  for ``"full"`` attention, each rank attending with its own queries) it
  sums the group's gradients for this rank's block (a reduce-scatter);
- :func:`ring_pass` sends each block to the next rank, so its backward
  sends each gradient to the previous one and receives from the next.

A parameter replicated over ``dp`` or ``sp`` then holds, on each rank, the
gradient through its own block of tokens: the sum over those axes is the
gradient of the loss (:class:`~deepdfa_tpu_torch.llm.joint.ClippedAdamW`'s
``sum_groups``). Ranks along ``fsdp`` and ``tp`` run the same tokens, so
they hold the same loss and, past each ``tp`` collective, the same
gradients. A collective runs its backward only where its input requires a
gradient: every rank builds the same graph, so every rank runs the same
collectives in the same order, also when ``remat`` recomputes a layer.
"""

from __future__ import annotations

import torch

__all__ = ["all_gather", "all_reduce", "all_reduce_", "copy", "ring_pass"]


def _staged(x: torch.Tensor, group) -> bool:
    import torch.distributed as dist

    return x.is_cuda and dist.get_backend(group) == "gloo"


def _tracked(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors if isinstance(t, torch.Tensor))


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group``'s ranks in place (no gradient) and return
    it."""
    import torch.distributed as dist

    if group is None:
        return x
    if _staged(x, group):
        host = x.cpu()
        dist.all_reduce(host, group=group)
        return x.copy_(host)
    dist.all_reduce(x, group=group)
    return x


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    src = (x.cpu() if _staged(x, group) else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` split evenly along ``dim``."""
    import torch.distributed as dist

    n = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * n, n).contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad):
        ctx.group, ctx.dim, ctx.grad = group, dim, grad
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = all_reduce_(g.clone(), ctx.group)
        return _block(g, ctx.group, ctx.dim), None, None, None


def _pass(tensors: tuple, group, forward: bool) -> tuple:
    """Send ``tensors`` one step around ``group``'s ring (to the next rank
    when ``forward``, else to the previous) and return what arrived (one
    ``batch_isend_irecv``)."""
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    step = 1 if forward else -1
    to = dist.get_global_rank(group, (me + step) % n)
    frm = dist.get_global_rank(group, (me - step) % n)
    staged = [(t.cpu() if _staged(t, group) else t).contiguous()
              for t in tensors]
    bufs = [torch.empty_like(t) for t in staged]
    ops = [dist.P2POp(dist.isend, t, to, group) for t in staged]
    ops += [dist.P2POp(dist.irecv, b, frm, group) for b in bufs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(b.to(t.device) for b, t in zip(bufs, tensors))


class _RingPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.floating = [t.is_floating_point() for t in tensors]
        out = _pass(tensors, group, forward=True)
        ctx.mark_non_differentiable(*[o for o, f in zip(out, ctx.floating)
                                      if not f])
        return out

    @staticmethod
    def backward(ctx, *grads):
        # every floating block's gradient goes back to the rank it came
        # from (a gradient autograd left out is zeros: each rank sends the
        # same tensors)
        send = [g for g, f in zip(grads, ctx.floating) if f]
        back = iter(_pass(tuple(send), ctx.group, forward=False))
        return (None, *[next(back) if f else None for f in ctx.floating])


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group``'s ranks. Without a gradient to track, in
    place in ``x`` (every such caller passes a buffer it has just made);
    with one, into a new tensor whose backward is the identity."""
    if group is None:
        return x
    if _tracked(x):
        return _AllReduce.apply(x, group)
    return all_reduce_(x, group)


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself going forward; its gradient summed over ``group``
    going back (the input of a column-parallel block)."""
    if group is None or not _tracked(x):
        return x
    return _Copy.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int,
               grad: str = "slice") -> torch.Tensor:
    """``group``'s ranks' ``x`` concatenated along ``dim`` in rank order.
    Backward (module docstring): ``grad="slice"`` takes this rank's block
    of the gradient, ``"sum"`` sums the group's gradients first."""
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad must be 'slice' or 'sum', not {grad!r}")
    if group is None:
        return x
    if _tracked(x):
        return _AllGather.apply(x, group, dim, grad)
    return _gather(x, group, dim)


def ring_pass(tensors: tuple, group) -> tuple:
    """Send ``tensors`` to the next rank of ``group`` and return those the
    previous rank sent (one ``batch_isend_irecv``); the floating ones'
    gradients travel back the other way."""
    if group is None:
        return tensors
    if _tracked(*tensors):
        return _RingPass.apply(group, *tensors)
    return _pass(tuple(tensors), group, forward=True)
