"""FLOP counts of the hand-written kernels, for
``torch.utils.flop_counter.FlopCounterMode``.

The mode counts the matrix products PyTorch dispatches (``mm``, ``bmm``,
``addmm``, ...). It cannot see inside a kernel launched through ``ctypes``,
so each kernel has a formula here: what ``FlopCounterMode`` counts on its
plain version at the same shapes (the element-wise work and the edge sums
count nothing, as there). A count therefore does not depend on the device:

- the registered ops (B1's and B5's no-grad forwards, the segment sum,
  :mod:`.custom_ops`) carry their formula through ``register_flop_formula``,
  on the CPU as on the card;
- the other launches (B1/B2 under autograd, B3/B4, B5 under autograd,
  B6/B6b) report theirs through :func:`count`, a registered no-op
  (``deepdfa::count_flops``) whose formula is its argument. On the CPU the
  same wrappers run their plain versions, which the mode sees directly.

The mode changes no value, so a step counted as it runs launches its
kernels and computes what it computes uncounted.
"""

from __future__ import annotations

import torch
from torch.utils import flop_counter

__all__ = ["count", "flash_attention_backward_flops",
           "flash_attention_flops", "fused_ggnn_backward_flops",
           "fused_ggnn_flops", "int8_matmul_flops", "megabatch_flops"]


def fused_ggnn_flops(n: int, d: int, n_steps: int) -> int:
    """B1: per round the edge linear ``[N, D]·[D, D]`` and the GRU's two
    ``[N, D]·[D, 3D]`` projections."""
    return 14 * n * d * d * n_steps


def fused_ggnn_backward_flops(n: int, d: int, n_steps: int) -> int:
    """B2's plain version: the forward banked again (14·N·D² a round), then
    per reverse round the GRU's two projections recomputed (12), the input
    and weight products of both (24) and of the edge linear (4)."""
    return 54 * n * d * d * n_steps


def megabatch_flops(n: int, d: int, n_steps: int, n_graphs: int,
                    head_dims) -> int:
    """B3 (``head_dims`` the widths ``[2D, ..., 1]``) and B4 (``head_dims``
    ``[2D]``, no head): B1's rounds, the attention gate ``[N, 2D]·[2D, 1]`` and each
    head layer ``[G, in]·[in, out]``."""
    head = sum(2 * n_graphs * a * b for a, b in zip(head_dims[:-1],
                                                   head_dims[1:]))
    return fused_ggnn_flops(n, d, n_steps) + 4 * n * d + head


def int8_matmul_flops(m: int, k: int, n: int) -> int:
    """B5: ``[M, K]·[K, N]``."""
    return 2 * m * k * n


def flash_attention_flops(b: int, s: int, h: int, d: int) -> int:
    """B6: ``Q·Kᵀ`` and ``P·V`` over every head, the masked entries too."""
    return 4 * b * h * s * s * d


def flash_attention_backward_flops(b: int, s: int, h: int, d: int) -> int:
    """B6b's plain version: the scores again, ``dV``, ``dP``, ``dK`` and
    ``dQ``."""
    return 10 * b * h * s * s * d


@torch.library.custom_op("deepdfa::count_flops", mutates_args=())
def _count_flops(anchor: torch.Tensor, flops: int) -> None:
    """A no-op whose FLOP formula is ``flops`` (``anchor`` only routes the
    call to its device)."""


@_count_flops.register_fake
def _(anchor, flops):
    return None


@flop_counter.register_flop_formula(torch.ops.deepdfa.count_flops)
def _count_flops_formula(anchor_shape, flops, *args, **kwargs) -> int:
    return flops


def _mode_active() -> bool:
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return bool(_get_current_dispatch_mode_stack())


def count(flops: int, anchor: torch.Tensor) -> None:
    """Report a kernel's ``flops`` to an active ``FlopCounterMode`` (nothing
    happens when no dispatch mode is active)."""
    if _mode_active():
        _count_flops(anchor, int(flops))
