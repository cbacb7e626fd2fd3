"""The port's inference kernels as registered ``torch.library`` ops.

A kernel launched through ``ctypes`` on raw ``data_ptr()``s is invisible to
a tracer: ``torch.export`` would record the plain torch rounds in its place.
Registered ops are recorded as one node each, so an exported program calls
the same kernels as the live model. Each op has a CPU and a CUDA
implementation, chosen by the dispatcher from its inputs' device when it
runs (an artifact exported on the CPU launches the kernels on the card),
and a fake implementation that gives only the output's shape and type.

- ``deepdfa::fused_ggnn``: B1's forward, the no-grad path of
  :func:`~deepdfa_tpu_torch.ops.fused_ggnn.fused_ggnn` (CPU: the plain
  rounds; CUDA: the kernels of ``csrc/fused_ggnn.cu``).
- ``deepdfa::segment_sum``: :func:`~deepdfa_tpu_torch.ops.segment.
  segment_sum` when no gradient is needed (CPU: ``index_add_`` in index
  order; CUDA: the ordered sum, no float atomics).
- ``deepdfa::int8_matmul``: B5's forward, the no-grad path of
  :func:`~deepdfa_tpu_torch.ops.int8_matmul.int8_matmul` (CPU: the plain
  product; CUDA: the kernel of ``csrc/int8_matmul.cu``).

Each op carries its kernel's FLOP formula (:mod:`.flops`) for
``FlopCounterMode``, the same on either device (the segment sum's is 0:
no product).

The launch counters are bumped inside the CUDA implementations, so an
exported program's calls count like live ones, and a failed build or
launch raises out of the op. The autograd paths of the three wrappers do
not go through these ops: training is unchanged. Import this module before
``torch.export.load`` of a program that calls them.
"""

import torch
from torch.utils import flop_counter

from deepdfa_tpu_torch.ops import flops as _flops
from deepdfa_tpu_torch.ops import fused_ggnn as _fg
from deepdfa_tpu_torch.ops import int8_matmul as _i8
from deepdfa_tpu_torch.ops import segment as _seg

__all__ = ["OPS", "fused_ggnn", "int8_matmul", "segment_sum"]

# the ops' names as an exported graph's nodes print them
OPS = ("deepdfa.fused_ggnn", "deepdfa.segment_sum", "deepdfa.int8_matmul")

Tensor = torch.Tensor


@torch.library.custom_op("deepdfa::fused_ggnn", mutates_args=(),
                         device_types="cpu")
def fused_ggnn(h0: Tensor, senders: Tensor, receivers: Tensor, ew: Tensor,
               eb: Tensor, xw: Tensor, xb: Tensor, hw: Tensor, hb: Tensor,
               n_steps: int) -> Tensor:
    if n_steps == 0:  # an op's output never aliases its input
        return h0.to(torch.float32).clone()
    return _fg.fused_ggnn_reference(h0, senders, receivers, ew, eb, xw, xb,
                                    hw, hb, n_steps=n_steps)


@fused_ggnn.register_kernel("cuda")
def _fused_ggnn_cuda(h0, senders, receivers, ew, eb, xw, xb, hw, hb,
                     n_steps):
    return _fg.forward_cuda(h0, senders, receivers, (ew, eb, xw, xb, hw, hb),
                            n_steps)


@fused_ggnn.register_fake
def _(h0, senders, receivers, ew, eb, xw, xb, hw, hb, n_steps):
    return h0.new_empty(h0.shape, dtype=torch.float32)


@flop_counter.register_flop_formula(torch.ops.deepdfa.fused_ggnn)
def _(h0, senders, receivers, ew, eb, xw, xb, hw, hb, n_steps,
      **kwargs) -> int:
    return _flops.fused_ggnn_flops(h0[0], h0[1], n_steps)


@torch.library.custom_op("deepdfa::segment_sum", mutates_args=(),
                         device_types="cpu")
def segment_sum(data: Tensor, segment_ids: Tensor,
                num_segments: int) -> Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


@segment_sum.register_kernel("cuda")
def _segment_sum_cuda(data, segment_ids, num_segments):
    return _seg._ordered_segment_sum(data, segment_ids, num_segments)


@segment_sum.register_fake
def _(data, segment_ids, num_segments):
    return data.new_empty((num_segments,) + tuple(data.shape[1:]))


@flop_counter.register_flop_formula(torch.ops.deepdfa.segment_sum)
def _(*args, **kwargs) -> int:
    return 0


@torch.library.custom_op("deepdfa::int8_matmul", mutates_args=(),
                         device_types="cpu")
def int8_matmul(x: Tensor, q: Tensor, scale: Tensor,
                out_dtype: torch.dtype) -> Tensor:
    return _i8.int8_matmul_reference(x, q, scale, out_dtype)


@int8_matmul.register_kernel("cuda")
def _int8_matmul_cuda(x, q, scale, out_dtype):
    return _i8.forward_cuda(x, q, scale, out_dtype)


@int8_matmul.register_fake
def _(x, q, scale, out_dtype):
    return x.new_empty(tuple(x.shape[:-1]) + (q.shape[1],), dtype=out_dtype)


@flop_counter.register_flop_formula(torch.ops.deepdfa.int8_matmul)
def _(x, q, scale, out_dtype, **kwargs) -> int:
    m = 1
    for size in x[:-1]:
        m *= size
    return _flops.int8_matmul_flops(m, q[0], q[1])
