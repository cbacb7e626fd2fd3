"""Causal, segment-masked flash attention (forward), kernel B6.

The port of the attention that ``deepdfa_tpu/llm/llama.py::_flash_attention``
hands to the stock Pallas TPU flash-attention kernel
(``jax.experimental.pallas.ops.tpu.flash_attention``):

- the scores ``q·kᵀ`` summed in float32, then times ``d^-0.5``;
- a key counts for a query when their segment ids are equal (the pad mask:
  1 for a real token, 0 for padding) and, when causal, it is not later; a
  masked key adds exactly 0. So a padding query row attends to the padding
  keys at or before it, as on the TPU — unlike
  :func:`~deepdfa_tpu_torch.ops.ring_attention.full_attention`, which returns
  zeros for padding rows;
- the softmax in float32, the unnormalised weights ``P`` rounded to ``v``'s
  type before ``P·V``, that product summed in float32 and the output written
  in ``q``'s type;
- grouped-query heads: query head ``i`` reads kv head ``i // (h // h_kv)``.

:func:`flash_attention` on CUDA tensors launches the hand-written kernel of
``csrc/flash_attention.cu`` (built for ``sm_90a`` at first use; bf16 on
``mma.sync`` tensor-core instructions, float32 on FFMA) or raises
``RuntimeError`` when it does not build or launch; on CPU tensors it runs
:func:`flash_attention_reference`. Head widths other than 16, 32, 64 and 128
raise ``ValueError`` on both. ``n_launches`` counts the kernel's launches (one
per call). Forward only: on the card a call that would need a gradient
raises; the TPU kernel's backward (the LoRA fine-tune path) comes with the
training slice.
"""

from __future__ import annotations

import ctypes

import torch

from deepdfa_tpu_torch.ops import _build

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_reference",
           "n_launches"]

# head widths the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)

# CUDA kernel launches made by flash_attention (B6) since the last reset.
n_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.fa_forward.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   ctypes.c_float, _I, _I, _P]
        lib.fa_forward.restype = _I
        lib.fa_error_string.argtypes = [_I]
        lib.fa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v, pad_mask) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [b, s, h, d] and k, v "
                         "[b, s, h_kv, d]")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s \
            or k.shape[3] != d:
        raise ValueError(f"k {list(k.shape)} and v {list(v.shape)} do not "
                         f"match q {list(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} is not one of {HEAD_DIMS}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be bfloat16 or all float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if pad_mask is not None and tuple(pad_mask.shape) != (b, s):
        raise ValueError(f"pad_mask must be [{b}, {s}], got "
                         f"{list(pad_mask.shape)}")
    tensors = (k, v) if pad_mask is None else (k, v, pad_mask)
    if any(x.device != q.device for x in tensors):
        raise ValueError("flash_attention: every argument must be on one "
                         "device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              pad_mask: torch.Tensor | None = None, *,
                              causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain torch: segment-id (and causal)
    masked softmax attention in float32, ``P`` rounded to ``v``'s type
    before ``P·V``. Materialises the repeated kv heads and the
    ``[b, h, s, s]`` scores."""
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    kf = k.repeat_interleave(n_rep, dim=2).to(torch.float32)
    vr = v.repeat_interleave(n_rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf)
    scores = scores * d ** -0.5
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None, None]
    if pad_mask is not None:
        seg = pad_mask.to(torch.int32)
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    # every query keeps its own key (same segment, not later), so each row
    # has a finite maximum and a sum of at least 1
    scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).transpose(1, 2)[..., None]  # [b, q, h, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(torch.float32),
                     vr.to(torch.float32))
    return (o / l).to(q.dtype)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: torch.Tensor | None = None, *,
                    causal: bool = True) -> torch.Tensor:
    """Segment-masked softmax attention ``[b, s, h, d]`` in ``q``'s type.

    ``q`` ``[b, s, h, d]``, ``k``/``v`` ``[b, s, h_kv, d]`` (bf16 or float32,
    ``d`` in :data:`HEAD_DIMS`), ``pad_mask`` ``[b, s]`` bool (True = real
    token) or None for one segment. CUDA tensors launch B6 or raise
    ``RuntimeError``; CPU tensors run :func:`flash_attention_reference`."""
    global n_launches
    _check(q, k, v, pad_mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, pad_mask, causal=causal)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward kernel yet (B6b, the LoRA "
            "training slice): call it under torch.no_grad or "
            "inference_mode")
    b, s, h, d = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    seg = None if pad_mask is None else pad_mask.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel():
        lib = _kernels()
        code = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seg is None else seg.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], d, d ** -0.5, int(causal),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
        if code != 0:
            msg = lib.fa_error_string(code).decode()
            raise RuntimeError(f"flash_attention: launch failed: {msg} "
                               f"({code})")
        n_launches += 1
    return out
