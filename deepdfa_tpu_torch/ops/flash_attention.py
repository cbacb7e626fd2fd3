"""Causal, segment-masked flash attention: forward (kernel B6) and backward
(kernel B6b).

The port of the attention that ``deepdfa_tpu/llm/llama.py::_flash_attention``
hands to the stock Pallas TPU flash-attention kernel
(``jax.experimental.pallas.ops.tpu.flash_attention``), and of that kernel's
custom VJP (``_flash_attention_bwd``: the dk/dv and dq Pallas kernels):

- the scores ``q·kᵀ`` summed in float32, then times ``d^-0.5``;
- a key counts for a query when their segment ids are equal (the pad mask:
  1 for a real token, 0 for padding) and, when causal, it is not later; a
  masked key adds exactly 0. So a padding query row attends to the padding
  keys at or before it, as on the TPU — unlike
  :func:`~deepdfa_tpu_torch.ops.ring_attention.full_attention`, which returns
  zeros for padding rows — and its gradients follow the same rule;
- the softmax in float32, the unnormalised weights ``P`` rounded to ``v``'s
  type before ``P·V``, that product summed in float32 and the output written
  in ``q``'s type;
- the backward from the forward's row logsumexp ``lse`` and
  ``di = rowsum(o·do)``: ``p = exp(s − lse)``, ``dv = pᵀ·do`` (p rounded to
  ``do``'s type), ``dp = do·vᵀ``, ``ds = (dp − di)·p·scale``, ``dk = dsᵀ·q``
  (ds rounded to ``do``'s type), ``dq = ds·k`` (ds rounded to ``k``'s type),
  every product summed in float32;
- grouped-query heads: query head ``i`` reads kv head ``i // (h // h_kv)``,
  and a kv head's ``dk``, ``dv`` sum over its query heads.

:func:`flash_attention` on CUDA tensors launches the hand-written kernels of
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` (built for
``sm_90a`` at first use; the variants below) or raises ``RuntimeError``
when they do not build or launch. When a gradient is needed, B6 also
writes each row's logsumexp and the call's backward launches B6b (two
kernels: dk/dv, then dq); under ``no_grad`` or ``inference_mode`` it
writes none. On CPU tensors it runs
:func:`flash_attention_reference`, and autograd differentiates that. Head
widths other than 16, 32, 64 and 128 raise ``ValueError`` on both.

B6 and B6b have three variants each, chosen by :func:`variant` before the
launch (a call's forward and backward take the same one): ``"wgmma"``
(bf16 at d 128 with s a multiple of 128, the shapes of CodeLlama-7B and
13B: TMA loads into a shared-memory ring and Hopper's ``wgmma`` tensor-core
products), ``"mma"`` (other bf16: ``mma.sync`` tensor-core instructions)
and ``"ffma"`` (float32). A failed launch raises; no variant falls back to
another. ``n_launches`` counts B6's launches (one per call),
``n_bwd_launches`` B6b's (two per backward), ``n_variant_launches`` and
``n_bwd_variant_launches`` each by variant. Each CUDA call reports its
FLOPs to an active ``FlopCounterMode`` (:mod:`.flops`).
:func:`flash_attention_backward_reference` is B6b's plain version.
"""

from __future__ import annotations

import ctypes

import torch

from deepdfa_tpu_torch.ops import _build, flops

__all__ = ["HEAD_DIMS", "VARIANTS", "flash_attention",
           "flash_attention_backward", "flash_attention_backward_reference",
           "flash_attention_forward", "flash_attention_reference",
           "n_bwd_launches", "n_bwd_variant_launches", "n_launches",
           "n_variant_launches", "variant"]

# head widths the kernels are compiled for
HEAD_DIMS = (16, 32, 64, 128)
VARIANTS = ("wgmma", "mma", "ffma")
# the multiple of s the wgmma variant takes: its query and key tiles
TC_TILE = 128

# CUDA kernel launches made by flash_attention since the last reset: B6
# (forward) and B6b (backward, dk/dv and dq), in all and by variant.
n_launches = 0
n_bwd_launches = 0
n_variant_launches = dict.fromkeys(VARIANTS, 0)
n_bwd_variant_launches = dict.fromkeys(VARIANTS, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_lib = None
_bwd_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.fa_forward.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _F, _I, _I, _P]
        lib.fa_forward.restype = _I
        lib.fa_forward_tc.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _F, _I, _P]
        lib.fa_forward_tc.restype = _I
        lib.fa_error_string.argtypes = [_I]
        lib.fa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _bwd_kernels() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("flash_attention_bwd")
        lib.fa_backward_dkv.argtypes = [_P] * 9 + [_I] * 5 + [_F, _I, _I, _P]
        lib.fa_backward_dkv.restype = _I
        lib.fa_backward_dq.argtypes = [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P]
        lib.fa_backward_dq.restype = _I
        lib.fa_backward_dkv_tc.argtypes = [_P] * 9 + [_I] * 5 + [_F, _I, _P]
        lib.fa_backward_dkv_tc.restype = _I
        lib.fa_backward_dq_tc.argtypes = [_P] * 8 + [_I] * 5 + [_F, _I, _P]
        lib.fa_backward_dq_tc.restype = _I
        lib.fa_bwd_error_string.argtypes = [_I]
        lib.fa_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


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


def _keep(pad_mask, s: int, causal: bool, device) -> torch.Tensor:
    """The boolean mask ``[b or 1, 1, s, s]``: equal segment ids and, when
    causal, a key that is not later than its query."""
    keep = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None, None]
    if pad_mask is not None:
        seg = pad_mask.to(torch.int32)
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    return keep


def _reference_forward(q, k, v, pad_mask, causal):
    """(output, row logsumexp ``[b, h, s]`` float32) of the forward in plain
    torch; differentiable through the output."""
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    kf = k.repeat_interleave(n_rep, dim=2).to(torch.float32)
    vr = v.repeat_interleave(n_rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf)
    scores = scores * d ** -0.5
    # every query keeps its own key (same segment, not later), so each row
    # has a finite maximum and a sum of at least 1
    scores = scores.masked_fill(~_keep(pad_mask, s, causal, q.device),
                                float("-inf"))
    # the maximum only shifts the exponent: no gradient runs through it
    m = scores.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(scores - m)
    l = p.sum(dim=-1)  # [b, h, q]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(torch.float32),
                     vr.to(torch.float32))
    out = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    return out, (m[..., 0] + torch.log(l)).detach()


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              pad_mask: torch.Tensor | None = None, *,
                              causal: bool = True) -> torch.Tensor:
    """B6's function in plain torch: segment-id (and causal) masked softmax
    attention in float32, ``P`` rounded to ``v``'s type before ``P·V``.
    Materialises the repeated kv heads and the ``[b, h, s, s]`` scores;
    autograd differentiates it."""
    return _reference_forward(q, k, v, pad_mask, causal)[0]


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        do: torch.Tensor, lse: torch.Tensor,
        pad_mask: torch.Tensor | None = None, *, causal: bool = True
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B6b's function in plain torch: ``(dq, dk, dv)`` of the forward's
    output ``o`` for the cotangent ``do``, from the forward's row
    logsumexp ``lse`` ``[b, h, s]``, by the explicit formulas with the
    kernel's roundings (``p`` and ``ds`` rounded to ``do``'s type before
    ``dv`` and ``dk``, ``ds`` to ``k``'s before ``dq``; float32 sums). A kv
    head's ``dk``, ``dv`` sum its query heads in order."""
    return _reference_backward(q, k, v, do, lse, _row_dot(o, do), pad_mask,
                               causal)


def _row_dot(o, do) -> torch.Tensor:
    """``di = rowsum(o·do)`` ``[b, h, s]`` in float32."""
    # do is promoted inside the product: no float32 copy of it is made
    di = (o.to(torch.float32) * do).sum(dim=-1)
    return di.transpose(1, 2)


def _reference_backward(q, k, v, do, lse, di, pad_mask, causal):
    """:func:`flash_attention_backward_reference` from ``di``, as B6b
    receives it."""
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    n_rep = h // h_kv
    scale = d ** -0.5
    f32 = torch.float32
    qf, dof = q.to(f32), do.to(f32)
    kf = k.repeat_interleave(n_rep, dim=2).to(f32)
    vf = v.repeat_interleave(n_rep, dim=2).to(f32)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.where(_keep(pad_mask, s, causal, q.device),
                    torch.exp(scores - lse[..., None]), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(f32), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (dp - di[..., None]) * p * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(do.dtype).to(f32), qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).to(f32), kf)
    dk = dk.reshape(b, s, h_kv, n_rep, d).sum(dim=3)
    dv = dv.reshape(b, s, h_kv, n_rep, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_residuals(q, o, do, lse) -> None:
    """The backward's extra arguments: ``o`` and ``do`` like ``q``, ``lse``
    float32 ``[b, h, s]``, all on ``q``'s device."""
    b, s, h, _ = q.shape
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"flash_attention backward: {name} must be "
                             f"{q.dtype} {list(q.shape)}, got {x.dtype} "
                             f"{list(x.shape)}")
    if tuple(lse.shape) != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: lse must be float32 "
                         f"[{b}, {h}, {s}], got {lse.dtype} "
                         f"{list(lse.shape)}")
    if any(x.device != q.device for x in (o, do, lse)):
        raise ValueError("flash_attention backward: every argument must be "
                         "on one device")


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The variant of B6 and B6b that takes ``q``, ``k``, ``v`` as the
    caller hands them over.

    ``"ffma"`` for float32. For bf16, ``"wgmma"`` when d is 128, s is a
    multiple of 128 (the kernels' tiles) and TMA can describe each operand:
    a 16-byte aligned base address, the last axis dense and every other
    stride a multiple of 16 bytes (a view with a storage offset may not
    be); ``"mma"`` otherwise. Every shape of the LLM tier (CodeLlama-7B
    and 13B: d 128, s 256-2048) takes ``"wgmma"``."""
    if q.dtype != torch.bfloat16:
        return "ffma"
    s, d = q.shape[1], q.shape[3]
    if d != 128 or s % TC_TILE:
        return "mma"
    for x in (q, k, v):
        if x.data_ptr() % 16 or x.stride(-1) != 1 \
                or any(st % 8 for st in x.stride()[:-1]):
            return "mma"
    return "wgmma"


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` dense (strides of its own shape: an expanded or transposed
    view is copied) at a 16-byte aligned address, as the kernels index it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_forward(q, k, v, seg, causal: bool, with_lse: bool,
                    kind: str | None = None):
    """B6's variant ``kind`` (by default :func:`variant`'s) on CUDA
    tensors: the output and, when asked, the row logsumexp ``[b, h, s]``
    float32 (else None)."""
    global n_launches
    kind = kind or variant(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    flops.count(flops.flash_attention_flops(b, s, h, d), q)
    if out.numel():
        lib = _kernels()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if seg is None else seg.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                b, s, h, k.shape[2], d, d ** -0.5, int(causal))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kind == "wgmma":
            code = lib.fa_forward_tc(*args, stream)
        else:
            code = lib.fa_forward(*args, int(kind == "mma"), stream)
        if code != 0:
            msg = lib.fa_error_string(code).decode()
            raise RuntimeError(f"flash_attention: {kind} launch failed: "
                               f"{msg} ({code})")
        n_launches += 1
        n_variant_launches[kind] += 1
    return out, lse


def _launch_backward(q, k, v, o, do, lse, seg, causal: bool,
                     kind: str | None = None):
    """B6b's variant ``kind`` (by default :func:`variant`'s) on CUDA
    tensors: ``(dq, dk, dv)``, two launches (dk/dv, then dq);
    ``di = rowsum(o·do)`` in float32 is a torch op, as the JAX wrapper
    computes it outside its kernels. The kernels read every tensor dense:
    a cotangent that autograd hands over expanded (``out.sum()``) or
    transposed is copied first."""
    global n_bwd_launches
    kind = kind or variant(q, k, v)
    b, s, h, d = q.shape
    q, k, v, do, lse = (_aligned(x) for x in (q, k, v, do, lse))
    di = _row_dot(o, do).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    flops.count(flops.flash_attention_backward_flops(b, s, h, d), q)
    if not dq.numel():
        return dq, dk, dv
    lib = _bwd_kernels()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    seg_ptr = None if seg is None else seg.data_ptr()
    args = (b, s, h, k.shape[2], d, d ** -0.5, int(causal))
    args += (stream,) if kind == "wgmma" else (int(kind == "mma"), stream)
    suffix = "_tc" if kind == "wgmma" else ""
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), di.data_ptr(), seg_ptr)
    for name, outs in (("fa_backward_dkv", (dk.data_ptr(), dv.data_ptr())),
                       ("fa_backward_dq", (dq.data_ptr(),))):
        code = getattr(lib, name + suffix)(*inputs, *outs, *args)
        if code != 0:
            msg = lib.fa_bwd_error_string(code).decode()
            raise RuntimeError(f"flash_attention backward: {name}{suffix} "
                               f"({kind}) launch failed: {msg} ({code})")
        n_bwd_launches += 1
        n_bwd_variant_launches[kind] += 1
    return dq, dk, dv


def _seg(pad_mask):
    """The segment ids ``[b, s]`` int32, dense and 16-byte aligned (the
    wgmma kernels copy them in bulk), or None."""
    return None if pad_mask is None else _aligned(pad_mask.to(torch.int32))


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            pad_mask: torch.Tensor | None = None, *,
                            causal: bool = True
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """B6 with its residual: ``(output, row logsumexp [b, h, s] float32)``.
    CUDA tensors launch the kernel or raise; CPU tensors run the plain
    version. Not differentiable (see :func:`flash_attention`)."""
    _check(q, k, v, pad_mask)
    if q.device.type == "cpu":
        return _reference_forward(q, k, v, pad_mask, causal)
    kind = variant(q, k, v)
    return _launch_forward(_aligned(q), _aligned(k), _aligned(v),
                           _seg(pad_mask), causal, with_lse=True, kind=kind)


def flash_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        do: torch.Tensor, lse: torch.Tensor,
        pad_mask: torch.Tensor | None = None, *, causal: bool = True
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B6b: ``(dq, dk, dv)`` for the cotangent ``do`` of the forward's
    output ``o`` and logsumexp ``lse``. CUDA tensors launch the kernels (two
    launches) or raise; CPU tensors run
    :func:`flash_attention_backward_reference`."""
    _check(q, k, v, pad_mask)
    _check_residuals(q, o, do, lse)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, do, lse,
                                                  pad_mask, causal=causal)
    return _launch_backward(q, k, v, o, do, lse, _seg(pad_mask), causal,
                            kind=variant(q, k, v))


class _Flash(torch.autograd.Function):
    """B6 forward with its logsumexp saved, B6b backward, both of variant
    ``kind`` (by default :func:`variant`'s)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal, kind=None):
        ctx.kind = kind or variant(q, k, v)
        out, lse = _launch_forward(q, k, v, seg, causal, with_lse=True,
                                   kind=ctx.kind)
        ctx.save_for_backward(q, k, v, out, lse,
                              *(() if seg is None else (seg,)))
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, *seg = ctx.saved_tensors
        seg = seg[0] if seg else None
        grads = _launch_backward(q, k, v, out, do, lse, seg, ctx.causal,
                                 ctx.kind)
        return (*grads, None, None, None)


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: torch.Tensor | None = None, *,
                    causal: bool = True) -> torch.Tensor:
    """Segment-masked softmax attention ``[b, s, h, d]`` in ``q``'s type.

    ``q`` ``[b, s, h, d]``, ``k``/``v`` ``[b, s, h_kv, d]`` (bf16 or float32,
    ``d`` in :data:`HEAD_DIMS`), ``pad_mask`` ``[b, s]`` bool (True = real
    token) or None for one segment. CUDA tensors launch B6, and B6b in the
    backward when a gradient is needed, or raise ``RuntimeError``; CPU
    tensors run :func:`flash_attention_reference`. The variant is
    :func:`variant` of the tensors as handed over."""
    _check(q, k, v, pad_mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, pad_mask, causal=causal)
    kind = variant(q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    seg = _seg(pad_mask)
    if _needs_grad(q, k, v):
        return _Flash.apply(q, k, v, seg, causal, kind)
    return _launch_forward(q, k, v, seg, causal, with_lse=False,
                           kind=kind)[0]
