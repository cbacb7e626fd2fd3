"""Matrix product with int8-resident weights, and their calibration.

The port of ``deepdfa_tpu/ops/int8_matmul.py``:

    y[..., N] = x[..., K] @ (q[K, N] · scale[N])  =  (x @ q) · scale

(the per-output-channel scale distributes out of the contraction).

- :func:`int8_matmul` on CUDA tensors launches kernel B5 of
  ``csrc/int8_matmul.cu`` (built for ``sm_90a`` at first use) or raises
  ``RuntimeError`` when it does not build or launch; on CPU tensors it runs
  :func:`int8_matmul_reference`. Activations are float32 (the GGNN's conv)
  or bf16 (the LLM's projections); the output is float32 unless
  ``out_dtype`` asks for bf16, rounded once from the scaled float32 sum.
  B5 has three variants, chosen by :func:`variant`: ``"wgmma"`` on the
  tensor cores (bf16 activations fed by TMA, the int8 weight converted to
  bf16 in registers as the A operand; float32 activations split exactly
  into three bf16 terms) wherever TMA can describe the operands;
  ``"gemv"`` for bf16 activations of at most :data:`GEMV_MAX_M` tokens
  (decode: the weight's bytes set the pace, so K is split over the card
  as well as N, and nothing is encoded on the host); and ``"ffma"`` (the
  int8 tile dequantized in registers, FFMA over K) for the strides and
  addresses neither can take. ``n_launches`` counts the kernel's launches,
  ``n_variant_launches`` each variant's. A call under autograd reports its
  FLOPs to an active ``FlopCounterMode`` (:mod:`.flops`; the op carries
  its own formula).
- Differentiable with respect to ``x`` only, as the JAX ``custom_vjp``:
  ``dx = (g · scale) @ qᵀ`` with both factors in bf16, summed in float32
  (:func:`vjp_product`; no float32 copy of the weight). The weight and
  scale are a frozen base and get no gradient.
- A call that needs no gradient goes through the registered op
  ``deepdfa::int8_matmul`` (:mod:`.custom_ops`), so ``torch.export``
  records B5 as one node.
- :func:`calibrate_int8` is the symmetric absmax calibration, bit for bit
  the JAX package's: in numpy on the host, or in torch on a tensor's own
  device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from deepdfa_tpu_torch.ops import _build, custom_ops, flops

__all__ = ["GEMV_MAX_M", "VARIANTS", "calibrate_int8", "forward_cuda",
           "int8_matmul", "int8_matmul_reference", "n_launches",
           "n_variant_launches", "n_vjp_products", "variant", "vjp_product"]

VARIANTS = ("wgmma", "ffma", "gemv")
# The most tokens (rows of x) a bf16 product sends to the gemv variant. Timed
# cold against the wgmma variant at M 1, 2, 4, 8, 16, 32, 64 on 4096 x 4096
# and 4096 x 11008 (chip_smoke.py's int8_kernel crossover rows, H100 80GB
# HBM3 at 700 W), gemv took at most half wgmma's time up to M 32 at both
# shapes. At M 64 the two tied at 4096 x 11008 (61.6-61.7 us against
# 61.7-64.5 in two runs), and M 33 to 63 take the same launch as M 64 (two
# groups of 32 tokens): the boundary is 32, where the win is clear.
GEMV_MAX_M = 32
# CUDA kernel launches made by int8_matmul (B5) since the last reset, in
# all and by variant
n_launches = 0
n_variant_launches = dict.fromkeys(VARIANTS, 0)
# activation-gradient products (vjp_product) since the last reset
n_vjp_products = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("int8_matmul")
        lib.i8_matmul.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
        lib.i8_matmul.restype = _I
        lib.i8_matmul_bf16.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.i8_matmul_bf16.restype = _I
        lib.i8_matmul_tc.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
        lib.i8_matmul_tc.restype = _I
        lib.i8_matmul_tc_bf16.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.i8_matmul_tc_bf16.restype = _I
        lib.i8_matmul_gemv_bf16.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                            _P]
        lib.i8_matmul_gemv_bf16.restype = _I
        lib.i8_error_string.argtypes = [_I]
        lib.i8_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def calibrate_int8(w) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 calibration of a ``[K, N]`` weight:
    ``(q int8 [K, N], scale float32 [N])`` with ``q · scale ≈ w``.

    - A column of zeros gets ``scale = 1`` and ``q = 0``, so it dequantizes
      to exact zeros instead of ``0/0``.
    - Every column calibrates off ``|w|``, so the full ``[-127, 127]`` range
      is used whatever the signs.
    - Non-finite weights raise ``ValueError``: a NaN- or inf-poisoned source
      would otherwise clamp to ±127 and serve garbage scores.

    The float32 division and round-half-to-even of ``jnp.round`` make ``q``
    and ``scale`` bit for bit the JAX package's. A torch tensor is
    calibrated by the same float32 operations on its own device (the LLM's
    weights need not leave the card) and gives torch tensors; anything else
    gives numpy arrays."""
    if isinstance(w, torch.Tensor):
        return _calibrate_tensor(w)
    w = np.asarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(
            f"calibrate_int8 expects a [K, N] weight, got shape {w.shape}")
    if not bool(np.all(np.isfinite(w))):
        raise ValueError(_NON_FINITE)
    absmax = np.max(np.abs(w), axis=0)
    scale = np.where(absmax > 0, absmax / np.float32(127.0),
                     np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


_NON_FINITE = ("calibrate_int8: non-finite values in calibration weights — "
               "refusing to quantize a NaN/inf-poisoned source (clamping "
               "would silently corrupt every score through this matmul)")


def _calibrate_tensor(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    w = w.detach().to(torch.float32).contiguous()
    if w.dim() != 2:
        raise ValueError(
            f"calibrate_int8 expects a [K, N] weight, got shape "
            f"{tuple(w.shape)}")
    if not bool(torch.isfinite(w).all()):
        raise ValueError(_NON_FINITE)
    absmax = w.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """``(x @ q) · scale`` in plain torch: summed in float32, rounded to
    ``out_dtype`` once."""
    y = (x.to(torch.float32) @ q.to(torch.float32)) * scale.to(torch.float32)
    return y.to(out_dtype)


_DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
           out_dtype: torch.dtype) -> None:
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES or (
            x.dtype == torch.float32 and out_dtype != torch.float32):
        raise TypeError(f"int8_matmul takes float32 activations to a float32 "
                        f"output or bfloat16 ones to either, got {x.dtype} -> "
                        f"{out_dtype}")
    if q.dim() != 2 or x.shape[-1] != q.shape[0]:
        raise ValueError(f"contraction mismatch: x[..., {x.shape[-1]}] vs "
                         f"q{list(q.shape)}")
    if tuple(scale.shape) != (q.shape[1],):
        raise ValueError(f"scale must be [{q.shape[1]}], got "
                         f"{list(scale.shape)}")
    if any(t.device != x.device for t in (q, scale)):
        raise ValueError("int8_matmul: every argument must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {x.device}")


def variant(x: torch.Tensor, q: torch.Tensor) -> str:
    """The variant of B5 that takes ``x [M, K] @ q [K, N]`` on the card.

    The operands must have every global stride a multiple of 16 bytes (K a
    multiple of 8, which also covers a float32 row; N a multiple of 16),
    both base addresses 16-byte aligned (a view with a storage offset may
    not be) and K > 0: what TMA needs to describe the bf16 path's operands,
    and more than the other kernels' vector loads need. Such operands take
    ``"gemv"`` when x is bf16 with at most :data:`GEMV_MAX_M` rows (decode),
    else ``"wgmma"``; any others take ``"ffma"``. Every shape of the GGNN's
    conv and the LLM's projections at 1,024 tokens takes ``"wgmma"``, and
    every decode step of the LLM ``"gemv"``."""
    k, n = q.shape
    if k == 0 or k % 8 or n % 16:
        return "ffma"
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        return "ffma"
    if x.dtype == torch.bfloat16 and x.numel() // k <= GEMV_MAX_M:
        return "gemv"
    return "wgmma"


def _stream(device: torch.device) -> int:
    """The handle of the current CUDA stream on ``device``. The public
    ``torch.cuda.current_stream(device).cuda_stream`` builds a ``Stream``
    object on every call, and a decode step makes 225 calls."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# the entry point of each variant with bf16 activations
_BF16_ENTRIES = {"wgmma": "i8_matmul_tc_bf16", "gemv": "i8_matmul_gemv_bf16",
                 "ffma": "i8_matmul_bf16"}


def _launch(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            out: torch.Tensor) -> None:
    """Launch B5's variant for the dense ``x2 [M, K] @ q [K, N]`` into
    ``out`` on the current stream; raises ``RuntimeError`` when the launch
    fails."""
    global n_launches
    (m, k), n = x2.shape, q.shape[1]
    kind = variant(x2, q)
    lib = _kernels()
    stream = _stream(x2.device)
    ptrs = (x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr())
    if x2.dtype == torch.float32:
        fn = lib.i8_matmul_tc if kind == "wgmma" else lib.i8_matmul
        code = fn(*ptrs, m, k, n, stream)
    else:
        fn = getattr(lib, _BF16_ENTRIES[kind])
        code = fn(*ptrs, m, k, n, int(out.dtype == torch.bfloat16), stream)
    if code != 0:
        msg = lib.i8_error_string(code).decode()
        raise RuntimeError(f"int8_matmul: launch failed: {msg} ({code})")
    n_launches += 1
    n_variant_launches[kind] += 1


def _forward(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B5 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale, out_dtype)
    return forward_cuda(x, q, scale, out_dtype)


def forward_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """B5 on CUDA tensors into a new ``[..., N]`` tensor (the CUDA
    implementation of the ``deepdfa::int8_matmul`` op)."""
    k, n = q.shape
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m and n:
        _launch(x2, q.contiguous(), scale.to(torch.float32).contiguous(), out)
    return out.reshape(*x.shape[:-1], n)


def vjp_product(gs: torch.Tensor, q: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """``gs[..., N] @ q[K, N]ᵀ`` as ``[..., K]`` in ``out_dtype``: the
    activation gradient's product, as the JAX VJP takes it (``jnp.dot`` of
    bf16 operands with ``preferred_element_type=float32``, then cast).

    ``gs`` is the bf16 ``g · scale``; the weight is converted to bf16 once
    for this call (exact: int8 fits bf16's 8-bit significand), a transient
    copy of one layer at half the float32 size, and no float32 copy of it is
    made. On CUDA tensors ``torch.mm(..., out_dtype=torch.float32)`` sums
    the bf16 products in float32 (the product sits outside any Pallas
    kernel in the JAX package, so a library call is its counterpart). On CPU
    tensors a bf16 ``out_dtype`` takes the bf16 product (float32 sums,
    rounded once), and a float32 one its plain version: the bf16 operands
    widened to float32, which hold them exactly. ``n_vjp_products`` counts
    the calls."""
    global n_vjp_products
    k, n = q.shape
    g2 = gs.reshape(-1, n)
    qb = q.to(torch.bfloat16)  # [K, N]
    if gs.device.type == "cuda":
        dx = torch.mm(g2, qb.t(), out_dtype=torch.float32).to(out_dtype)
    elif out_dtype == torch.bfloat16:
        dx = torch.mm(g2, qb.t())
    else:
        dx = g2.to(torch.float32) @ qb.t().to(torch.float32)
    n_vjp_products += 1
    return dx.reshape(*gs.shape[:-1], k)


class _Int8Matmul(torch.autograd.Function):
    """The product, differentiable with respect to ``x`` only."""

    @staticmethod
    def forward(ctx, x, q, scale, out_dtype):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        if x.device.type == "cuda":
            flops.count(flops.int8_matmul_flops(x.numel() // q.shape[0],
                                                *q.shape), x)
        return _forward(x, q, scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        gs = (g.to(torch.float32) * scale).to(torch.bfloat16)
        return vjp_product(gs, q, ctx.x_dtype), None, None, None


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x[..., K] @ (q[K, N] · scale[N])`` as ``[..., N]`` in ``out_dtype``.

    ``x`` float32 or bf16 activations (leading dims flattened to M), ``q``
    int8 weights, ``scale`` per-output-channel float32 (the layout
    :func:`calibrate_int8` returns); float32 activations give a float32
    output, bf16 ones either. CUDA tensors launch B5 or raise
    ``RuntimeError``; CPU tensors run :func:`int8_matmul_reference`.
    Differentiable with respect to ``x``."""
    _check(x, q, scale, out_dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Int8Matmul.apply(x, q, scale, out_dtype)
    return custom_ops.int8_matmul(x, q, scale, out_dtype)
