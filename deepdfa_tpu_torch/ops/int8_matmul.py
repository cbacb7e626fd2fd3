"""Matrix product with int8-resident weights, and their calibration.

The port of ``deepdfa_tpu/ops/int8_matmul.py``:

    y[..., N] = x[..., K] @ (q[K, N] · scale[N])  =  (x @ q) · scale

(the per-output-channel scale distributes out of the contraction).

- :func:`int8_matmul` on CUDA tensors launches the hand-written kernel of
  ``csrc/int8_matmul.cu`` (kernel B5, built for ``sm_90a`` at first use:
  the int8 weight tile dequantized in registers, FFMA over K in a fixed
  order, the scale in the epilogue) or raises ``RuntimeError`` when it does
  not build or launch; on CPU tensors it runs
  :func:`int8_matmul_reference`. Activations are float32 (the JAX kernel
  also takes bf16 for the LLM, which comes with that slice); the output is
  float32. ``n_launches`` counts the kernel's launches.
- Differentiable with respect to ``x`` only, as the JAX ``custom_vjp``:
  ``dx = (g · scale) @ qᵀ`` with both factors rounded to bf16 and summed in
  float32. The weight and scale are a frozen base and get no gradient.
- :func:`calibrate_int8` is the host-side symmetric absmax calibration, in
  numpy, bit for bit the JAX package's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from deepdfa_tpu_torch.ops import _build

__all__ = ["calibrate_int8", "int8_matmul", "int8_matmul_reference",
           "n_launches"]

# CUDA kernel launches made by int8_matmul (B5) since the last reset.
n_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("int8_matmul")
        lib.i8_matmul.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
        lib.i8_matmul.restype = _I
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
    and ``scale`` bit for bit the JAX package's."""
    w = np.asarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(
            f"calibrate_int8 expects a [K, N] weight, got shape {w.shape}")
    if not bool(np.all(np.isfinite(w))):
        raise ValueError(
            "calibrate_int8: non-finite values in calibration weights — "
            "refusing to quantize a NaN/inf-poisoned source (clamping would "
            "silently corrupt every score through this matmul)")
    absmax = np.max(np.abs(w), axis=0)
    scale = np.where(absmax > 0, absmax / np.float32(127.0),
                     np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """``(x @ q) · scale`` in plain torch, float32."""
    return (x.to(torch.float32) @ q.to(torch.float32)) * scale.to(
        torch.float32)


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"int8_matmul takes float32 activations, got "
                        f"{x.dtype}")
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


def _forward(x: torch.Tensor, q: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """B5 on CUDA tensors, the plain version on CPU tensors."""
    global n_launches
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale)
    k, n = q.shape
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        lib = _kernels()
        q = q.contiguous()
        scale = scale.to(torch.float32).contiguous()
        code = lib.i8_matmul(x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
                             out.data_ptr(), m, k, n,
                             torch.cuda.current_stream(x.device).cuda_stream)
        if code != 0:
            msg = lib.i8_error_string(code).decode()
            raise RuntimeError(f"int8_matmul: launch failed: {msg} ({code})")
        n_launches += 1
    return out.reshape(*x.shape[:-1], n)


class _Int8Matmul(torch.autograd.Function):
    """The product, differentiable with respect to ``x`` only."""

    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)
        return _forward(x, q, scale)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        # the JAX package's VJP: both factors in bf16, summed in float32
        gs = (g.to(torch.float32) * scale).to(torch.bfloat16).to(torch.float32)
        dx = gs @ q.t().to(torch.bfloat16).to(torch.float32)
        return dx, None, None


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``x[..., K] @ (q[K, N] · scale[N])`` as float32 ``[..., N]``.

    ``x`` float32 activations (leading dims flattened to M), ``q`` int8
    weights, ``scale`` per-output-channel float32 (the layout
    :func:`calibrate_int8` returns). CUDA tensors launch B5 or raise
    ``RuntimeError``; CPU tensors run :func:`int8_matmul_reference`.
    Differentiable with respect to ``x``."""
    _check(x, q, scale)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Int8Matmul.apply(x, q, scale)
    return _forward(x, q, scale)
