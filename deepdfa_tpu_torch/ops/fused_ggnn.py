"""Fused GGNN message passing: the hand-written CUDA kernel and its plain version.

The port of ``deepdfa_tpu/ops/fused_ggnn.py`` (the Pallas TPU kernel
``_kernel``). :func:`fused_ggnn` runs ``n_steps`` rounds of (edge linear →
gather(senders) → sum per receiver → GRU) and keeps the JAX package's public
signature and ``[in, out]`` weight layout:

- on CUDA tensors it launches the kernels of ``csrc/fused_ggnn.cu`` (built
  for ``sm_90a`` at first use): one CSR build per call, then two launches
  per round. A failed build or launch raises; nothing falls back;
- on CPU tensors it runs :func:`fused_ggnn_reference`, the same math in
  plain torch.

``n_launches`` counts the CUDA kernel launches, one per launch:
``1 + 2 * n_steps`` per call. This slice is forward only: a CUDA call that
would need a gradient raises (the backward kernel comes with training).
"""

from __future__ import annotations

import ctypes

import torch

from deepdfa_tpu_torch.ops import _build

__all__ = ["fused_ggnn", "fused_ggnn_reference", "launches_per_call",
           "n_launches"]

# CUDA kernel launches made by fused_ggnn since the last reset.
n_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None
_max_width = 0


def _kernels() -> ctypes.CDLL:
    global _lib, _max_width
    if _lib is None:
        lib = _build.load("fused_ggnn")
        lib.ggnn_csr.argtypes = [_P, _I, _I, _P, _P]
        lib.ggnn_linear.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
        lib.ggnn_gru_round.argtypes = [_P] * 8 + [_P, _I, _I, _P]
        for fn in (lib.ggnn_csr, lib.ggnn_linear, lib.ggnn_gru_round):
            fn.restype = _I
        lib.ggnn_max_width.argtypes = []
        lib.ggnn_max_width.restype = _I
        lib.ggnn_error_string.argtypes = [_I]
        lib.ggnn_error_string.restype = ctypes.c_char_p
        _max_width = lib.ggnn_max_width()
        _lib = lib
    return _lib


def launches_per_call(n_steps: int) -> int:
    """CUDA launches one :func:`fused_ggnn` call makes."""
    return 1 + 2 * n_steps if n_steps > 0 else 0


def fused_ggnn_reference(h0, senders, receivers, ew, eb, xw, xb, hw, hb, *,
                         n_steps: int) -> torch.Tensor:
    """The plain torch version (``_unrolled_reference`` of the JAX package).
    Edges are summed per receiver with ``index_add_``: in edge-list order on
    the CPU, with atomics on CUDA."""
    h = h0.float()
    n = h.shape[0]
    for _ in range(n_steps):
        msg = h @ ew + eb
        agg = h.new_zeros((n, h.shape[1])).index_add_(
            0, receivers, msg.index_select(0, senders))
        xr, xz, xn = (agg @ xw + xb).chunk(3, dim=-1)
        hr, hz, hn = (h @ hw + hb).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n_ = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n_ + z * h
    return h


def _check(code: int, what: str) -> None:
    if code != 0:
        msg = _kernels().ggnn_error_string(code).decode()
        raise RuntimeError(f"fused_ggnn: {what} launch failed: {msg} ({code})")


def _pad_width(ew, eb, xw, xb, hw, hb, d: int, dp: int):
    """The weights at width ``dp >= d``: zero rows and columns added to every
    r|z|n block. A node state padded with zero columns keeps them at zero
    through a round (their gates give ``h' = 0.5 * 0 + 0.5 * 0``)."""
    p = dp - d
    ew = torch.nn.functional.pad(ew, (0, p, 0, p))
    eb = torch.nn.functional.pad(eb, (0, p))
    gates = lambda w: torch.nn.functional.pad(
        w.reshape(d, 3, d), (0, p, 0, 0, 0, p)).reshape(dp, 3 * dp)
    bias = lambda b: torch.nn.functional.pad(b.reshape(3, d), (0, p)).reshape(-1)
    return ew, eb, gates(xw), bias(xb), gates(hw), bias(hb)


def fused_ggnn(h0, senders, receivers, ew, eb, xw, xb, hw, hb, *,
               n_steps: int) -> torch.Tensor:
    """``n_steps`` GGNN rounds from node states ``h0 [N, D]``.

    ``senders``/``receivers``: ``[E]`` integer edge endpoints, sorted by
    receiver (the ``batch_np`` contract, which the models check); each
    receiver's messages are summed in edge-list order. ``ew [D, D]``,
    ``eb [D]``: the edge linear; ``xw``/``hw [D, 3D]``, ``xb``/``hb [3D]``:
    the fused r|z|n GRU projections. Computes in float32; returns ``[N, D]``.
    On CUDA a width that is not a multiple of 4 runs padded with zero
    columns to the next one (the edge sum reads rows as ``float4``).
    """
    global n_launches
    if h0.device.type == "cpu":
        return fused_ggnn_reference(h0, senders, receivers, ew, eb, xw, xb,
                                    hw, hb, n_steps=n_steps)
    if h0.device.type != "cuda":
        raise ValueError(f"fused_ggnn runs on cuda or cpu, not {h0.device}")
    floats = (h0, ew, eb, xw, xb, hw, hb)
    tensors = floats + (senders, receivers)
    if any(t.device != h0.device for t in tensors):
        raise ValueError("fused_ggnn: every argument must be on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in floats):
        raise RuntimeError(
            "fused_ggnn on CUDA is forward only: call it under "
            "torch.no_grad()/inference_mode() (the backward kernel comes with "
            "the training slice)")
    n, d = h0.shape
    e = senders.shape[0]
    shapes = {"ew": (ew, (d, d)), "eb": (eb, (d,)), "xw": (xw, (d, 3 * d)),
              "xb": (xb, (3 * d,)), "hw": (hw, (d, 3 * d)),
              "hb": (hb, (3 * d,)), "receivers": (receivers, (e,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"fused_ggnn: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")
    h = h0.to(torch.float32).contiguous()
    if n_steps == 0 or n == 0 or d == 0:
        return h.clone()
    lib = _kernels()
    dp = -(-d // 4) * 4
    if dp > _max_width:
        raise ValueError(f"fused_ggnn: width {d} exceeds the kernel's "
                         f"shared-memory limit of {_max_width}")
    ew, eb, xw, xb, hw, hb = (t.to(torch.float32)
                              for t in (ew, eb, xw, xb, hw, hb))
    if dp != d:
        ew, eb, xw, xb, hw, hb = _pad_width(ew, eb, xw, xb, hw, hb, d, dp)
        h = torch.nn.functional.pad(h, (0, dp - d))
    ew, eb, xw, xb, hw, hb = (t.contiguous() for t in (ew, eb, xw, xb, hw, hb))
    snd = senders.to(torch.int32).contiguous()
    rcv = receivers.to(torch.int32).contiguous()

    stream = torch.cuda.current_stream(h0.device).cuda_stream
    row_ptr = torch.empty(n + 1, dtype=torch.int32, device=h0.device)
    msg = torch.empty_like(h)
    out = torch.empty_like(h)
    spare = torch.empty_like(h)
    _check(lib.ggnn_csr(rcv.data_ptr(), e, n, row_ptr.data_ptr(), stream),
           "csr")
    n_launches += 1
    cur = h
    for t in range(n_steps):
        # ping-pong so that the last round writes into `out`
        nxt = out if (n_steps - 1 - t) % 2 == 0 else spare
        _check(lib.ggnn_linear(cur.data_ptr(), ew.data_ptr(), eb.data_ptr(),
                               msg.data_ptr(), n, dp, dp, stream), "linear")
        n_launches += 1
        _check(lib.ggnn_gru_round(
            cur.data_ptr(), msg.data_ptr(), row_ptr.data_ptr(),
            snd.data_ptr(), xw.data_ptr(), xb.data_ptr(), hw.data_ptr(),
            hb.data_ptr(), nxt.data_ptr(), n, dp, stream), "gru_round")
        n_launches += 1
        cur = nxt
    return out if dp == d else out[:, :d].contiguous()
