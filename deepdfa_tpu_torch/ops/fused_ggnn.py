"""Fused GGNN message passing: the hand-written CUDA kernels and their plain
versions, forward and training backward.

The port of ``deepdfa_tpu/ops/fused_ggnn.py``: the Pallas TPU kernels
``_kernel`` (B1, the forward) and ``_train_kernel`` (B2, the training
backward), and the ``custom_vjp`` that joins them. :func:`fused_ggnn` runs
``n_steps`` rounds of (edge linear → gather(senders) → sum per receiver →
GRU) and keeps the JAX package's public signature and ``[in, out]`` weight
layout:

- on CUDA tensors it launches the kernels of ``csrc/fused_ggnn.cu`` (built
  for ``sm_90a`` at first use): one row-pointer build per call, then two
  launches per round. When a gradient is needed, the call goes through a
  ``torch.autograd.Function`` whose forward banks each round's pre-update
  state and aggregate, and whose backward launches the kernels of
  ``csrc/fused_ggnn_bwd.cu``: one CSC build, then three launches per
  reverse round (six with the ``"ffma"`` variant) and one final reduction.
  A failed
  build or launch raises; nothing falls back;
- on CPU tensors it runs :func:`fused_ggnn_reference` forward and
  :func:`fused_ggnn_backward_reference` backward, the same math in plain
  torch.

Both directions have two variants, chosen by :func:`variant` from the
width: ``"wgmma"`` (width 128 after padding to a multiple of 4, the golden
width and every bucket of the main paths: 3xTF32 products on the tensor
cores, the edge sum with runs of one sender in closed form) and ``"ffma"``
(any other width: float32 FFMA products, the serial edge sum). Both sum
every edge segment in edge-list order, bit for bit the serial float32 sum.

``n_launches`` counts the forward's CUDA kernel launches
(:func:`launches_per_call` per call) and ``n_bwd_launches`` the backward's
(:func:`bwd_launches_per_call` per call), one per launch;
``n_variant_launches`` and ``n_bwd_variant_launches`` count them by variant.
"""

from __future__ import annotations

import ctypes

import torch

from deepdfa_tpu_torch.ops import _build

__all__ = ["BWD_KERNELS", "TC_WIDTH", "VARIANTS", "bwd_launches_per_call",
           "fused_ggnn", "fused_ggnn_backward_reference",
           "fused_ggnn_reference", "heads_words", "launches_per_call",
           "n_bwd_launches", "n_bwd_variant_launches", "n_launches",
           "n_variant_launches", "variant"]

VARIANTS = ("wgmma", "ffma")
# CUDA kernel launches made by fused_ggnn's forward (B1) and backward (B2)
# since the last reset, in all and by variant
n_launches = 0
n_bwd_launches = 0
n_variant_launches = dict.fromkeys(VARIANTS, 0)
n_bwd_variant_launches = dict.fromkeys(VARIANTS, 0)
# the one width the tensor-core variant takes (csrc/ggnn_tc.cuh kTcD)
TC_WIDTH = 128

# Values of the ``bwd_kernel`` option (the JAX package's backward tiers).
# On the card "auto" and "pallas" select the backward kernel and "xla"
# raises; on the CPU every one runs the plain backward.
BWD_KERNELS = ("auto", "pallas", "xla")

_P = ctypes.c_void_p
_I = ctypes.c_int
_fwd = None
_bwd = None
_max_width = 0
_max_train_width = 0


def _kernels() -> ctypes.CDLL:
    global _fwd, _max_width
    if _fwd is None:
        lib = _build.load("fused_ggnn")
        lib.ggnn_csr.argtypes = [_P, _I, _I, _P, _P]
        lib.ggnn_linear.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
        lib.ggnn_gru_round.argtypes = [_P] * 10 + [_I, _I, _P]
        lib.ggnn_tc_prep.argtypes = [_P, _P, _I, _I, _P, _P, _P]
        lib.ggnn_tc_linear.argtypes = [_P] * 8 + [_I, _P]
        lib.ggnn_tc_round.argtypes = [_P] * 12 + [_I, _P]
        for fn in (lib.ggnn_csr, lib.ggnn_linear, lib.ggnn_gru_round,
                   lib.ggnn_tc_prep, lib.ggnn_tc_linear, lib.ggnn_tc_round):
            fn.restype = _I
        lib.ggnn_max_width.argtypes = []
        lib.ggnn_max_width.restype = _I
        lib.ggnn_error_string.argtypes = [_I]
        lib.ggnn_error_string.restype = ctypes.c_char_p
        _max_width = lib.ggnn_max_width()
        _fwd = lib
    return _fwd


def _bwd_kernels() -> ctypes.CDLL:
    global _bwd, _max_train_width
    if _bwd is None:
        lib = _build.load("fused_ggnn_bwd")
        lib.ggnn_bwd_csc.argtypes = [_P, _I, _I, _P, _P]
        lib.ggnn_bwd_gate.argtypes = [_P] * 10 + [_I, _I, _P]
        lib.ggnn_bwd_linear.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
        lib.ggnn_bwd_transpose_sum.argtypes = [_P, _P, _P, _P, _I, _I, _P]
        lib.ggnn_bwd_wgrad.argtypes = [_P] * 6 + [_I, _I, _I, _P]
        lib.ggnn_bwd_reduce.argtypes = [_P, _I, _I, _P, _P]
        lib.ggnn_bwd_tc_prep.argtypes = [_P, _P, _I, _I, _P, _P, _P]
        lib.ggnn_bwd_tc_gate.argtypes = [_P] * 11 + [_I, _P]
        lib.ggnn_bwd_tc_tsum.argtypes = [_P] * 7 + [_I, _P]
        lib.ggnn_bwd_tc_wgrad.argtypes = [_P] * 6 + [_I, _I, _P]
        for fn in (lib.ggnn_bwd_csc, lib.ggnn_bwd_gate, lib.ggnn_bwd_linear,
                   lib.ggnn_bwd_transpose_sum, lib.ggnn_bwd_wgrad,
                   lib.ggnn_bwd_reduce, lib.ggnn_bwd_tc_prep,
                   lib.ggnn_bwd_tc_gate, lib.ggnn_bwd_tc_tsum,
                   lib.ggnn_bwd_tc_wgrad):
            fn.restype = _I
        for fn in (lib.ggnn_bwd_partial_width, lib.ggnn_bwd_chunks):
            fn.argtypes = [_I]
            fn.restype = _I
        lib.ggnn_bwd_max_width.argtypes = []
        lib.ggnn_bwd_max_width.restype = _I
        lib.ggnn_error_string.argtypes = [_I]
        lib.ggnn_error_string.restype = ctypes.c_char_p
        _max_train_width = lib.ggnn_bwd_max_width()
        _bwd = lib
    return _bwd


def variant(width: int) -> str:
    """The variant of B1 and B2 that takes a call of node width ``width``:
    ``"wgmma"`` when the width padded to a multiple of 4 is
    :data:`TC_WIDTH` (the tensor-core kernels are written for it), else
    ``"ffma"``."""
    return "wgmma" if -(-width // 4) * 4 == TC_WIDTH else "ffma"


def launches_per_call(n_steps: int) -> int:
    """CUDA launches one :func:`fused_ggnn` forward makes: the row-pointer
    build and two per round, on either variant."""
    return 1 + 2 * n_steps if n_steps > 0 else 0


def bwd_launches_per_call(n_steps: int, kind: str = "wgmma") -> int:
    """CUDA launches one backward of :func:`fused_ggnn` makes: the CSC
    build, three per reverse round (``"wgmma"``: the gate products with the
    two products with the transposed gate weights, the transposed edge sum
    with the edge weight's product, the weight gradients) or six
    (``"ffma"``), and the reduction of the weight gradients."""
    per_round = {"wgmma": 3, "ffma": 6}[kind]
    return 2 + per_round * n_steps if n_steps > 0 else 0


def heads_words(n_edges: int) -> int:
    """32-bit words of the change bitmask the tensor-core variant's edge
    sum reads: one bit per 32 edges, at least one word
    (``csrc/ggnn_tc.cuh`` ``heads_words``)."""
    return max(1, -(-n_edges // 1024))


def _gru(agg, h, xw, xb, hw, hb):
    xr, xz, xn = (agg @ xw + xb).chunk(3, dim=-1)
    hr, hz, hn = (h @ hw + hb).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return r, z, n, hn


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
        _, z, n_, _ = _gru(agg, h, xw, xb, hw, hb)
        h = (1.0 - z) * n_ + z * h
    return h


def fused_ggnn_backward_reference(h0, senders, receivers, ew, eb, xw, xb, hw,
                                  hb, g, *, n_steps: int):
    """The plain torch version of the training backward (``_train_kernel``
    of the JAX package): bank each round's pre-update state and aggregate,
    then run the reverse rounds with the cotangent chain written out, the
    transpose edge sum as ``index_add_`` over senders and the products with
    ``.t()``. Returns ``(dh0, dew, deb, dxw, dxb, dhw, dhb)`` in float32,
    or in float64 when given float64 inputs (an exact yardstick for the
    kernel's float32 sums)."""
    dt = torch.promote_types(h0.dtype, torch.float32)
    h = h0.to(dt)
    n, d = h.shape
    hs, aggs = [], []
    for _ in range(n_steps):
        hs.append(h)
        msg = h @ ew + eb
        agg = h.new_zeros((n, d)).index_add_(
            0, receivers, msg.index_select(0, senders))
        aggs.append(agg)
        _, z, n_, _ = _gru(agg, h, xw, xb, hw, hb)
        h = (1.0 - z) * n_ + z * h
    dh = g.to(dt)
    dew, deb = torch.zeros_like(ew, dtype=dt), h.new_zeros(d)
    dxw, dhw = (torch.zeros_like(w, dtype=dt) for w in (xw, hw))
    dxb, dhb = h.new_zeros(3 * d), h.new_zeros(3 * d)
    for t in reversed(range(n_steps)):
        h, agg = hs[t], aggs[t]
        r, z, n_, hn = _gru(agg, h, xw, xb, hw, hb)
        dz = dh * (h - n_)
        dn = dh * (1.0 - z)
        dpre_n = dn * (1.0 - n_ * n_)
        dr = dpre_n * hn
        dpre_r = dr * r * (1.0 - r)
        dpre_z = dz * z * (1.0 - z)
        dxp = torch.cat([dpre_r, dpre_z, dpre_n], dim=1)
        dhp = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=1)
        # x-projection: xp = agg @ xw + xb
        dagg = dxp @ xw.t()
        dxw += agg.t() @ dxp
        dxb += dxp.sum(0)
        # h-projection: hp = h @ hw + hb, plus the direct z·h path
        dh_next = dh * z + dhp @ hw.t()
        dhw += h.t() @ dhp
        dhb += dhp.sum(0)
        # transpose of the receiver-ordered edge sum, then the edge linear
        dmsg = h.new_zeros((n, d)).index_add_(
            0, senders, dagg.index_select(0, receivers))
        dh = dh_next + dmsg @ ew.t()
        dew += h.t() @ dmsg
        deb += dmsg.sum(0)
    return dh, dew, deb, dxw, dxb, dhw, dhb


def _check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.ggnn_error_string(code).decode()
        raise RuntimeError(f"fused_ggnn: {what} launch failed: {msg} ({code})")


def _pad_width(ew, eb, xw, xb, hw, hb, d: int, dp: int):
    """The weights at width ``dp >= d``: zero rows and columns added to every
    r|z|n block. A node state padded with zero columns keeps them at zero
    through a round (their gates give ``h' = 0.5 * 0 + 0.5 * 0``), and a
    cotangent padded with zero columns keeps them at zero through a reverse
    round (every product that feeds them reads a zero weight row)."""
    p = dp - d
    ew = torch.nn.functional.pad(ew, (0, p, 0, p))
    eb = torch.nn.functional.pad(eb, (0, p))
    gates = lambda w: torch.nn.functional.pad(
        w.reshape(d, 3, d), (0, p, 0, 0, 0, p)).reshape(dp, 3 * dp)
    bias = lambda b: torch.nn.functional.pad(b.reshape(3, d), (0, p)).reshape(-1)
    return ew, eb, gates(xw), bias(xb), gates(hw), bias(hb)


def _unpad_grads(dew, deb, dxw, dxb, dhw, dhb, d: int, dp: int):
    """Inverse of :func:`_pad_width` on the weight gradients."""
    gates = lambda w: w.reshape(dp, 3, dp)[:d, :, :d].reshape(d, 3 * d)
    bias = lambda b: b.reshape(3, dp)[:, :d].reshape(-1)
    return (dew[:d, :d], deb[:d], gates(dxw), bias(dxb), gates(dhw),
            bias(dhb))


def _validate(h0, senders, receivers, ew, eb, xw, xb, hw, hb, bwd_kernel):
    if bwd_kernel not in BWD_KERNELS:
        raise ValueError(f"bwd_kernel must be auto|pallas|xla, got "
                         f"{bwd_kernel!r}")
    if h0.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_ggnn runs on cuda or cpu, not {h0.device}")
    if any(t.device != h0.device
           for t in (ew, eb, xw, xb, hw, hb, senders, receivers)):
        raise ValueError("fused_ggnn: every argument must be on one device")
    n, d = h0.shape
    e = senders.shape[0]
    shapes = {"ew": (ew, (d, d)), "eb": (eb, (d,)), "xw": (xw, (d, 3 * d)),
              "xb": (xb, (3 * d,)), "hw": (hw, (d, 3 * d)),
              "hb": (hb, (3 * d,)), "receivers": (receivers, (e,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"fused_ggnn: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the tensor-core
    kernels read rows as float4 and copy weight rows in bulk)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _Prepared:
    """The CUDA call's inputs at the padded width ``dp`` (a multiple of 4),
    in float32 / int32 and contiguous, and the variant that takes them."""

    def __init__(self, h0, senders, receivers, weights, limit: int):
        n, d = h0.shape
        self.n, self.d, self.e = n, d, senders.shape[0]
        self.dp = dp = -(-d // 4) * 4
        self.variant = variant(d)
        if self.variant == "ffma" and dp > limit:
            raise ValueError(f"fused_ggnn: width {d} exceeds the kernels' "
                             f"shared-memory limit of {limit}")
        h = h0.to(torch.float32)
        w = tuple(t.to(torch.float32) for t in weights)
        if dp != d:
            w = _pad_width(*w, d, dp)
            h = torch.nn.functional.pad(h, (0, dp - d))
        self.h = _aligned(h)
        self.ew, self.eb, self.xw, self.xb, self.hw, self.hb = (
            _aligned(t) for t in w)
        self.snd = senders.to(torch.int32).contiguous()
        self.rcv = receivers.to(torch.int32).contiguous()


def _run(lib: ctypes.CDLL, kind: str, bwd: bool, what: str, fn, *args):
    """Launch one kernel through ``fn``, raise if it was refused, and count
    it for its direction and variant."""
    global n_launches, n_bwd_launches
    _check(lib, fn(*args), what)
    if bwd:
        n_bwd_launches += 1
        n_bwd_variant_launches[kind] += 1
    else:
        n_launches += 1
        n_variant_launches[kind] += 1


def _check_kind(p: _Prepared, kind: str | None) -> str:
    kind = kind or p.variant
    if kind not in VARIANTS:
        raise ValueError(f"unknown variant {kind!r}")
    if kind == "wgmma" and p.dp != TC_WIDTH:
        raise ValueError(f"fused_ggnn: the wgmma variant takes width "
                         f"{TC_WIDTH}, not {p.dp}")
    return kind


def _forward_cuda(p: _Prepared, n_steps: int, bank: bool,
                  kind: str | None = None):
    """B1's rounds on the card, on ``p.variant`` unless ``kind`` names the
    other. With ``bank`` every round writes a buffer of its own, so
    ``states[t]`` is round t's pre-update state, and ``aggs[t]`` its
    aggregate; otherwise two buffers alternate. Returns ``(out [n, dp],
    states, aggs)``."""
    kind = _check_kind(p, kind)
    lib = _kernels()
    n, dp, dev = p.n, p.dp, p.h.device
    # the stream current at the call (a backward may run on another one
    # than its forward, a captured call on the capture's)
    stream = torch.cuda.current_stream(dev).cuda_stream
    run = lambda what, fn, *args: _run(lib, kind, False, what, fn, *args,
                                       stream)
    row_ptr = torch.empty(n + 1, dtype=torch.int32, device=dev)
    msg = torch.empty_like(p.h)
    out = torch.empty_like(p.h)
    if bank:
        later = torch.empty((n_steps - 1, n, dp), device=dev)
        aggs = torch.empty((n_steps, n, dp), device=dev)
        targets = list(later) + [out]
    else:
        # ping-pong so that the last round writes into `out`
        spare = torch.empty_like(p.h)
        targets = [out if (n_steps - 1 - t) % 2 == 0 else spare
                   for t in range(n_steps)]
    w = [t.data_ptr() for t in (p.ew, p.eb, p.xw, p.xb, p.hw, p.hb)]
    if kind == "wgmma":
        heads = torch.empty(heads_words(p.e), dtype=torch.int32, device=dev)
        # the padding sink's row, found by each round's edge linear
        flags = torch.empty(n, dtype=torch.int32, device=dev)
        run("tc_prep", lib.ggnn_tc_prep, p.rcv.data_ptr(), p.snd.data_ptr(),
            p.e, n, row_ptr.data_ptr(), heads.data_ptr())
    else:
        run("csr", lib.ggnn_csr, p.rcv.data_ptr(), p.e, n, row_ptr.data_ptr())
    cur = p.h
    for t in range(n_steps):
        nxt = targets[t]
        agg = aggs[t].data_ptr() if bank else None
        if kind == "wgmma":
            run("tc_linear", lib.ggnn_tc_linear, cur.data_ptr(), w[0], w[1],
                row_ptr.data_ptr(), p.snd.data_ptr(), heads.data_ptr(),
                flags.data_ptr(), msg.data_ptr(), n)
            run("tc_round", lib.ggnn_tc_round, cur.data_ptr(), msg.data_ptr(),
                row_ptr.data_ptr(), p.snd.data_ptr(), heads.data_ptr(),
                flags.data_ptr(), *w[2:], nxt.data_ptr(), agg, n)
        else:
            run("linear", lib.ggnn_linear, cur.data_ptr(), w[0], w[1],
                msg.data_ptr(), n, dp, dp)
            run("gru_round", lib.ggnn_gru_round, cur.data_ptr(),
                msg.data_ptr(), row_ptr.data_ptr(), p.snd.data_ptr(), *w[2:],
                nxt.data_ptr(), agg, n, dp)
        cur = nxt
    if not bank:
        return out, None, None
    return out, [p.h] + list(later), list(aggs)


def _backward_cuda(p: _Prepared, states, aggs, g: torch.Tensor,
                   kind: str | None = None):
    """B2's reverse rounds on the card from the banked states and
    aggregates, on ``p.variant`` unless ``kind`` names the other. Returns
    the unpadded ``(dh0, dew, deb, dxw, dxb, dhw, dhb)``."""
    kind = _check_kind(p, kind)
    lib = _bwd_kernels()
    n, d, dp, e = p.n, p.d, p.dp, p.e
    n_steps = len(states)
    dev = p.h.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    run = lambda what, fn, *args: _run(lib, kind, True, what, fn, *args,
                                       stream)
    # the running cotangent, in buffers of its own (the rounds write them)
    dh = torch.zeros((n, dp), device=dev)
    dh[:, :d] = g
    # the sender-sorted (CSC) index: for each sender its edges' receivers
    # in edge-list order (the sort is stable)
    csc_snd, order = torch.sort(p.snd, stable=True)
    csc_rcv = p.rcv[order].contiguous()
    csc_ptr = torch.empty(n + 1, dtype=torch.int32, device=dev)
    dxp = torch.empty((n, 3 * dp), device=dev)
    # dhp = [dpre_r | dpre_z | dpre_n r]: the FFMA kernels write all of it,
    # the tensor-core ones its last block (dhn) beside dxp
    dhp = torch.empty((n, (3 if kind == "ffma" else 1) * dp), device=dev)
    dagg = torch.empty((n, dp), device=dev)
    dmsg = torch.empty_like(dagg)
    dh_next = torch.empty_like(dagg)
    chunks = lib.ggnn_bwd_chunks(n)
    ld = lib.ggnn_bwd_partial_width(dp)
    part = torch.empty((chunks, ld), device=dev)
    ew, xw, xb, hw, hb = (t.data_ptr() for t in (p.ew, p.xw, p.xb, p.hw, p.hb))
    if kind == "wgmma":
        heads = torch.empty(heads_words(e), dtype=torch.int32, device=dev)
        run("tc_prep", lib.ggnn_bwd_tc_prep, csc_snd.data_ptr(),
            csc_rcv.data_ptr(), e, n, csc_ptr.data_ptr(), heads.data_ptr())
    else:
        run("csc", lib.ggnn_bwd_csc, csc_snd.data_ptr(), e, n,
            csc_ptr.data_ptr())
        xw_t, hw_t, ew_t = (w.t().contiguous() for w in (p.xw, p.hw, p.ew))
    for i, t in enumerate(reversed(range(n_steps))):
        h, agg = states[t].data_ptr(), aggs[t].data_ptr()
        gate = (h, agg, dh.data_ptr(), xw, xb, hw, hb, dxp.data_ptr(),
                dhp.data_ptr())
        wgrad = (agg, dxp.data_ptr(), h, dhp.data_ptr(), dmsg.data_ptr(),
                 part.data_ptr(), n)
        if kind == "wgmma":
            run("tc_gate", lib.ggnn_bwd_tc_gate, *gate, dagg.data_ptr(),
                dh_next.data_ptr(), n)
            run("tc_tsum", lib.ggnn_bwd_tc_tsum, dagg.data_ptr(),
                csc_ptr.data_ptr(), csc_rcv.data_ptr(), heads.data_ptr(), ew,
                dmsg.data_ptr(), dh_next.data_ptr(), n)
            run("tc_wgrad", lib.ggnn_bwd_tc_wgrad, *wgrad, int(i > 0))
        else:
            run("gate_bwd", lib.ggnn_bwd_gate, *gate, dh_next.data_ptr(), n,
                dp)
            run("linear (dagg)", lib.ggnn_bwd_linear, dxp.data_ptr(),
                xw_t.data_ptr(), dagg.data_ptr(), n, 3 * dp, dp, 0)
            run("linear (dh)", lib.ggnn_bwd_linear, dhp.data_ptr(),
                hw_t.data_ptr(), dh_next.data_ptr(), n, 3 * dp, dp, 1)
            run("transpose_sum", lib.ggnn_bwd_transpose_sum, dagg.data_ptr(),
                csc_ptr.data_ptr(), csc_rcv.data_ptr(), dmsg.data_ptr(), n, dp)
            run("linear (dmsg)", lib.ggnn_bwd_linear, dmsg.data_ptr(),
                ew_t.data_ptr(), dh_next.data_ptr(), n, dp, dp, 1)
            run("wgrad", lib.ggnn_bwd_wgrad, *wgrad, dp, int(i > 0))
        dh, dh_next = dh_next, dh
    flat = torch.empty(ld, device=dev)
    run("reduce", lib.ggnn_bwd_reduce, part.data_ptr(), chunks, ld,
        flat.data_ptr())
    sizes = [dp * 3 * dp, 3 * dp, dp * 3 * dp, 3 * dp, dp * dp, dp]
    dxw, dxb, dhw, dhb, dew, deb = flat.split(sizes)
    grads = _unpad_grads(dew.view(dp, dp), deb, dxw.view(dp, 3 * dp), dxb,
                         dhw.view(dp, 3 * dp), dhb, d, dp)
    return (dh[:, :d],) + grads


class _FusedGGNN(torch.autograd.Function):
    """The differentiable call (the ``custom_vjp`` of the JAX package).
    Weight gradients come back in the ``[in, out]`` layout the call was
    given; a caller passing ``linear.weight.t()`` gets them transposed back
    by autograd."""

    @staticmethod
    def forward(ctx, h0, senders, receivers, ew, eb, xw, xb, hw, hb,
                n_steps):
        ctx.n_steps = n_steps
        ctx.dtypes = tuple(t.dtype for t in (h0, ew, eb, xw, xb, hw, hb))
        if h0.device.type == "cpu":
            ctx.save_for_backward(h0, senders, receivers, ew, eb, xw, xb,
                                  hw, hb)
            return fused_ggnn_reference(h0, senders, receivers, ew, eb, xw,
                                        xb, hw, hb, n_steps=n_steps)
        ctx.empty = n_steps == 0 or h0.shape[0] == 0 or h0.shape[1] == 0
        if ctx.empty:
            ctx.shapes = tuple(t.shape for t in (ew, eb, xw, xb, hw, hb))
            return h0.to(torch.float32).clone()
        _kernels()
        _bwd_kernels()
        p = _Prepared(h0, senders, receivers, (ew, eb, xw, xb, hw, hb),
                      min(_max_width, _max_train_width))
        out, ctx.states, ctx.aggs = _forward_cuda(p, n_steps, bank=True)
        ctx.prepared = p
        return out if p.dp == p.d else out[:, :p.d].contiguous()

    @staticmethod
    def backward(ctx, g):
        if g.device.type == "cpu":
            grads = fused_ggnn_backward_reference(*ctx.saved_tensors, g,
                                                  n_steps=ctx.n_steps)
        elif ctx.empty:
            grads = (g.to(torch.float32),) + tuple(
                g.new_zeros(s, dtype=torch.float32) for s in ctx.shapes)
        else:
            grads = _backward_cuda(ctx.prepared, ctx.states, ctx.aggs, g)
            ctx.prepared = ctx.states = ctx.aggs = None
        dh0, dew, deb, dxw, dxb, dhw, dhb = (
            t.to(dt) for t, dt in zip(grads, ctx.dtypes))
        return dh0, None, None, dew, deb, dxw, dxb, dhw, dhb, None


def fused_ggnn(h0, senders, receivers, ew, eb, xw, xb, hw, hb, *,
               n_steps: int, bwd_kernel: str = "auto") -> torch.Tensor:
    """``n_steps`` GGNN rounds from node states ``h0 [N, D]``.

    ``senders``/``receivers``: ``[E]`` integer edge endpoints, sorted by
    receiver (the ``batch_np`` contract, which the models check); each
    receiver's messages are summed in edge-list order. ``ew [D, D]``,
    ``eb [D]``: the edge linear; ``xw``/``hw [D, 3D]``, ``xb``/``hb [3D]``:
    the fused r|z|n GRU projections. Computes in float32; returns ``[N, D]``.
    On CUDA a width that is not a multiple of 4 runs padded with zero
    columns to the next one (the edge sums read rows as ``float4``).

    Differentiable with respect to ``h0`` and the six weights.
    ``bwd_kernel`` is the JAX package's backward-tier option: on the card
    ``"auto"`` and ``"pallas"`` select the backward kernel, and ``"xla"``
    raises when a gradient is needed (the card has one backward, the
    kernel); on the CPU every value runs the plain backward. Any other
    value raises ``ValueError``.
    """
    _validate(h0, senders, receivers, ew, eb, xw, xb, hw, hb, bwd_kernel)
    weights = (ew, eb, xw, xb, hw, hb)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (h0,) + weights)
    if needs_grad:
        if h0.device.type == "cuda" and bwd_kernel == "xla":
            raise ValueError(
                "bwd_kernel='xla' asks for the XLA recompute backward, which "
                "the card does not have: its one backward is the CUDA kernel "
                "(bwd_kernel='auto' or 'pallas')")
        return _FusedGGNN.apply(h0, senders, receivers, *weights, n_steps)
    if h0.device.type == "cpu":
        return fused_ggnn_reference(h0, senders, receivers, *weights,
                                    n_steps=n_steps)
    n, d = h0.shape
    if n_steps == 0 or n == 0 or d == 0:
        return h0.to(torch.float32).contiguous().clone()
    _kernels()
    p = _Prepared(h0, senders, receivers, weights, _max_width)
    out, _, _ = _forward_cuda(p, n_steps, bank=False)
    return out if p.dp == p.d else out[:, :d].contiguous()
