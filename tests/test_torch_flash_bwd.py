"""B6b's plain version (``flash_attention_backward_reference``) and the
port's differentiable flash attention against the JAX package, on the CPU.

The JAX side differentiates ``deepdfa_tpu/llm/llama.py::_flash_attention``:
the stock Pallas TPU flash-attention kernel, whose custom VJP runs the
stock dk/dv and dq Pallas kernels, all in interpret mode
(``pltpu.force_tpu_interpret_mode``). The same numpy inputs (made from a
seed) go to both packages.

Tolerances, each over the gradient's largest value: float32 1e-5 (float32
sums in other orders: a query that sees one key has dq exactly 0 in exact
arithmetic, and the two packages return rounding noise of ~1e-7 of the
largest value there, so element-wise relative bounds do not apply); bf16
2e-2 (the JAX package's bar for its
flash path; p and ds are rounded to bf16 from float32 values that differ in
their last bits, the JAX path sums a kv group's dk and dv after rounding
each query head's to bf16, the port before).
"""

import ctypes
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from deepdfa_tpu.llm import llama as jl  # noqa: E402

from deepdfa_tpu_torch.ops import flash_attention as tfa  # noqa: E402


def _inputs(b, s, h, h_kv, d, seed):
    """q, k, v, the cotangent and a left-padded mask (one row unpadded,
    one with 100 pads, one all but 3 tokens padding)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    do = rng.normal(size=(b, s, h, d)).astype(np.float32)
    mask = np.ones((b, s), bool)
    mask[1, :100] = False
    mask[2, : s - 3] = False
    return q, k, v, do, mask


def _port_grads(fn, q, k, v, do, mask, dtype):
    t = [torch.from_numpy(x).to(dtype).requires_grad_(True)
         for x in (q, k, v)]
    out = fn(*t, torch.from_numpy(mask))
    out.backward(torch.from_numpy(do).to(dtype))
    return [x.grad.to(torch.float32).numpy() for x in t]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64])
def test_backward_reference_matches_the_stock_pallas_backward(dtype, d):
    """dq, dk, dv of B6b's plain version against ``jax.vjp`` of the JAX
    flash path (the stock dk/dv and dq Pallas kernels), GQA (4 query heads
    over 2 kv heads) and left pads included: padding queries attend to
    earlier padding keys and get gradients by the same rule."""
    q, k, v, do, mask = _inputs(3, 256, 4, 2, d, seed=d)
    jdt = jnp.dtype(dtype)
    @jax.jit
    def jax_grads(a, b, c, g):
        _, vjp = jax.vjp(lambda a, b, c: jl._flash_attention(
            a, b, c, jnp.asarray(mask)), a, b, c)
        return [x.astype(jnp.float32) for x in vjp(g)]

    # one jitted computation: TPU interpret mode runs JAX ops inside its
    # callbacks, and eager ops dispatched around a running pallas_call can
    # deadlock with them on a loaded host
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(g) for g in jax_grads(
            *(jnp.asarray(x, jdt) for x in (q, k, v, do)))]
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    o, lse = tfa._reference_forward(tq, tk, tv, torch.from_numpy(mask), True)
    got = tfa.flash_attention_backward_reference(
        tq, tk, tv, o, torch.from_numpy(do).to(tdt), lse,
        torch.from_numpy(mask))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and g.shape == w.shape, name
        g = g.to(torch.float32).numpy()
        limit = 1e-5 if dtype == "float32" else 2e-2
        assert np.abs(g - w).max() <= limit * np.abs(w).max(), name
    # the padding rows carry gradients (they attend to earlier padding)
    assert np.abs(want[0][1, :100]).max() > 0.01


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,h_kv", [(4, 2), (2, 2)])
def test_backward_reference_is_autograd_of_the_forward(causal, h, h_kv):
    """The explicit formulas against autograd of
    ``flash_attention_reference``, float32: the same gradients, kv groups
    summed."""
    q, k, v, do, mask = _inputs(3, 128, h, h_kv, 32, seed=h + causal)
    fwd = lambda a, b, c, m: tfa.flash_attention_reference(  # noqa: E731
        a, b, c, m, causal=causal)
    want = _port_grads(fwd, q, k, v, do, mask, torch.float32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = tfa._reference_forward(tq, tk, tv, torch.from_numpy(mask),
                                    causal)
    got = tfa.flash_attention_backward_reference(
        tq, tk, tv, o, torch.from_numpy(do), lse, torch.from_numpy(mask),
        causal=causal)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_cpu_gradients_run_the_plain_versions_and_count_no_launch():
    """On CPU tensors ``flash_attention`` is differentiated by autograd of
    its plain forward, and ``flash_attention_backward`` runs the explicit
    backward: the same gradients, no kernel launch counted."""
    q, k, v, do, mask = _inputs(3, 128, 4, 2, 16, seed=3)
    before = (tfa.n_launches, tfa.n_bwd_launches)
    auto = _port_grads(tfa.flash_attention, q, k, v, do, mask, torch.float32)
    tq, tk, tv, tdo, tm = (torch.from_numpy(x) for x in (q, k, v, do, mask))
    o, lse = tfa.flash_attention_forward(tq, tk, tv, tm)
    explicit = tfa.flash_attention_backward(tq, tk, tv, o, tdo, lse, tm)
    assert (tfa.n_launches, tfa.n_bwd_launches) == before
    for a, b in zip(auto, explicit):
        assert np.abs(a - b.numpy()).max() <= 1e-5 * np.abs(a).max()
    assert torch.equal(o, tfa.flash_attention_reference(tq, tk, tv, tm))
    bad = torch.zeros(1, 128, 2, 24)
    with pytest.raises(ValueError, match="head width"):
        tfa.flash_attention_backward(bad, bad, bad, bad, bad,
                                     torch.zeros(1, 2, 128))


@pytest.mark.parametrize("which,wrong", [
    ("do", lambda x: x.to(torch.bfloat16)),
    ("do", lambda x: x[:, :64]),
    ("o", lambda x: x[..., :8]),
    ("lse", lambda x: x.to(torch.float64)),
    ("lse", lambda x: x.transpose(1, 2)),
])
def test_backward_refuses_residuals_of_another_shape_or_type(which, wrong):
    """``o`` and ``do`` must be like ``q`` and ``lse`` float32 ``[b, h, s]``:
    anything else raises before any kernel reads it."""
    q, k, v, do, mask = _inputs(3, 128, 4, 2, 16, seed=4)
    tq, tk, tv, tdo, tm = (torch.from_numpy(x) for x in (q, k, v, do, mask))
    o, lse = tfa.flash_attention_forward(tq, tk, tv, tm)
    args = dict(o=o, do=tdo, lse=lse)
    args[which] = wrong(args[which])
    with pytest.raises(ValueError, match=f"{which} must be"):
        tfa.flash_attention_backward(tq, tk, tv, args["o"], args["do"],
                                     args["lse"], tm)


def _dense(ptr, shape, dtype):
    """The ``shape`` array of ``dtype`` a kernel reads at address ``ptr``:
    dense, as the CUDA kernels index their arguments."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    buf = (ctypes.c_char * n).from_address(ptr)
    return torch.from_numpy(np.frombuffer(buf, dtype=dtype).reshape(shape))


class _DenseReadingLib:
    """Stands in for the built kernels on CPU memory: each entry point reads
    its arguments through their addresses as dense arrays, as B6 and B6b
    do, and computes the plain versions there."""

    @staticmethod
    def _args(ptrs, b, s, h, h_kv, d):
        q = _dense(ptrs[0], (b, s, h, d), np.float32)
        k = _dense(ptrs[1], (b, s, h_kv, d), np.float32)
        v = _dense(ptrs[2], (b, s, h_kv, d), np.float32)
        return q, k, v

    @staticmethod
    def _seg(ptr, b, s):
        return None if ptr is None else _dense(ptr, (b, s), np.int32) != 0

    def fa_forward(self, q, k, v, seg, out, lse, b, s, h, h_kv, d, scale,
                   causal, bf16, stream):
        q, k, v = self._args((q, k, v), b, s, h, h_kv, d)
        o, row_lse = tfa._reference_forward(q, k, v, self._seg(seg, b, s),
                                            bool(causal))
        _dense(out, (b, s, h, d), np.float32)[:] = o
        if lse is not None:
            _dense(lse, (b, h, s), np.float32)[:] = row_lse
        return 0

    def _backward(self, ptrs, b, s, h, h_kv, d, causal):
        q, k, v = self._args(ptrs, b, s, h, h_kv, d)
        do = _dense(ptrs[3], (b, s, h, d), np.float32)
        lse = _dense(ptrs[4], (b, h, s), np.float32)
        di = _dense(ptrs[5], (b, h, s), np.float32)
        return tfa._reference_backward(q, k, v, do, lse, di,
                                       self._seg(ptrs[6], b, s),
                                       bool(causal))

    def fa_backward_dkv(self, *a):
        b, s, h, h_kv, d, _, causal = a[9:16]
        _, dk, dv = self._backward(a[:7], b, s, h, h_kv, d, causal)
        _dense(a[7], (b, s, h_kv, d), np.float32)[:] = dk
        _dense(a[8], (b, s, h_kv, d), np.float32)[:] = dv
        return 0

    def fa_backward_dq(self, *a):
        b, s, h, h_kv, d, _, causal = a[8:15]
        dq = self._backward(a[:7], b, s, h, h_kv, d, causal)[0]
        _dense(a[7], (b, s, h, d), np.float32)[:] = dq
        return 0


@pytest.mark.parametrize("cotangent", ["random", "sum", "mean",
                                       "transposed"])
def test_kernel_path_hands_the_kernels_a_dense_cotangent(monkeypatch,
                                                         cotangent):
    """The kernels' autograd path with stand-ins that read every argument
    through its address as a dense array: a loss that reduces the output
    directly (autograd hands over an expanded cotangent) or reads it
    transposed gives the gradients of the plain forward, float32 within
    1e-5 of each gradient's largest, with two backward launches."""
    q, k, v, _, mask = _inputs(3, 128, 4, 2, 16, seed=5)
    weight = torch.from_numpy(np.random.default_rng(6).normal(
        size=(3, 4, 128, 16)).astype(np.float32))
    loss = {"random": lambda o: (o * weight.transpose(1, 2)
                                 .contiguous()).sum(),
            "sum": lambda o: o.sum(), "mean": lambda o: o.mean(),
            "transposed": lambda o: (o.transpose(1, 2) * weight).sum()
            }[cotangent]
    monkeypatch.setattr(tfa, "_lib", _DenseReadingLib())
    monkeypatch.setattr(tfa, "_bwd_lib", _DenseReadingLib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    grads = []
    for kernels in (True, False):
        t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        tm = torch.from_numpy(mask)
        before = tfa.n_bwd_launches
        if kernels:
            out = tfa._Flash.apply(*t, tfa._seg(tm), True)
        else:
            out = tfa.flash_attention_reference(*t, tm)
        loss(out).backward()
        assert tfa.n_bwd_launches - before == (2 if kernels else 0)
        grads.append([x.grad for x in t])
    for name, got, want in zip(("dq", "dk", "dv"), *grads):
        top = float(want.abs().max())
        assert top > 0 and float((got - want).abs().max()) <= 1e-5 * top, \
            name
