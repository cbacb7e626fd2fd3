"""Kernels B6 and B6b: the wrapper's choice of variant, on the CPU (the
kernels themselves run only on the card: tests/test_torch_cuda.py).

Stand-in libraries record every entry point the wrapper calls with its
shape, and read the arguments through their addresses as dense arrays, as
the kernels do, computing the plain versions there. They hold that:

- every shape of the LLM tier (CodeLlama-7B serving and training, b 4,
  s 256, h 32, d 128; the 13B presets, h 40 at s 1024 and 2048;
  grouped-query heads at d 128) reaches the ``wgmma`` entries of the
  forward and of both backward kernels;
- bf16 at d 16, 32 and 64, at an s that is not a multiple of 128, and a
  view at an address TMA cannot take reach ``"mma"``; float32 reaches
  ``"ffma"``; a call's backward takes its forward's variant;
- a failed launch of each ``wgmma`` entry raises;
- a cotangent handed over expanded or transposed reaches the ``wgmma``
  entries dense.

Tolerance: the stand-ins compute the plain versions themselves, so the
wrapper's outputs equal them bitwise.
"""

import ctypes
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepdfa_tpu_torch.ops import flash_attention as tfa  # noqa: E402

# name, b, s, h, h_kv: the LLM tier at d 128
MAIN_SHAPES = [("7b", 4, 256, 32, 32), ("13b_s1024", 6, 1024, 40, 40),
               ("13b_s2048", 4, 2048, 40, 40), ("gqa", 2, 256, 8, 2)]


def _dense(ptr, shape, dtype):
    """The ``shape`` array of ``dtype`` at address ``ptr``, dense, as the
    kernels index their arguments."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    buf = (ctypes.c_char * n).from_address(ptr)
    return torch.from_numpy(np.frombuffer(buf, dtype=dtype).reshape(shape))


def _read(ptr, shape, bf16):
    x = _dense(ptr, shape, np.uint16 if bf16 else np.float32)
    return x.view(torch.bfloat16) if bf16 else x


def _write(ptr, shape, bf16, value):
    out = _dense(ptr, shape, np.uint16 if bf16 else np.float32)
    out[:] = value.view(torch.uint16) if bf16 else value


class _RecordingLib:
    """Stands in for both built libraries on CPU memory: each entry point
    records ``(entry, b, s, h, h_kv, d)`` and, when ``compute`` is set,
    writes the plain version's results from its arguments read through
    their addresses; the entries named in ``fail`` return an error code
    instead."""

    def __init__(self, compute=True, fail=()):
        self.calls, self.compute, self.fail = [], compute, fail

    def _code(self, entry):
        return 700 if entry in self.fail else 0

    def _seg(self, ptr, b, s):
        return None if ptr is None else _dense(ptr, (b, s), np.int32) != 0

    def _forward(self, entry, q, k, v, seg, out, lse, b, s, h, h_kv, d,
                 causal, bf16):
        self.calls.append((entry, b, s, h, h_kv, d))
        if self.compute and not self._code(entry):
            qs, ks, vs = (_read(p, (b, s, n, d), bf16)
                          for p, n in ((q, h), (k, h_kv), (v, h_kv)))
            o, row_lse = tfa._reference_forward(qs, ks, vs,
                                                self._seg(seg, b, s),
                                                bool(causal))
            _write(out, (b, s, h, d), bf16, o)
            if lse is not None:
                _dense(lse, (b, h, s), np.float32)[:] = row_lse
        return self._code(entry)

    def fa_forward(self, q, k, v, seg, out, lse, b, s, h, h_kv, d, scale,
                   causal, is_bf16, stream):
        entry = "mma" if is_bf16 else "ffma"
        return self._forward(entry, q, k, v, seg, out, lse, b, s, h, h_kv,
                             d, causal, bool(is_bf16))

    def fa_forward_tc(self, q, k, v, seg, out, lse, b, s, h, h_kv, d, scale,
                      causal, stream):
        return self._forward("wgmma", q, k, v, seg, out, lse, b, s, h, h_kv,
                             d, causal, True)

    def _backward(self, entry, ptrs, outs, b, s, h, h_kv, d, causal, bf16):
        self.calls.append((entry, b, s, h, h_kv, d))
        if not self.compute or self._code(entry):
            return self._code(entry)
        q, k, v, do = (_read(p, (b, s, n, d), bf16) for p, n in zip(
            ptrs[:4], (h, h_kv, h_kv, h)))
        lse, di = (_dense(p, (b, h, s), np.float32) for p in ptrs[4:6])
        dq, dk, dv = tfa._reference_backward(q, k, v, do, lse, di,
                                             self._seg(ptrs[6], b, s),
                                             bool(causal))
        if len(outs) == 2:
            _write(outs[0], (b, s, h_kv, d), bf16, dk)
            _write(outs[1], (b, s, h_kv, d), bf16, dv)
        else:
            _write(outs[0], (b, s, h, d), bf16, dq)
        return 0

    def fa_backward_dkv(self, *a):
        b, s, h, h_kv, d, _, causal, is_bf16 = a[9:17]
        return self._backward("mma_dkv" if is_bf16 else "ffma_dkv", a[:7],
                              a[7:9], b, s, h, h_kv, d, causal, is_bf16)

    def fa_backward_dq(self, *a):
        b, s, h, h_kv, d, _, causal, is_bf16 = a[8:16]
        return self._backward("mma_dq" if is_bf16 else "ffma_dq", a[:7],
                              a[7:8], b, s, h, h_kv, d, causal, is_bf16)

    def fa_backward_dkv_tc(self, *a):
        b, s, h, h_kv, d, _, causal = a[9:16]
        return self._backward("wgmma_dkv", a[:7], a[7:9], b, s, h, h_kv, d,
                              causal, True)

    def fa_backward_dq_tc(self, *a):
        b, s, h, h_kv, d, _, causal = a[8:15]
        return self._backward("wgmma_dq", a[:7], a[7:8], b, s, h, h_kv, d,
                              causal, True)

    @staticmethod
    def fa_error_string(code):
        return b"an illegal memory access was encountered"

    fa_bwd_error_string = fa_error_string


@pytest.fixture
def lib(monkeypatch):
    def install(**kw):
        stand_in = _RecordingLib(**kw)
        monkeypatch.setattr(tfa, "_lib", stand_in)
        monkeypatch.setattr(tfa, "_bwd_lib", stand_in)
        return stand_in

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(tfa, "n_variant_launches",
                        dict.fromkeys(tfa.VARIANTS, 0))
    monkeypatch.setattr(tfa, "n_bwd_variant_launches",
                        dict.fromkeys(tfa.VARIANTS, 0))
    return install


def _inputs(b, s, h, h_kv, d, dtype, seed=0):
    """q, k, v, do from a seed, and a left-padded pad mask (row 0 unpadded,
    the last row all padding)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, n, d)).astype(np.float32)).to(dtype)
        for n in (h, h_kv, h_kv, h))
    mask = np.ones((b, s), dtype=bool)
    for i in range(1, b):
        mask[i, :s if i == b - 1 else int(rng.integers(1, s))] = False
    return q, k, v, do, torch.from_numpy(mask)


@pytest.mark.parametrize("name,b,s,h,h_kv", MAIN_SHAPES)
def test_llm_shapes_reach_the_wgmma_entries(lib, name, b, s, h, h_kv):
    stand_in = lib(compute=False)
    meta = dict(dtype=torch.bfloat16, device="meta")
    q, do = (torch.empty(b, s, h, 128, **meta) for _ in range(2))
    k, v = (torch.empty(b, s, h_kv, 128, **meta) for _ in range(2))
    seg = torch.empty(b, s, dtype=torch.int32, device="meta")
    lse = torch.empty(b, h, s, dtype=torch.float32, device="meta")
    assert tfa.variant(q, k, v) == "wgmma"
    tfa._launch_forward(q, k, v, seg, True, with_lse=True)
    tfa._launch_backward(q, k, v, q, do, lse, seg, True)
    shape = (b, s, h, h_kv, 128)
    assert stand_in.calls == [("wgmma", *shape), ("wgmma_dkv", *shape),
                              ("wgmma_dq", *shape)]
    assert tfa.n_variant_launches == {"wgmma": 1, "mma": 0, "ffma": 0}
    assert tfa.n_bwd_variant_launches == {"wgmma": 2, "mma": 0, "ffma": 0}


def _run(q, k, v, do, mask, causal):
    """``flash_attention``'s path on the card, on the stand-ins: the
    variant of the tensors as handed over, then B6 on dense aligned copies
    and B6b for ``do``; the output and gradients."""
    kind = tfa.variant(q, k, v)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tfa._Flash.apply(*leaves, tfa._seg(mask), causal, kind)
    out.backward(do)
    return out.detach(), [x.grad for x in leaves]


def _plain(q, k, v, do, mask, causal):
    """The plain versions on the dense inputs: output and gradients."""
    out, lse = tfa._reference_forward(q, k, v, mask, causal)
    return out, tfa.flash_attention_backward_reference(q, k, v, out, do, lse,
                                                       mask, causal=causal)


@pytest.mark.parametrize("b,s,h,h_kv,d,dtype,causal,kind", [
    (2, 128, 2, 1, 128, torch.bfloat16, True, "wgmma"),
    (2, 256, 4, 2, 128, torch.bfloat16, False, "wgmma"),
    (2, 128, 2, 2, 64, torch.bfloat16, True, "mma"),
    (2, 128, 2, 1, 32, torch.bfloat16, True, "mma"),
    (2, 128, 2, 2, 16, torch.bfloat16, False, "mma"),
    (2, 200, 2, 2, 128, torch.bfloat16, True, "mma"),  # s off the tile
    (2, 128, 4, 2, 16, torch.float32, True, "ffma"),
    (2, 128, 2, 2, 128, torch.float32, True, "ffma"),
])
def test_each_variant_gets_dense_operands_forward_and_backward(
        lib, b, s, h, h_kv, d, dtype, causal, kind):
    stand_in = lib()
    q, k, v, do, mask = _inputs(b, s, h, h_kv, d, dtype, seed=s + d)
    assert tfa.variant(q, k, v) == kind
    out, grads = _run(q, k, v, do, mask, causal)
    want, want_grads = _plain(q, k, v, do, mask, causal)
    shape = (b, s, h, h_kv, d)
    assert stand_in.calls == [(kind, *shape), (f"{kind}_dkv", *shape),
                              (f"{kind}_dq", *shape)]
    assert tfa.n_variant_launches[kind] == 1
    assert tfa.n_bwd_variant_launches[kind] == 2
    assert torch.equal(out, want)
    for got, ref in zip(grads, want_grads):
        assert got.dtype == dtype and torch.equal(got, ref)


def test_a_misaligned_view_reaches_the_mma_variant(lib):
    stand_in = lib()
    q, k, v, do, mask = _inputs(2, 128, 2, 2, 128, torch.bfloat16, seed=3)
    flat = torch.zeros(8 + q.numel(), dtype=torch.bfloat16)
    q_off = flat[1:1 + q.numel()].view(q.shape)  # 2 bytes off alignment
    q_off.copy_(q)
    assert q_off.is_contiguous() and q_off.data_ptr() % 16
    assert tfa.variant(flat[8:].view(q.shape), k, v) == "wgmma"
    assert tfa.variant(q_off, k, v) == "mma"
    # a last axis that is not dense cannot be described to TMA
    assert tfa.variant(q, k, torch.cat([v, v], dim=-1)[..., ::2]) == "mma"
    out, grads = _run(q_off, k, v, do, mask, True)
    want, want_grads = _plain(q, k, v, do, mask, True)
    assert [c[0] for c in stand_in.calls] == ["mma", "mma_dkv", "mma_dq"]
    assert torch.equal(out, want)
    assert all(torch.equal(g, w) for g, w in zip(grads, want_grads))


@pytest.mark.parametrize("entry,match,launched", [
    ("wgmma", "flash_attention: wgmma launch failed", 0),
    ("wgmma_dkv", "fa_backward_dkv_tc .wgmma. launch failed", 0),
    ("wgmma_dq", "fa_backward_dq_tc .wgmma. launch failed", 1)])
def test_a_failed_wgmma_launch_raises(lib, entry, match, launched):
    stand_in = lib(fail=(entry,))
    q, k, v, do, mask = _inputs(1, 128, 2, 2, 128, torch.bfloat16, seed=4)
    seg = tfa._seg(mask)
    before = tfa.n_launches, tfa.n_bwd_launches
    with pytest.raises(RuntimeError, match=match):
        out, lse = tfa._launch_forward(q, k, v, seg, True, True)
        tfa._launch_backward(q, k, v, out, do, lse, seg, True)
    assert stand_in.calls[-1][0] == entry
    # nothing fell back to another variant; a failed launch is not counted
    assert {c[0] for c in stand_in.calls} <= {"wgmma", "wgmma_dkv",
                                              "wgmma_dq"}
    if entry == "wgmma":
        assert tfa.n_launches == before[0]
    else:
        assert tfa.n_bwd_launches - before[1] == launched


@pytest.mark.parametrize("cotangent", ["sum", "mean", "transposed"])
def test_an_expanded_or_transposed_cotangent_reaches_wgmma_dense(lib,
                                                                 cotangent):
    stand_in = lib()
    b, s, h, h_kv, d = 2, 128, 4, 2, 128
    q, k, v, _, mask = _inputs(b, s, h, h_kv, d, torch.bfloat16, seed=6)
    weight = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (b, h, s, d)).astype(np.float32)).to(torch.bfloat16)
    loss = {"sum": lambda o: o.sum(), "mean": lambda o: o.mean(),
            "transposed": lambda o: (o.transpose(1, 2) * weight).sum()
            }[cotangent]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    loss(tfa._Flash.apply(*leaves, tfa._seg(mask), True)).backward()
    out, lse = tfa._reference_forward(q, k, v, mask, True)
    probe = out.clone().requires_grad_(True)
    do = torch.autograd.grad(loss(probe), probe)[0].contiguous()
    want = tfa.flash_attention_backward_reference(q, k, v, out, do, lse,
                                                  mask)
    assert [c[0] for c in stand_in.calls] == ["wgmma", "wgmma_dkv",
                                              "wgmma_dq"]
    for leaf, ref in zip(leaves, want):
        assert torch.equal(leaf.grad, ref)
