"""Kernel B5's wrapper and the arithmetic of its tensor-core variant, on the
CPU (the kernels themselves run only on the card: tests/test_torch_cuda.py).

- Routing: stand-in libraries record every entry point the wrapper calls
  with its M, K, N and output type, and read the arguments through their
  addresses as dense arrays, as the kernels do. Every shape of the main
  paths (the LLM's projections at CodeLlama-7B and 13B widths, the GGNN's
  conv at its M buckets) reaches the tensor-core entry; decode (bf16, at
  most ``GEMV_MAX_M`` tokens, the projections and lm_heads of both) the
  gemv entry, and one token more the tensor-core one again; float32
  activations never take gemv; strides TMA cannot describe and a
  misaligned address reach the FFMA variant; a failed launch raises.
- Arithmetic: a float32 activation is exactly the sum of three bf16 terms,
  and the three bf16 products against the int8 weight sum to the plain
  version's product within float32 rounding.

Tolerances: the routing stand-ins compute the plain version itself, so the
wrapper's output equals it bitwise; the split is bitwise; the three-term
product is within 1e-6 of the largest output (float32 sums in another
order).
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepdfa_tpu_torch.ops import int8_matmul as tmm  # noqa: E402

# The GGNN's conv products: K = 128 (hidden 32 x 4 subkeys), N = 128 for
# the edge linear and 384 for the GRU's three gates, M the padded node
# count of the serving ladder, the megabatch shape and the largest
# training bucket
GGNN_SHAPES = [(m, 128, n) for m in (2048, 4096, 5120, 16768)
               for n in (128, 384)]
# The LLM's projections at 1,024 tokens (4 functions x block 256): q, k,
# v, o; gate and up; down, for CodeLlama-7B and 13B
LLM_SHAPES = [(1024, k, n) for k, n in (
    (4096, 4096), (4096, 11008), (11008, 4096),
    (5120, 5120), (5120, 13824), (13824, 5120))]
# The same projections at decode, one token a row, and both lm_heads
DECODE_KN = [(k, n) for _, k, n in LLM_SHAPES] + [(4096, 32016),
                                                   (5120, 32016)]
DECODE_M = (1, 4, 8, tmm.GEMV_MAX_M)


def _dense(ptr, shape, dtype):
    """The ``shape`` array of ``dtype`` at address ``ptr``, dense, as the
    kernels index their arguments."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    buf = (ctypes.c_char * n).from_address(ptr)
    return torch.from_numpy(np.frombuffer(buf, dtype=dtype).reshape(shape))


class _RecordingLib:
    """Stands in for the built library on CPU memory: each entry point
    records its call and, when ``compute`` is set, reads its arguments
    through their addresses and writes the plain version's result."""

    def __init__(self, compute=True, code=0):
        self.calls, self.compute, self.code = [], compute, code

    def _run(self, entry, x, q, scale, y, m, k, n, x_bf16, out_bf16):
        self.calls.append((entry, m, k, n, bool(out_bf16)))
        if self.compute and self.code == 0:
            xs = _dense(x, (m, k), np.uint16 if x_bf16 else np.float32)
            xs = xs.view(torch.bfloat16) if x_bf16 else xs
            want = tmm.int8_matmul_reference(
                xs, _dense(q, (k, n), np.int8),
                _dense(scale, (n,), np.float32),
                torch.bfloat16 if out_bf16 else torch.float32)
            out = _dense(y, (m, n), np.uint16 if out_bf16 else np.float32)
            out[:] = want.view(torch.int16).view(torch.uint16) \
                if out_bf16 else want
        return self.code

    def i8_matmul(self, x, q, scale, y, m, k, n, stream):
        return self._run("ffma", x, q, scale, y, m, k, n, False, False)

    def i8_matmul_tc(self, x, q, scale, y, m, k, n, stream):
        return self._run("wgmma", x, q, scale, y, m, k, n, False, False)

    def i8_matmul_bf16(self, x, q, scale, y, m, k, n, out_bf16, stream):
        return self._run("ffma", x, q, scale, y, m, k, n, True, out_bf16)

    def i8_matmul_tc_bf16(self, x, q, scale, y, m, k, n, out_bf16, stream):
        return self._run("wgmma", x, q, scale, y, m, k, n, True, out_bf16)

    def i8_matmul_gemv_bf16(self, x, q, scale, y, m, k, n, out_bf16,
                            stream):
        return self._run("gemv", x, q, scale, y, m, k, n, True, out_bf16)

    @staticmethod
    def i8_error_string(code):
        return b"an illegal memory access was encountered"


@pytest.fixture
def lib(monkeypatch):
    def install(**kw):
        stand_in = _RecordingLib(**kw)
        monkeypatch.setattr(tmm, "_lib", stand_in)
        return stand_in

    monkeypatch.setattr(tmm, "_stream", lambda device: 0)
    monkeypatch.setattr(tmm, "n_variant_launches",
                        dict.fromkeys(tmm.VARIANTS, 0))
    return install


def _operands(m, k, n, x_dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, scale = tmm.calibrate_int8(torch.randn(k, n, generator=gen))
    x = torch.randn(m, k, generator=gen).to(x_dtype)
    return x, q, scale


@pytest.mark.parametrize("m,k,n", LLM_SHAPES)
def test_llm_projections_reach_the_tensor_core_entry(lib, m, k, n):
    stand_in = lib(compute=False)
    x = torch.empty(m, k, dtype=torch.bfloat16)
    q = torch.empty(k, n, dtype=torch.int8)
    out = torch.empty(m, n, dtype=torch.bfloat16)
    tmm._launch(x, q, torch.ones(n), out)
    assert stand_in.calls == [("wgmma", m, k, n, True)]
    assert tmm.n_variant_launches == {"wgmma": 1, "ffma": 0, "gemv": 0}


@pytest.mark.parametrize("m,k,n", GGNN_SHAPES)
def test_ggnn_conv_products_reach_the_tensor_core_entry(lib, m, k, n):
    stand_in = lib(compute=False)
    x = torch.empty(m, k)
    q = torch.empty(k, n, dtype=torch.int8)
    tmm._launch(x, q, torch.ones(n), torch.empty(m, n))
    assert stand_in.calls == [("wgmma", m, k, n, False)]
    assert tmm.n_variant_launches == {"wgmma": 1, "ffma": 0, "gemv": 0}


@pytest.mark.parametrize("k,n", DECODE_KN)
@pytest.mark.parametrize("m", DECODE_M)
def test_decode_shapes_reach_the_gemv_entry(lib, m, k, n):
    stand_in = lib(compute=False)
    x = torch.empty(m, k, dtype=torch.bfloat16)
    q = torch.empty(k, n, dtype=torch.int8)
    tmm._launch(x, q, torch.ones(n), torch.empty(m, n, dtype=torch.bfloat16))
    assert stand_in.calls == [("gemv", m, k, n, True)]
    assert tmm.n_variant_launches == {"wgmma": 0, "ffma": 0, "gemv": 1}


@pytest.mark.parametrize("k,n", DECODE_KN)
def test_one_token_past_gemv_max_m_reaches_the_tensor_core_entry(lib, k, n):
    stand_in = lib(compute=False)
    m = tmm.GEMV_MAX_M + 1
    x = torch.empty(m, k, dtype=torch.bfloat16)
    q = torch.empty(k, n, dtype=torch.int8)
    tmm._launch(x, q, torch.ones(n), torch.empty(m, n, dtype=torch.bfloat16))
    assert stand_in.calls == [("wgmma", m, k, n, True)]


@pytest.mark.parametrize("m", DECODE_M)
def test_float32_activations_never_take_gemv(lib, m):
    stand_in = lib()
    x, q, scale = _operands(m, 128, 384, torch.float32)
    out = torch.empty(m, 384)
    tmm._launch(x, q, scale, out)
    assert stand_in.calls == [("wgmma", m, 128, 384, False)]
    assert torch.equal(out, tmm.int8_matmul_reference(x, q, scale))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 4, 8])
def test_a_decode_step_reaches_gemv_with_dense_operands(lib, b, out_dtype):
    """A decode step's ``[b, 1, K]`` activations, here a strided view (every
    other element of a buffer twice as wide), reach the gemv entry dense
    through the registered op's CUDA implementation, bitwise the plain
    version."""
    stand_in = lib()
    _, q, scale = _operands(b, 256, 384, torch.bfloat16, seed=b)
    buf = torch.randn(b, 1, 512, generator=torch.Generator().manual_seed(b))
    x = buf.to(torch.bfloat16)[..., ::2]
    assert not x.is_contiguous()
    got = tmm.forward_cuda(x, q, scale, out_dtype)
    assert stand_in.calls == [("gemv", b, 256, 384,
                               out_dtype == torch.bfloat16)]
    assert got.shape == (b, 1, 384)
    assert torch.equal(got, tmm.int8_matmul_reference(x, q, scale,
                                                      out_dtype))


@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("m,k,n,variant", [
    (64, 128, 384, "wgmma"),
    (37, 200, 272, "wgmma"),  # ragged M, K not a multiple of 64
    (37, 100, 130, "ffma"),   # K and N strides off 16 bytes
    (5, 256, 127, "ffma"),    # N off 16 bytes
    (5, 12, 32, "ffma"),      # K off 16 bytes in bf16
])
def test_launch_passes_dense_operands_to_its_variant(lib, x_dtype, out_dtype,
                                                     m, k, n, variant):
    stand_in = lib()
    x, q, scale = _operands(m, k, n, x_dtype)
    out = torch.empty(m, n, dtype=out_dtype)
    before = tmm.n_launches
    tmm._launch(x, q, scale, out)
    assert stand_in.calls == [(variant, m, k, n,
                               out_dtype == torch.bfloat16)]
    assert tmm.n_launches - before == 1
    assert tmm.n_variant_launches[variant] == 1
    assert torch.equal(out, tmm.int8_matmul_reference(x, q, scale, out_dtype))


@pytest.mark.parametrize("m", [4, 64])
def test_a_misaligned_decode_view_still_takes_ffma(lib, m):
    stand_in = lib()
    _, q, scale = _operands(m, 128, 256, torch.bfloat16)
    flat = torch.randn(1 + m * 128).to(torch.bfloat16)
    x = flat[1:].view(m, 128)  # contiguous, 2 bytes off alignment
    assert x.is_contiguous() and x.data_ptr() % 16
    out = torch.empty(m, 256, dtype=torch.bfloat16)
    tmm._launch(x, q, scale, out)
    assert [c[0] for c in stand_in.calls] == ["ffma"]
    assert torch.equal(out, tmm.int8_matmul_reference(x, q, scale,
                                                      torch.bfloat16))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_a_misaligned_address_reaches_the_ffma_variant(lib, x_dtype):
    stand_in = lib()
    _, q, scale = _operands(64, 128, 256, x_dtype)
    flat = torch.randn(1 + 64 * 128).to(x_dtype)
    x = flat[1:].view(64, 128)  # contiguous, 2 or 4 bytes off alignment
    assert x.is_contiguous() and x.data_ptr() % 16
    assert tmm.variant(flat[:-1].view(64, 128), q) == "wgmma"
    out = torch.empty(64, 256, dtype=x_dtype)
    tmm._launch(x, q, scale, out)
    assert [c[0] for c in stand_in.calls] == ["ffma"]
    assert torch.equal(out, tmm.int8_matmul_reference(x, q, scale, x_dtype))
    # a misaligned weight as well
    qflat = torch.zeros(16 + 128 * 256, dtype=torch.int8)
    q_off = qflat[4:4 + 128 * 256].view(128, 256)
    assert tmm.variant(x.contiguous().clone(), q_off) == "ffma"


@pytest.mark.parametrize("x_dtype,entry", [(torch.float32, "wgmma"),
                                           (torch.bfloat16, "wgmma"),
                                           (torch.float32, "ffma"),
                                           (torch.bfloat16, "gemv")])
def test_a_failed_launch_raises(lib, x_dtype, entry):
    stand_in = lib(code=700)
    k, n = (100, 130) if entry == "ffma" else (128, 256)
    # bf16 past GEMV_MAX_M tokens takes wgmma, at most it gemv
    m = tmm.GEMV_MAX_M + 1 if entry == "wgmma" else 8
    x, q, scale = _operands(m, k, n, x_dtype)
    before = tmm.n_launches
    with pytest.raises(RuntimeError, match="launch failed"):
        tmm._launch(x, q, scale, torch.empty(m, n, dtype=x_dtype))
    assert stand_in.calls[0][0] == entry
    assert tmm.n_launches == before


def _split(x: torch.Tensor) -> list[torch.Tensor]:
    """The tensor-core variant's split of float32 ``x`` into three bf16
    terms: each the bf16 rounding of what the terms before leave."""
    terms, rest = [], x
    for _ in range(3):
        t = rest.to(torch.bfloat16)
        terms.append(t)
        rest = rest - t.float()
    return terms


def test_three_bf16_terms_sum_to_a_float32_value_exactly():
    # |x| in [2^-100, 2^100], and zeros. Below 2^-100 the last term can
    # fall among bf16's subnormals (under 2^-126), which keep too few bits;
    # near float32's largest value bf16(x) rounds to inf. The GGNN's
    # activations (embeddings, GRU states, their sums) lie well inside.
    rng = np.random.default_rng(7)
    mag = np.exp2(rng.uniform(-100, 100, 200_000))
    x = (mag * rng.choice([-1.0, 1.0], mag.size)).astype(np.float32)
    x[::97] = 0.0
    x = np.concatenate([x, np.float32([2.0 ** -100, -2.0 ** 100, 1.0,
                                       np.nextafter(np.float32(1), 2)])])
    x = torch.from_numpy(x)
    x0, x1, x2 = (t.float() for t in _split(x))
    assert torch.equal(x0 + x1 + x2, x)
    assert torch.equal((x0 + x1) + x2, x)


@pytest.mark.parametrize("m,k,n", [(256, 128, 384), (64, 128, 128)])
def test_three_bf16_products_match_the_plain_version(m, k, n):
    rng = np.random.default_rng(m + n)
    q, scale = tmm.calibrate_int8(
        (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32))
    q, scale = torch.from_numpy(q), torch.from_numpy(scale)
    x = torch.from_numpy((rng.standard_normal((m, k)) * 0.5)
                         .astype(np.float32))
    want = tmm.int8_matmul_reference(x, q, scale)
    got = sum(t.float() @ q.float() for t in _split(x)) * scale
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * top
