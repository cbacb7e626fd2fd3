"""LoRA adapters trained over an int8-resident base
(``LlamaForCausalLM(int8_runtime=True, lora_rank>0)``) in the port against
``jax.grad`` through the JAX package's ``int8_matmul`` (the Pallas kernel
in interpret mode, its ``custom_vjp`` backward), on the CPU; the VJP's
operands; ``remat``.

Inputs: a seeded float ``tiny_llama`` tree quantised by the JAX package's
``to_int8_runtime_params`` (bitwise the port's) with non-zero ``lora_b``,
carried across by ``bridge.llama_flax_to_torch``; ids, left-padded pad
masks and a response-only loss mask from numpy.

Tolerance of the adapter gradients, from the shapes: both packages round
``g · scale`` to bf16 before the product with the int8 weight, and their
float32 ``g`` differ by float32 sums in other orders (about 1e-6 of the
largest). Where that moves an element of ``g · scale`` across a bf16
rounding boundary, that term of ``dx`` moves by one bf16 ulp of itself
(2^-8 relative) and no more; every adapter gradient is a sum of products
of such terms with activations, so it moves by at most 2^-8 ≈ 3.9e-3 of its
largest value. The loss: atol 1e-5 (float32 sums, as the model tests).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as nn  # noqa: E402

from deepdfa_tpu.llm import finetune as jft  # noqa: E402
from deepdfa_tpu.llm import llama as jl  # noqa: E402
from deepdfa_tpu.llm import lora as jlora  # noqa: E402
from deepdfa_tpu.llm import quant as jquant  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.llm import finetune as tft  # noqa: E402
from deepdfa_tpu_torch.llm import llama as tl  # noqa: E402
from deepdfa_tpu_torch.llm import lora as tlora  # noqa: E402
from deepdfa_tpu_torch.ops import int8_matmul as tmm  # noqa: E402

VJP_LIMIT = 2.0 ** -8
S = 64


def _inputs(cfg, seed=0, b=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, size=(b, S)).astype(np.int32)
    mask = np.ones((b, S), bool)
    mask[1, :13] = False
    mask[2, : S - 9] = False
    ids[~mask] = 2
    loss_mask = mask & (rng.random((b, S)) < 0.5)
    return ids, mask, loss_mask


def _params(cfg, seed=0):
    fcfg = dataclasses.replace(cfg, int8_runtime=False)
    params = jl.LlamaForCausalLM(fcfg).init(
        jax.random.key(seed), np.zeros((1, 8), np.int32))["params"]
    params = jax.tree.map(np.asarray, jquant.to_int8_runtime_params(
        nn.meta.unbox(params)))
    rng = np.random.default_rng(seed + 1)
    for i in range(cfg.num_hidden_layers):
        attn = params["model"][f"layers_{i}"]["self_attn"]
        for name in ("lora_q", "lora_v"):
            shape = attn[name]["lora_b"].shape
            attn[name]["lora_b"] = (rng.normal(size=shape) * 0.05).astype(
                np.float32)
    return params


def _jax_loss_and_grads(cfg, params, ids, mask, loss_mask):
    lora, base = jlora.split_lora(params)
    model = jl.LlamaForCausalLM(cfg)

    def loss_fn(lora):
        merged = jax.tree.map(lambda a, b: b if a is None else a, lora, base,
                              is_leaf=lambda x: x is None)
        logits = model.apply({"params": merged}, ids, mask)
        return jft.lm_loss(logits, ids, mask, loss_mask)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(lora)
    flat = {}
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        keys = [str(getattr(k, "key", k)) for k in path]
        flat[".".join(keys)] = np.asarray(g)
    return float(loss), flat


def _port_loss_and_grads(cfg, params, ids, mask, loss_mask):
    model = tl.build_llama(tl.LlamaConfig(**dataclasses.asdict(cfg)), "cpu",
                           seed=None, cls=tl.LlamaForCausalLM)
    model.load_state_dict(bridge.llama_flax_to_torch(params))
    tlora.freeze_base(model)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    before = tmm.n_vjp_products
    loss = tft.lm_loss(model(t(ids).long(), t(mask)), t(ids), t(mask),
                       t(loss_mask))
    loss.backward()
    products = tmm.n_vjp_products - before
    grads = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            key = name.replace("layers.", "layers_")
            grads[key] = p.grad.numpy()
    return float(loss.detach()), grads, products


@pytest.mark.parametrize("remat", [False, True])
def test_adapter_gradients_over_int8_match_jax_grad(remat):
    cfg = jl.tiny_llama(int8_runtime=True, lora_rank=4, remat=remat)
    params = _params(cfg)
    ids, mask, loss_mask = _inputs(cfg)
    jloss, jgrads = _jax_loss_and_grads(cfg, params, ids, mask, loss_mask)
    loss, grads, products = _port_loss_and_grads(cfg, params, ids, mask,
                                                 loss_mask)
    assert abs(loss - jloss) <= 1e-5
    assert sorted(grads) == sorted(jgrads) and len(grads) == 8
    for name, want in jgrads.items():
        top = float(np.abs(want).max())
        assert top > 0, name
        err = float(np.abs(grads[name] - want).max())
        assert err <= VJP_LIMIT * top, (name, err / top)
    # one activation-gradient product per projection whose input needs a
    # gradient: all seven of every layer and lm_head, less the first
    # layer's q/k/v, whose input (the frozen embedding, normed) needs none
    assert products == 7 * cfg.num_hidden_layers + 1 - 3


def test_remat_recomputes_each_layer_and_keeps_the_gradients():
    """``remat=True``: the same loss and adapter gradients bit for bit, and
    the backward recomputes every layer whole: each projection of the
    decoder stack runs twice, ``lm_head`` (outside the layers) once."""
    cfg = tl.tiny_llama(int8_runtime=True, lora_rank=4)
    params = _params(jl.tiny_llama(int8_runtime=True, lora_rank=4))
    ids, mask, loss_mask = _inputs(cfg, seed=3)
    out = {}
    for remat in (False, True):
        model = tl.build_llama(dataclasses.replace(cfg, remat=remat), "cpu",
                               seed=None, cls=tl.LlamaForCausalLM)
        model.load_state_dict(bridge.llama_flax_to_torch(params))
        tlora.freeze_base(model)
        calls = []
        hooks = [m.register_forward_hook(lambda *a: calls.append(1))
                 for m in model.modules() if isinstance(m, tl.Int8Dense)]
        t = lambda a: torch.from_numpy(a)  # noqa: E731
        loss = tft.lm_loss(model(t(ids).long(), t(mask)), t(ids), t(mask),
                           t(loss_mask))
        loss.backward()
        for h in hooks:
            h.remove()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.requires_grad}
        out[remat] = (float(loss.detach()), grads, len(calls))
    n_layer = 7 * cfg.num_hidden_layers
    assert out[False][2] == n_layer + 1
    assert out[True][2] == 2 * n_layer + 1
    assert out[False][0] == out[True][0]
    assert all(torch.equal(g, out[True][1][n])
               for n, g in out[False][1].items())


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_vjp_builds_no_float32_copy_of_the_weight(x_dtype):
    """The backward's product takes bf16 operands and makes no tensor of
    the weight's size in float32 (on the CPU a float32 output, the GGNN's
    case, widens the operands: its plain version; the card's path sums
    bf16 operands in float32, tests/test_torch_cuda.py)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    k, n, m = 48, 80, 24
    gen = torch.Generator().manual_seed(0)
    q, scale = tmm.calibrate_int8(torch.randn(k, n, generator=gen))
    x = torch.randn(m, k, generator=gen).to(x_dtype).requires_grad_()
    y = tmm.int8_matmul(x, q, scale, out_dtype=x_dtype)
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if "mm" in str(func):
                seen.append(("mm", [a.dtype for a in args
                                    if isinstance(a, torch.Tensor)]))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    seen.append((t.dtype, tuple(t.shape)))
            return out

    g = torch.randn(m, n, generator=gen).to(x_dtype)
    with Record():
        y.backward(g)
    weight_f32 = [s for s in seen if s[0] == torch.float32
                  and sorted(s[1]) == sorted((k, n))]
    mms = [s[1] for s in seen if s[0] == "mm"]
    assert len(mms) == 1
    if x_dtype == torch.bfloat16:
        assert weight_f32 == [] and mms[0] == [torch.bfloat16] * 2
    assert x.grad.dtype == x_dtype
    want = ((g.float() * scale).to(torch.bfloat16).float()
            @ q.t().float()).to(x_dtype)
    assert torch.equal(x.grad, want) if x_dtype == torch.float32 else \
        float((x.grad.float() - want.float()).abs().max()) <= \
        VJP_LIMIT * float(want.float().abs().max())


def test_a_lora_finetuner_epoch_over_int8_lowers_nothing_but_the_adapters():
    """``LoraFinetuner`` over the int8 base: the int8 weights and scales
    are untouched, every adapter moves, the response-only loss is finite."""
    from deepdfa_tpu_torch.llm.dataset import HashTokenizer
    from deepdfa_tpu_torch.llm.selfinstruct import encode_multitask

    cfg = tl.tiny_llama(int8_runtime=True, lora_rank=4)
    model = tl.build_llama(cfg, "cpu", seed=None, cls=tl.LlamaForCausalLM)
    model.load_state_dict(bridge.llama_flax_to_torch(
        _params(jl.tiny_llama(int8_runtime=True, lora_rank=4))))
    base = {k: v.clone() for k, v in model.state_dict().items()
            if not tlora.is_lora_name(k)}
    adapters = {k: v.clone() for k, v in model.state_dict().items()
                if tlora.is_lora_name(k)}
    tok = HashTokenizer(cfg.vocab_size)
    ex = encode_multitask(["int f(int *p) { return p[4]; }"] * 4 + [
        "void g(char *b) { b[9] = 0; }"] * 4, [1, 0] * 4, tok, 64,
        cwes=["CWE-787", ""] * 4, explanations=["write past the end", ""] * 4)
    _, losses = tft.LoraFinetuner(model, tft.FinetuneConfig(
        learning_rate=1e-2, epochs=2, batch_size=4)).train(ex)
    assert all(np.isfinite(losses))
    state = model.state_dict()
    assert all(torch.equal(state[k], v) for k, v in base.items())
    assert all(not torch.equal(state[k], v) for k, v in adapters.items()
               if k.endswith("lora_b"))
