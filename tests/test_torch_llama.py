"""The port's LLM (``deepdfa_tpu_torch.llm.llama``) against the JAX package's,
on the CPU.

The same inputs go to both packages: token ids and left-padded pad masks
made with numpy from a seed, and the JAX parameters carried across by
``bridge.llama_flax_to_torch``. The JAX ``attn_impl="flash"`` path runs the
stock Pallas TPU flash-attention kernel in interpret mode
(``pltpu.force_tpu_interpret_mode``); the port's runs kernel B6's plain
version (``flash_attention_reference``), as every CPU tensor does.

Tolerances:
- float32 hidden states, every row (padding rows included):
  atol = rtol = 1e-5 (float32 sums in other orders; measured ≤ 6e-6 on
  values up to 4);
- bf16 hidden states: ``BF16_LIMIT`` of the largest value (see there);
- the attention functions alone: atol = rtol = 1e-5 in float32, 2e-2 of the
  largest output in bf16 (the JAX package's own bar, tests/test_llama.py);
- quantization, dequantization, LoRA merging and the bridge's round trips:
  bit for bit.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as nn  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from deepdfa_tpu.llm import llama as jl  # noqa: E402
from deepdfa_tpu.llm import lora as jlora  # noqa: E402
from deepdfa_tpu.llm import presets as jpresets  # noqa: E402
from deepdfa_tpu.llm import quant as jquant  # noqa: E402
from deepdfa_tpu.ops import ring_attention as jring  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.llm import convert, lora, presets, quant  # noqa: E402
from deepdfa_tpu_torch.llm import llama as tl  # noqa: E402
from deepdfa_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from deepdfa_tpu_torch.ops import int8_matmul as tmm  # noqa: E402
from deepdfa_tpu_torch.ops import ring_attention as tring  # noqa: E402

# bf16 model, JAX (XLA CPU, one jitted computation) against torch (CPU):
# both round every matmul output, the residual stream and the norms to
# bf16, but the two round elementwise chains (silu = x * sigmoid(x), the
# rotary products) at other places; a flipped rounding of one ulp (2^-8
# relative) in a residual of size ~4 moves a hidden value by ~0.016, and two
# layers compound a few such flips. Held to 2 % of the largest value.
BF16_LIMIT = 2e-2


def _inputs(cfg, s, seed, b=3):
    """Token ids and a left-padded pad mask: one full row, one with 37
    pads, one with all but 5 tokens padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[1, :37] = False
    mask[2, : s - 5] = False
    ids[~mask] = 2  # pads carry the eos id, as HashTokenizer writes them
    return ids, mask


def _jax_params(cfg):
    """Seeded Flax params of ``cfg`` (initialised through the "full" path,
    whose tree is the same), unboxed into numpy."""
    init_cfg = dataclasses.replace(cfg, attn_impl="full")
    params = jl.LlamaModel(init_cfg).init(
        jax.random.key(0), np.zeros((1, 8), np.int32))["params"]
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def _jax_hidden(cfg, params, ids, mask):
    # one jitted computation: TPU interpret mode runs JAX ops inside its
    # callbacks, and eager ops dispatched around a running pallas_call
    # deadlocked with them on a loaded host (a full parallel test run)
    apply = jax.jit(lambda p, i, m: jl.LlamaModel(cfg).apply({"params": p},
                                                             i, m))
    with pltpu.force_tpu_interpret_mode():
        out = apply(params, ids, mask)
    return np.asarray(out.astype(jnp.float32))


def _port_hidden(cfg, params, ids, mask):
    model = tl.build_llama(tl.LlamaConfig(**dataclasses.asdict(cfg)), "cpu",
                           seed=None)
    model.load_state_dict(bridge.llama_flax_to_torch(params))
    with torch.inference_mode():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    return out.to(torch.float32).numpy()


@pytest.mark.parametrize("impl,s", [("full", 128), ("full", 256),
                                    ("flash", 128), ("flash", 256)])
def test_llama_matches_jax_on_every_row(impl, s):
    cfg = jl.tiny_llama(attn_impl=impl)
    params = _jax_params(cfg)
    ids, mask = _inputs(cfg, s, seed=s)
    want = _jax_hidden(cfg, params, ids, mask)
    got = _port_hidden(cfg, params, ids, mask)
    assert got.shape == (3, s, cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_flash_and_full_differ_on_padding_rows_only():
    """The JAX package's two paths agree on real rows and differ on padding
    rows (flash lets them attend to earlier padding, full zeroes them);
    the port keeps each path's own semantics."""
    cfg = tl.tiny_llama()
    model = tl.build_llama(cfg, "cpu", seed=3)
    ids, mask = _inputs(cfg, 128, seed=5)
    flash = tl.build_llama(dataclasses.replace(cfg, attn_impl="flash"),
                           "cpu", seed=None)
    flash.load_state_dict(model.state_dict())
    with torch.inference_mode():
        a = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        b = flash(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(a[mask], b[mask], atol=1e-5, rtol=1e-5)
    assert np.abs(a[~mask] - b[~mask]).max() > 0.1


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_bf16_llama_matches_jax_within_its_bound(impl):
    cfg = jl.tiny_llama(attn_impl=impl, dtype="bfloat16")
    params = _jax_params(cfg)
    ids, mask = _inputs(cfg, 128, seed=9)
    want = _jax_hidden(cfg, params, ids, mask)
    got = _port_hidden(cfg, params, ids, mask)
    top = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= BF16_LIMIT * top


def test_int8_runtime_with_lora_matches_the_jax_int8_dense():
    """Every projection on B5's plain version against the JAX ``Int8Dense``
    (the Pallas int8 kernel in interpret mode), LoRA adapters on q and v."""
    cfg = jl.tiny_llama(int8_runtime=True, lora_rank=4)
    fcfg = dataclasses.replace(cfg, int8_runtime=False)
    params = jquant.to_int8_runtime_params(_jax_params(fcfg))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(2)
    for i in range(cfg.num_hidden_layers):  # non-zero adapters
        attn = params[f"layers_{i}"]["self_attn"]
        for name in ("lora_q", "lora_v"):
            shape = attn[name]["lora_b"].shape
            attn[name]["lora_b"] = (rng.normal(size=shape) * 0.05).astype(
                np.float32)
    ids, mask = _inputs(cfg, 64, seed=4)
    want = _jax_hidden(cfg, params, ids, mask)
    got = _port_hidden(cfg, params, ids, mask)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_int8_matmul_with_bf16_activations_matches_the_jax_kernel(out):
    """B5's plain version with bf16 activations (the LLM's projections)
    against the JAX Pallas kernel in interpret mode: both sum in float32 and
    round once, so a bf16 output may differ by one ulp (2^-7 of the largest
    output at most)."""
    from deepdfa_tpu.ops.int8_matmul import int8_matmul as jint8_matmul

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 33, 256)).astype(np.float32)
    q, scale = tmm.calibrate_int8(
        (rng.normal(size=(256, 200)) * 0.06).astype(np.float32))
    want = np.asarray(jint8_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(scale),
        out_dtype=jnp.dtype(out), interpret=True).astype(jnp.float32))
    got = tmm.int8_matmul(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(q), torch.from_numpy(scale),
                          out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (2, 33, 200)
    limit = 2.0 ** -7 if out == "bfloat16" else 1e-6
    top = float(np.abs(want).max())
    assert float(np.abs(got.to(torch.float32).numpy() - want).max()) <= \
        limit * top


def test_to_int8_runtime_params_is_bitwise_the_jax_tree():
    params = _jax_params(jl.tiny_llama(lora_rank=2))
    want = jax.tree.map(np.asarray, jquant.to_int8_runtime_params(params))
    got = quant.to_int8_runtime_params(bridge.llama_flax_to_torch(params))
    assert all(got[k].dtype == torch.int8 for k in got if k.endswith(".q"))
    back = bridge.llama_torch_to_flax(got)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # on a torch tensor calibrate_int8 gives the numpy calibration's bits
    w = params["layers_0"]["mlp"]["up_proj"]["kernel"]
    q, scale = tmm.calibrate_int8(torch.from_numpy(np.array(w)))
    nq, nscale = tmm.calibrate_int8(w)
    np.testing.assert_array_equal(q.numpy(), nq)
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  nscale.view(np.uint32))


def test_dequantize_and_merge_lora_are_the_jax_transforms():
    params = _jax_params(jl.tiny_llama(lora_rank=4))
    rng = np.random.default_rng(6)
    attn = params["layers_1"]["self_attn"]
    for name in ("lora_q", "lora_v"):  # non-zero adapters
        attn[name]["lora_b"] = rng.normal(
            size=attn[name]["lora_b"].shape).astype(np.float32)
    merged = lora.merge_lora(bridge.llama_flax_to_torch(params), alpha=16.0)
    want = jax.tree.map(np.asarray, jlora.merge_lora(params, alpha=16.0))
    assert not any(".lora_" in k for k in merged)
    got = bridge.llama_torch_to_flax(merged)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    # dequantize: (q · scale)ᵀ in the asked type, as the JAX package's
    state8 = quant.to_int8_runtime_params(merged)
    deq = quant.dequantize_tree(state8, dtype=torch.float32)
    assert set(deq) == set(merged)
    w = merged["layers.0.mlp.down_proj.weight"]
    qleaf = jquant._quantize(np.asarray(w).T)
    jw = np.asarray(jquant.dequantize_tree({"k": qleaf}, jnp.float32)["k"])
    np.testing.assert_array_equal(deq["layers.0.mlp.down_proj.weight"].numpy(),
                                  jw.T)


def test_randomized_int8_state_is_seeded_and_keeps_norms():
    model = tl.build_llama(tl.tiny_llama(int8_runtime=True), "cpu", seed=0)
    state = model.state_dict()
    a = quant.randomize_int8_runtime_params(state, seed=3)
    b = quant.randomize_int8_runtime_params(state, seed=3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    q = a["layers.0.mlp.up_proj.q"]
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    assert torch.equal(a["norm.weight"], state["norm.weight"])
    assert 0.005 < float(a["layers.1.self_attn.o_proj.scale"].mean()) < 0.015
    model.load_state_dict(a)
    with torch.inference_mode():
        out = model(torch.ones(1, 16, dtype=torch.long))
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) > 0


@pytest.mark.parametrize("variant", ["float", "int8", "lora", "causal_lm"])
def test_llama_bridge_round_trip_is_bitwise(variant):
    kw = {"int8": dict(int8_runtime=True), "lora": dict(lora_rank=2)}.get(
        variant, {})
    cfg = jl.tiny_llama(**kw)
    cls = jl.LlamaForCausalLM if variant == "causal_lm" else jl.LlamaModel
    params = cls(dataclasses.replace(cfg, int8_runtime=False)).init(
        jax.random.key(1), np.zeros((1, 8), np.int32))["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))
    if variant == "int8":
        params = jax.tree.map(np.asarray,
                              jquant.to_int8_runtime_params(params))
    state = bridge.llama_flax_to_torch(params)
    tcls = tl.LlamaForCausalLM if variant == "causal_lm" else tl.LlamaModel
    model = tl.build_llama(tl.LlamaConfig(**dataclasses.asdict(cfg)), "cpu",
                           seed=None, cls=tcls)
    assert set(model.state_dict()) == set(state)
    model.load_state_dict(state)
    back = bridge.llama_torch_to_flax(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64])
def test_flash_reference_matches_the_stock_pallas_kernel(dtype, d):
    """B6's plain version against the stock TPU kernel, called as
    ``llama._flash_attention`` calls it, GQA (4 query heads, 2 kv heads)
    and left pads included."""
    rng = np.random.default_rng(d)
    b, s, h, h_kv = 2, 256, 4, 2
    jdt = jnp.dtype(dtype)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    mask = np.ones((b, s), bool)
    mask[1, :100] = False
    with pltpu.force_tpu_interpret_mode():  # jitted, as in _jax_hidden
        want = jax.jit(jl._flash_attention)(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            jnp.asarray(mask))
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = tfa.flash_attention(torch.from_numpy(q).to(tdt),
                              torch.from_numpy(k).to(tdt),
                              torch.from_numpy(v).to(tdt),
                              torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == (b, s, h, d)
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:  # P rounded to bf16 at other running maxima, bf16 output
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_full_attention_matches_jax_with_masked_rows():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    mask = np.ones((2, 24), bool)
    mask[1, :] = False  # an all-padding row: zeros
    mask[0, :7] = False
    for causal in (True, False):
        want = np.asarray(jring.full_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            kv_mask=jnp.asarray(mask)))
        got = tring.full_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, kv_mask=torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert not got[1].any()


def test_flash_attention_checks_its_arguments_and_counts_no_cpu_launch():
    q = torch.zeros(1, 128, 4, 16)
    kv = torch.zeros(1, 128, 2, 16)
    with pytest.raises(ValueError, match="head width"):
        tfa.flash_attention(torch.zeros(1, 128, 4, 24),
                            torch.zeros(1, 128, 2, 24),
                            torch.zeros(1, 128, 2, 24))
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, torch.zeros(1, 128, 3, 16),
                            torch.zeros(1, 128, 3, 16))
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="pad_mask"):
        tfa.flash_attention(q, kv, kv, torch.ones(1, 64, dtype=torch.bool))
    before = tfa.n_launches
    out = tfa.flash_attention(q, kv, kv, torch.ones(1, 128, dtype=torch.bool))
    assert out.shape == q.shape and tfa.n_launches == before


@pytest.mark.parametrize("head_dim,theta", [(16, 1e6), (128, 1e4)])
def test_rope_tables_are_the_float64_functions_rounded_once(head_dim, theta):
    """The rotary tables: the JAX package's float32 angles, cos and sin
    taken in float64 and rounded to float32 once, so every element is the
    correctly rounded value whichever thread computes it (torch's float32
    cos on the CPU returned values up to 1.5e-4 off on one worker thread's
    share of a table in some processes); within two float32 ulps of 1
    (1.2e-7) of the JAX package's float32 tables, which read one ulp
    (6.0e-8) here. 3 × 2048 positions: many threads' shares."""
    pos = np.tile(np.arange(2048), (3, 1))
    cos, sin = tl.rope_cos_sin(torch.from_numpy(pos), head_dim, theta)
    inv_freq = (1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                               dtype=torch.float32)
                                 / head_dim))).numpy()
    angles = (pos.astype(np.float32)[..., None] * inv_freq).astype(
        np.float64)
    assert np.array_equal(cos.numpy(), np.cos(angles).astype(np.float32))
    assert np.array_equal(sin.numpy(), np.sin(angles).astype(np.float32))
    jcos, jsin = jl.rope_cos_sin(jnp.asarray(pos), head_dim, theta)
    for got, want in ((cos, jcos), (sin, jsin)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1.2e-7


@pytest.mark.parametrize("kw,exc,match", [
    # the ring is ported; without a mesh it raises, as in the JAX package
    (dict(attn_impl="ring"), ValueError, "requires a mesh"),
    (dict(attn_impl="paged"), ValueError, "attn_impl"),
    # head width 20 (hidden 80 over 4 heads) is not one B6 is built for
    (dict(attn_impl="flash", hidden_size=80), ValueError, "head widths"),
    (dict(dtype="float16"), ValueError, "dtype"),
])
def test_llama_construction_errors(kw, exc, match):
    with pytest.raises(exc, match=match):
        tl.LlamaModel(tl.tiny_llama(**kw))


def test_decode_raises_naming_its_roadmap_item():
    """decode=True is ported (tests/test_torch_generate.py); without the
    cache it must read and write it raises, naming the cache."""
    model = tl.build_llama(tl.tiny_llama(), "cpu")
    with pytest.raises(ValueError, match="KVCache"):
        model(torch.ones(1, 4, dtype=torch.long), decode=True)
    cache = tl.KVCache.empty(model.cfg, 1, 4, "cpu")
    with torch.inference_mode():
        hidden, cache = model(torch.ones(1, 4, dtype=torch.long),
                              decode=True, cache=cache)
    assert hidden.shape == (1, 4, 64) and cache.pos == 4


def test_seeded_init_is_reproducible_and_in_distribution():
    cfg = tl.tiny_llama(hidden_size=128, intermediate_size=256)
    a = tl.build_llama(cfg, "cpu", seed=7).state_dict()
    b = tl.build_llama(cfg, "cpu", seed=7).state_dict()
    c = tl.build_llama(cfg, "cpu", seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.mlp.up_proj.weight"],
                           c["layers.0.mlp.up_proj.weight"])
    w = a["layers.0.mlp.down_proj.weight"]  # [out, in], fan_in 256
    assert abs(float(w.std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert float(w.abs().max()) <= 2 * 256 ** -0.5 / 0.87962566103423978
    assert abs(float(a["embed_tokens.weight"].std()) - 0.02) < 0.002
    assert torch.equal(a["norm.weight"], torch.ones(128))
    bf = tl.build_llama(dataclasses.replace(cfg, dtype="bfloat16"), "cpu",
                        seed=7).state_dict()
    assert bf["layers.0.mlp.up_proj.weight"].dtype == torch.bfloat16
    assert bf["norm.weight"].dtype == torch.float32  # norms stay float32
    assert torch.equal(bf["layers.0.mlp.up_proj.weight"],
                       a["layers.0.mlp.up_proj.weight"].to(torch.bfloat16))


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_hf_directory_loads_with_no_renaming(tmp_path, fmt):
    cfg = tl.tiny_llama()
    lm = tl.build_llama(cfg, "cpu", seed=2, cls=tl.LlamaForCausalLM)
    state = {k: v.clone() for k, v in lm.state_dict().items()}
    state["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(8)
    if fmt == "bin":
        torch.save(state, tmp_path / "pytorch_model.bin")
    else:
        from safetensors.torch import save_file

        save_file(state, str(tmp_path / "model.safetensors"))
    hf_cfg = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                  intermediate_size=cfg.intermediate_size,
                  num_hidden_layers=cfg.num_hidden_layers,
                  num_attention_heads=cfg.num_attention_heads,
                  num_key_value_heads=cfg.num_key_value_heads,
                  rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
                  max_position_embeddings=256, dtype="float32",
                  architectures=["LlamaForCausalLM"], model_type="llama")
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg))
    assert convert.load_hf_config(tmp_path) == cfg
    bare = tl.build_llama(cfg, "cpu", seed=None)
    bare.load_state_dict(convert.load_hf_checkpoint(tmp_path, bare=True))
    full = tl.build_llama(cfg, "cpu", seed=None, cls=tl.LlamaForCausalLM)
    full.load_state_dict(convert.load_hf_checkpoint(tmp_path))
    ids = torch.randint(3, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        assert torch.equal(bare(ids), lm.model(ids))
        assert torch.equal(full(ids), lm(ids))
    with pytest.raises(FileNotFoundError):
        convert.load_torch_state(tmp_path / "nothing")


def test_llama_presets_are_the_jax_presets():
    """Every JAX preset, the two LineVul (RoBERTa) ones included."""
    from deepdfa_tpu_torch.llm import roberta as troberta

    for name, p in presets.PRESETS.items():
        j = jpresets.PRESETS[name]
        assert type(p.llm).__name__ == type(j.llm).__name__, name
        assert dataclasses.asdict(p.llm) == dataclasses.asdict(j.llm), name
        assert dataclasses.asdict(p.joint) == dataclasses.asdict(j.joint)
        assert (p.finetuned, p.dataset, p.encoder_family) == (
            j.finetuned, j.dataset, j.encoder_family)
        assert dataclasses.asdict(p.mesh) == dataclasses.asdict(j.mesh)
    assert set(presets.PRESETS) == set(jpresets.PRESETS)
    assert presets.PRESETS["bigvul_ft_bigvul"].llm == tl.codellama_7b()
    for name in ("linevul", "linevul_fusion"):
        assert presets.PRESETS[name].llm == troberta.codebert_base()
        assert presets.PRESETS[name].encoder_family == "roberta"
    with pytest.raises(KeyError):
        presets.PRESETS["nope"]
