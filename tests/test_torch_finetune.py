"""LoRA fine-tuning in the port (``deepdfa_tpu_torch.llm.finetune``) against
the JAX package's, on the CPU.

The same inputs go to both packages: token ids and left-padded pad masks
made with numpy from a seed, the JAX parameters (with non-zero ``lora_b``)
carried across by ``bridge.llama_flax_to_torch``. The JAX
``attn_impl="flash"`` step differentiates the stock Pallas TPU kernel
through its own backward (the dk/dv and dq Pallas kernels) in interpret
mode; the port's runs B6 and B6b's plain versions, as every CPU tensor
does.

Tolerances:
- the loss: atol 1e-5; every adapter gradient: 1e-5 of that gradient's
  largest value (float32 sums in other orders);
- a ``LoraFinetuner`` epoch: the losses atol 1e-5; each adapter's change
  over the epoch within 1e-3 of that change's largest value (AdamW moves
  every element by about the learning rate whatever its gradient's size,
  so a gradient element at rounding level could move the two packages'
  element apart; none did at this seed);
- the optimizer against optax on the same gradients: 1e-6 of each
  parameter's largest change plus one float32 ulp of the parameter per
  step;
  schedules 1e-7 of the peak;
- masks, splits, the report and checkpoint round trips: exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import linen as nn  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from deepdfa_tpu.llm import dataset as jds  # noqa: E402
from deepdfa_tpu.llm import finetune as jft  # noqa: E402
from deepdfa_tpu.llm import joint as jjoint  # noqa: E402
from deepdfa_tpu.llm import llama as jl  # noqa: E402
from deepdfa_tpu.llm import lora as jlora  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.llm import dataset as tds  # noqa: E402
from deepdfa_tpu_torch.llm import finetune as tft  # noqa: E402
from deepdfa_tpu_torch.llm import joint as tjoint  # noqa: E402
from deepdfa_tpu_torch.llm import llama as tl  # noqa: E402
from deepdfa_tpu_torch.llm import lora as tlora  # noqa: E402
from deepdfa_tpu_torch.ops import flash_attention as tfa  # noqa: E402


def _inputs(cfg, s, seed, b=3):
    """Token ids and a left-padded pad mask (tests/test_torch_llama.py's):
    one full row, one with 37 pads, one with all but 5 tokens padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[1, :37] = False
    mask[2, : s - 5] = False
    ids[~mask] = 2  # pads carry the eos id, as HashTokenizer writes them
    return ids, mask


def _jax_params(cfg, seed=0):
    """Seeded ``LlamaForCausalLM`` params of ``cfg`` (initialised through
    the "full" path) with non-zero ``lora_b``, unboxed into numpy."""
    init_cfg = dataclasses.replace(cfg, attn_impl="full")
    params = jl.LlamaForCausalLM(init_cfg).init(
        jax.random.key(seed), np.zeros((1, 8), np.int32))["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))
    rng = np.random.default_rng(seed + 1)
    for i in range(cfg.num_hidden_layers):
        attn = params["model"][f"layers_{i}"]["self_attn"]
        for name in ("lora_q", "lora_v"):
            shape = attn[name]["lora_b"].shape
            attn[name]["lora_b"] = (rng.normal(size=shape) * 0.05).astype(
                np.float32)
    return params


def _port_model(cfg, params):
    model = tl.build_llama(tl.LlamaConfig(**dataclasses.asdict(cfg)), "cpu",
                           seed=None, cls=tl.LlamaForCausalLM)
    model.load_state_dict(bridge.llama_flax_to_torch(params))
    return model


def _jax_value_and_grad(cfg, params, ids, mask):
    def loss_fn(p):
        logits = jl.LlamaForCausalLM(cfg).apply({"params": p}, ids, mask)
        return jft.lm_loss(logits, ids, mask)

    # one jitted computation: TPU interpret mode runs JAX ops inside its
    # callbacks, and eager ops dispatched around a running pallas_call can
    # deadlock with them on a loaded host
    with pltpu.force_tpu_interpret_mode():
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads = bridge.llama_flax_to_torch(jax.tree.map(np.asarray, grads))
    return float(loss), {k: v for k, v in grads.items()
                         if tlora.is_lora_name(k)}


def _port_value_and_grad(model, ids, mask):
    tlora.freeze_base(model)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    loss = tft.lm_loss(model(ids, mask), ids, mask)
    loss.backward()
    return float(loss), {n: p.grad for n, p in model.named_parameters()
                         if p.requires_grad}


@pytest.fixture(scope="module", params=[128, 256])
def lora_step(request):
    """One LoRA ``value_and_grad`` of ``tiny_llama(attn_impl="flash",
    lora_rank=4)`` in the JAX package (the stock kernel and its Pallas
    backward in interpret mode), computed once per sequence length."""
    s = request.param
    cfg = jl.tiny_llama(attn_impl="flash", lora_rank=4)
    params = _jax_params(cfg)
    ids, mask = _inputs(cfg, s, seed=s + 1)
    loss, grads = _jax_value_and_grad(cfg, params, ids, mask)
    return cfg, params, ids, mask, loss, grads


def test_lora_loss_and_gradients_through_flash_match_jax(lora_step):
    cfg, params, ids, mask, want_loss, want = lora_step
    loss, got = _port_value_and_grad(_port_model(cfg, params), ids, mask)
    assert set(got) == set(want) and len(got) == 4 * cfg.num_hidden_layers
    assert abs(loss - want_loss) <= 1e-5
    for name, g in got.items():
        w = torch.from_numpy(np.asarray(want[name]))
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max()), \
            name


def test_full_attention_differs_by_the_padding_row_rule(lora_step):
    """The same step under ``attn_impl="full"`` (padding queries get zeros,
    not attention over earlier padding) differs: the loss grades the last
    padding position before a row's first real token, so the rule the
    flash path carries reaches the loss and the gradients."""
    cfg, params, ids, mask, want_loss, want = lora_step
    full = dataclasses.replace(cfg, attn_impl="full")
    loss, got = _port_value_and_grad(_port_model(full, params), ids, mask)
    assert abs(loss - want_loss) > 1e-5
    rel = max(float((g - want[n]).abs().max() / want[n].abs().max())
              for n, g in got.items())
    assert rel > 1e-3


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    words = ["int", "char", "buf", "len", "memcpy", "if", "return", "ptr",
             "free", "while", "count", "idx", "struct", "node"]
    return ["int f%d(char *buf) {\n  %s;\n}" % (
        i, " ".join(rng.choice(words, size=int(rng.integers(5, 200)))))
        for i in range(n)]


def test_lora_finetuner_epoch_matches_the_jax_tuner(tmp_path):
    """One epoch of three steps (lr 0, then the peak, then half of it)
    through the flash path: the epoch's loss and every adapter's change
    against the JAX ``LoraFinetuner``; the adapters it writes load back."""
    cfg = jl.tiny_llama(attn_impl="flash", lora_rank=4)
    params = _jax_params(cfg, seed=3)
    texts = _texts(6, seed=4)
    jex = jds.encode_functions(texts, [0] * 6, jds.HashTokenizer(320), 128)
    tex = tds.encode_functions(texts, [0] * 6, tds.HashTokenizer(320), 128)
    fcfg = dict(learning_rate=1e-3, epochs=1, batch_size=2, seed=5)
    with pltpu.force_tpu_interpret_mode():
        jparams, jlosses = jft.LoraFinetuner(
            jl.LlamaForCausalLM(cfg), jft.FinetuneConfig(**fcfg)).train(
                params, jex)
    want = bridge.llama_flax_to_torch(jax.tree.map(np.asarray, jparams))
    start = bridge.llama_flax_to_torch(params)
    model = _port_model(cfg, params)
    tuner = tft.LoraFinetuner(model, tft.FinetuneConfig(**fcfg),
                              run_dir=tmp_path)
    before = tfa.n_bwd_launches
    model, losses = tuner.train(tex)
    assert tfa.n_bwd_launches == before  # the CPU runs the plain versions
    assert len(losses) == 1 and abs(losses[0] - jlosses[0]) <= 1e-5
    state = model.state_dict()
    for name in tlora.split_lora(state)[0]:
        moved = want[name] - start[name]
        assert float(moved.abs().max()) > 0, name
        err = float((state[name] - want[name]).abs().max())
        assert err <= 1e-3 * float(moved.abs().max()), name
    # the base never moved, and the epoch's adapters were written alone
    for name, value in tlora.split_lora(state)[1].items():
        assert torch.equal(value, start[name]), name
    saved = torch.load(tmp_path / "adapters_epoch_0" / "state.pt")
    assert set(saved) == set(tlora.split_lora(state)[0])
    fresh = tuner.load_adapters(_port_model(cfg, params), "adapters_epoch_0")
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in
               state.items())


def test_adapter_save_load_and_merge_round_trip(tmp_path):
    """Adapters saved alone load onto a fresh base and, merged into the
    projections, give the unmerged model's logits; a directory that is not
    this package's (an orbax checkpoint) or adapters of another shape
    raise."""
    cfg = tl.tiny_llama(attn_impl="flash", lora_rank=4)
    model = tl.build_llama(cfg, "cpu", seed=2, cls=tl.LlamaForCausalLM)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(
                    len(name)))
    tuner = tft.LoraFinetuner(model, tft.FinetuneConfig(), run_dir=tmp_path)
    path = tuner.save_adapters(model, "adapters_epoch_3")
    assert sorted(p.name for p in path.iterdir()) == ["meta.json",
                                                     "state.pt"]
    base = tl.build_llama(cfg, "cpu", seed=2, cls=tl.LlamaForCausalLM)
    assert not torch.equal(base.model.layers[0].self_attn.lora_q.lora_b,
                           model.model.layers[0].self_attn.lora_q.lora_b)
    tuner.load_adapters(base, "adapters_epoch_3")
    merged = tl.build_llama(dataclasses.replace(cfg, lora_rank=0), "cpu",
                            seed=None, cls=tl.LlamaForCausalLM)
    merged.load_state_dict(tlora.merge_lora(base.state_dict(),
                                            alpha=cfg.lora_alpha))
    ids, mask = _inputs(cfg, 128, seed=8)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.inference_mode():
        want, got = model(ids, mask), base(ids, mask)
        flat = merged(ids, mask)
    assert torch.equal(got, want)
    np.testing.assert_allclose(flat.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    orbax = tmp_path / "adapters_epoch_0"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="llama_flax_to_torch"):
        tuner.load_adapters(base, "adapters_epoch_0")
    other = tl.build_llama(dataclasses.replace(cfg, lora_rank=2), "cpu",
                           cls=tl.LlamaForCausalLM)
    with pytest.raises(ValueError, match="do not match"):
        tuner.load_adapters(other, "adapters_epoch_3")


def test_lora_mask_and_split_are_the_jax_ones():
    cfg = jl.tiny_llama(lora_rank=2)
    params = _jax_params(cfg)
    state = bridge.llama_flax_to_torch(params)
    jmask = bridge.llama_flax_to_torch(jax.tree.map(
        lambda m, p: np.full(p.shape, m, np.float32),
        jlora.lora_mask(params), params))
    mask = tlora.lora_mask(state)
    assert mask == {k: bool(v.reshape(-1)[0]) for k, v in jmask.items()}
    assert sum(mask.values()) == 4 * cfg.num_hidden_layers
    model = _port_model(cfg, params)
    assert tlora.lora_mask(model) == mask
    lora, base = tlora.split_lora(state)
    jlo, jbase = jlora.split_lora(params)
    assert len(lora) == len(jax.tree.leaves(jlo))
    assert len(base) == len(jax.tree.leaves(jbase))
    assert set(lora) | set(base) == set(state) and not set(lora) & set(base)
    trainable = tlora.freeze_base(model)
    assert [n for n, p in model.named_parameters() if p.requires_grad] == \
        [n for n in state if mask[n]] and len(trainable) == len(lora)


def test_schedules_match_optax():
    for lr, warmup, total in ((1e-4, 1, 8), (5e-5, 3, 40), (2e-3, 0, 1),
                              (1e-3, 10, 10)):
        want = jjoint.cosine_warmup_schedule(lr, warmup, total)
        got = tjoint.cosine_warmup_schedule(lr, warmup, total)
        for count in range(total + 3):
            assert abs(got(count) - float(want(count))) <= 1e-7 * lr, (
                lr, warmup, total, count)
    assert tjoint.cosine_warmup_schedule(1e-4, 1, 8)(0) == 0.0


def _nest(flat: dict) -> dict:
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _module(flat: dict) -> torch.nn.Module:
    """A module whose parameters carry the dotted names of ``flat``."""
    root = torch.nn.Module()
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            if not hasattr(node, part):
                node.add_module(part, torch.nn.Module())
            node = getattr(node, part)
        node.register_parameter(leaf, torch.nn.Parameter(
            torch.from_numpy(v.copy())))
    return root


@pytest.mark.parametrize("accumulate,freeze,wd", [(1, False, 0.0),
                                                  (3, False, 0.01),
                                                  (2, True, 0.01)])
def test_clipped_adamw_follows_the_optax_chain(accumulate, freeze, wd):
    """``joint_optimizer`` (``ClippedAdamW``) against the JAX
    ``joint_optimizer``'s optax chain on the same seeded gradients over a
    tree with biases, a norm weight and an encoder: six micro-steps,
    gradients large enough that the clip engages."""
    rng = np.random.default_rng(accumulate)
    shapes = {"flowgnn_encoder.ggnn.gru.x_proj.weight": (6, 4),
              "flowgnn_encoder.ggnn.gru.x_proj.bias": (6,),
              "classifier.dense.weight": (5, 3),
              "classifier.dense.bias": (5,), "llm.norm.weight": (3,)}
    init = {k: rng.normal(size=sh).astype(np.float32)
            for k, sh in shapes.items()}
    kw = dict(gradient_accumulation_steps=accumulate, freeze_gnn=freeze,
              weight_decay=wd, learning_rate=1e-2, max_grad_norm=0.5)
    jparams = _nest({k: jnp.asarray(v) for k, v in init.items()})
    tx = jjoint.joint_optimizer(jjoint.JointConfig(**kw), 60, jparams)
    jstate = tx.init(jparams)
    module = _module(init)
    params = dict(module.named_parameters())
    opt = tjoint.joint_optimizer(tjoint.JointConfig(**kw), 60, module)
    assert tjoint.weight_decay_mask(params) == {
        k: k.split(".")[-1] == "weight" and "norm" not in k for k in params}
    for step in range(6):
        grads = {k: (rng.normal(size=sh) * 3).astype(np.float32)
                 for k, sh in shapes.items()}
        updates, jstate = tx.update(
            _nest({k: jnp.asarray(v) for k, v in grads.items()}), jstate,
            jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        assert opt.step() == ((step + 1) % accumulate == 0)
        for k, p in params.items():
            node = jparams
            for part in k.split("."):
                node = node[part]
            want = np.asarray(node)
            moved = np.abs(want - init[k]).max()
            err = np.abs(p.detach().numpy() - want).max()
            # the updates' own rounding, and one float32 ulp of the
            # parameter per update added to it
            ulp = np.spacing(np.abs(want).max())
            assert err <= 1e-6 * moved + (step + 1) * ulp, (step, k)
    if freeze:
        gnn = "flowgnn_encoder.ggnn.gru.x_proj.weight"
        assert np.array_equal(params[gnn].detach().numpy(), init[gnn])
