"""The port's RoBERTa encoder (``deepdfa_tpu_torch.llm.roberta``) against
the JAX package's, on the CPU.

The JAX ``RobertaEncoder`` tree of ``tiny_roberta`` is carried across with
``bridge.roberta_flax_to_torch``; ids and left-padded pad masks are numpy
from a seed.

Tolerances: float32 hidden states on every row within atol = rtol = 1e-5
(float32 sums in other orders; the post-LN LayerNorms are float32 in both,
with Flax's statistics); position ids, conversions and the bridge's round
trip exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as nn  # noqa: E402

from deepdfa_tpu.llm import roberta as jr  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.llm import roberta as tr  # noqa: E402


def _inputs(cfg, s=48, seed=0, b=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[1, :11] = False
    mask[2, : s - 4] = False
    ids[~mask] = 2
    return ids, mask


@pytest.fixture(scope="module")
def pair():
    cfg = jr.tiny_roberta()
    ids, mask = _inputs(cfg)
    params = jr.RobertaEncoder(cfg).init(jax.random.key(1), ids, mask)
    params = jax.tree.map(np.asarray, nn.meta.unbox(params["params"]))
    port = tr.build_roberta(tr.tiny_roberta(), "cpu", seed=None)
    port.load_state_dict(bridge.roberta_flax_to_torch(params))
    return cfg, params, port


@pytest.mark.parametrize("with_mask", [True, False])
def test_hidden_states_match_jax_on_every_row(pair, with_mask):
    cfg, params, port = pair
    ids, mask = _inputs(cfg, seed=2)
    m = mask if with_mask else None
    want = np.asarray(jax.jit(lambda p, i, k: jr.RobertaEncoder(cfg).apply(
        {"params": p}, i, k))(params, ids, m))
    with torch.inference_mode():
        got = port(torch.from_numpy(ids).long(),
                   None if m is None else torch.from_numpy(m)).numpy()
    assert got.shape == (3, 48, cfg.hidden_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_position_ids_are_the_jax_position_ids():
    _, mask = _inputs(jr.tiny_roberta(), seed=3)
    np.testing.assert_array_equal(
        tr.roberta_position_ids(torch.from_numpy(mask), 1).numpy(),
        np.asarray(jr.roberta_position_ids(jnp.asarray(mask), 1)))


def test_configs_are_the_jax_configs():
    import dataclasses

    for name in ("codebert_base", "tiny_roberta"):
        assert dataclasses.asdict(getattr(tr, name)()) == dataclasses.asdict(
            getattr(jr, name)())
    hf = dict(vocab_size=500, hidden_size=32, num_attention_heads=2,
              model_type="roberta", architectures=["RobertaModel"])
    assert dataclasses.asdict(tr.RobertaConfig.from_hf_dict(hf)) == \
        dataclasses.asdict(jr.RobertaConfig.from_hf_dict(hf))


def _hf_state(cfg, prefix: str, seed: int = 4) -> dict:
    """A synthetic HF RoBERTa state dict of ``cfg``'s shapes, with the
    entries conversion must drop."""
    rng = np.random.default_rng(seed)
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {
        "embeddings.word_embeddings.weight": (cfg.vocab_size, h),
        "embeddings.position_embeddings.weight":
            (cfg.max_position_embeddings, h),
        "embeddings.token_type_embeddings.weight": (cfg.type_vocab_size, h),
        "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,),
    }
    for i in range(cfg.num_hidden_layers):
        lay = f"encoder.layer.{i}"
        for m in ("query", "key", "value"):
            shapes[f"{lay}.attention.self.{m}.weight"] = (h, h)
            shapes[f"{lay}.attention.self.{m}.bias"] = (h,)
        for mod, (o, i_) in (("attention.output", (h, h)),
                             ("intermediate", (f, h)), ("output", (h, f))):
            shapes[f"{lay}.{mod}.dense.weight"] = (o, i_)
            shapes[f"{lay}.{mod}.dense.bias"] = (o,)
        for mod in ("attention.output", "output"):
            shapes[f"{lay}.{mod}.LayerNorm.weight"] = (h,)
            shapes[f"{lay}.{mod}.LayerNorm.bias"] = (h,)
    state = {f"{prefix}{k}": torch.from_numpy(
        rng.standard_normal(v).astype(np.float32)) for k, v in shapes.items()}
    state[f"{prefix}embeddings.position_ids"] = torch.arange(
        cfg.max_position_embeddings)[None]
    state[f"{prefix}pooler.dense.weight"] = torch.zeros(h, h)
    state["classifier.dense.weight"] = torch.zeros(h, h)
    state["lm_head.bias"] = torch.zeros(cfg.vocab_size)
    return state


@pytest.mark.parametrize("prefix", ["", "roberta."])
def test_convert_hf_roberta_gives_the_jax_tree(pair, prefix):
    cfg, _, _ = pair
    hf = _hf_state(cfg, prefix)
    got = tr.convert_hf_roberta(hf)
    port = tr.build_roberta(tr.tiny_roberta(), "cpu", seed=None)
    port.load_state_dict(got)  # strict: every parameter, nothing else
    want = jr.convert_hf_roberta(hf)
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in p): v
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    got_tree, want_tree = flat(bridge.roberta_torch_to_flax(got)), flat(want)
    assert sorted(got_tree) == sorted(want_tree)
    for k, v in want_tree.items():
        np.testing.assert_array_equal(got_tree[k], v, err_msg=k)


def test_bridge_round_trip_is_bit_for_bit(pair):
    _, params, port = pair
    back = bridge.roberta_torch_to_flax(port.state_dict())
    for (p, a), (q, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert p == q and np.array_equal(a, b)


def test_seeded_init_and_dropout_only_in_train_mode():
    cfg = tr.tiny_roberta()
    a = tr.build_roberta(cfg, "cpu", seed=3)
    b = tr.build_roberta(cfg, "cpu", seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    w = a.state_dict()["encoder.layer.0.intermediate.dense.weight"]
    assert abs(float(w.std()) - 64 ** -0.5) < 0.1 * 64 ** -0.5
    ids, mask = _inputs(cfg, seed=5)
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.no_grad():
        e1, e2 = a(ids, mask), a(ids, mask)
        a.train()
        torch.manual_seed(0)
        t1 = a(ids, mask)
        torch.manual_seed(0)
        t2 = a(ids, mask)
        t3 = a(ids, mask)
    assert torch.equal(e1, e2) and torch.equal(t1, t2)
    assert not torch.equal(t1, e1) and not torch.equal(t1, t3)
