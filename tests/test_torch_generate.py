"""The port's KV-cache decoding and generation
(``deepdfa_tpu_torch.llm.llama`` ``decode=True``,
``deepdfa_tpu_torch.llm.generate``) against the JAX package's, on the CPU.

The JAX ``LlamaForCausalLM`` tree of ``tiny_llama`` is carried across with
``bridge.llama_flax_to_torch``; prompts are left-padded numpy ids from a
seed. The JAX cache is ``max_position_embeddings`` (256) slots long, the
port's prompt + new tokens.

Tolerances: greedy tokens are equal; each decode step's float32 logits
within atol = rtol = 1e-5 (float32 sums in other orders, as the model
tests); the port's sized cache against a full-length one of its own: equal
tokens, logits within the same 1e-5 (masked slots add exact zeros, but the
longer score and value sums are blocked in another order). Sampling cannot
match ``jax.random.categorical``'s draws (another generator): it is held to
the same top-k support and to seed determinism.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as nn  # noqa: E402

from deepdfa_tpu.llm import generate as jgen  # noqa: E402
from deepdfa_tpu.llm import llama as jl  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.llm import generate as tgen  # noqa: E402
from deepdfa_tpu_torch.llm import llama as tl  # noqa: E402

S, NEW = 12, 8


def _prompts(cfg, b=3, s=S, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[1, :4] = False
    mask[2, : s - 3] = False
    ids[~mask] = 2
    return ids, mask


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, port model) over the same weights."""
    cfg = jl.tiny_llama()
    model = jl.LlamaForCausalLM(cfg)
    params = model.init(jax.random.key(3), np.zeros((1, 8), np.int32))
    params = jax.tree.map(np.asarray, nn.meta.unbox(params["params"]))
    port = tl.build_llama(tl.LlamaConfig(**dataclasses.asdict(cfg)), "cpu",
                          seed=None, cls=tl.LlamaForCausalLM)
    port.load_state_dict(bridge.llama_flax_to_torch(params))
    return cfg, params, port


def _jax_generate(cfg, params, ids, mask, gcfg):
    return np.asarray(jgen.generate(jl.LlamaForCausalLM(cfg), params, ids,
                                    mask, gcfg))


def test_greedy_generation_gives_the_jax_tokens(pair):
    cfg, params, port = pair
    ids, mask = _prompts(cfg)
    g = dict(max_new_tokens=NEW, do_sample=False)
    want = _jax_generate(cfg, params, ids, mask, jgen.GenerateConfig(**g))
    scores = []
    got = tgen.generate(port, ids, mask, tgen.GenerateConfig(**g),
                        scores=scores)
    assert got.shape == (3, NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the scores are each generation position's logits: their argmax is
    # the token (no row emitted eos here)
    assert len(scores) == NEW and (got != 2).all()
    np.testing.assert_array_equal(
        torch.stack(scores).argmax(-1).T.numpy(), got)


def test_each_decode_step_has_the_jax_logits(pair):
    """Teacher-forced through prompt and suffix: the JAX decode step over
    its 256-slot cache against the port's over S + NEW slots."""
    cfg, params, port = pair
    ids, mask = _prompts(cfg, seed=1)
    b = ids.shape[0]
    jmodel = jl.LlamaForCausalLM(cfg)
    cache = jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jmodel.init(
            jax.random.key(0), jnp.zeros((b, 1), jnp.int32),
            decode=True))["cache"])

    @jax.jit
    def jstep(cache, tok, valid, t):
        logits, out = jmodel.apply(
            {"params": params, "cache": cache}, tok[:, None],
            attn_mask=valid[:, None],
            positions=jnp.broadcast_to(t, (b, 1)).astype(jnp.int32),
            decode=True, mutable=["cache"])
        return logits[:, 0], out["cache"]

    tcache = tl.KVCache.empty(port.cfg, b, S + NEW, "cpu")
    suffix = np.random.default_rng(2).integers(3, cfg.vocab_size, (b, NEW))
    seq = np.concatenate([ids, suffix], axis=1)
    valid = np.concatenate([mask, np.ones((b, NEW), bool)], axis=1)
    with torch.inference_mode():
        for t in range(S + NEW):
            want, cache = jstep(cache, seq[:, t], valid[:, t], t)
            got, tcache = port(torch.from_numpy(seq[:, t:t + 1]).long(),
                               torch.from_numpy(valid[:, t:t + 1]),
                               decode=True, cache=tcache)
            np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)
    assert tcache.pos == S + NEW


def test_sized_cache_gives_the_full_length_caches_tokens(pair):
    """The port's cache of S + NEW slots against one of
    max_position_embeddings slots (the JAX package's size): the same
    tokens, and logits within 1e-5 at every step."""
    cfg, _, port = pair
    ids, mask = _prompts(cfg, seed=4)
    b = ids.shape[0]
    caches = [tl.KVCache.empty(port.cfg, b, n, "cpu")
              for n in (S + NEW, cfg.max_position_embeddings)]
    assert caches[0].nbytes() * 10 < caches[1].nbytes()
    toks = [torch.from_numpy(ids[:, :1]).long()] * 2
    with torch.inference_mode():
        for t in range(S + NEW - 1):
            outs = []
            for i, c in enumerate(caches):
                cur = (torch.from_numpy(ids[:, t:t + 1]).long() if t < S
                       else toks[i])
                valid = (torch.from_numpy(mask[:, t:t + 1]) if t < S
                         else torch.ones(b, 1, dtype=torch.bool))
                logits, _ = port(cur, valid, decode=True, cache=c)
                outs.append(logits[:, 0])
                toks[i] = torch.argmax(logits[:, 0], -1)[:, None]
            np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                                       atol=1e-5, rtol=1e-5)
            assert torch.equal(toks[0], toks[1])


def test_a_prompt_chunk_in_one_decode_call_equals_token_by_token(pair):
    """A several-token decode step attends causally within itself: the
    prompt in one call leaves the cache and the last logits of the
    one-token steps."""
    _, _, port = pair
    ids, mask = _prompts(port.cfg, seed=5)
    b = ids.shape[0]
    one = tl.KVCache.empty(port.cfg, b, S + 2, "cpu")
    chunk = tl.KVCache.empty(port.cfg, b, S + 2, "cpu")
    with torch.inference_mode():
        for t in range(S):
            last, one = port(torch.from_numpy(ids[:, t:t + 1]).long(),
                             torch.from_numpy(mask[:, t:t + 1]), decode=True,
                             cache=one)
        logits, chunk = port(torch.from_numpy(ids).long(),
                             torch.from_numpy(mask), decode=True, cache=chunk)
    assert one.pos == chunk.pos == S
    np.testing.assert_allclose(logits[:, -1].numpy(), last[:, 0].numpy(),
                               atol=1e-5, rtol=1e-5)
    for a, c in zip(one.k + one.v, chunk.k + chunk.v):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5, rtol=1e-5)
    assert all(torch.equal(a, c) for a, c in zip(one.valid, chunk.valid))


def test_eos_stops_a_row_and_pads_it_as_jax_does(pair):
    """eos set to a token a row emits early: that row is eos from there
    on, in both packages, token for token."""
    cfg, params, port = pair
    ids, mask = _prompts(cfg, seed=6)
    free = tgen.generate(port, ids, mask,
                         tgen.GenerateConfig(max_new_tokens=NEW,
                                             do_sample=False))
    eos = int(free[0, 2])
    g = dict(max_new_tokens=NEW, do_sample=False, eos_token_id=eos)
    got = tgen.generate(port, ids, mask, tgen.GenerateConfig(**g))
    want = _jax_generate(cfg, params, ids, mask, jgen.GenerateConfig(**g))
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(got[0] == eos))
    assert first <= 2 and (got[0, first:] == eos).all()


def test_prompt_length_guard_as_jax(pair):
    cfg, params, port = pair
    ids, mask = _prompts(cfg, s=200)
    g = dict(max_new_tokens=cfg.max_position_embeddings - 199,
             do_sample=False)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tgen.generate(port, ids, mask, tgen.GenerateConfig(**g))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        _jax_generate(cfg, params, ids, mask, jgen.GenerateConfig(**g))
    with pytest.raises(ValueError, match="cache"):
        port(torch.ones(1, 1, dtype=torch.long), decode=True)


def test_sampling_is_seeded_by_its_generator(pair):
    _, _, port = pair
    ids, mask = _prompts(port.cfg, seed=7)
    g = tgen.GenerateConfig(max_new_tokens=NEW, temperature=1.0, top_k=20)
    runs = [tgen.generate(port, ids, mask, g,
                          torch.Generator().manual_seed(seed))
            for seed in (11, 11, 12)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


def test_top_k_filter_is_the_jax_filter():
    """On the same logits (ties included) the port keeps the JAX
    ``_sample``'s support: every JAX draw and every port draw lies in the
    port's finite set, which is the JAX expression's."""
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((4, 64)).astype(np.float32)
    logits[0, :5] = 3.0  # a tie at the k-th largest
    cfg = tgen.GenerateConfig(temperature=0.7, top_k=3)
    kept = torch.isfinite(tgen.filtered_logits(torch.from_numpy(logits),
                                               cfg)).numpy()
    scaled = jnp.asarray(logits) / cfg.temperature
    kth = jnp.sort(scaled, axis=-1)[..., -cfg.top_k][..., None]
    np.testing.assert_array_equal(kept, np.asarray(scaled >= kth))
    assert kept[0, :5].all() and kept.sum(axis=1)[1:].tolist() == [3, 3, 3]
    jcfg = jgen.GenerateConfig(temperature=0.7, top_k=3)
    draws = jax.jit(jax.vmap(lambda k: jgen._sample(jnp.asarray(logits),
                                                    jcfg, k)))(
        jax.random.split(jax.random.key(0), 200))
    gen = torch.Generator().manual_seed(0)
    ours = torch.stack([tgen.sample_tokens(torch.from_numpy(logits), cfg,
                                           gen) for _ in range(200)])
    for d in (np.asarray(draws), ours.numpy()):
        assert kept[np.arange(4)[None, :].repeat(200, 0), d].all()
    greedy = tgen.GenerateConfig(do_sample=False)
    np.testing.assert_array_equal(
        tgen.sample_tokens(torch.from_numpy(logits), greedy).numpy(),
        np.asarray(jgen._sample(jnp.asarray(logits), jgen.GenerateConfig(
            do_sample=False), jax.random.key(0))))
