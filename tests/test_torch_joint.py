"""The port's joint LLM+GGNN scoring path against the JAX package's, on the
CPU: the tokenizer and the text batches, the GGNN encoder's pooled rows,
the fusion head, ``JointEngine.score`` against the JAX
``make_joint_steps(...)[1]``, ``from_run_dir`` on a run directory written
from the JAX fusion tree, and the fusion bridge.

The same inputs go to both packages: texts and graphs made from a seed, the
JAX parameters carried across by ``bridge.llama_flax_to_torch`` and
``bridge.fusion_flax_to_torch``.

Tolerances: token ids, pad masks and batches equal; float32 pooled rows,
logits and probabilities atol = rtol = 1e-5 (float32 sums in other
orders); bf16 hidden states into the head ``BF16_HEAD_LIMIT`` (see there);
the bridge's round trip bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as nn  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.llm import dataset as jds  # noqa: E402
from deepdfa_tpu.llm import fusion as jfusion  # noqa: E402
from deepdfa_tpu.llm import joint as jjoint  # noqa: E402
from deepdfa_tpu.llm import llama as jl  # noqa: E402
from deepdfa_tpu.models import make_model as jmake_model  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.graphs import batch_np, to_device  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.llm import dataset as tds  # noqa: E402
from deepdfa_tpu_torch.llm import fusion as tfusion  # noqa: E402
from deepdfa_tpu_torch.llm import joint as tjoint  # noqa: E402
from deepdfa_tpu_torch.llm import llama as tl  # noqa: E402
from deepdfa_tpu_torch.llm.joint_engine import (JointEngine,  # noqa: E402
                                                newest_epoch_dir)
from deepdfa_tpu_torch.models import make_model  # noqa: E402

INPUT_DIM = 1002  # FeatureConfig().input_dim: JointEngine's default
BLOCK = 128
# bf16 hidden states: the float32 graph embedding is cast to bf16 before the
# head, as in the JAX package; pooled rows that differ in their last float32
# bits (≤ 1e-6) can round to neighbouring bf16 values (2^-8 relative), which
# the head's 4,352-wide dense layer carries into the logits at ~1e-4
BF16_HEAD_LIMIT = 1e-3

_WORDS = ["int", "char", "buf", "len", "size_t", "memcpy", "strcpy", "if",
          "return", "while", "ptr", "malloc", "free", "count", "idx",
          "readInput", "HTTPHeader", "parseURL", "for", "struct", "node"]


def _texts(n, seed):
    """C-like functions of 5-300 subtokens: some truncated at BLOCK, most
    left-padded."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(5, 300))
        words = rng.choice(_WORDS, size=k)
        out.append("void f_%d(int a) {\n  %s;\n}" % (k, " ".join(words)))
    return out


def _graphs(n, seed):
    """The same request graphs in both packages (the port's generator is a
    copy of the JAX package's)."""
    return (random_dataset(n, seed=seed, input_dim=INPUT_DIM, mean_nodes=30),
            jdataset(n, seed=seed, input_dim=INPUT_DIM, mean_nodes=30))


def test_hash_tokenizer_and_batches_equal_the_jax_ones():
    texts = _texts(7, seed=0) + ["", "x", "readHTTPHeader(buf);"]
    for vocab, block in ((320, 16), (2048, BLOCK), (32016, 256)):
        jt, tt = jds.HashTokenizer(vocab), tds.HashTokenizer(vocab)
        for text in texts:
            a, b = tt.encode_block(text, block), jt.encode_block(text, block)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        te = tds.encode_functions(texts, list(range(len(texts))), tt, block)
        je = jds.encode_functions(texts, list(range(len(texts))), jt, block)
        for x, y in zip(te, je):
            np.testing.assert_array_equal(x, y)
        for tb, jb in zip(tds.text_batches(te, 4, shuffle=True, seed=3),
                          jds.text_batches(je, 4, shuffle=True, seed=3)):
            for x, y in zip(tb, jb):
                np.testing.assert_array_equal(x, y)
    assert tds.normalize_whitespace(" a \t b\n\n c ") == \
        jds.normalize_whitespace(" a \t b\n\n c ")
    with pytest.raises(ValueError):
        tds.HashTokenizer(4)


def test_graph_join_matches_jax_and_masks_missing_graphs():
    tg, jg = _graphs(3, seed=4)
    ex_t = tds.encode_functions(_texts(4, 1), [0, 1, 0, 1],
                                tds.HashTokenizer(2048), BLOCK)
    ex_j = jds.encode_functions(_texts(4, 1), [0, 1, 0, 1],
                                jds.HashTokenizer(2048), BLOCK)
    tjoin = tds.GraphJoin(graphs={i: g for i, g in enumerate(tg)},
                          max_nodes=512, max_edges=2048)
    jjoin = jds.GraphJoin(graphs={i: g for i, g in enumerate(jg)},
                          max_nodes=512, max_edges=2048)
    tb = tjoin.join(next(tds.text_batches(ex_t, 4)))
    jb = jjoin.join(next(jds.text_batches(ex_j, 4)))
    assert list(tb.mask) == [True, True, True, False]  # graph 3 is missing
    assert tjoin.num_missing == jjoin.num_missing == 1
    np.testing.assert_array_equal(tb.mask, jb.mask)
    for x, y in zip(tb.graphs[1:], jb.graphs[1:]):
        np.testing.assert_array_equal(x, y)
    for k in tb.graphs.node_feats:
        np.testing.assert_array_equal(tb.graphs.node_feats[k],
                                      jb.graphs.node_feats[k])
    # the dense layout is ported (tests/test_torch_joint_dense.py); an
    # unknown one is refused as the JAX GraphJoin refuses it
    with pytest.raises(ValueError, match="unknown layout"):
        tds.GraphJoin(graphs={}, layout="sparse")
    with pytest.raises(ValueError, match="empty graph store"):
        tds.GraphJoin(graphs={}).join(next(tds.text_batches(ex_t, 4)))


@pytest.fixture(scope="module")
def encoder():
    """The golden GGNN in encoder mode: JAX params and the port's state."""
    jcfg = JCfg(encoder_mode=True)
    jmodel = jmake_model(jcfg, INPUT_DIM)
    example = jax.tree.map(jnp.asarray, jbatch_np(_graphs(4, 0)[1], 5, 512,
                                                  2048))
    params = jax.tree.map(np.asarray,
                          jmodel.init(jax.random.key(0), example)["params"])
    cfg = GGNNConfig(encoder_mode=True)
    return jmodel, params, cfg, bridge.flax_to_torch(params, cfg, INPUT_DIM)


@pytest.mark.parametrize("layout", ["segment", "fused"])
def test_ggnn_encoder_pooled_rows_match_jax(encoder, layout):
    jmodel, params, cfg, state = encoder
    assert not any(k.startswith("head.") for k in state)
    tg, jg = _graphs(4, seed=7)
    want = np.asarray(jmodel.apply({"params": params}, jax.tree.map(
        jnp.asarray, jbatch_np(jg, 5, 512, 2048))))
    model = make_model(dataclasses.replace(cfg, layout=layout), INPUT_DIM,
                       device="cpu")
    model.load_state_dict(state)
    with torch.inference_mode():
        got = model(to_device(batch_np(tg, 5, 512, 2048), "cpu")).numpy()
    assert got.shape == (5, cfg.out_dim) == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert bridge.torch_to_flax(state, cfg, INPUT_DIM).keys() == params.keys()


@pytest.fixture(scope="module")
def joint():
    """tiny_llama(vocab 2048) + the golden GGNN + the fusion head: JAX
    modules and params, and the port's state dicts of the same values."""
    llm_cfg = jl.tiny_llama(vocab_size=2048)
    jllm = jl.LlamaModel(llm_cfg)
    llm_params = jax.tree.map(np.asarray, nn.meta.unbox(jllm.init(
        jax.random.key(0), np.zeros((2, BLOCK), np.int32))["params"]))
    jfus = jfusion.FusionModel(gnn_cfg=JCfg(), input_dim=INPUT_DIM,
                               llm_hidden_size=llm_cfg.hidden_size,
                               dropout_rate=0.1, pool="last")
    hidden = np.zeros((2, BLOCK, llm_cfg.hidden_size), np.float32)
    graphs = jbatch_np(_graphs(2, 0)[1], 3, 512, 2048)
    fus_params = jfus.init({"params": jax.random.key(1),
                            "dropout": jax.random.key(2)}, hidden, graphs,
                           deterministic=True,
                           token_mask=np.ones((2, BLOCK), bool))["params"]
    fus_params = jax.tree.map(np.asarray, fus_params)
    llm_state = bridge.llama_flax_to_torch(llm_params)
    fus_state = bridge.fusion_flax_to_torch(fus_params, GGNNConfig(),
                                            INPUT_DIM)
    return (jllm, llm_params, jfus, fus_params, llm_state, fus_state,
            llm_cfg)


def _port_models(joint, gnn_cfg=None):
    *_, llm_state, fus_state, llm_cfg = joint
    llm = tl.build_llama(tl.LlamaConfig(**dataclasses.asdict(llm_cfg)),
                         "cpu", seed=None)
    llm.load_state_dict(llm_state)
    fus = tfusion.build_fusion(gnn_cfg or GGNNConfig(), INPUT_DIM,
                               llm_cfg.hidden_size, dropout_rate=0.1,
                               device="cpu")
    fus.load_state_dict(fus_state)
    return llm, fus


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fusion_logits_match_jax(joint, dtype):
    jllm, llm_params, jfus, fus_params, _, fus_state, llm_cfg = joint
    rng = np.random.default_rng(11)
    hidden = rng.normal(size=(3, BLOCK, llm_cfg.hidden_size)).astype(
        np.float32)
    mask = np.ones((3, BLOCK), bool)
    mask[1, :50] = False
    mask[2, 60:] = False  # right padding: "last" takes the last real token
    tg, jg = _graphs(3, seed=12)
    jh = jnp.asarray(hidden, jnp.dtype(dtype))
    want = np.asarray(jfus.apply({"params": fus_params}, jh,
                                 jbatch_np(jg, 4, 512, 2048),
                                 deterministic=True, token_mask=mask))
    fus = _port_models(joint)[1]
    with torch.inference_mode():
        got = fus(torch.from_numpy(hidden).to(getattr(torch, dtype)),
                  to_device(batch_np(tg, 4, 512, 2048), "cpu"),
                  token_mask=torch.from_numpy(mask)).numpy()
    assert got.shape == (3, 2) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(got - want).max() <= BF16_HEAD_LIMIT
    # the loss and the softmax
    labels = np.array([0, 1, 1], np.int32)
    ok = np.array([True, True, False])
    jloss, jprobs = jfusion.fusion_loss(jnp.asarray(want), labels, ok)
    tloss, tprobs = tfusion.fusion_loss(torch.from_numpy(np.array(want)),
                                        torch.from_numpy(labels),
                                        torch.from_numpy(ok))
    assert abs(float(tloss) - float(jloss)) <= 1e-6
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-7)


def test_pool_tokens_matches_jax():
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(3, 9, 4)).astype(np.float32)
    mask = np.ones((3, 9), bool)
    mask[0, :4] = False
    mask[1, 5:] = False
    mask[2, :] = False
    for pool in ("last", "first", "cls"):
        for m in (mask, None):
            want = np.asarray(jfusion.pool_tokens(
                jnp.asarray(feats), None if m is None else jnp.asarray(m),
                pool))
            got = tfusion.pool_tokens(torch.from_numpy(feats),
                                      None if m is None else
                                      torch.from_numpy(m), pool).numpy()
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="pool"):
        tfusion.pool_tokens(torch.from_numpy(feats), None, "mean")


def _jax_scores(joint, items, max_batch=4):
    """The JAX package's probabilities of ``items`` through its own
    ``make_joint_steps(...)[1]`` over the same batches."""
    jllm, llm_params, jfus, fus_params, *_ = joint
    _, eval_step = jjoint.make_joint_steps(jllm, jfus, None)
    tok = jds.HashTokenizer(2048)
    out = []
    for start in range(0, len(items), max_batch):
        chunk = items[start: start + max_batch]
        ex = jds.encode_functions([t for t, _ in chunk], [0] * len(chunk),
                                  tok, BLOCK)
        tb = next(jds.text_batches(ex, max_batch))
        join = jds.GraphJoin(graphs={i: g for i, (_, g) in enumerate(chunk)},
                             max_nodes=1024, max_edges=4096)
        _, probs = eval_step(fus_params, llm_params, join.join(tb))
        out.append(np.asarray(probs)[: len(chunk), 1])
    return np.concatenate(out)


@pytest.fixture(scope="module")
def scored(joint):
    texts = _texts(6, seed=21)
    tg, jg = _graphs(6, seed=22)
    want = _jax_scores(joint, list(zip(texts, jg)))
    return texts, tg, want


def test_joint_engine_scores_match_the_jax_eval_step(joint, scored):
    texts, tg, want = scored
    llm, fus = _port_models(joint)
    engine = JointEngine(llm, fus, tds.HashTokenizer(2048),
                         tjoint.JointConfig(block_size=BLOCK), max_batch=4,
                         max_nodes=1024, max_edges=4096, device="cpu")
    got = engine.score(list(zip(texts, tg)))
    assert got.dtype == np.float64 and got.shape == (6,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert engine.n_batches == 2
    report = engine.warmup()
    assert report == {"max_batch": 4, "model_rev": engine.model_rev}
    assert engine.describe() == {"model_rev": engine.model_rev,
                                 "max_batch": 4, "block_size": BLOCK,
                                 "use_gnn": True}
    # the fused layout's encoder (B1's plain version here) scores the same
    fused = JointEngine(*_port_models(joint, GGNNConfig(layout="fused")),
                        tds.HashTokenizer(2048),
                        tjoint.JointConfig(block_size=BLOCK), max_nodes=1024,
                        max_edges=4096, device="cpu")
    np.testing.assert_allclose(fused.score(list(zip(texts, tg))), want,
                               atol=1e-5, rtol=1e-5)


def test_eval_step_loss_is_the_jax_loss(joint):
    jllm, llm_params, jfus, fus_params, *_ = joint
    texts = _texts(3, seed=31)
    tg, jg = _graphs(3, seed=32)
    labels = [1, 0, 1]
    jex = jds.encode_functions(texts, labels, jds.HashTokenizer(2048), BLOCK)
    tex = tds.encode_functions(texts, labels, tds.HashTokenizer(2048), BLOCK)
    jb = jds.GraphJoin(graphs=dict(enumerate(jg[:2])), max_nodes=1024,
                       max_edges=4096).join(next(jds.text_batches(jex, 4)))
    tb = tds.GraphJoin(graphs=dict(enumerate(tg[:2])), max_nodes=1024,
                       max_edges=4096).join(next(tds.text_batches(tex, 4)))
    jloss, jprobs = jjoint.make_joint_steps(jllm, jfus, None)[1](
        fus_params, llm_params, jb)
    llm, fus = _port_models(joint)
    tloss, tprobs = tjoint.eval_step(llm, fus, tb, "cpu")
    assert abs(float(tloss) - float(jloss)) <= 1e-5
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-5)


def test_from_run_dir_restores_the_newest_epoch_of_a_jax_tree(joint, scored,
                                                              tmp_path):
    texts, tg, want = scored
    *_, llm_state, fus_state, _ = joint
    stale = {k: torch.zeros_like(v) for k, v in fus_state.items()}
    tjoint.save_fusion_epoch(tmp_path, 9, stale)
    tjoint.save_fusion_epoch(tmp_path, 10, fus_state)  # 10 beats 9
    (tmp_path / "epoch_11.tmp").mkdir()  # a torn write: never a candidate
    assert newest_epoch_dir(tmp_path).name == "epoch_10"
    engine = JointEngine.from_run_dir(
        tmp_path, jcfg=tjoint.JointConfig(block_size=BLOCK),
        llm_state=llm_state, max_nodes=1024, max_edges=4096, device="cpu")
    np.testing.assert_allclose(engine.score(list(zip(texts, tg))), want,
                               atol=1e-5, rtol=1e-5)
    # the hermetic default draws its own LLM weights from the seed
    seeded = JointEngine.from_run_dir(tmp_path, device="cpu", seed=1)
    assert seeded.model_rev == engine.model_rev  # the same fusion tree
    assert not torch.equal(seeded.llm.embed_tokens.weight,
                           engine.llm.embed_tokens.weight)


def test_from_run_dir_refuses_orbax_and_empty_directories(tmp_path):
    with pytest.raises(FileNotFoundError, match="epoch_"):
        JointEngine.from_run_dir(tmp_path, device="cpu")
    orbax = tmp_path / "epoch_0"  # what the JAX JointTrainer.save writes
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    (orbax / "manifest.ocdbt").write_bytes(b"\0")
    with pytest.raises(ValueError, match="fusion_flax_to_torch"):
        JointEngine.from_run_dir(tmp_path, device="cpu")
    # a mesh is accepted (tests/test_torch_shard.py) and refuses the same
    from deepdfa_tpu_torch.parallel.mesh import local_mesh

    with pytest.raises(ValueError, match="fusion_flax_to_torch"):
        JointEngine.from_run_dir(tmp_path, mesh=local_mesh(1, device="cpu"),
                                 device="cpu")


def test_fusion_bridge_round_trip_is_bitwise(joint):
    *_, fus_params, _, fus_state, _ = joint
    assert set(fus_state) == set(_port_models(joint)[1].state_dict())
    back = bridge.fusion_torch_to_flax(fus_state, GGNNConfig(), INPUT_DIM)
    assert jax.tree.structure(back) == jax.tree.structure(fus_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(fus_params)):
        np.testing.assert_array_equal(a, b)
    # the LLM-only head (use_gnn=False) has no encoder entries
    head = {k: v for k, v in fus_state.items() if k.startswith("classifier.")}
    head["classifier.dense.weight"] = head["classifier.dense.weight"][:, :64]
    tree = bridge.fusion_torch_to_flax(head, GGNNConfig(), INPUT_DIM)
    assert set(tree) == {"classifier"}
    again = bridge.fusion_flax_to_torch(tree, GGNNConfig(), INPUT_DIM)
    assert all(torch.equal(again[k], head[k]) for k in head)
    fus = tfusion.build_fusion(GGNNConfig(), INPUT_DIM, 64, use_gnn=False,
                               device="cpu")
    fus.load_state_dict(again)


def test_joint_engine_without_the_gnn_scores_text_only(joint):
    llm, _ = _port_models(joint)
    fus = tfusion.build_fusion(GGNNConfig(), INPUT_DIM, 64, use_gnn=False,
                               device="cpu", seed=4)
    engine = JointEngine(llm, fus, tds.HashTokenizer(2048),
                         tjoint.JointConfig(block_size=BLOCK), max_batch=2,
                         device="cpu")
    probs = engine.score([(t, None) for t in _texts(3, seed=5)])
    assert probs.shape == (3,) and np.all((probs > 0) & (probs < 1))
    assert engine.warmup()["max_batch"] == 2
    assert engine.describe()["use_gnn"] is False
