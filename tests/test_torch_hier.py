"""The port's hierarchical whole-unit scoring against the JAX package's, on
the CPU: the level-1 encoder (kernel B4's plain version against the JAX
Pallas encoder in interpret mode), the hierarchical packer's bins, level-1
embeddings through the packer and the embedding cache, level 2 on the
``cross_taint.c`` fixture with the JAX level-2 weights carried across by
the bridge, the cache's keys and its torn-entry rules, and the engine's
``score_unit``.

The same inputs go to both packages: graphs encoded by the JAX package's C
front end from the fixtures (the port has no front end yet), or made from a
seed with numpy, and the JAX parameters carried across by the bridge.

Tolerances:
- pooled embeddings and level-1 rows: atol = rtol = 1e-5 (the JAX
  megabatch tests' bar: the products sum in another order than XLA's);
- unit score, attribution weights and scores: atol 1e-5 (the JAX side
  rounds to 6 decimals as well);
- cache payloads, the port's own cold / warm / standalone embeddings and
  two engines' unit scores: bit for bit (no arithmetic in between).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.data.graphs import Graph as JGraph  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.models import ggnn_hier as jhier  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.ops import megabatch as jmb  # noqa: E402
from deepdfa_tpu.pipeline import source_key as jsource_key  # noqa: E402
from deepdfa_tpu.resilience.journal import (  # noqa: E402
    atomic_write_bytes as jatomic_write_bytes)
from deepdfa_tpu.serve.embcache import (  # noqa: E402
    FunctionEmbeddingCache as JCache)

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.graphs import Graph, batch_np  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.models import ggnn_hier as hier  # noqa: E402
from deepdfa_tpu_torch.ops import megabatch as mb  # noqa: E402
from deepdfa_tpu_torch.pipeline import normalize_source, source_key  # noqa: E402
from deepdfa_tpu_torch.resilience.journal import atomic_write_bytes  # noqa: E402
from deepdfa_tpu_torch.serve import (EMBCACHE_VERSION,  # noqa: E402
                                     FunctionEmbeddingCache, ScoringEngine,
                                     serve_buckets)

FIXTURES = Path(__file__).parent / "fixtures"
CROSS_TAINT = FIXTURES / "interproc" / "cross_taint.c"
REALWORLD = sorted((FIXTURES / "realworld").glob("*.c"))
INPUT_DIM = 40
SMALL = dict(hidden_dim=8, n_steps=2, num_output_layers=2)
KEYS = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)
ATOL = RTOL = 1e-5


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def vocabs():
    from deepdfa_tpu.config import FeatureConfig
    from deepdfa_tpu.cpg.features import add_dependence_edges
    from deepdfa_tpu.cpg.frontend import parse_source
    from deepdfa_tpu.data.codegen import demo_corpus
    from deepdfa_tpu.data.materialize import CorpusBuilder

    rows = demo_corpus(6, seed=0).to_dict("records")
    cpgs = {int(r["id"]): add_dependence_edges(parse_source(r["before"]))
            for r in rows}
    labels = {int(r["id"]): int(r["vul"]) for r in rows}
    _, vocabs = CorpusBuilder(FeatureConfig()).build(
        cpgs, list(cpgs), graph_labels=labels)
    return vocabs


@pytest.fixture(scope="module")
def live():
    """The JAX package's tiny megabatch-compatible GGNN with seeded
    parameters, and the same parameters as a port state dict."""
    jcfg = JCfg(**SMALL)
    model = JGGNN(cfg=jcfg, input_dim=INPUT_DIM)
    g = JGraph(senders=np.arange(3, dtype=np.int32),
               receivers=np.arange(1, 4, dtype=np.int32),
               node_feats={k: np.zeros(4, np.int32) for k in KEYS},
               ).with_self_loops()
    example = jax.tree.map(jnp.asarray, jbatch_np([g], 2, 8, 128))
    params = model.init(jax.random.key(0), example)["params"]
    cfg = GGNNConfig(**SMALL, layout="fused")
    state = bridge.flax_to_torch(jax.tree.map(np.asarray, params), cfg,
                                 INPUT_DIM)
    return model, params, cfg, state


def _port_graph(g) -> Graph:
    return Graph(senders=np.asarray(g.senders), receivers=np.asarray(g.receivers),
                 node_feats={k: np.asarray(v) for k, v in g.node_feats.items()})


def _jax_graph(g: Graph) -> JGraph:
    return JGraph(senders=g.senders, receivers=g.receivers,
                  node_feats=g.node_feats)


def _encode(code: str, vocabs):
    """The JAX front end's functions of ``code``: (JAX UnitFunctions, port
    UnitFunctions, CPGs)."""
    from deepdfa_tpu.pipeline import encode_source

    fns = [fn for fn in encode_source(code, vocabs, keep_cpg=True)
           if fn.graph is not None]
    jfns = [jhier.UnitFunction(fn.name, f"{fn.name}\n{code}", fn.graph)
            for fn in fns]
    tfns = [hier.UnitFunction(fn.name, f"{fn.name}\n{code}",
                              _port_graph(fn.graph)) for fn in fns]
    return jfns, tfns, [fn.cpg for fn in fns if fn.cpg is not None]


@pytest.fixture(scope="module")
def realworld(vocabs):
    jfns, tfns = [], []
    for path in REALWORLD:
        a, b, _ = _encode(path.read_text(), vocabs)
        jfns += a
        tfns += b
    assert len(tfns) >= len(REALWORLD)
    return jfns, tfns


def _synthetic():
    """Many small graphs, a few mid-size ones and one larger than a bin's
    node budget: several bins, the graph and node caps both binding."""
    small = random_dataset(150, seed=11, input_dim=INPUT_DIM, mean_nodes=40)
    mid = random_dataset(6, seed=12, input_dim=INPUT_DIM, mean_nodes=900)
    big = random_dataset(1, seed=13, input_dim=INPUT_DIM, mean_nodes=4600)
    return small + mid + big


def _scorers(live, **kw):
    model, params, cfg, state = live
    jscorer = jhier.HierScorer(model.cfg, INPUT_DIM, params, **{
        k: v for k, v in kw.items() if k != "cache"})
    tscorer = hier.HierScorer(cfg, INPUT_DIM, state, device="cpu", **kw)
    return jscorer, tscorer


# ------------------------------------------------------------ B4 encoder


def _encoder_args(scorer, batch):
    ids = np.stack([batch.node_feats[f"_ABS_DATAFLOW_{sk}"] + i * INPUT_DIM
                    for i, sk in enumerate(ALL_SUBKEYS)], axis=-1)
    arrays = (scorer._table.numpy(), ids, batch.senders, batch.receivers,
              batch.node_gidx, batch.node_mask) + tuple(
                  w.numpy() for w in scorer._weights)
    return arrays


@pytest.mark.parametrize("corpus", ["realworld", "synthetic"])
def test_encoder_reference_matches_the_jax_encoder(live, realworld, corpus):
    """B4's plain version (what the wrapper runs on CPU tensors) against
    the JAX Pallas encoder in interpret mode, on the hierarchical packer's
    batches."""
    _, tscorer = _scorers(live)
    graphs = ([fn.graph for fn in realworld[1]] if corpus == "realworld"
              else _synthetic()[:40])
    for indices, plan in tscorer._pack(graphs):
        batch = batch_np([graphs[i] for i in indices], plan.max_graphs,
                         plan.max_nodes, plan.max_edges)
        arrays = _encoder_args(tscorer, batch)
        kw = dict(n_steps=SMALL["n_steps"], n_graphs=batch.max_graphs)
        got = mb.fused_ggnn_encoder(*(torch.from_numpy(np.asarray(a))
                                      for a in arrays), **kw)
        want = jmb.fused_ggnn_encoder(*(jnp.asarray(a) for a in arrays),
                                      interpret=True, edges_sorted=True, **kw)
        assert got.shape == (batch.max_graphs, 2 * 4 * SMALL["hidden_dim"])
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
        ref = jmb.megabatch_encoder_reference(
            *(jnp.asarray(a) for a in arrays), **kw)
        np.testing.assert_allclose(
            mb.megabatch_encoder_reference(
                *(torch.from_numpy(np.asarray(a)) for a in arrays),
                **kw).numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_encoder_pools_what_the_whole_model_pools(live):
    """The whole model's logits are its head over the encoder's rows."""
    _, tscorer = _scorers(live)
    graphs = random_dataset(7, seed=3, input_dim=INPUT_DIM, mean_nodes=12)
    (indices, plan), = tscorer._pack(graphs)
    batch = batch_np([graphs[i] for i in indices], plan.max_graphs,
                     plan.max_nodes, plan.max_edges)
    args = [torch.from_numpy(np.asarray(a))
            for a in _encoder_args(tscorer, batch)]
    kw = dict(n_steps=SMALL["n_steps"], n_graphs=batch.max_graphs)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((64, 1)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(1).astype(np.float32))
    logits = mb.fused_ggnn_model(*args, ((w, b),), **kw)
    pooled = mb.fused_ggnn_encoder(*args, **kw)
    torch.testing.assert_close(logits, (pooled @ w + b)[:, 0], atol=0, rtol=0)


def test_encoder_is_inference_only_and_checks_widths(live):
    _, tscorer = _scorers(live)
    g = random_dataset(2, seed=4, input_dim=INPUT_DIM, mean_nodes=6)
    batch = batch_np(g, 3, 64, 128)
    args = [torch.from_numpy(np.asarray(a))
            for a in _encoder_args(tscorer, batch)]
    kw = dict(n_steps=1, n_graphs=3)
    args[6].requires_grad_(True)
    with pytest.raises(ValueError, match="inference only"):
        mb.fused_ggnn_encoder(*args, **kw)
    with torch.no_grad():
        assert mb.fused_ggnn_encoder(*args, **kw).shape == (3, 64)
    args[6] = args[6].detach()
    args[0] = args[0][:, :4]  # embed width 4·4 != conv width 32
    with pytest.raises(ValueError, match="embed width"):
        mb.fused_ggnn_encoder(*args, **kw)


# ------------------------------------------------------------- the packer


@pytest.mark.parametrize("corpus", ["realworld", "synthetic"])
def test_hier_bins_equal_jax_index_for_index(live, realworld, corpus):
    jscorer, tscorer = _scorers(live)
    graphs = ([fn.graph for fn in realworld[1]] if corpus == "realworld"
              else _synthetic())
    got = tscorer._pack(graphs)
    want = jscorer._pack([_jax_graph(g) for g in graphs])
    assert [b for b, _ in got] == [b for b, _ in want]
    for (_, p), (_, q) in zip(got, want):
        assert (p.max_graphs, p.max_nodes, p.max_edges, p.n_head_layers) == (
            q.max_graphs, q.max_nodes, q.max_edges, q.n_head_layers)
        assert p.fits
    if corpus == "synthetic":
        assert len(got) >= 4
        assert max(len(b) for b, _ in got) == hier.HierScorer.MAX_BIN_GRAPHS


# ------------------------------------------------------ level-1 embeddings


def test_embed_graphs_matches_jax_and_the_cache_changes_no_bit(
        live, realworld, tmp_path):
    jfns, tfns = realworld
    jscorer, tscorer = _scorers(live)
    want = jscorer.embed_graphs([fn.graph for fn in jfns])
    ref = tscorer.embed_graphs([fn.graph for fn in tfns])
    np.testing.assert_allclose(ref, want, atol=ATOL, rtol=RTOL)
    assert tscorer.n_level1_dispatches == 1
    assert tscorer.n_fallback_dispatches == 0

    cache = FunctionEmbeddingCache(tmp_path / "emb", model_rev="r1",
                                   vocab_hash="v1")
    _, cold = _scorers(live, cache=cache)
    np.testing.assert_array_equal(cold.embed_functions(tfns), ref)
    assert cold.level1_recompute == len(tfns)
    assert cold.stats()["cache"]["puts"] == len(tfns)

    warm_cache = FunctionEmbeddingCache(tmp_path / "emb", model_rev="r1",
                                        vocab_hash="v1")
    _, warm = _scorers(live, cache=warm_cache)
    np.testing.assert_array_equal(warm.embed_functions(tfns), ref)
    assert warm.level1_recompute == 0 and warm.n_level1_dispatches == 0
    assert warm_cache.stats()["hits"] == len(tfns)
    assert warm_cache.stats()["hit_rate"] == 1.0


def test_a_row_does_not_depend_on_its_bin(live):
    """A function's row embedded alone equals its row inside a full bin
    (the plain version here; the card's check is in test_torch_cuda.py)."""
    _, tscorer = _scorers(live)
    graphs = random_dataset(20, seed=6, input_dim=INPUT_DIM, mean_nodes=15)
    together = tscorer.embed_graphs(graphs)
    for i in (0, 7, 19):
        alone = tscorer.embed_graphs([graphs[i]])[0]
        np.testing.assert_allclose(alone, together[i], atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------------ level 2


def test_level2_on_cross_taint_matches_jax(live, vocabs):
    from deepdfa_tpu.cpg.interproc import build_supergraph, merge_cpgs

    jfns, tfns, cpgs = _encode(CROSS_TAINT.read_text(), vocabs)
    merged, _ = merge_cpgs(cpgs)
    sg = build_supergraph(merged)
    names = [fn.name for fn in jfns]

    jscorer, tscorer = _scorers(live)
    l2 = jax.tree.map(np.asarray, jscorer._l2_params)
    tscorer.level2.load_state_dict(bridge.level2_flax_to_torch(l2))
    snd, rcv = hier.unit_call_edges(sg, names)
    jsnd, jrcv = jhier.unit_call_edges(sg, names)
    np.testing.assert_array_equal(snd, jsnd)
    np.testing.assert_array_equal(rcv, jrcv)
    unit = hier.UnitCallGraph(snd, rcv, jhier.unit_summaries(sg, names),
                              int(sg.n_call_edges))

    want = jscorer.score_unit(jfns, sg)
    got = tscorer.score_unit(tfns, unit)
    assert set(got) == set(want)
    assert got["n_functions"] == want["n_functions"] == 2
    assert got["call_edges"] == want["call_edges"] == 1
    assert got["unit_score"] == pytest.approx(want["unit_score"], abs=ATOL)
    assert [r["function"] for r in got["attribution"]] == [
        r["function"] for r in want["attribution"]]
    for a, b in zip(got["attribution"], want["attribution"]):
        assert a["weight"] == pytest.approx(b["weight"], abs=ATOL)
        assert a["score"] == pytest.approx(b["score"], abs=ATOL)
    assert got["level1"]["dispatches"] == 1
    assert got["level1"]["fallback_dispatches"] == 0
    assert set(tscorer.last_seconds) == {"level1", "level2"}


def test_level2_bridge_round_trip_is_bit_for_bit(live):
    jscorer, tscorer = _scorers(live)
    l2 = jax.tree.map(np.asarray, jscorer._l2_params)
    state = bridge.level2_flax_to_torch(l2)
    assert set(state) == set(tscorer.level2.state_dict())
    back = bridge.level2_torch_to_flax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(l2)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_level2_seed_comes_from_the_weights_not_the_revision(live):
    """Two scorers over the same weights draw the same level-2 weights,
    whatever ``model_rev`` names them; other weights draw others."""
    _, a = _scorers(live, model_rev="one")
    _, b = _scorers(live, model_rev="two")
    assert a.model_rev == "one"
    for k, v in a.level2.state_dict().items():
        assert torch.equal(v, b.level2.state_dict()[k]), k
    model, params, cfg, state = live
    other = dict(state)
    other["ggnn.edge_linear.bias"] = other["ggnn.edge_linear.bias"] + 1.0
    c = hier.HierScorer(cfg, INPUT_DIM, other, device="cpu")
    assert not torch.equal(c.level2.in_proj.weight, a.level2.in_proj.weight)


def test_score_unit_checks_its_inputs(live):
    _, tscorer = _scorers(live)
    g = random_dataset(2, seed=5, input_dim=INPUT_DIM, mean_nodes=6)
    fns = [hier.UnitFunction(f"f{i}", f"int f{i};", x) for i, x in enumerate(g)]
    unit = hier.UnitCallGraph(np.array([0, 1], np.int32),
                              np.array([0, 1], np.int32),
                              np.zeros((3, hier.N_SUMMARY_FEATURES),
                                        np.float32), 0)
    with pytest.raises(ValueError, match="summaries"):
        tscorer.score_unit(fns, unit)
    with pytest.raises(ValueError, match="at least one"):
        tscorer.score_unit([], unit)


def test_megabatch_compatible_mirrors_the_jax_envelope(live):
    for kw in ({}, dict(concat_all_absdf=False), dict(label_style="node"),
               dict(encoder_mode=True), dict(aggregation="union"),
               dict(dataflow_families=True)):
        assert hier.megabatch_compatible(GGNNConfig(**kw)) == \
            jhier.megabatch_compatible(JCfg(**kw)), kw
    model, params, cfg, state = live
    with pytest.raises(ValueError, match="megabatch-compatible"):
        hier.HierScorer(dataclasses.replace(cfg, concat_all_absdf=False),
                        INPUT_DIM, state, device="cpu")


# ------------------------------------------------------- embedding cache


def test_source_key_and_atomic_write_match_the_jax_package(tmp_path):
    for code in ("int f(int x) { return x + 1; }",
                 "int f(int x) {\r\n  return x + 1;   \r\n\n}\n",
                 "\n\n  \n"):
        assert source_key(code) == jsource_key(code)
    assert normalize_source("a  \r\n\r\nb\rc") == "a\nb\nc"
    a = atomic_write_bytes(tmp_path / "a.bin", b"\x00\x01payload")
    b = jatomic_write_bytes(tmp_path / "b.bin", b"\x00\x01payload")
    assert a.read_bytes() == b.read_bytes() == b"\x00\x01payload"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a.bin", "b.bin"]


@pytest.mark.parametrize("salt", [
    dict(model_rev="r1", vocab_hash="v1"),
    dict(model_rev="r1", vocab_hash="v1", feature_salt="fa"),
    dict(model_rev="deadbeef", vocab_hash="v2", version=2),
])
def test_cache_keys_equal_the_jax_cache(tmp_path, salt):
    ours = FunctionEmbeddingCache(tmp_path / "t", **salt)
    theirs = JCache(tmp_path / "j", **salt)
    for code in ("int f(int x) { return x + 1; }", "void g(void) {}\n"):
        assert ours.key(code) == theirs.key(code)
    # an entry one writes, the other reads
    emb = np.linspace(-1, 1, 12).astype(np.float32)
    key = ours.key("int h;")
    ours.put(key, emb)
    shared = JCache(tmp_path / "t", **salt)
    np.testing.assert_array_equal(shared.get(key), emb)
    assert EMBCACHE_VERSION == 1


def test_cache_key_rotates_on_model_rev_vocab_and_features(tmp_path):
    code = "int f(int x) { return x + 1; }"
    base = dict(model_rev="r1", vocab_hash="v1", feature_salt="fa")
    cache = FunctionEmbeddingCache(tmp_path, **base)
    key = cache.key(code)
    cache.put(key, np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(cache.get(key),
                                  np.arange(4, dtype=np.float32))
    for rotated in (dict(base, model_rev="r2"), dict(base, vocab_hash="v2"),
                    dict(base, feature_salt="fb")):
        other = FunctionEmbeddingCache(tmp_path, **rotated)
        assert other.key(code) != key
        assert other.get(other.key(code)) is None
        assert other.stats()["misses"] == 1
    assert cache.key("int f(int x) { return x + 1; }  \r\n\n") == key
    v2 = FunctionEmbeddingCache(tmp_path, **base, version=2)
    assert v2.key(code) != key
    assert len(cache) == 1


def test_torn_truncated_and_wrong_width_entries_read_as_miss(tmp_path):
    cache = FunctionEmbeddingCache(tmp_path, model_rev="r", vocab_hash="v")
    emb = np.linspace(0, 1, 8).astype(np.float32)

    torn = cache.key("int a(void) { return 0; }")
    _, meta = cache._paths(torn)
    cache.put(torn, emb)
    meta.unlink()  # the payload landed, the meta marker did not
    assert cache.get(torn) is None

    trunc = cache.key("int b(void) { return 1; }")
    cache.put(trunc, emb)
    payload, _ = cache._paths(trunc)
    payload.write_bytes(payload.read_bytes()[:5])
    assert cache.get(trunc) is None
    assert cache.stats()["corrupt"] == 1

    bad_meta = cache.key("int c(void) { return 2; }")
    cache.put(bad_meta, emb)
    cache._paths(bad_meta)[1].write_text("{not json")
    assert cache.get(bad_meta) is None
    assert cache.stats()["corrupt"] == 2

    sized = FunctionEmbeddingCache(tmp_path, model_rev="r", vocab_hash="v",
                                   dim=16)
    ok = sized.key("int d(void) { return 3; }")
    sized.put(ok, emb)  # 8 wide, the scorer wants 16
    assert sized.get(ok) is None
    stats = cache.stats()
    assert set(stats) == {"hits", "misses", "corrupt", "puts", "hit_rate"}
    assert stats["hits"] == 0 and stats["puts"] == 3


# ---------------------------------------------------------------- engine


def _engine(live, **kw):
    model, params, cfg, state = live
    return ScoringEngine.from_model(make_model(cfg, INPUT_DIM, device="cpu"),
                                    state, "graph", feat_keys=KEYS,
                                    max_batch=4, device="cpu", **kw)


def test_engine_score_unit_counts_bins_and_repeats(live):
    graphs = _synthetic()[:140]
    fns = [hier.UnitFunction(f"f{i}", f"int f{i}(void);", g)
           for i, g in enumerate(graphs)]
    n = len(fns)
    rng = np.random.default_rng(9)
    unit = hier.UnitCallGraph(
        np.concatenate([np.arange(n), np.arange(n - 1)]).astype(np.int32),
        np.concatenate([np.arange(n), np.arange(1, n)]).astype(np.int32),
        rng.random((n, hier.N_SUMMARY_FEATURES)).astype(np.float32), n - 1)
    engine = _engine(live)
    bins = len(engine.hier._pack(graphs))
    assert bins >= 3
    before = engine.n_dispatches
    out = engine.score_unit(fns, unit)
    assert engine.n_dispatches - before == bins
    assert out["level1"]["dispatches"] == bins
    assert 0.0 < out["unit_score"] < 1.0 and out["call_edges"] == n - 1
    assert abs(sum(r["weight"] for r in out["attribution"]) - 1.0) < 1e-4
    again = _engine(live).score_unit(fns, unit)
    assert again["unit_score"] == out["unit_score"]
    assert again["attribution"] == out["attribution"]


def test_engine_hier_uses_the_f32_weights_under_int8(live):
    model, params, cfg, state = live
    f32 = _engine(live)
    int8 = _engine(live, precision="int8")
    assert int8.precision == "int8"
    for k, v in f32.hier.level2.state_dict().items():
        assert torch.equal(v, int8.hier.level2.state_dict()[k])
    assert torch.equal(f32.hier._table, int8.hier._table)
    assert f32.hier.model_rev == f32.model_rev


def test_engine_without_a_compatible_model_has_no_hier_path(live):
    eng = ScoringEngine(lambda b: np.zeros(b.max_graphs, np.float32),
                        serve_buckets(4))
    with pytest.raises(RuntimeError, match="megabatch-compatible"):
        eng.hier
    cfg = GGNNConfig(**SMALL, concat_all_absdf=False, layout="fused")
    flat = ScoringEngine.from_model(make_model(cfg, INPUT_DIM, device="cpu"),
                                    None, "graph",
                                    feat_keys=("_ABS_DATAFLOW",),
                                    device="cpu")
    with pytest.raises(RuntimeError, match="megabatch-compatible"):
        flat.score_unit([], None)
