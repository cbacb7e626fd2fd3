"""``predict_paths`` of the port against the JAX package's, on the CPU.

The ``realworld`` fixtures, one file that does not parse and a directory
with no ``.c`` file go through both packages with the same vocabularies
(a ``demo_corpus`` build) and the same weights (a seeded Flax init carried
across by ``bridge.flax_to_torch``). The JAX side scores in the segment
layout; the port through the fused layout's plain version. Every statement
is ranked (``top_k`` 1,000), in the occlusion and the gate modes.

Tolerances: rows (file, function, error, keys, the number of ranked
statements) equal exactly; probabilities within 1e-5 and saliencies within
2e-5 absolute (both sides round to 6 decimals, and the products sum in
another order than XLA's: a saliency is a difference of two
probabilities); the ranked lines equal at every rank whose saliency is
more than 4e-5 from its neighbours' (closer ones may swap).

Also: the occlusion machinery (chunking, tail padding, index bookkeeping)
against a scorer whose probability is the sum of a graph's feature ids,
the scorer's call count, and the refusals of unsupported models.
"""

import dataclasses
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu import predict as jpredict  # noqa: E402
from deepdfa_tpu.config import ExperimentConfig as JExp  # noqa: E402
from deepdfa_tpu.config import FeatureConfig as JFeat  # noqa: E402
from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.cpg.features import add_dependence_edges  # noqa: E402
from deepdfa_tpu.cpg.frontend import parse_source  # noqa: E402
from deepdfa_tpu.data.codegen import demo_corpus  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.data.materialize import CorpusBuilder  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.pipeline import encode_source as jencode  # noqa: E402

from deepdfa_tpu_torch import bridge, predict  # noqa: E402
from deepdfa_tpu_torch.config import ExperimentConfig, GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.graphs import Graph  # noqa: E402
from deepdfa_tpu_torch.data.vocab import Vocabulary  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.pipeline import encode_source  # noqa: E402

FIXTURES = Path(__file__).parent / "fixtures" / "realworld"
SMALL = dict(hidden_dim=8, n_steps=2, num_output_layers=2)
INPUT_DIM = JFeat().input_dim
ALL = 1000
PROB_ATOL, SAL_ATOL, RANK_GAP = 1e-5, 2e-5, 4e-5


@pytest.fixture(scope="module")
def vocabs():
    rows = demo_corpus(40, seed=6).to_dict("records")
    cpgs = {int(r["id"]): add_dependence_edges(parse_source(r["before"]))
            for r in rows}
    _, jvocabs = CorpusBuilder(JFeat()).build(
        cpgs, list(cpgs), graph_labels={k: 0 for k in cpgs})
    return jvocabs, {k: Vocabulary.from_dict(v.to_dict())
                     for k, v in jvocabs.items()}


@pytest.fixture(scope="module")
def models(vocabs):
    jvocabs, _ = vocabs
    jmodel = JGGNN(cfg=JCfg(**SMALL, layout="segment"), input_dim=INPUT_DIM)
    g = jencode((FIXTURES / "ptr_walk.c").read_text(), jvocabs)[0].graph
    example = jax.tree.map(jnp.asarray, jbatch_np([g], 2, 64, 256))
    params = jmodel.init(jax.random.key(2), example)["params"]
    cfg = GGNNConfig(**SMALL, layout="fused")
    model = make_model(cfg, INPUT_DIM, device="cpu")
    model.load_state_dict(bridge.flax_to_torch(
        jax.tree.map(np.asarray, params), cfg, INPUT_DIM))
    return (JExp(model=JCfg(**SMALL, layout="segment")), jmodel, params,
            ExperimentConfig(model=cfg), model)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    tree = root / "tree"
    shutil.copytree(FIXTURES, tree, ignore=shutil.ignore_patterns("*.json"))
    (tree / "broken.c").write_text("int f( {{{ not C at all")
    empty = root / "cpponly"
    empty.mkdir()
    (empty / "x.cpp").write_text("class X {};")
    return [tree, empty]


def _rows(report):
    return [(Path(r["file"]).name, r.get("function"), r.get("error"),
             sorted(r), len(r.get("top_statements", ())))
            for r in report["results"]]


@pytest.mark.parametrize("saliency", ["occlusion", "gate"])
def test_predict_paths_equals_jax(vocabs, models, paths, saliency):
    jvocabs, tvocabs = vocabs
    jcfg, jmodel, params, cfg, model = models
    want = jpredict.predict_paths(paths, cfg=jcfg, model=jmodel,
                                  params=params, vocabs=jvocabs, top_k=ALL,
                                  saliency=saliency)
    scorer = predict.Scorer(model)
    got = predict.predict_paths(paths, cfg=cfg, model=model, vocabs=tvocabs,
                                top_k=ALL, saliency=saliency, scorer=scorer)
    assert sorted(got) == sorted(want) == ["n_errors", "n_scored", "results"]
    assert (got["n_scored"], got["n_errors"]) == (want["n_scored"],
                                                  want["n_errors"])
    assert _rows(got) == _rows(want)
    assert got["n_errors"] == 2 and got["n_scored"] >= 10
    n_nodes = 0
    for a, b in zip(got["results"], want["results"]):
        if "error" in a:
            continue
        assert a["saliency"] == b["saliency"] == saliency
        assert abs(a["vulnerable_probability"]
                   - b["vulnerable_probability"]) <= PROB_ATOL
        sa, sb = a["top_statements"], b["top_statements"]
        n_nodes += len(sa)
        w = np.array([s["weight"] for s in sb])
        np.testing.assert_allclose([s["weight"] for s in sa], w, rtol=0,
                                   atol=SAL_ATOL)
        gap = np.minimum(np.abs(np.diff(w, prepend=np.inf)),
                         np.abs(np.diff(w, append=-np.inf)))
        for k in np.flatnonzero(gap > RANK_GAP):
            assert (sa[k]["line"], sa[k]["code"]) == (sb[k]["line"],
                                                      sb[k]["code"])
    # one forward per function, plus one per 16 statements when occluding
    chunks = sum(-(-len(r["top_statements"]) // 16)
                 for r in got["results"] if "error" not in r)
    assert scorer.n_calls == got["n_scored"] + (
        chunks if saliency == "occlusion" else 0)
    assert n_nodes > 100


def test_default_top_k_ranks_five(vocabs, models, paths):
    _, tvocabs = vocabs
    _, _, _, cfg, model = models
    report = predict.predict_paths(paths[:1], cfg=cfg, model=model,
                                   vocabs=tvocabs)
    lengths = {len(r["top_statements"]) for r in report["results"]
               if "error" not in r}
    assert max(lengths) == 5


def test_occlusion_saliency_masking_math():
    """Against a scorer whose probability is the sum of a graph's
    ``_ABS_DATAFLOW`` ids: masking node i drops it by exactly feat[i]."""
    n = 21  # > chunk (16): exercises the padded tail chunk
    feats = np.arange(1, n + 1, dtype=np.int32)
    g = Graph(
        senders=np.arange(n - 1, dtype=np.int32),
        receivers=np.arange(1, n, dtype=np.int32),
        node_feats={"_VULN": np.zeros(n, np.int32),
                    "_ABS_DATAFLOW": feats.copy()},
    ).with_self_loops()
    calls = []

    def scorer(batch):
        calls.append(batch.max_graphs)
        vals = np.where(batch.node_mask,
                        batch.node_feats["_ABS_DATAFLOW"], 0).astype(np.float32)
        per_graph = np.zeros(batch.max_graphs, np.float32)
        np.add.at(per_graph, batch.node_gidx, vals)
        return per_graph, vals

    sal = predict.occlusion_saliency(scorer, g, n, chunk=16)
    np.testing.assert_allclose(sal, feats.astype(np.float32))
    assert calls == [2, 17, 17]  # the full forward, then two chunks
    assert np.array_equal(g.node_feats["_ABS_DATAFLOW"], feats)


def test_make_scorer_refuses_unsupported_models():
    model = make_model(GGNNConfig(**SMALL), INPUT_DIM, device="cpu")
    with pytest.raises(NotImplementedError, match="node-label"):
        predict.make_scorer(model, "node")
    with pytest.raises(ValueError, match="dataflow_solution_in"):
        predict.make_scorer(model, "dataflow_solution_in")
    enc = make_model(GGNNConfig(**SMALL, encoder_mode=True), INPUT_DIM,
                     device="cpu")
    with pytest.raises(ValueError, match="encoder_mode"):
        predict.make_scorer(enc, "graph")
    mega = make_model(GGNNConfig(**SMALL, layout="megabatch"), INPUT_DIM,
                      device="cpu")
    with pytest.raises(ValueError, match="megabatch"):
        predict.Scorer(mega)


def test_predict_refuses_bad_options(vocabs, models, paths):
    _, tvocabs = vocabs
    _, _, _, cfg, model = models
    scorer = predict.Scorer(model)
    code = (FIXTURES / "ptr_walk.c").read_text()
    with pytest.raises(ValueError, match="saliency"):
        predict.predict_source(code, scorer=scorer, vocabs=tvocabs,
                               saliency="attention")
    with pytest.raises(NotImplementedError, match="node-label"):
        predict.predict_source(code, scorer=scorer, vocabs=tvocabs,
                               label_style="node")
    other = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, feature=dataclasses.replace(cfg.data.feature,
                                              limit_all=50)))
    with pytest.raises(ValueError, match="input_dim"):
        predict.predict_paths(paths, cfg=other, model=model, vocabs=tvocabs)


def test_collect_sources(paths, tmp_path):
    tree, empty = paths
    assert predict.collect_sources([empty]) == []
    names = [Path(n).name for n, _ in predict.collect_sources([tree])]
    assert names == sorted(names) and "broken.c" in names
    odd = tmp_path / "unit.inc"
    odd.write_text("int f(void) { return 0; }")
    assert predict.collect_sources([odd]) == [(str(odd), odd.read_text())]
    with pytest.raises(FileNotFoundError):
        predict.collect_sources([tmp_path / "missing"])


def test_predict_source_rows_follow_the_encoder(vocabs, models):
    """One row per encoded function, in the encoder's order, each ranking
    statements of that function."""
    _, tvocabs = vocabs
    _, _, _, cfg, model = models
    code = (FIXTURES / "ptr_walk.c").read_text()
    rows = predict.predict_source(code, scorer=predict.Scorer(model),
                                  vocabs=tvocabs, top_k=ALL, name="x.c")
    enc = encode_source(code, tvocabs)
    assert [r["function"] for r in rows] == [e.name for e in enc]
    for r, e in zip(rows, enc):
        assert len(r["top_statements"]) == len(e.node_ids)
        assert {s["line"] for s in r["top_statements"]} <= {
            e.cpg.nodes[n].line for n in e.node_ids}
