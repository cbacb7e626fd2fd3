"""The port's exported artifacts against the JAX package's, on the CPU.

``deepdfa_tpu_torch.serving.export_ggnn`` writes a ``torch.export`` program
of the trained GGNN (``model.pt2`` + ``manifest.json``); ``load_exported``
scores with it and nothing of the model code. Here, at a narrow config (2
rounds, hidden 8 × 4 subkeys, ``data.batch`` of 8 graphs × 512 nodes ×
2,048 edges):

- the port's export + load against the JAX package's ``export_ggnn`` +
  ``load_exported`` on the same parameters (``bridge.flax_to_torch``), on
  a real batch at the exported shapes, within ``ATOL`` (the
  ``test_torch_serve.py`` limit: float32 sums in another order);
- the manifest's key set (plus ``torch_version``) and ``input_leaves``
  equal JAX's;
- the refusals: a missing feature key, a vocab mismatch (a warning), a
  JAX StableHLO directory;
- a node-label export against the JAX node export, and both
  ``from_artifact`` engines' host-side per-function max;
- the program: the registered ops ``deepdfa.fused_ggnn`` and
  ``deepdfa.segment_sum`` (``deepdfa.int8_matmul`` for an int8 model) and
  no ``index_add``; a fresh process that loads it through
  ``load_exported`` alone scores it equal;
- ``export_model`` and its CLI on a CPU ``fit`` run; ``from_artifact``
  (one bucket at the manifest's budgets) within ``FROM_CKPT_ATOL`` of
  ``from_checkpoint``; ``build_server(artifact=)`` and
  ``scan_command(artifact=)`` against the engine.
"""

import dataclasses
import http.client
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import load_config as jload_config  # noqa: E402
from deepdfa_tpu.data.graphs import BucketSpec as JBucketSpec  # noqa: E402
from deepdfa_tpu.data.graphs import GraphBatcher as JBatcher  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu.models import make_model as jmake_model  # noqa: E402
from deepdfa_tpu.serving import export_ggnn as jexport_ggnn  # noqa: E402
from deepdfa_tpu.serving import load_exported as jload_exported  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch import serving  # noqa: E402
from deepdfa_tpu_torch.config import ServeConfig, load_config  # noqa: E402
from deepdfa_tpu_torch.cpg.features import add_dependence_edges  # noqa: E402
from deepdfa_tpu_torch.cpg.frontend import parse_source  # noqa: E402
from deepdfa_tpu_torch.data.codegen import demo_corpus  # noqa: E402
from deepdfa_tpu_torch.data.materialize import CorpusBuilder  # noqa: E402
from deepdfa_tpu_torch.models.ggnn_int8 import (GGNNInt8,  # noqa: E402
                                                quantize_conv_params)
from deepdfa_tpu_torch.pipeline import encode_source  # noqa: E402
from deepdfa_tpu_torch.serve import ScoringEngine  # noqa: E402
from deepdfa_tpu_torch.serve.server import build_server  # noqa: E402
from deepdfa_tpu_torch.train import cli  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
NARROW = {"model.hidden_dim": 8, "model.n_steps": 2,
          "model.num_output_layers": 2, "data.batch.batch_graphs": 8,
          "data.batch.max_nodes": 512, "data.batch.max_edges": 2048}
# float32 sums of the two frameworks in another order
ATOL = 1e-5
# one model and weights at two padded shapes: the artifact's ceiling bucket
# against the checkpoint engine's ladder buckets
FROM_CKPT_ATOL = 1e-6


def _port_cfg(**extra):
    return load_config(overrides={**NARROW, **extra})


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """One parameter set exported by both packages: JAX's segment model
    (its ``export_model`` coerces to it) and the port's fused one through
    ``bridge.flax_to_torch``."""
    root = tmp_path_factory.mktemp("exports")
    jcfg = jload_config(overrides={**NARROW, "model.layout": "segment"})
    jmodel = jmake_model(jcfg.model, jcfg.input_dim)
    from deepdfa_tpu.serving import example_batch as jexample

    params = jmodel.init(jax.random.key(0), jax.tree.map(
        jnp.asarray, jexample(jcfg)))["params"]
    jout = jexport_ggnn(jcfg, params, root / "jax")
    cfg = _port_cfg()
    state = bridge.flax_to_torch(jax.tree.map(np.asarray, params),
                                 dataclasses.replace(cfg.model,
                                                     layout="fused"),
                                 cfg.input_dim)
    tout = serving.export_ggnn(cfg, state, root / "torch", device="cpu")
    b = cfg.data.batch
    batcher = JBatcher([JBucketSpec(b.batch_graphs + 1, b.max_nodes,
                                    b.max_edges)])
    batch = next(iter(batcher.batches(
        random_dataset(8, seed=3, input_dim=cfg.input_dim))))
    return {"jax": jout, "torch": tout, "state": state, "cfg": cfg,
            "batch": batch, "root": root}


def test_export_matches_the_jax_export_on_the_same_parameters(exports):
    batch = exports["batch"]
    want = jload_exported(exports["jax"])(batch)
    got = serving.load_exported(exports["torch"], device="cpu")(batch)
    mask = np.asarray(batch.graph_mask)
    assert got.shape == want.shape == mask.shape and mask.sum() > 1
    np.testing.assert_allclose(got[mask], want[mask], atol=ATOL)


def test_manifest_keys_and_input_leaves_equal_jax(exports):
    jman = json.loads((exports["jax"] / "manifest.json").read_text())
    tman = json.loads((exports["torch"] / "manifest.json").read_text())
    assert set(tman) == set(jman) | {"torch_version"}
    for key in ("input_leaves", "node_feat_keys", "label_style",
                "vocab_hash", "provenance"):
        assert tman[key] == jman[key], key
    assert tman["format"] == "torch.export"
    assert tman["platforms"] == ["cpu", "cuda"]
    assert tman["layout"] == "fused"
    assert tman["torch_version"] == torch.__version__
    # from_artifact's budgets, read exactly as the JAX engine reads them
    leaves = tman["input_leaves"]
    b = exports["cfg"].data.batch
    assert [leaves[-1]["shape"][0], leaves[-2]["shape"][0],
            leaves[-3]["shape"][0]] == [b.batch_graphs + 1, b.max_edges,
                                        b.max_nodes]


def test_servable_rejects_missing_feature_keys(exports):
    sv = serving.load_exported(exports["torch"], device="cpu")
    batch = exports["batch"]
    feats = dict(batch.node_feats)
    feats.pop("_ABS_DATAFLOW_api")
    with pytest.raises(ValueError, match="missing node_feats"):
        sv(batch._replace(node_feats=feats))
    unsorted = batch._replace(receivers=np.asarray(batch.receivers)[::-1])
    with pytest.raises(ValueError, match="not sorted by receiver"):
        sv(unsorted)


def test_vocab_hash_mismatch_warns(exports, tmp_path):
    out = serving.export_ggnn(exports["cfg"], exports["state"],
                              tmp_path / "hashed", device="cpu",
                              vocab_hash="aaaa000011112222")
    with pytest.warns(UserWarning, match="vocab hash mismatch"):
        serving.load_exported(out, expect_vocab_hash="bbbb444455556666",
                              device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        serving.load_exported(out, expect_vocab_hash="aaaa000011112222",
                              device="cpu")
        serving.load_exported(out, device="cpu")
        # a hashless artifact loads silently whatever the caller expects
        serving.load_exported(exports["torch"],
                              expect_vocab_hash="bbbb444455556666",
                              device="cpu")


def test_node_labels_raise_naming_a3(exports, tmp_path):
    """Node labels (ROADMAP A3) no longer raise: a node-label model exports
    per-node probabilities, equal to the JAX package's node export on the
    same parameters (the graph model's, less its pooling), and both
    ``from_artifact`` engines take the per-function max on the host."""
    from deepdfa_tpu.serve.engine import ScoringEngine as JEngine

    cfg = exports["cfg"]
    node = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, label_style="node"))
    state = {k: v for k, v in exports["state"].items()
             if not k.startswith("pooling.")}
    out = serving.export_ggnn(node, state, tmp_path / "n", device="cpu")
    man = json.loads((out / "manifest.json").read_text())
    assert man["label_style"] == "node"
    jcfg = jload_config(overrides={**NARROW, "model.layout": "segment",
                                   "model.label_style": "node"})
    jparams = jax.tree.map(jnp.asarray, bridge.torch_to_flax(
        state, node.model, cfg.input_dim))
    jout = jexport_ggnn(jcfg, jparams, tmp_path / "jn")
    batch = exports["batch"]
    got = serving.load_exported(out, device="cpu")(batch)
    want = np.asarray(jload_exported(jout)(batch))
    assert got.shape == want.shape == (batch.node_mask.shape[0],)
    mask = np.asarray(batch.node_mask)
    np.testing.assert_allclose(got[mask], want[mask], atol=ATOL, rtol=0)
    teng = ScoringEngine.from_artifact(out, device="cpu")
    jeng = JEngine.from_artifact(jout)
    assert teng.label_style == jeng.label_style == "node"
    fn_t, fn_j = teng._score_fn(batch), np.asarray(jeng._score_fn(batch))
    real = np.asarray(batch.graph_mask)
    np.testing.assert_allclose(fn_t[real], fn_j[real], atol=ATOL, rtol=0)
    gidx = np.asarray(batch.node_gidx)
    for gi in np.flatnonzero(real):
        assert fn_t[gi] == got[mask & (gidx == gi)].max()


def test_a_jax_stablehlo_dir_raises_naming_the_format(exports):
    with pytest.raises(ValueError, match="stablehlo"):
        serving.load_exported(exports["jax"], device="cpu")
    with pytest.raises(ValueError, match="stablehlo"):
        ScoringEngine.from_artifact(exports["jax"], device="cpu")


def test_the_program_holds_the_registered_ops(exports):
    ops = serving.exported_ops(
        serving.load_exported(exports["torch"], device="cpu").program)
    assert {"deepdfa.fused_ggnn.default",
            "deepdfa.segment_sum.default"} <= ops
    assert not any("index_add" in op for op in ops)
    # the int8 model: every conv product on deepdfa::int8_matmul
    cfg = exports["cfg"]
    model8 = GGNNInt8(cfg.model, cfg.input_dim)
    model8.load_state_dict(quantize_conv_params(exports["state"]))
    ex = serving.example_batch(cfg)
    ops8 = serving.exported_ops(serving.export_program(
        model8.eval(), ex, sorted(ex.node_feats)))
    assert {"deepdfa.int8_matmul.default",
            "deepdfa.segment_sum.default"} <= ops8
    assert "deepdfa.fused_ggnn.default" not in ops8
    assert not any("index_add" in op for op in ops8)


_FRESH = """
import importlib.abc, sys
import numpy as np
for name in ("jax", "jaxlib", "flax", "optax", "pandas"):
    sys.modules[name] = None

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "deepdfa_tpu" or name.startswith("deepdfa_tpu."):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
from deepdfa_tpu_torch.data.graphs import BatchedGraphs
from deepdfa_tpu_torch.serving import load_exported

z = np.load(sys.argv[2])
feats = {k[5:]: z[k] for k in z.files if k.startswith("feat:")}
batch = BatchedGraphs(feats, *(z[k] for k in ("senders", "receivers",
    "node_gidx", "node_mask", "edge_mask", "graph_mask")))
np.save(sys.argv[3], load_exported(sys.argv[1], device="cpu")(batch))
assert "deepdfa_tpu_torch.models" not in sys.modules
"""


def test_a_fresh_process_scores_through_load_exported_alone(exports,
                                                           tmp_path):
    """No model code: the fresh process imports the serving module and
    nothing of ``deepdfa_tpu_torch.models``."""
    batch = exports["batch"]
    np.savez(tmp_path / "batch.npz",
             **{f"feat:{k}": v for k, v in batch.node_feats.items()},
             **{f: getattr(batch, f) for f in serving.LEAF_FIELDS})
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH, str(exports["torch"]),
         str(tmp_path / "batch.npz"), str(tmp_path / "out.npy")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = serving.load_exported(exports["torch"], device="cpu")(batch)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)


# ---------------------------------------------------------------------------
# export_model, from_artifact, the server and scan on a CPU fit run

_FIT = {**NARROW, "model.layout": "fused", "data.sample": True,
        "data.undersample": None, "optim.max_epochs": 1}


@pytest.fixture(scope="module")
def fit_run(tmp_path_factory):
    """A CPU ``fit`` run at the narrow config, a shard dir holding the
    vocabularies of ``demo_corpus(6)``, and its sources."""
    from deepdfa_tpu_torch.config import FeatureConfig
    from deepdfa_tpu_torch.train.fit import fit

    root = tmp_path_factory.mktemp("fit_run")
    old = os.environ.get("DEEPDFA_STORAGE")
    os.environ["DEEPDFA_STORAGE"] = str(root / "storage")
    try:
        cfg = load_config(overrides=_FIT)
        fit(cfg, root / "run", device="cpu")
    finally:
        if old is None:
            os.environ.pop("DEEPDFA_STORAGE")
        else:
            os.environ["DEEPDFA_STORAGE"] = old
    rows = demo_corpus(6, seed=0)
    cpgs = {int(r["id"]): add_dependence_edges(parse_source(r["before"]))
            for r in rows}
    _, vocabs = CorpusBuilder(FeatureConfig()).build(
        cpgs, list(cpgs), graph_labels={int(r["id"]): int(r["vul"])
                                        for r in rows})
    shards = root / "shards"
    shards.mkdir()
    (shards / "vocab.json").write_text(
        json.dumps({k: v.to_dict() for k, v in vocabs.items()}))
    return cfg, root / "run", shards, vocabs, [r["before"] for r in rows]


@pytest.fixture(scope="module")
def artifact(fit_run):
    cfg, run, shards, _, _ = fit_run
    result = cli.main(["export", "--run-dir", str(run), "--shard-dir",
                       str(shards), "--device", "cpu",
                       *[f"--set={k}={json.dumps(v)}"
                         for k, v in _FIT.items()]])
    return result


def test_export_model_writes_the_artifact_with_provenance(fit_run, artifact):
    from deepdfa_tpu_torch.pipeline import vocab_content_hash

    cfg, run, _, vocabs, _ = fit_run
    out = Path(artifact["export_dir"])
    assert out == run / "export"
    assert artifact["pt2_bytes"] == (out / "model.pt2").stat().st_size > 0
    assert artifact["restored"] == "best"
    man = json.loads((out / "manifest.json").read_text())
    assert man["provenance"] == {k: artifact[k] for k in
                                 ("checkpoint_dir", "restored", "step")}
    assert man["vocab_hash"] == vocab_content_hash(vocabs)
    assert man["config"]["model"]["n_steps"] == cfg.model.n_steps


def test_export_model_requires_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="run fit first"):
        cli.export_model(_port_cfg(), tmp_path / "empty", device="cpu")
    # bench is the perf ledger's reporting path: it reads the artifacts it
    # is pointed at and, as the JAX CLI's, creates no run dir
    repo = Path(__file__).resolve().parent.parent
    assert cli.main(["bench", "--run-dir", str(tmp_path / "bench"),
                     "--ledger-dir", str(repo)]) == {
        "command": "bench", "subcommand": "ledger", "rc": 0}
    assert not (tmp_path / "bench").exists()


def _graphs(vocabs, sources):
    return [fn.graph for src in sources for fn in encode_source(src, vocabs)
            if fn.graph is not None]


def test_from_artifact_is_one_bucket_and_equals_from_checkpoint(fit_run,
                                                               artifact):
    cfg, run, _, vocabs, sources = fit_run
    eng = ScoringEngine.from_artifact(artifact["export_dir"], vocabs=vocabs,
                                      device="cpu")
    b = cfg.data.batch
    (bucket,) = eng.buckets
    assert (bucket.spec.max_graphs, bucket.spec.max_nodes,
            bucket.spec.max_edges) == (b.batch_graphs + 1, b.max_nodes,
                                       b.max_edges)
    assert bucket.graph_nodes == b.max_nodes - 1
    assert eng.label_style == "graph" and eng.mega_bucket is None
    ref = ScoringEngine.from_checkpoint(cfg, run / "checkpoints", vocabs,
                                        device="cpu")
    assert eng.vocab_hash == ref.vocab_hash
    graphs = _graphs(vocabs, sources)
    got = eng.score(graphs, bucket)
    want = np.concatenate([ref.score([g], ref.assign_bucket(g))
                           for g in graphs])
    np.testing.assert_allclose(got, want, atol=FROM_CKPT_ATOL)
    with pytest.raises(RuntimeError, match="score_unit"):
        eng.hier  # noqa: B018 — no hierarchical path from an artifact


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/score", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_build_server_serves_the_artifact(fit_run, artifact):
    cfg, _, shards, vocabs, sources = fit_run
    srv = build_server(dataclasses.replace(
        cfg, serve=ServeConfig(port=0, max_wait_ms=1.0)),
        artifact=artifact["export_dir"], shard_dir=shards, device="cpu")
    eng = ScoringEngine.from_artifact(artifact["export_dir"], vocabs=vocabs,
                                      device="cpu")
    try:
        report = srv.warmup()
        assert (report["hits"], report["misses"]) == (0, 1)
        srv.start()
        for src in sources[:3]:
            status, body = _post(srv.port, {"source": src})
            assert status == 200
            graphs = [fn.graph for fn in encode_source(src, vocabs)]
            want = eng.score([g for g in graphs if g is not None],
                             eng.buckets[0])
            got = [r["vulnerable_probability"] for r in body["results"]
                   if "vulnerable_probability" in r]
            assert got == [round(float(p), 6) for p in want]
    finally:
        srv.shutdown()


def test_scan_command_with_an_artifact_equals_the_checkpoint_engine(
        fit_run, artifact, tmp_path):
    from deepdfa_tpu_torch.scan import scan_command, scan_paths

    cfg, run, shards, vocabs, sources = fit_run
    tree = tmp_path / "tree"
    tree.mkdir()
    for i, src in enumerate(sources):
        (tree / f"f{i}.c").write_text(src)
    got = scan_command(cfg, tmp_path / "out", [str(tree)],
                       artifact=artifact["export_dir"], workers=1,
                       shard_dir=shards, device="cpu")
    ref = ScoringEngine.from_checkpoint(cfg, run / "checkpoints", vocabs,
                                        device="cpu")
    want = scan_paths([tree], vocabs, engine=ref, n_workers=1,
                      cache_dir=tmp_path / "cache")
    rows = lambda rep: [(r["file"].rsplit("/", 1)[-1], r["function"],
                         r.get("vulnerable_probability"))
                        for r in rep["results"]]
    assert len(got["results"]) == len(want["results"]) > 0
    for (fa, na, pa), (fb, nb, pb) in zip(rows(got), rows(want)):
        assert (fa, na) == (fb, nb)
        assert (pa is None) == (pb is None)
        if pa is not None:  # rows round to 6 places
            assert abs(pa - pb) <= FROM_CKPT_ATOL + 1e-6
    assert (tmp_path / "out" / "scan.json").exists()
