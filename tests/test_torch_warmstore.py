"""The port's warm store of exported bucket programs, on the CPU.

``deepdfa_tpu_torch.serve.warmstore`` is a copy of the JAX package's store
with ``.pt2`` payloads: the same commit protocol (the meta ``.json`` last),
the same ``bucket_artifact_key``. ``ScoringEngine.warmup(warm_store=)``
exports each bucket's program on a miss and loads it on a hit. Here, on a
narrow fused GGNN (2 rounds, hidden 8 × 4 subkeys) and its int8 engine:

- the store's protocol: round trip, keys, stats, a payload without meta;
- ``bucket_artifact_key`` equal to JAX's for the same inputs;
- a join: the first engine misses 3 and commits 3 entries, a second with
  the same weights hits 3 and scores bitwise equal (the same ops on the
  same inputs), journaled as ``warmup``; ``compile_seconds_saved >= 0``
  (eager torch has no compile to skip: the saving may be 0);
- other weights miss; an int8 join's programs hold ``deepdfa.int8_matmul``;
- a store filled by the JAX engine gives the port 0 hits;
- a server with ``serve.warm_store_dir`` reports the hits in its
  ``serving`` line and the ``warm_store_*`` families on ``/metrics``.
"""

import dataclasses
import http.client
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.serve import ScoringEngine as JEngine  # noqa: E402
from deepdfa_tpu.serve import WarmStore as JWarmStore  # noqa: E402
from deepdfa_tpu.serve import bucket_artifact_key as jkey  # noqa: E402

from deepdfa_tpu_torch import bridge, serving  # noqa: E402
from deepdfa_tpu_torch.config import (ALL_SUBKEYS, GGNNConfig,  # noqa: E402
                                      ServeConfig, load_config)
from deepdfa_tpu_torch.data.graphs import Graph  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.resilience.journal import RunJournal  # noqa: E402
from deepdfa_tpu_torch.serve import (ScoringEngine, WarmStore,  # noqa: E402
                                     bucket_artifact_key)

SMALL = dict(hidden_dim=8, n_steps=2, num_output_layers=2)
KEYS = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)
INPUT_DIM = 40


def _graph(n, seed):
    rng = np.random.default_rng(seed)
    feats = {k: rng.integers(0, INPUT_DIM, n).astype(np.int32) for k in KEYS}
    return Graph(senders=rng.integers(0, n, 2 * n).astype(np.int32),
                 receivers=rng.integers(0, n, 2 * n).astype(np.int32),
                 node_feats=feats).with_self_loops()


@pytest.fixture(scope="module")
def state():
    model = make_model(GGNNConfig(**SMALL, layout="fused"), INPUT_DIM,
                       device="cpu", seed=3)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _engine(state, **kw):
    model = make_model(GGNNConfig(**SMALL, layout="fused"), INPUT_DIM,
                       device="cpu")
    return ScoringEngine.from_model(model, state, "graph", feat_keys=KEYS,
                                    max_batch=4, device="cpu",
                                    vocab_hash="vh", **kw)


def _score_all(eng, graphs):
    out = []
    for g in graphs:
        out.append(eng.score([g], eng.assign_bucket(g)))
    return np.concatenate(out)


# one graph per size class of the ladder (126, 1022, 4094 nodes)
GRAPHS = [_graph(n, seed) for seed, n in enumerate((12, 60, 300, 900, 2000))]


def test_warm_store_roundtrip_keys_and_stats(tmp_path):
    ws = WarmStore(tmp_path / "store")
    assert ws.get("nope") is None and ws.keys() == []
    ws.put("k1", b"program-bytes", {"compile_seconds": 1.25})
    e = ws.get("k1")
    assert e.payload == b"program-bytes"
    assert e.meta["compile_seconds"] == 1.25
    assert ws.keys() == ["k1"]
    assert ws.stats() == {"entries": 1, "bytes": len(b"program-bytes")}
    assert (ws.root / "k1.pt2").exists()


def test_a_payload_without_meta_is_absent(tmp_path):
    ws = WarmStore(tmp_path / "store")
    (ws.root / "torn.pt2").write_bytes(b"half-written")
    assert ws.get("torn") is None and ws.keys() == []
    (ws.root / "bad.pt2").write_bytes(b"x")
    (ws.root / "bad.json").write_text("{not json")
    assert ws.get("bad") is None and ws.keys() == []
    (ws.root / "list.pt2").write_bytes(b"x")
    (ws.root / "list.json").write_text("[1, 2]")
    assert ws.get("list") is None and ws.keys() == []


@pytest.mark.parametrize("inputs", [
    ("vh", "mr", "f32", "graph", ("_ABS_DATAFLOW",), 5, 128, 512),
    (None, None, "int8", "graph", KEYS, 17, 2048, 8192),
    ("a" * 16, "b" * 16, "f32", "node", KEYS[:2], 257, 40960, 81920),
])
def test_bucket_artifact_key_equals_jax(inputs):
    assert bucket_artifact_key(*inputs) == jkey(*inputs)


def test_a_join_loads_every_bucket_and_scores_bitwise_equal(state, tmp_path):
    ws = WarmStore(tmp_path / "store")
    ja, jb = RunJournal(tmp_path / "a.json"), RunJournal(tmp_path / "b.json")
    eng_a = _engine(state)
    rep_a = eng_a.warmup(warm_store=ws, journal=ja)
    assert (rep_a["hits"], rep_a["misses"]) == (0, 3)
    assert len(ws.keys()) == 3 and ja.read()["event"] == "warmup"
    for b in eng_a.buckets:
        row = rep_a["per_bucket"][str(b.graph_nodes)]
        assert row["key"] == eng_a.bucket_key(b) and row["source"] == "compile"
        assert row["export_seconds"] > 0 and "export_error" not in row
        meta = ws.get(row["key"]).meta
        assert meta["model_rev"] == eng_a.model_rev
        assert meta["spec"] == [b.spec.max_graphs, b.spec.max_nodes,
                                b.spec.max_edges]
    want = _score_all(eng_a, GRAPHS)

    eng_b = _engine(state)
    assert eng_b.model_rev == eng_a.model_rev
    rep_b = eng_b.warmup(warm_store=ws, journal=jb)
    assert (rep_b["hits"], rep_b["misses"]) == (3, 0)
    rec = jb.read()
    assert rec["event"] == "warmup" and rec["hits"] == 3
    assert rec["compile_seconds_saved"] >= 0
    for row in rep_b["per_bucket"].values():
        assert row["source"] == "store" and row["warm_seconds"] > 0
        assert row["compile_seconds_saved"] >= 0
    got = _score_all(eng_b, GRAPHS)
    np.testing.assert_array_equal(got, want)
    # the joiner's dispatches ran the loaded programs
    assert set(eng_b._bucket_fns) == set(eng_b.buckets)


def test_keys_change_with_the_model_revision(state, tmp_path):
    ws = WarmStore(tmp_path / "store")
    eng_a = _engine(state)
    eng_a.warmup(warm_store=ws)
    bumped = {k: v + 0.01 if v.is_floating_point() else v
              for k, v in state.items()}
    eng_c = _engine(bumped)
    assert eng_c.model_rev != eng_a.model_rev
    rep = eng_c.warmup(warm_store=ws)
    assert (rep["hits"], rep["misses"]) == (0, 3)
    assert len(ws.keys()) == 6  # both revisions side by side


def test_no_store_in_latency_mode_and_mega_never_exports(state, tmp_path):
    ws = WarmStore(tmp_path / "store")
    rep = _engine(state, latency_mode=True).warmup(warm_store=ws)
    assert (rep["hits"], rep["misses"]) == (0, 3) and ws.keys() == []
    rep = _engine(state, megabatch=True).warmup(warm_store=ws)
    assert rep["per_bucket"]["mega"] == {
        "key": None, "source": "compile",
        "compile_seconds": rep["per_bucket"]["mega"]["compile_seconds"]}
    assert len(ws.keys()) == 3


def test_an_int8_join_runs_the_int8_programs(state, tmp_path):
    ws = WarmStore(tmp_path / "store")
    eng_a = _engine(state, precision="int8")
    assert eng_a.precision == "int8"
    eng_a.warmup(warm_store=ws)
    for key in ws.keys():
        program, _ = serving.load_program(ws.get(key).payload, "cpu")
        ops = serving.exported_ops(program)
        assert "deepdfa.int8_matmul.default" in ops
        assert "deepdfa.fused_ggnn.default" not in ops
        assert not any("index_add" in op for op in ops)
    want = _score_all(eng_a, GRAPHS)
    eng_b = _engine(state, precision="int8")
    rep = eng_b.warmup(warm_store=ws)
    assert (rep["hits"], rep["misses"]) == (3, 0)
    np.testing.assert_array_equal(_score_all(eng_b, GRAPHS), want)
    # the float32 engine's keys differ (precision is in the key)
    assert _engine(state).warmup(warm_store=ws)["hits"] == 0


def test_a_store_filled_by_the_jax_engine_gives_no_hit(tmp_path):
    jmodel = JGGNN(cfg=JCfg(**SMALL, layout="segment"), input_dim=INPUT_DIM)
    example = jax.tree.map(jnp.asarray, jbatch_np([_graph(6, 0)], 2, 16, 64))
    params = jmodel.init(jax.random.key(0), example)["params"]
    jeng = JEngine.from_model(jmodel, params, "graph", feat_keys=KEYS,
                              max_batch=4, vocab_hash="vh")
    store_dir = tmp_path / "store"
    jrep = jeng.warmup(warm_store=JWarmStore(store_dir))
    assert jrep["misses"] == 3 and len(list(store_dir.glob("*.stablehlo"))) == 3
    state = bridge.flax_to_torch(jax.tree.map(np.asarray, params),
                                 GGNNConfig(**SMALL, layout="fused"),
                                 INPUT_DIM)
    ws = WarmStore(store_dir)
    rep = _engine(state).warmup(warm_store=ws)
    assert (rep["hits"], rep["misses"]) == (0, 3)
    assert len(list(store_dir.glob("*.pt2"))) == 3


def test_a_server_warms_through_serve_warm_store_dir(tmp_path):
    """``serve.warm_store_dir`` through ``build_server`` on a CPU fit run:
    the second replica's ``serving`` line reports 3 hits, and ``/metrics``
    carries the ``warm_store_*`` families."""
    from deepdfa_tpu_torch.config import FeatureConfig
    from deepdfa_tpu_torch.cpg.features import add_dependence_edges
    from deepdfa_tpu_torch.cpg.frontend import parse_source
    from deepdfa_tpu_torch.data.codegen import demo_corpus
    from deepdfa_tpu_torch.data.materialize import CorpusBuilder
    from deepdfa_tpu_torch.serve.server import build_server
    from deepdfa_tpu_torch.train.fit import fit

    os.environ["DEEPDFA_STORAGE"] = str(tmp_path / "storage")
    try:
        cfg = load_config(overrides={
            "model.hidden_dim": 8, "model.n_steps": 2,
            "model.num_output_layers": 2, "model.layout": "fused",
            "data.sample": True, "data.undersample": None,
            "data.batch.batch_graphs": 8, "data.batch.max_nodes": 512,
            "data.batch.max_edges": 2048, "optim.max_epochs": 1})
        fit(cfg, tmp_path / "run", device="cpu")
    finally:
        os.environ.pop("DEEPDFA_STORAGE")
    rows = demo_corpus(3, seed=0)
    cpgs = {int(r["id"]): add_dependence_edges(parse_source(r["before"]))
            for r in rows}
    _, vocabs = CorpusBuilder(FeatureConfig()).build(
        cpgs, list(cpgs), graph_labels={i: 0 for i in cpgs})
    shards = tmp_path / "shards"
    shards.mkdir()
    (shards / "vocab.json").write_text(
        json.dumps({k: v.to_dict() for k, v in vocabs.items()}))
    cfg = dataclasses.replace(cfg, serve=ServeConfig(
        port=0, warm_store_dir=str(tmp_path / "store")))
    reports = []
    for _ in range(2):
        srv = build_server(cfg, run_dir=tmp_path / "run", shard_dir=shards,
                           device="cpu")
        try:
            reports.append(srv.warmup())
            srv.start()
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=30)
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
            conn.close()
        finally:
            srv.shutdown()
    assert [(r["hits"], r["misses"]) for r in reports] == [(0, 3), (3, 0)]
    assert "deepdfa_serve_warm_store_hits_total 3" in text
    assert "deepdfa_serve_warm_store_misses_total 0" in text
    assert "deepdfa_serve_warm_store_compile_seconds_saved" in text
    assert 'source="store"' in text
