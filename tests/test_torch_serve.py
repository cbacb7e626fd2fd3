"""The port's HTTP scoring service against the JAX package's, on the CPU.

Both packages' ``ScoreServer`` run side by side behind the same stub score
function (a real ``ScoringEngine`` of each package over it), with the same
vocabularies (the JAX front end's ``CorpusBuilder`` over ``demo_corpus(6)``,
carried across with ``Vocabulary.from_dict``), and take the same requests:
status codes and JSON bodies are equal key for key (``/healthz`` apart from
``model_rev`` and ``replica_id``, which name the process), and the
``/metrics`` families are equal (``JAX_ONLY_FAMILIES`` is empty: the port
renders admission control's and brownout's too).

Live engines: a JAX GGNN's parameters carried across by
``bridge.flax_to_torch`` (both servers score the demo sources within
``ATOL``), and a CPU ``fit`` run restored by ``from_checkpoint`` (fused
layout) against the segment layout on the same state dict within ``ATOL``.
Latency-mode ``submit`` equals ``score`` bitwise, and concurrent submits
each get their own batch's scores.

Synchronization waits on events, futures and ``server.wait()``; one test
raises a real SIGTERM and restores the handlers.
"""

import contextlib
import dataclasses
import http.client
import json
import signal
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import FeatureConfig as JFeatureConfig  # noqa: E402
from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.config import ServeConfig as JServeConfig  # noqa: E402
from deepdfa_tpu.config import load_config as jload_config  # noqa: E402
from deepdfa_tpu.config import to_json as jto_json  # noqa: E402
from deepdfa_tpu.cpg.features import add_dependence_edges  # noqa: E402
from deepdfa_tpu.cpg.frontend import parse_source  # noqa: E402
from deepdfa_tpu.data.codegen import demo_corpus  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.data.materialize import CorpusBuilder  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.pipeline import encode_source as jencode  # noqa: E402
from deepdfa_tpu.resilience import faults as jfaults  # noqa: E402
from deepdfa_tpu.serve import ScoreServer as JServer  # noqa: E402
from deepdfa_tpu.serve import ScoringEngine as JEngine  # noqa: E402
from deepdfa_tpu.serve import serve_buckets as jserve_buckets  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.config import ServeConfig, load_config  # noqa: E402
from deepdfa_tpu_torch.config import to_json  # noqa: E402
from deepdfa_tpu_torch.data.vocab import Vocabulary  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.resilience import faults  # noqa: E402
from deepdfa_tpu_torch.serve import (ScoringEngine, serve_buckets,  # noqa: E402
                                     ScanCache)
from deepdfa_tpu_torch.serve.server import (ScoreServer,  # noqa: E402
                                            build_server, main)

SMALL = dict(hidden_dim=8, n_steps=2, num_output_layers=2)
KEYS = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)
INPUT_DIM = JFeatureConfig().input_dim
ATOL = 1e-5
# families only the JAX package renders: none
JAX_ONLY_FAMILIES: set[str] = set()
# /healthz values that name the process or the framework's weights
PER_PROCESS = {"model_rev", "replica_id"}


@pytest.fixture(scope="module")
def demo():
    rows = demo_corpus(6, seed=0).to_dict("records")
    cpgs = {int(r["id"]): add_dependence_edges(parse_source(r["before"]))
            for r in rows}
    labels = {int(r["id"]): int(r["vul"]) for r in rows}
    _, jvocabs = CorpusBuilder(JFeatureConfig()).build(
        cpgs, list(cpgs), graph_labels=labels)
    tvocabs = {k: Vocabulary.from_dict(v.to_dict()) for k, v in jvocabs.items()}
    return jvocabs, tvocabs, [r["before"] for r in rows]


def _stub_fn(prob=0.25, fail_first=False, gate=None):
    """One stub score function for both packages: a constant probability,
    the real-graph count of every batch recorded, optionally a first call
    that raises, optionally blocking on ``gate`` (``(entered, release)``
    events)."""
    record, state = [], {"fail": fail_first}

    def score_fn(batch):
        if state["fail"]:
            state["fail"] = False
            raise RuntimeError("stub engine failure")
        if gate is not None:
            gate[0].set()
            assert gate[1].wait(timeout=60)
        record.append(int(np.sum(np.asarray(batch.graph_mask))))
        return np.full(batch.max_graphs, prob, np.float32)

    return score_fn, record


def _stub_engines(vocabs_pair, max_batch=4, **kw):
    jv, tv = vocabs_pair
    jfn, jrec = _stub_fn(**kw)
    tfn, trec = _stub_fn(**kw)
    jeng = JEngine(jfn, jserve_buckets(max_batch), feat_keys=tuple(jv))
    teng = ScoringEngine(tfn, serve_buckets(max_batch), feat_keys=tuple(tv))
    jeng.record, teng.record = jrec, trec
    return jeng, teng


@contextlib.contextmanager
def _servers(demo, engines=None, **cfg):
    """Both packages' servers on ephemeral ports with the same config."""
    jv, tv, _ = demo
    jeng, teng = engines or _stub_engines((jv, tv))
    jsrv = JServer(jeng, jv, JServeConfig(port=0, **cfg)).start()
    tsrv = ScoreServer(teng, tv, ServeConfig(port=0, **cfg)).start()
    try:
        yield jsrv, tsrv
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def _req(port, method, path, body=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _post(port, payload, timeout=30):
    body = payload if isinstance(payload, bytes) else json.dumps(payload)
    status, data = _req(port, "POST", "/score", body, timeout)
    return status, json.loads(data)


def _both(pair, method, path, payload=None):
    """The same request to both servers: ``(jax answer, port answer)``,
    each ``(status, parsed body)``."""
    out = []
    for srv in pair:
        if method == "POST":
            out.append(_post(srv.port, payload))
        else:
            status, data = _req(srv.port, method, path)
            out.append((status, json.loads(data)))
    return out


def _families(text: str) -> dict[str, str]:
    return {line.split()[2]: line.split()[3] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_scores_then_serves_from_cache(demo):
    _, _, sources = demo
    with _servers(demo, max_wait_ms=2.0) as (jsrv, tsrv):
        for payload in ({"source": sources[0]},
                        {"source": sources[0] + "   \n"},  # WS-only edit
                        {"source": sources[3]}):
            want, got = _both((jsrv, tsrv), "POST", "/score", payload)
            assert got == want
        assert got[1]["cached"] is False
        assert tsrv.cache.stats() == jsrv.cache.stats()
        assert tsrv.cache.stats()["hits"] == 1
        assert tsrv.engine.n_dispatches == jsrv.engine.n_dispatches == 2
        assert tsrv.engine.record == jsrv.engine.record


def test_rejects_bad_requests_and_stays_up(demo):
    _, _, sources = demo
    with _servers(demo, max_wait_ms=2.0) as (jsrv, tsrv):
        for payload in (b"{nope", {"source": ""}, {"nosource": 1},
                        {"source": "this is not C {{{"},
                        {"source": sources[0], "class": "bulk"},
                        {"source": sources[0], "class": "batch"}):
            want, got = _both((jsrv, tsrv), "POST", "/score", payload)
            assert got[0] == want[0] and got[1].keys() == want[1].keys()
            if got[0] != 422:  # a 422 carries the front end's message
                assert got == want
        assert [want[0] for want in
                (_req(jsrv.port, "GET", "/nope"), _req(tsrv.port, "GET",
                                                       "/nope"))] == [404, 404]
        want, got = _both((jsrv, tsrv), "GET", "/healthz")
        assert got[0] == want[0] == 200 and got[1]["status"] == "ok"


def test_unparseable_source_is_the_same_422(demo):
    with _servers(demo) as (jsrv, tsrv):
        want, got = _both((jsrv, tsrv), "POST", "/score",
                          {"source": "int f( {{{ not C at all"})
    assert got[0] == want[0] == 422
    assert got[1]["error"].split(":")[0] == want[1]["error"].split(":")[0]


def test_metrics_families_equal_jax(demo):
    _, _, sources = demo
    with _servers(demo, max_wait_ms=2.0) as (jsrv, tsrv):
        for _ in range(2):
            _both((jsrv, tsrv), "POST", "/score", {"source": sources[0]})
        _both((jsrv, tsrv), "POST", "/score", b"{nope")
        jsrv.warmup()
        tsrv.warmup()
        jtext = _req(jsrv.port, "GET", "/metrics")[1].decode()
        ttext = _req(tsrv.port, "GET", "/metrics")[1].decode()
    jfam, tfam = _families(jtext), _families(ttext)
    # (the admission counters render only once a decision was made)
    assert set(jfam) - set(tfam) == JAX_ONLY_FAMILIES == set()
    assert "deepdfa_serve_brownout_level" in set(jfam) & set(tfam)
    assert tfam == jfam
    # the counters of the same traffic are the same samples
    for line in ttext.splitlines():
        if line.startswith(("deepdfa_serve_requests_total",
                            "deepdfa_serve_responses_total",
                            "deepdfa_serve_errors_total",
                            "deepdfa_serve_cache_", "deepdfa_serve_batches",
                            "deepdfa_serve_batch_graphs_total",
                            "deepdfa_serve_warm_store_hits_total",
                            "deepdfa_serve_warm_store_misses_total",
                            "deepdfa_serve_warmup_compile_seconds{")):
            name = line.split()[0]
            assert any(j.split()[0] == name for j in jtext.splitlines()), line
            if "warmup" not in name:
                assert line in jtext.splitlines(), line
    assert "deepdfa_serve_cache_hits_total 1" in ttext


def test_drop_request_fault_is_the_same_503(demo):
    _, _, sources = demo
    with _servers(demo, max_wait_ms=2.0) as (jsrv, tsrv):
        with faults.installed("serve.drop_request@1"), \
                jfaults.installed("serve.drop_request@1"):
            want, got = _both((jsrv, tsrv), "POST", "/score",
                              {"source": sources[0]})
            assert got == want and got[0] == 503 and "drop" in got[1]["error"]
            want, got = _both((jsrv, tsrv), "GET", "/healthz")
            assert got[1]["status"] == want[1]["status"] == "ok"
            want, got = _both((jsrv, tsrv), "POST", "/score",
                              {"source": sources[0]})
            assert got == want and got[0] == 200
        assert tsrv.metrics.snapshot()["dropped_total"] == 1


def test_engine_fault_poisons_the_request_not_the_server(demo):
    _, _, sources = demo
    with _servers(demo, max_wait_ms=2.0) as (jsrv, tsrv):
        with faults.installed("serve.engine_raises@1"), \
                jfaults.installed("serve.engine_raises@1"):
            want, got = _both((jsrv, tsrv), "POST", "/score",
                              {"source": sources[1]})
            assert got[0] == want[0] == 500
            assert "serve.engine_raises" in got[1]["error"]
            want, got = _both((jsrv, tsrv), "POST", "/score",
                              {"source": sources[1]})
            assert got == want and got[0] == 200 and not got[1]["cached"]
        assert tsrv.cache.stats() == jsrv.cache.stats()
        assert tsrv.cache.stats()["encode_hits"] == 1  # the frontend ran once


def test_engine_warmup_leaves_an_armed_fault_for_the_first_request(demo):
    _, tv, _ = demo
    _, teng = _stub_engines((tv, tv))
    with faults.installed("serve.engine_raises@1"):
        report = teng.warmup()
        assert report["buckets"] == 3 and set(report["per_bucket"]) == {
            "126", "1022", "4094"}
        assert {r["source"] for r in report["per_bucket"].values()} == {
            "compile"}
        with pytest.raises(faults.InjectedFault):
            teng.score([_chain(5)], teng.buckets[0])
    assert len(teng.record) == 3 and teng.n_dispatches == 0


def test_draining_server_refuses_new_scores(demo):
    _, _, sources = demo
    with _servers(demo, max_wait_ms=1.0) as (jsrv, tsrv):
        want, got = _both((jsrv, tsrv), "GET", "/healthz")
        assert got[0] == want[0] == 200
        for srv in (jsrv, tsrv):
            srv._stop_requested.set()
        want, got = _both((jsrv, tsrv), "GET", "/healthz")
        assert got[0] == want[0] == 503
        assert got[1]["status"] == "draining" and got[1]["draining"] is True
        want, got = _both((jsrv, tsrv), "POST", "/score",
                          {"source": sources[0]})
        assert got == want and got[0] == 503
        for srv in (jsrv, tsrv):
            srv._draining.set()
        want, got = _both((jsrv, tsrv), "POST", "/score",
                          {"source": sources[0]})
        assert got == want and "draining" in got[1]["error"]


def test_healthz_equals_jax_but_for_the_process_identity(demo):
    with _servers(demo) as (jsrv, tsrv):
        want, got = _both((jsrv, tsrv), "GET", "/healthz")
        assert got[1].keys() == want[1].keys()
        assert got[1]["replica_id"] == f"127.0.0.1:{tsrv.port}"
        same = lambda h: {k: v for k, v in h.items() if k not in PER_PROCESS}
        assert same(got[1]) == same(want[1])
        assert got[1]["warm"] is False and got[1]["n_replicas"] == 1
        jsrv.warmup()
        tsrv.warmup()
        want, got = _both((jsrv, tsrv), "GET", "/healthz")
        assert same(got[1]) == same(want[1])
        assert got[1]["warm_buckets"] == [126, 1022, 4094]


def test_sigterm_drains_inflight_requests_before_exit(demo):
    """The one real SIGTERM of the port's tests: a request blocked inside
    the engine when the signal lands is answered 200, then the listener is
    closed."""
    _, tv, sources = demo
    entered, release = threading.Event(), threading.Event()
    _, teng = _stub_engines((tv, tv), gate=(entered, release))
    srv = ScoreServer(teng, tv, ServeConfig(port=0, max_wait_ms=1.0,
                                            drain_timeout_s=30.0)).start()
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        srv.install_signal_handlers()
        got = {}
        client = threading.Thread(
            target=lambda: got.setdefault("resp",
                                          _post(srv.port,
                                                {"source": sources[0]})),
            daemon=True)
        client.start()
        assert entered.wait(timeout=60)  # the batch is inside the engine
        signal.raise_signal(signal.SIGTERM)
        assert srv.draining
        release.set()
        snap = srv.wait()
        client.join(timeout=60)
        status, body = got["resp"]
        assert status == 200
        assert body["results"][0]["vulnerable_probability"] == 0.25
        assert snap["responses_total"] == {200: 1}
        with pytest.raises(OSError):
            _req(srv.port, "GET", "/healthz", timeout=2)
    finally:
        release.set()
        for s, h in prev.items():
            signal.signal(s, h)


# ---------------------------------------------------------------------------
# live engines


def _chain(n, keys=KEYS):
    from deepdfa_tpu_torch.data.graphs import Graph

    feats = {k: np.zeros(n, np.int32) for k in keys}
    return Graph(senders=np.arange(n - 1, dtype=np.int32),
                 receivers=np.arange(1, n, dtype=np.int32),
                 node_feats=feats).with_self_loops()


@pytest.fixture(scope="module")
def live(demo):
    """A JAX GGNN (segment layout) and the port's fused model on the same
    parameters (``bridge.flax_to_torch``), as engines of each package."""
    jv, _, sources = demo
    jmodel = JGGNN(cfg=JCfg(**SMALL, layout="segment"), input_dim=INPUT_DIM)
    g = jencode(sources[0], jv)[0].graph
    example = jax.tree.map(jnp.asarray, jbatch_np([g], 2, 64, 256))
    params = jmodel.init(jax.random.key(3), example)["params"]
    state = bridge.flax_to_torch(jax.tree.map(np.asarray, params),
                                 GGNNConfig(**SMALL, layout="fused"),
                                 INPUT_DIM)
    return jmodel, params, state


def _torch_engine(state, layout="fused", **kw):
    cfg = GGNNConfig(**SMALL, layout=layout)
    return ScoringEngine.from_model(make_model(cfg, INPUT_DIM, device="cpu"),
                                    state, "graph", feat_keys=KEYS,
                                    max_batch=4, device="cpu", **kw)


def test_live_servers_score_the_demo_sources_alike(demo, live):
    _, _, sources = demo
    jmodel, params, state = live
    jeng = JEngine.from_model(jmodel, params, "graph", feat_keys=KEYS,
                              max_batch=4)
    with _servers(demo, engines=(jeng, _torch_engine(state)),
                  max_wait_ms=2.0) as (jsrv, tsrv):
        for src in sources + ["\n".join(sources[:3])]:
            want, got = _both((jsrv, tsrv), "POST", "/score", {"source": src})
            assert got[0] == want[0] == 200
            assert [r["function"] for r in got[1]["results"]] == [
                r["function"] for r in want[1]["results"]]
            for a, b in zip(got[1]["results"], want[1]["results"]):
                assert a.keys() == b.keys()
                assert a["vulnerable_probability"] == pytest.approx(
                    b["vulnerable_probability"], abs=ATOL)


def test_latency_mode_submit_equals_score_and_never_mixes(live):
    _, _, state = live
    eng = _torch_engine(state, latency_mode=True)
    assert eng.latency_mode
    bucket = eng.buckets[0]
    inputs = [[_chain(5 + i)] for i in range(6)]
    eng.latency_mode = False
    want = [eng.score(gs, bucket) for gs in inputs]
    eng.latency_mode = True
    for gs, w in zip(inputs, want):
        np.testing.assert_array_equal(eng.score(gs, bucket), w)
        np.testing.assert_array_equal(eng.submit(gs, bucket).result(), w)
    assert len(set(float(w[0]) for w in want)) == len(want)  # distinct

    errors, barrier = [], threading.Barrier(len(inputs))

    def worker(idx):
        try:
            barrier.wait(timeout=30)
            pending = [eng.submit(inputs[idx], bucket) for _ in range(4)]
            for p in pending:
                np.testing.assert_array_equal(p.result(), want[idx])
        except Exception as exc:  # noqa: BLE001
            errors.append((idx, exc))

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert eng.n_dispatches == 3 * len(inputs) + 4 * len(inputs)


_FIT = {"model.hidden_dim": 8, "model.n_steps": 3,
        "model.num_output_layers": 2, "model.layout": "fused",
        "data.sample": True, "data.undersample": None,
        "data.batch.batch_graphs": 32, "data.batch.max_nodes": 160,
        "data.batch.max_edges": 320, "optim.max_epochs": 1}


@pytest.fixture(scope="module")
def fit_run(demo, tmp_path_factory):
    """A CPU ``fit`` run (fused layout) and a shard dir holding the demo
    vocabularies."""
    import os

    from deepdfa_tpu_torch.train.fit import fit

    _, tv, _ = demo
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
    shards = root / "shards"
    shards.mkdir()
    (shards / "vocab.json").write_text(
        json.dumps({k: v.to_dict() for k, v in tv.items()}))
    return cfg, root / "run", shards


def test_from_checkpoint_serves_the_fit_run_on_the_fused_layout(demo,
                                                                fit_run):
    from deepdfa_tpu_torch.pipeline import encode_source
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager

    _, tv, sources = demo
    cfg, run, shards = fit_run
    eng = ScoringEngine.from_checkpoint(cfg, run / "checkpoints", tv,
                                        device="cpu")
    ckpts = CheckpointManager(run / "checkpoints", cfg.checkpoint)
    state = ckpts.restore(ckpts.best_step())
    seg_cfg = dataclasses.replace(cfg.model, layout="segment")
    seg = make_model(seg_cfg, cfg.input_dim, device="cpu")
    fused = make_model(dataclasses.replace(cfg.model, layout="fused"),
                       cfg.input_dim, device="cpu")
    # the layouts share one parameter set: the names map one to one
    assert seg.state_dict().keys() == fused.state_dict().keys() == \
        state.keys()
    ref = ScoringEngine.from_model(seg, state, "graph", feat_keys=tuple(tv),
                                   max_batch=4, device="cpu")
    graphs = [fn.graph for src in sources for fn in encode_source(src, tv)
              if fn.graph is not None]
    bucket = eng.buckets[0]
    np.testing.assert_allclose(eng.score(graphs[:4], bucket),
                               ref.score(graphs[:4], bucket), atol=ATOL)
    assert eng.model_rev == ref.model_rev
    assert eng.vocab_hash is not None and eng.label_style == "graph"

    # the same run behind HTTP, built the way the entry point builds it
    srv = build_server(dataclasses.replace(
        cfg, serve=ServeConfig(port=0, max_wait_ms=1.0)), run_dir=run,
        shard_dir=shards, device="cpu")
    try:
        srv.warmup()
        srv.start()
        status, body = _post(srv.port, {"source": sources[0]})
        assert status == 200
        want = eng.score([encode_source(sources[0], tv)[0].graph], bucket)
        assert body["results"][0]["vulnerable_probability"] == round(
            float(want[0]), 6)
    finally:
        srv.shutdown()


def test_a_server_without_a_gpu_raises_and_artifacts_wait(fit_run):
    """Without a GPU the default device raises, for a checkpoint and for an
    exported artifact alike; the artifact serves on an explicit CPU."""
    from deepdfa_tpu_torch.train.cli import export_model

    cfg, run, shards = fit_run
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(cfg, run_dir=run, shard_dir=shards)
    artifact = export_model(cfg, run, shard_dir=shards,
                            device="cpu")["export_dir"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--run-dir", str(run), "--shard-dir", str(shards),
              "--artifact", artifact])
    srv = build_server(cfg, artifact=artifact, shard_dir=shards,
                       device="cpu").start()
    try:
        (bucket,) = srv.engine.buckets
        assert bucket.spec.max_nodes == cfg.data.batch.max_nodes
    finally:
        srv.shutdown()
    with pytest.raises(ValueError, match="run-dir"):
        build_server(cfg, shard_dir=shards, device="cpu")


# ---------------------------------------------------------------------------
# configuration


def test_every_serve_key_of_the_jax_config_parses(tmp_path):
    """The JAX package's whole ``serve`` block, written by its ``to_json``,
    loads into the port's config and writes back the same JSON."""
    serve = json.loads(jto_json(jload_config()))["serve"]
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"serve": serve}))
    assert json.loads(to_json(load_config(path)))["serve"] == serve
    over = {"serve.max_batch": 4, "serve.max_wait_ms": 2.5,
            "serve.cache_entries": 0, "serve.cascade.enabled": True,
            "serve.cascade.band_lo": 0.3, "serve.frontend.mode": "process",
            "serve.frontend.workers": 3, "serve.obs.trace": False,
            "serve.obs.drift_window": 64, "serve.latency_mode": True,
            "serve.precision": "int8", "serve.mesh_replicas": 1}
    assert json.loads(to_json(load_config(overrides=over)))["serve"] == \
        json.loads(jto_json(jload_config(overrides=over)))["serve"]


@pytest.mark.parametrize("overrides,error,match", [
    ({"serve.max_batch": 0}, ValueError, "max_batch"),
    ({"serve.max_queue": 0}, ValueError, "max_queue"),
    ({"serve.cascade.band_lo": 0.9, "serve.cascade.band_hi": 0.1},
     ValueError, "band_lo < band_hi"),
    ({"serve.frontend.mode": "fork"}, ValueError, "mode"),
    ({"serve.obs.drift_bins": 1}, ValueError, "drift_bins"),
    ({"serve.warm_store_dir": "/x"}, None, None),  # parses (the warm store)
    ({"serve.mesh_replicas": 2}, None, None),  # parses (replication)
    ({"serve.admission.enabled": True}, None, None),  # parses (admission)
    ({"serve.continual.capture_path": "c.jsonl"}, None, None),  # capture
    ({"serve.continual.shadow_bins": 1}, ValueError, "shadow_bins"),
    ({"serve.federation.cells": ["a:1"]}, None, None),  # parses
    ({"serve.autoscale.max_replicas": 8}, None, None),  # parses
    ({"serve.admission.max_level": 4}, ValueError, "max_level"),
    ({"serve.federation.vnodes": 0}, ValueError, "vnodes"),
    ({"serve.autoscale.min_replicas": 5}, ValueError, "min_replicas"),
    ({"serve.obs.train_port": 0}, None, None),  # parses (trainer telemetry)
])
def test_serve_config_validation_and_deferred_parts(overrides, error, match):
    if error is None:
        parsed = json.loads(to_json(load_config(overrides=overrides)))
        for key, value in overrides.items():
            node = parsed
            for part in key.split("."):
                node = node[part]
            assert node == value
        return
    with pytest.raises(error, match=match):
        load_config(overrides=overrides)


def test_scan_cache_equals_jax():
    from deepdfa_tpu.serve import ScanCache as JScanCache

    ops = [("lookup", "k"), ("store", "k", "enc"), ("lookup", "k"),
           ("store", "k", None, [1]), ("lookup", "k"), ("store", "a", None, [2]),
           ("store", "b", None, [3]), ("lookup", "a"), ("store", "c", None, [4]),
           ("lookup", "k"), ("lookup", "b")]
    stats = []
    for cache in (ScanCache(capacity=3), JScanCache(capacity=3)):
        seen = []
        for op in ops:
            if op[0] == "lookup":
                e = cache.lookup(op[1])
                seen.append(None if e is None else (e.encoded, e.results))
            else:
                cache.store(op[1], encoded=op[2],
                            results=op[3] if len(op) > 3 else None)
        stats.append((seen, cache.stats(), len(cache)))
    assert stats[0] == stats[1]
    off = ScanCache(capacity=0)
    off.store("k", results=[1])
    assert off.lookup("k") is None and len(off) == 0
