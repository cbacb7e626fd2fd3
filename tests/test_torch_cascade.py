"""The port's two-tier cascade against the JAX package's, on the CPU: band
routing, the tier-2 queue, the degradation contract (tier-2 failure never
fails a request tier 1 answered), both fault points, the metrics and SLO
families, the spans, scan's tier attribution and ``scan_command``'s
argument checks.

Tier 1 is a real ``ScoringEngine`` of each package over one stub score
function; tier 2 is a recording stub with the ``JointEngine`` duck type
(``score(items)`` + ``model_rev``), the same for both packages, and in the
last test the real ``JointEngine`` of each package over ``tiny_llama``
with the JAX tree carried across by ``bridge.llama_flax_to_torch`` and
``bridge.fusion_flax_to_torch``: the tier-2 probabilities of both servers
agree within ``ATOL`` (float32 sums in other orders; both round to 6
places). Bodies are otherwise equal key for key.

Waits are on events and futures: a tier 2 that must be slow blocks on an
event the test releases.
"""

import contextlib
import dataclasses
import http.client
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

import jax  # noqa: E402
from flax import linen as nn  # noqa: E402

from deepdfa_tpu.config import CascadeConfig as JCascadeConfig  # noqa: E402
from deepdfa_tpu.config import FeatureConfig as JFeatureConfig  # noqa: E402
from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.config import ServeConfig as JServeConfig  # noqa: E402
from deepdfa_tpu.cpg.features import add_dependence_edges  # noqa: E402
from deepdfa_tpu.cpg.frontend import parse_source  # noqa: E402
from deepdfa_tpu.data.codegen import demo_corpus  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.data.materialize import CorpusBuilder  # noqa: E402
from deepdfa_tpu.llm import dataset as jds  # noqa: E402
from deepdfa_tpu.llm import fusion as jfusion  # noqa: E402
from deepdfa_tpu.llm import joint as jjoint  # noqa: E402
from deepdfa_tpu.llm import llama as jl  # noqa: E402
from deepdfa_tpu.llm.joint_engine import JointEngine as JJoint  # noqa: E402
from deepdfa_tpu.resilience import faults as jfaults  # noqa: E402
from deepdfa_tpu.scan import scan_paths as jscan  # noqa: E402
from deepdfa_tpu.serve import ScoreServer as JServer  # noqa: E402
from deepdfa_tpu.serve import ScoringEngine as JEngine  # noqa: E402
from deepdfa_tpu.serve import serve_buckets as jserve_buckets  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import (CascadeConfig, GGNNConfig,  # noqa: E402
                                      ServeConfig, load_config, to_json)
from deepdfa_tpu_torch.data.vocab import Vocabulary  # noqa: E402
from deepdfa_tpu_torch.llm import dataset as tds  # noqa: E402
from deepdfa_tpu_torch.llm import fusion as tfusion  # noqa: E402
from deepdfa_tpu_torch.llm import joint as tjoint  # noqa: E402
from deepdfa_tpu_torch.llm import llama as tl  # noqa: E402
from deepdfa_tpu_torch.llm.joint_engine import JointEngine  # noqa: E402
from deepdfa_tpu_torch.resilience import faults  # noqa: E402
from deepdfa_tpu_torch.scan import scan_command, scan_paths  # noqa: E402
from deepdfa_tpu_torch.serve import (ScoringEngine,  # noqa: E402
                                     serve_buckets)
from deepdfa_tpu_torch.serve.cascade import (CascadeRouter,  # noqa: E402
                                             Tier2Batcher, Tier2QueueFull)
from deepdfa_tpu_torch.serve.server import ScoreServer  # noqa: E402

INPUT_DIM = JFeatureConfig().input_dim
BLOCK = 64
ATOL = 1e-5


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


class _StubTier2:
    """The ``JointEngine`` duck type: ``score(items)`` over (text, graph)
    pairs. With ``gate`` (``(entered, release)`` events) a call signals
    that it started and blocks until the test releases it."""

    def __init__(self, prob=0.9, fail=False, gate=None):
        self.prob = prob
        self.fail = fail
        self.gate = gate
        self.model_rev = "t2-stub"
        self.calls: list[list[str]] = []
        self._lock = threading.Lock()

    def score(self, items):
        if self.fail:
            raise RuntimeError("tier-2 stub failure")
        if self.gate is not None:
            self.gate[0].set()
            assert self.gate[1].wait(timeout=60)
        with self._lock:
            self.calls.append([text for text, _ in items])
        return np.full(len(items), self.prob, np.float64)


def _tier1(pkg, vocabs, prob):
    fn = lambda batch: np.full(batch.max_graphs, prob, np.float32)  # noqa: E731
    if pkg == "jax":
        return JEngine(fn, jserve_buckets(4), feat_keys=tuple(vocabs))
    return ScoringEngine(fn, serve_buckets(4), feat_keys=tuple(vocabs))


@contextlib.contextmanager
def _cascade_servers(demo, *, tier1_prob=0.5, tier2=None, band=(0.4, 0.6),
                     **cascade_kw):
    """Both packages' servers, cascade on; ``tier2`` is a pair (JAX's
    engine, the port's) or one engine both share."""
    jv, tv, _ = demo
    t2 = tier2 if isinstance(tier2, tuple) else (tier2 or _StubTier2(),) * 2
    kw = dict(enabled=True, band_lo=band[0], band_hi=band[1], **cascade_kw)
    jsrv = JServer(_tier1("jax", jv, tier1_prob), jv,
                   JServeConfig(port=0, max_wait_ms=2.0,
                                cascade=JCascadeConfig(**kw)),
                   tier2_engine=t2[0]).start()
    tsrv = ScoreServer(_tier1("port", tv, tier1_prob), tv,
                       ServeConfig(port=0, max_wait_ms=2.0,
                                   cascade=CascadeConfig(**kw)),
                       tier2_engine=t2[1]).start()
    snaps = {}
    try:
        yield jsrv, tsrv, snaps
    finally:
        snaps["jax"] = jsrv.shutdown()
        snaps["port"] = tsrv.shutdown()


def _req(port, method, path, body=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _post(port, source, timeout=60):
    status, data = _req(port, "POST", "/score",
                        json.dumps({"source": source}), timeout)
    return status, json.loads(data)


def _cascade_snap(snap):
    return {k: snap[k] for k in ("cascade_escalated_total",
                                 "cascade_degraded_total",
                                 "cascade_answered")}


# ---------------------------------------------------------------------------
# config


@pytest.mark.parametrize("kw,match", [
    (dict(band_lo=0.8, band_hi=0.2), "band_lo < band_hi"),
    (dict(band_lo=0.5, band_hi=0.5), "band_lo < band_hi"),
    (dict(band_lo=-0.1, band_hi=0.5), "band_lo < band_hi"),
    (dict(band_lo=0.5, band_hi=1.1), "band_lo < band_hi"),
    (dict(tier2_max_batch=0), "tier2_max_batch"),
    (dict(tier2_max_wait_ms=-1.0), "tier2_max_wait_ms"),
    (dict(tier2_max_queue=0), "tier2_max_queue"),
    (dict(tier2_deadline_ms=0.0), "tier2_deadline_ms"),
])
def test_cascade_config_validation_equals_jax(kw, match):
    for cls in (CascadeConfig, JCascadeConfig):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def test_cascade_config_dotted_overrides_and_roundtrip(tmp_path):
    over = {"serve.cascade.enabled": True, "serve.cascade.band_lo": 0.3,
            "serve.cascade.band_hi": 0.7, "serve.cascade.tier2_max_batch": 2,
            "serve.cascade.tier2_deadline_ms": 500.0}
    cc = load_config(overrides=over).serve.cascade
    assert isinstance(cc, CascadeConfig)
    assert (cc.enabled, cc.band_lo, cc.band_hi, cc.tier2_max_batch,
            cc.tier2_deadline_ms) == (True, 0.3, 0.7, 2, 500.0)
    path = tmp_path / "cfg.json"
    path.write_text(to_json(load_config(overrides=over)))
    assert load_config(path).serve.cascade == cc


# ---------------------------------------------------------------------------
# the tier-2 queue


def test_router_band_boundaries_inclusive():
    router = CascadeRouter(CascadeConfig(band_lo=0.4, band_hi=0.6),
                           _StubTier2())
    assert router.in_band(0.4) and router.in_band(0.6) and router.in_band(0.5)
    assert not router.in_band(0.39999) and not router.in_band(0.60001)
    assert router.model_rev == "t2-stub"
    assert router.deadline_s == 2.0


def test_tier2_batcher_coalesces_and_resolves():
    t2 = _StubTier2(prob=0.7)
    b = Tier2Batcher(t2, max_batch=4, max_wait_ms=10_000.0, max_queue=8)
    futs = [b.submit(f"fn{i}", None) for i in range(4)]  # before start
    b.start()
    try:
        assert [f.result(timeout=30) for f in futs] == [0.7] * 4
        assert t2.calls == [["fn0", "fn1", "fn2", "fn3"]]  # one window
    finally:
        b.stop(drain=True, timeout=10)


def test_tier2_batcher_queue_full_and_drain_refusal():
    entered, release = threading.Event(), threading.Event()
    t2 = _StubTier2(gate=(entered, release))
    b = Tier2Batcher(t2, max_batch=1, max_wait_ms=1.0, max_queue=1).start()
    try:
        first = b.submit("fn0", None)
        assert entered.wait(timeout=30)  # the dispatcher holds fn0
        second = b.submit("fn1", None)  # the queue holds one
        with pytest.raises(Tier2QueueFull, match="capacity"):
            b.submit("overflow", None)
        release.set()
        assert first.result(timeout=30) == second.result(timeout=30) == 0.9
    finally:
        release.set()
        b.stop(drain=True, timeout=10)
    with pytest.raises(RuntimeError, match="draining"):
        b.submit("late", None)


def test_tier2_batcher_engine_failure_fails_window_only():
    t2 = _StubTier2(fail=True)
    b = Tier2Batcher(t2, max_batch=2, max_wait_ms=1.0, max_queue=8).start()
    try:
        with pytest.raises(RuntimeError, match="tier-2 stub failure"):
            b.submit("fn0", None).result(timeout=30)
        t2.fail = False
        assert b.submit("fn1", None).result(timeout=30) == 0.9
    finally:
        b.stop(drain=True, timeout=10)


# ---------------------------------------------------------------------------
# the servers: band routing and tier attribution


def test_in_band_answers_tier2_as_jax_does(demo):
    _, _, sources = demo
    jt2, tt2 = _StubTier2(prob=0.9), _StubTier2(prob=0.9)
    with _cascade_servers(demo, tier2=(jt2, tt2)) as (jsrv, tsrv, snaps):
        want, got = _post(jsrv.port, sources[0]), _post(tsrv.port, sources[0])
        assert got == want and got[0] == 200
        row = got[1]["results"][0]
        assert (row["tier"], row["tier1_score"],
                row["vulnerable_probability"]) == (2, 0.5, 0.9)
        assert "tier2_degraded" not in row
        assert tt2.calls == jt2.calls == [[sources[0]]]
    assert _cascade_snap(snaps["port"]) == _cascade_snap(snaps["jax"]) == {
        "cascade_escalated_total": 1, "cascade_degraded_total": 0,
        "cascade_answered": {2: 1}}
    assert snaps["port"]["tier2_latency_p99_ms"] is not None


def test_out_of_band_stays_tier1(demo):
    _, _, sources = demo
    t2 = _StubTier2()
    with _cascade_servers(demo, tier1_prob=0.25, tier2=t2) as (
            jsrv, tsrv, snaps):
        want, got = _post(jsrv.port, sources[0]), _post(tsrv.port, sources[0])
        assert got == want and got[0] == 200
        row = got[1]["results"][0]
        assert (row["tier"], row["tier1_score"],
                row["vulnerable_probability"]) == (1, 0.25, 0.25)
        assert not t2.calls
    assert _cascade_snap(snaps["port"]) == _cascade_snap(snaps["jax"])
    assert snaps["port"]["cascade_answered"] == {1: 1}


def test_without_cascade_rows_carry_no_tier(demo):
    _, tv, sources = demo
    srv = ScoreServer(_tier1("port", tv, 0.5), tv,
                      ServeConfig(port=0, max_wait_ms=2.0)).start()
    try:
        status, body = _post(srv.port, sources[0])
        assert status == 200
        assert "tier" not in body["results"][0]
        assert "tier1_score" not in body["results"][0]
        health = json.loads(_req(srv.port, "GET", "/healthz")[1])
        assert health["cascade"] is False and health["tier2_model_rev"] is None
    finally:
        srv.shutdown()
    with pytest.raises(ValueError, match="needs a tier-2 engine"):
        ScoreServer(_tier1("port", tv, 0.5), tv,
                    ServeConfig(port=0, cascade=CascadeConfig(enabled=True)))


# ---------------------------------------------------------------------------
# invariant 24: every tier-2 failure degrades to the tier-1 answer


def test_tier2_engine_failure_degrades(demo):
    _, _, sources = demo
    with _cascade_servers(demo, tier2=_StubTier2(fail=True)) as (
            jsrv, tsrv, snaps):
        want, got = _post(jsrv.port, sources[0]), _post(tsrv.port, sources[0])
        assert got == want and got[0] == 200
        row = got[1]["results"][0]
        assert row["tier"] == 1 and row["tier2_degraded"] is True
        assert row["vulnerable_probability"] == 0.5
        status, health = _req(tsrv.port, "GET", "/healthz")
        assert status == 200 and json.loads(health)["status"] == "ok"
    assert _cascade_snap(snaps["port"]) == _cascade_snap(snaps["jax"])
    assert snaps["port"]["cascade_degraded_total"] == 1


def test_tier2_deadline_blown_degrades(demo):
    _, _, sources = demo
    entered, release = threading.Event(), threading.Event()
    t2 = _StubTier2(gate=(entered, release))
    try:
        with _cascade_servers(demo, tier2=t2, tier2_deadline_ms=50.0) as (
                jsrv, tsrv, snaps):
            for srv in (jsrv, tsrv):
                status, body = _post(srv.port, sources[0])
                assert status == 200
                row = body["results"][0]
                assert row["tier"] == 1 and row["tier2_degraded"] is True
                assert row["vulnerable_probability"] == 0.5
            assert entered.is_set()
            release.set()
    finally:
        release.set()
    assert _cascade_snap(snaps["port"]) == _cascade_snap(snaps["jax"])
    assert snaps["port"]["cascade_degraded_total"] == 1


def test_tier2_queue_full_degrades_not_503(demo):
    """One request of four functions into a tier 2 that holds its first
    window, with a batch of 1 and a queue of 1: the escalations that find
    the queue full degrade, the admitted ones answer tier 2, and the
    response is one 200, on both servers."""
    _, _, sources = demo
    source = "\n".join(sources[:4])
    with _cascade_servers(demo, tier2_max_batch=1, tier2_max_wait_ms=1.0,
                          tier2_max_queue=1,
                          tier2_deadline_ms=60_000.0) as (jsrv, tsrv, snaps):
        for srv in (jsrv, tsrv):
            entered, release = threading.Event(), threading.Event()
            srv.cascade.engine = srv.cascade.batcher.engine = _StubTier2(
                gate=(entered, release))
            # release tier 2 once the request has placed all four
            # escalations (enqueued or refused)
            placed, escalate = [], srv.cascade.escalate

            def counted(text, graph, escalate=escalate, placed=placed,
                        release=release):
                try:
                    return escalate(text, graph)
                finally:
                    placed.append(1)
                    if len(placed) == 4:
                        release.set()

            srv.cascade.escalate = counted
            status, body = _post(srv.port, source)
            assert status == 200 and entered.is_set()
            rows = body["results"]
            degraded = [r for r in rows if r.get("tier2_degraded")]
            answered2 = [r for r in rows if r.get("tier") == 2]
            assert degraded and answered2, rows
            assert len(degraded) + len(answered2) == 4
            assert all(r["vulnerable_probability"] == 0.5 for r in degraded)
            assert srv.metrics.snapshot()["cascade_degraded_total"] == len(
                degraded)
    for snap in snaps.values():
        assert not any(int(code) >= 500 for code in snap["responses_total"])


# ---------------------------------------------------------------------------
# the fault points, through the real HTTP surface


@pytest.mark.parametrize("point", ["cascade.tier2_timeout",
                                   "cascade.escalation_drop"])
def test_fault_points_keep_the_tier1_answer(demo, point):
    _, _, sources = demo
    jt2, tt2 = _StubTier2(), _StubTier2()
    with _cascade_servers(demo, tier2=(jt2, tt2)) as (jsrv, tsrv, snaps):
        with faults.installed(f"{point}@1"), jfaults.installed(f"{point}@1"):
            want = _post(jsrv.port, sources[0])
            got = _post(tsrv.port, sources[0])
            assert got == want and got[0] == 200
            row = got[1]["results"][0]
            assert row["tier"] == 1 and row["tier2_degraded"] is True
            assert row["vulnerable_probability"] == 0.5
            status, health = _req(tsrv.port, "GET", "/healthz")
            assert status == 200 and json.loads(health)["status"] == "ok"
        want, got = _post(jsrv.port, sources[1]), _post(tsrv.port, sources[1])
        assert got == want and got[1]["results"][0]["tier"] == 2
        if point == "cascade.escalation_drop":
            assert len(tt2.calls) == len(jt2.calls) == 1
    for snap in snaps.values():
        assert snap["cascade_degraded_total"] == 1
        assert not any(int(code) >= 500 for code in snap["responses_total"])


# ---------------------------------------------------------------------------
# observability


def _families(text: str) -> set[str]:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_metrics_slo_and_healthz_expose_the_cascade_as_jax_does(demo):
    _, _, sources = demo
    with _cascade_servers(demo) as (jsrv, tsrv, _):
        for srv in (jsrv, tsrv):
            assert _post(srv.port, sources[0])[0] == 200
        jm = _req(jsrv.port, "GET", "/metrics")[1].decode()
        tm = _req(tsrv.port, "GET", "/metrics")[1].decode()
        for family in ("deepdfa_serve_cascade_escalated_total",
                       "deepdfa_serve_cascade_degraded_total",
                       "deepdfa_serve_cascade_answered_total",
                       "deepdfa_serve_tier2_queue_depth",
                       "deepdfa_serve_tier1_latency_ms",
                       "deepdfa_serve_tier2_latency_ms",
                       "deepdfa_serve_tier2_queue_wait_ms",
                       "deepdfa_serve_tier2_dispatch_ms"):
            assert family in _families(tm) and family in _families(jm)
        assert 'deepdfa_serve_cascade_answered_total{tier="2"} 1' in tm
        js = _req(jsrv.port, "GET", "/slo")[1].decode()
        ts = _req(tsrv.port, "GET", "/slo")[1].decode()
        assert _families(ts) == _families(js)
        slo_lines = lambda t: sorted(  # noqa: E731
            line.split()[0] for line in t.splitlines()
            if not line.startswith("#"))
        assert slo_lines(ts) == slo_lines(js)
        assert "tier2_latency_p99" in ts and "tier2_success" in ts
        jh = json.loads(_req(jsrv.port, "GET", "/healthz")[1])
        th = json.loads(_req(tsrv.port, "GET", "/healthz")[1])
        assert th["cascade"] is jh["cascade"] is True
        assert th["tier2_model_rev"] == jh["tier2_model_rev"] == "t2-stub"


def test_escalation_spans_reach_the_tracer(demo):
    _, _, sources = demo
    with _cascade_servers(demo) as (jsrv, tsrv, _):
        for srv in (jsrv, tsrv):
            assert _post(srv.port, sources[0])[0] == 200
    for srv in (jsrv, tsrv):
        names = {s.name for s in srv.tracer.spans()}
        assert {"server.request", "cache.lookup", "queue.wait",
                "engine.dispatch", "cascade.escalate", "tier2.queue.wait",
                "tier2.engine.dispatch"} <= names
    assert {s.name for s in tsrv.tracer.spans()} == {
        s.name for s in jsrv.tracer.spans()}


# ---------------------------------------------------------------------------
# scan with a cascade


def _write_tree(tmp_path, n):
    rows = demo_corpus(n, seed=0).to_dict("records")
    for i, r in enumerate(rows):
        (tmp_path / f"f{i}.c").write_text(r["before"])


def _scan_rows(report):
    return [{k: v for k, v in r.items() if k != "file"}
            for r in report["results"]]


def test_scan_cascade_tier_attribution_equals_jax(demo, tmp_path):
    jv, tv, _ = demo
    _write_tree(tmp_path, 3)
    kw = dict(tier2_band=(0.4, 0.6), n_workers=1, cache_dir=None)
    jt2, tt2 = _StubTier2(prob=0.88), _StubTier2(prob=0.88)
    want = jscan([tmp_path], jv, engine=_tier1("jax", jv, 0.5), tier2=jt2,
                 **kw)
    got = scan_paths([tmp_path], tv, engine=_tier1("port", tv, 0.5),
                     tier2=tt2, **kw)
    assert _scan_rows(got) == _scan_rows(want)
    scored = [r for r in got["results"] if "vulnerable_probability" in r]
    assert scored and all(r["tier"] == 2 and r["tier1_score"] == 0.5
                          and r["vulnerable_probability"] == 0.88
                          for r in scored)
    assert got["cascade"] == want["cascade"] == {
        "band": [0.4, 0.6], "n_tier2": len(scored), "n_degraded": 0,
        "tier2_model_rev": "t2-stub"}
    assert tt2.calls == jt2.calls and all(t for c in tt2.calls for t in c)

    out = scan_paths([tmp_path], tv, engine=_tier1("port", tv, 0.5),
                     tier2=_StubTier2(), tier2_band=(0.8, 0.9), n_workers=1)
    assert all(r["tier"] == 1 for r in out["results"]
               if "vulnerable_probability" in r)
    assert out["cascade"]["n_tier2"] == 0
    bad = scan_paths([tmp_path], tv, engine=_tier1("port", tv, 0.5),
                     tier2=_StubTier2(fail=True), **kw)
    jbad = jscan([tmp_path], jv, engine=_tier1("jax", jv, 0.5),
                 tier2=_StubTier2(fail=True), **kw)
    assert _scan_rows(bad) == _scan_rows(jbad)
    assert bad["cascade"]["n_degraded"] == len(scored)


def test_scan_command_cascade_requires_scores_and_joint_dir(tmp_path):
    (tmp_path / "a.c").write_text("int f(void) { return 1; }\n")
    cfg = load_config(overrides={"data.sample": True})
    with pytest.raises(ValueError, match="needs tier-1 scores"):
        scan_command(cfg, tmp_path, [str(tmp_path)], workers=1,
                     cache_dir=None, cascade=True)
    with pytest.raises(ValueError, match="needs a tier-2 checkpoint"):
        scan_command(cfg, tmp_path, [str(tmp_path)],
                     ckpt_dir=tmp_path / "nonexistent_ckpt", workers=1,
                     cache_dir=None, cascade=True)
    # an exported artifact's scores are tier-1 scores too
    with pytest.raises(ValueError, match="needs a tier-2 checkpoint"):
        scan_command(cfg, tmp_path, [str(tmp_path)], artifact="x",
                     workers=1, cascade=True)


# ---------------------------------------------------------------------------
# the real tier 2: tiny_llama JointEngines of both packages


@pytest.fixture(scope="module")
def joint_engines():
    llm_cfg = jl.tiny_llama(vocab_size=2048)
    jllm = jl.LlamaModel(llm_cfg)
    llm_params = jax.tree.map(np.asarray, nn.meta.unbox(jllm.init(
        jax.random.key(0), np.zeros((2, BLOCK), np.int32))["params"]))
    jfus = jfusion.FusionModel(gnn_cfg=JCfg(), input_dim=INPUT_DIM,
                               llm_hidden_size=llm_cfg.hidden_size,
                               dropout_rate=0.1, pool="last")
    from deepdfa_tpu.data.synthetic import random_dataset

    graphs = jbatch_np(random_dataset(2, seed=0, input_dim=INPUT_DIM,
                                      mean_nodes=20), 3, 512, 2048)
    fus_params = jax.tree.map(np.asarray, jfus.init(
        {"params": jax.random.key(1), "dropout": jax.random.key(2)},
        np.zeros((2, BLOCK, llm_cfg.hidden_size), np.float32), graphs,
        deterministic=True, token_mask=np.ones((2, BLOCK), bool))["params"])
    kw = dict(max_batch=4, max_nodes=1024, max_edges=4096)
    jeng = JJoint(jllm, llm_params, jfus, fus_params, jds.HashTokenizer(2048),
                  jjoint.JointConfig(block_size=BLOCK), **kw)
    llm = tl.build_llama(tl.LlamaConfig(**dataclasses.asdict(llm_cfg)),
                         "cpu", seed=None)
    llm.load_state_dict(bridge.llama_flax_to_torch(llm_params))
    fus = tfusion.build_fusion(GGNNConfig(), INPUT_DIM, llm_cfg.hidden_size,
                               dropout_rate=0.1, device="cpu")
    fus.load_state_dict(bridge.fusion_flax_to_torch(fus_params, GGNNConfig(),
                                                    INPUT_DIM))
    teng = JointEngine(llm, fus, tds.HashTokenizer(2048),
                       tjoint.JointConfig(block_size=BLOCK), device="cpu",
                       **kw)
    return jeng, teng


def test_real_tier2_probabilities_equal_jax(demo, joint_engines):
    jv, tv, sources = demo
    jeng, teng = joint_engines
    source = "\n".join(sources[:3])
    with _cascade_servers(demo, tier2=joint_engines, band=(0.0, 1.0),
                          tier2_deadline_ms=120_000.0) as (jsrv, tsrv, snaps):
        want = _post(jsrv.port, source, timeout=180)
        got = _post(tsrv.port, source, timeout=180)
    assert got[0] == want[0] == 200
    rows, jrows = got[1]["results"], want[1]["results"]
    assert [r["function"] for r in rows] == [r["function"] for r in jrows]
    assert [r["tier"] for r in rows] == [r["tier"] for r in jrows] == [2] * 3
    for a, b in zip(rows, jrows):
        assert a["vulnerable_probability"] == pytest.approx(
            b["vulnerable_probability"], abs=ATOL)
    # the port's tier 2 scored the function's request source and graph
    from deepdfa_tpu_torch.pipeline import encode_source

    fns = [fn for fn in encode_source(source, tv) if fn.graph is not None]
    direct = teng.score([(source, fn.graph) for fn in fns])
    assert [r["vulnerable_probability"] for r in rows] == [
        round(float(p), 6) for p in direct]
    assert _cascade_snap(snaps["port"]) == _cascade_snap(snaps["jax"])
