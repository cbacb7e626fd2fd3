"""The port's continual loop (``deepdfa_tpu_torch/continual``) against the
JAX package's, on the CPU, case for case with ``tests/test_continual.py``.

Both packages run side by side on the same inputs, and where they compute
the same thing the test compares them, exactly:

- ``ContinualConfig``: defaults, validation messages, dotted overrides and
  the JSON round trip; ``admission``, ``autoscale`` and ``federation``
  parse as the JAX package's do, and refuse the same values;
- capture: journal bytes (fixed clock), sampling and bound counters, the
  unwritable path, ``continual.capture_drop``, the torn tail, and the rows
  a real ``ScoreServer`` records (equal to the JAX server's but for the
  clock);
- the promotion veto reader on every degenerate artifact shape;
- shadow replay on identical, distinct and empty traffic: the reports
  equal (PSI, deltas, buckets) and the gate's decision and reason;
- ``corpus_delta`` stats, ``no_regression_gate`` decisions and reasons on
  every leg (the ledger leg over the repo's artifacts), ``run_retrain``'s
  record;
- ``PromotionController`` on fake rings: the roll, the veto, missing and
  stale alerts, a failing shadow report, injected and real drift rollback,
  ``converge`` from a crash state: the decisions' action sequence, gates
  and reasons, the journal's transitions, the ring trace, the summary;
  ``stage_candidate`` through the warm store;
- ``kill -9`` mid-rollout: a controller subprocess of the port driven
  through the router's admin surface dies at ``continual.rollout_crash``
  (rc 137), and a resumed controller converges the fleet to the prior rev
  with no 5xx through the real port router.

Every wait is on an event, a future or a poll of state, never a sleep.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

from deepdfa_tpu import continual as jcont  # noqa: E402
from deepdfa_tpu.config import ContinualConfig as JContinualConfig  # noqa: E402
from deepdfa_tpu.config import FeatureConfig as JFeatureConfig  # noqa: E402
from deepdfa_tpu.config import ServeConfig as JServeConfig  # noqa: E402
from deepdfa_tpu.config import load_config as jload_config  # noqa: E402
from deepdfa_tpu.config import to_json as jto_json  # noqa: E402
from deepdfa_tpu.cpg.features import add_dependence_edges  # noqa: E402
from deepdfa_tpu.cpg.frontend import parse_source  # noqa: E402
from deepdfa_tpu.data.codegen import demo_corpus  # noqa: E402
from deepdfa_tpu.data.extract_cache import ExtractCache as JExtractCache  # noqa: E402
from deepdfa_tpu.data.materialize import CorpusBuilder  # noqa: E402
from deepdfa_tpu.obs import slo as jslo  # noqa: E402
from deepdfa_tpu.pipeline import encode_source as jencode  # noqa: E402
from deepdfa_tpu.resilience import faults as jfaults  # noqa: E402
from deepdfa_tpu.resilience.journal import RunJournal as JRunJournal  # noqa: E402
from deepdfa_tpu.serve import ScoreServer as JServer  # noqa: E402
from deepdfa_tpu.serve import ScoringEngine as JEngine  # noqa: E402
from deepdfa_tpu.serve import WarmStore as JWarmStore  # noqa: E402
from deepdfa_tpu.serve import serve_buckets as jserve_buckets  # noqa: E402

from deepdfa_tpu_torch import continual  # noqa: E402
from deepdfa_tpu_torch.config import (ContinualConfig, ServeConfig,  # noqa: E402
                                      load_config, to_json)
from deepdfa_tpu_torch.data.extract_cache import ExtractCache  # noqa: E402
from deepdfa_tpu_torch.data.vocab import Vocabulary  # noqa: E402
from deepdfa_tpu_torch.obs import slo  # noqa: E402
from deepdfa_tpu_torch.pipeline import encode_source  # noqa: E402
from deepdfa_tpu_torch.resilience import faults  # noqa: E402
from deepdfa_tpu_torch.resilience.journal import RunJournal  # noqa: E402
from deepdfa_tpu_torch.serve import (ScoringEngine, WarmStore,  # noqa: E402
                                     serve_buckets)
from deepdfa_tpu_torch.serve.server import ScoreServer  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PKGS = ("port", "jax")
CONT = {"port": continual, "jax": jcont}
SLO = {"port": slo, "jax": jslo}


# ---------------------------------------------------------------------------
# shared fakes and fixtures


def _stub_engine(pkg, vocabs=(), max_batch=4, prob=0.5, rev=None):
    """A real ScoringEngine of ``pkg`` over a constant score function."""
    def score_fn(batch):
        return np.full(batch.max_graphs, prob, np.float32)

    if pkg == "port":
        return ScoringEngine(score_fn, serve_buckets(max_batch),
                             feat_keys=tuple(vocabs), model_rev=rev)
    return JEngine(score_fn, jserve_buckets(max_batch),
                   feat_keys=tuple(vocabs), model_rev=rev)


class _Journal:
    def __init__(self, fail=False):
        self.fail = fail
        self.events: list[dict] = []

    def write(self, **kw):
        if self.fail:
            raise OSError("journal sink down")
        self.events.append(kw)


class _Flight:
    def __init__(self):
        self.events: list[tuple[str, dict]] = []

    def record(self, kind, **kw):
        self.events.append((kind, kw))


@pytest.fixture(scope="module")
def demo():
    """({pkg: vocabs}, sources, {pkg: graphs}): the JAX front end's
    vocabularies over ``demo_corpus(6)``, carried to the port with
    ``Vocabulary.from_dict``, and each package's encoded graphs."""
    rows = demo_corpus(6, seed=0).to_dict("records")
    cpgs = {int(r["id"]): add_dependence_edges(parse_source(r["before"]))
            for r in rows}
    labels = {int(r["id"]): int(r["vul"]) for r in rows}
    _, jvocabs = CorpusBuilder(JFeatureConfig()).build(
        cpgs, list(cpgs), graph_labels=labels)
    tvocabs = {k: Vocabulary.from_dict(v.to_dict()) for k, v in jvocabs.items()}
    sources = [r["before"] for r in rows]
    graphs = {}
    for pkg, enc, voc in (("port", encode_source, tvocabs),
                          ("jax", jencode, jvocabs)):
        graphs[pkg] = [ef.graph for src in sources
                       for ef in enc(src, voc, keep_cpg=False)
                       if ef.graph is not None][:6]
    assert len(graphs["port"]) >= 3
    return {"port": tvocabs, "jax": jvocabs}, sources, graphs


def _traffic(pkg, path, demo, *, prob=0.5, rev="revA", tier=1,
             clock=lambda: 1.0):
    """A capture journal of real graphs with stub scores, via the real
    write path of ``pkg``."""
    graphs = demo[2][pkg]
    rows = [{"function": f"f{i}", "vulnerable_probability": prob,
             "tier": tier} for i in range(len(graphs))]
    cap = CONT[pkg].TrafficCapture(path, clock=clock)
    assert cap.record_request("srckey", rows, graphs, model_rev=rev) == \
        len(graphs)
    return path, cap


# ---------------------------------------------------------------------------
# config


def test_continual_config_validation_equals_jax():
    assert dataclasses.asdict(ContinualConfig()) == \
        dataclasses.asdict(JContinualConfig())
    for field, bad in [("capture_sample_every", 0),
                       ("capture_max_records", 0),
                       ("shadow_bins", 1),
                       ("shadow_max_psi", 0.0),
                       ("veto_max_age_s", 0.0),
                       ("drift_settle_polls", 0),
                       ("poll_interval_s", 0.0),
                       ("join_timeout_s", 0.0)]:
        with pytest.raises(ValueError, match=field) as mine:
            ContinualConfig(**{field: bad})
        with pytest.raises(ValueError) as ref:
            JContinualConfig(**{field: bad})
        assert str(mine.value) == str(ref.value)


def test_continual_config_dotted_overrides_and_roundtrip(tmp_path):
    over = {"serve.continual.enabled": True,
            "serve.continual.capture_path": "traffic.jsonl",
            "serve.continual.capture_sample_every": 3,
            "serve.continual.shadow_max_psi": 0.1,
            "serve.continual.drift_settle_polls": 5}
    cfg = load_config(overrides=over)
    cc = cfg.serve.continual
    assert isinstance(cc, ContinualConfig)
    assert (cc.enabled, cc.capture_path, cc.capture_sample_every,
            cc.shadow_max_psi, cc.drift_settle_polls) == (
                True, "traffic.jsonl", 3, 0.1, 5)
    assert json.loads(to_json(cfg))["serve"]["continual"] == \
        json.loads(jto_json(jload_config(overrides=over)))["serve"]["continual"]
    path = tmp_path / "cfg.json"
    path.write_text(to_json(cfg))
    assert load_config(path).serve.continual == cc
    with pytest.raises(ValueError, match="shadow_bins"):
        load_config(overrides={"serve.continual.shadow_bins": 1})
    # the fleet's blocks parse as the JAX package's do, and refuse alike
    for key, value in (("serve.admission.enabled", True),
                       ("serve.autoscale.max_replicas", 8),
                       ("serve.federation.cells", ["a:1"])):
        block = key.split(".")[1]
        assert json.loads(to_json(load_config(overrides={key: value})))[
            "serve"][block] == json.loads(jto_json(jload_config(
                overrides={key: value})))["serve"][block]
    for key, value in (("serve.admission.max_level", 4),
                       ("serve.autoscale.min_replicas", 0),
                       ("serve.federation.cells", ["nocolon"])):
        errors = []
        for load in (load_config, jload_config):
            with pytest.raises(ValueError) as e:
                load(overrides={key: value})
            errors.append(str(e.value))
        assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# capture


def test_capture_roundtrip_equals_jax_bytes(tmp_path, demo):
    paths = {}
    for pkg in PKGS:
        paths[pkg], cap = _traffic(pkg, tmp_path / f"{pkg}.jsonl", demo,
                                   prob=0.25, rev="rev1")
        assert cap.stats()["written"] == len(demo[2][pkg])
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    rows = continual.read_capture(paths["port"])
    assert rows == jcont.read_capture(paths["jax"])
    for rec in rows:
        assert rec["schema"] == 1 and rec["model_rev"] == "rev1"
        assert rec["score"] == 0.25 and rec["tier"] == 1
    g0 = continual.record_graph(rows[0])
    want = demo[2]["port"][0]
    np.testing.assert_array_equal(g0.senders, want.senders)
    np.testing.assert_array_equal(g0.receivers, want.receivers)
    assert set(g0.node_feats) == set(want.node_feats)
    for k in want.node_feats:
        np.testing.assert_array_equal(g0.node_feats[k], want.node_feats[k])
    assert continual.record_graph({"schema": 1}) is None


def test_capture_sampling_and_record_bound_equal_jax(tmp_path, demo):
    out = {}
    for pkg in PKGS:
        g = demo[2][pkg][:1]
        row = [{"function": "f", "vulnerable_probability": 0.5}]
        cap = CONT[pkg].TrafficCapture(tmp_path / f"{pkg}.jsonl",
                                       sample_every=2, max_records=2)
        wrote = [cap.record_request(f"k{i}", row, g, model_rev="r")
                 for i in range(6)]
        out[pkg] = (wrote, cap.stats(),
                    len(CONT[pkg].read_capture(tmp_path / f"{pkg}.jsonl")))
    assert out["port"] == out["jax"]
    assert out["port"] == ([1, 0, 1, 0, 0, 0], {"written": 2, "skipped": 4,
                                                "dropped": 0, "seen": 6}, 2)


def test_capture_never_fails_on_unwritable_path(tmp_path, demo):
    for pkg in PKGS:
        g = demo[2][pkg][:1]
        row = [{"function": "f", "vulnerable_probability": 0.5}]
        flight = _Flight()
        cap = CONT[pkg].TrafficCapture(tmp_path, flight=flight)  # a dir
        assert cap.record_request("k", row, g, model_rev="r") == 0
        assert cap.stats()["dropped"] == 1
        assert [k for k, _ in flight.events] == ["capture.dropped"]


def test_capture_drop_fault_counts_never_raises(tmp_path, demo):
    stats = {}
    for pkg, fmod in (("port", faults), ("jax", jfaults)):
        g = demo[2][pkg][:1]
        row = [{"function": "f", "vulnerable_probability": 0.5}]
        cap = CONT[pkg].TrafficCapture(tmp_path / f"{pkg}.jsonl",
                                       flight=_Flight())
        with fmod.installed("continual.capture_drop@1"):
            assert cap.record_request("k0", row, g, model_rev="r") == 0
            assert cap.record_request("k1", row, g, model_rev="r") == 1
        stats[pkg] = cap.stats()
    assert stats["port"] == stats["jax"]
    assert stats["port"]["dropped"] == 1 and stats["port"]["written"] == 1


def test_read_capture_tolerates_torn_tail(tmp_path):
    path = tmp_path / "t.jsonl"
    good = json.dumps({"schema": 1, "score": 0.5})
    path.write_text(good + "\n" + good + "\n" + '{"schema": 1, "sco')
    assert continual.read_capture(path) == jcont.read_capture(path)
    assert len(continual.read_capture(path)) == 2
    assert continual.read_capture(tmp_path / "absent.jsonl") == []


# ---------------------------------------------------------------------------
# capture through a real ScoreServer


def _capture_server(pkg, demo, tmp_path, **cont_kw):
    path = str(tmp_path / f"{pkg}_traffic.jsonl")
    if pkg == "port":
        cfg = ServeConfig(port=0, max_wait_ms=2.0, continual=ContinualConfig(
            enabled=True, capture_path=path, **cont_kw))
        return ScoreServer(_stub_engine(pkg, demo[0][pkg]), demo[0][pkg], cfg)
    cfg = JServeConfig(port=0, max_wait_ms=2.0, continual=JContinualConfig(
        enabled=True, capture_path=path, **cont_kw))
    return JServer(_stub_engine(pkg, demo[0][pkg]), demo[0][pkg], cfg)


def _post_score(port, source, timeout=30):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/score", json.dumps({"source": source}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        conn.close()


def _uniq(base: str, i: int) -> str:
    return f"{base}\nint cont_uniq_{i}(int a) {{\n  return a + {i};\n}}\n"


def test_server_capture_records_what_the_jax_server_records(demo, tmp_path):
    sources = demo[1]
    rows = {}
    for pkg in PKGS:
        srv = _capture_server(pkg, demo, tmp_path).start()
        try:
            for i in range(2):
                status, body = _post_score(srv.port, _uniq(sources[0], i))
                assert status == 200 and body["results"]
            # a result-cache hit records nothing
            assert _post_score(srv.port, _uniq(sources[0], 0))[1]["cached"]
        finally:
            srv.shutdown()
        assert srv.capture.stats()["dropped"] == 0
        rows[pkg] = CONT[pkg].read_capture(tmp_path / f"{pkg}_traffic.jsonl")
        assert len(rows[pkg]) == srv.capture.stats()["written"] > 0
    strip = [{k: v for k, v in r.items() if k != "t"} for r in rows["port"]]
    assert strip == [{k: v for k, v in r.items() if k != "t"}
                     for r in rows["jax"]]
    for rec in rows["port"]:
        assert 0.0 <= rec["score"] <= 1.0 and rec["tier"] == 1
        assert rec["model_rev"] == "unknown"  # the stub engine has no rev
        assert continual.record_graph(rec) is not None


def test_capture_drop_never_fails_the_scored_request(demo, tmp_path):
    srv = _capture_server("port", demo, tmp_path).start()
    try:
        with faults.installed("continual.capture_drop@1"):
            status, body = _post_score(srv.port, _uniq(demo[1][1], 0))
        assert status == 200 and body["results"]
    finally:
        srv.shutdown()
    assert srv.capture.stats()["dropped"] == 1


def test_capture_off_by_default(demo):
    srv = ScoreServer(_stub_engine("port", demo[0]["port"]), demo[0]["port"],
                      ServeConfig(port=0))
    try:
        assert srv.capture is None
    finally:
        srv.start().shutdown()


# ---------------------------------------------------------------------------
# the promotion veto reader


def _veto_both(path, **kw):
    mine = slo.read_promotion_veto(path, **kw)
    assert mine == jslo.read_promotion_veto(path, **kw)
    return mine


def test_read_promotion_veto_missing():
    for path in (None, "/nonexistent/alerts.json"):
        veto = _veto_both(path)
        assert veto["allow"] is False and veto["reason"] == "missing"
        assert veto["vetoed"] is None and veto["age_s"] is None


def test_read_promotion_veto_torn(tmp_path):
    path = tmp_path / "alerts.json"
    for text in ('{"schema": 1, "promotion_ve',
                 '[1, 2, 3]',
                 '{"schema": 2, "generated_at_unix": 1, '
                 '"promotion_vetoed": false}',
                 '{"schema": 1, "promotion_vetoed": false}'):
        path.write_text(text)
        veto = _veto_both(path)
        assert veto["allow"] is False and veto["reason"] == "torn", text


def test_read_promotion_veto_stale(tmp_path):
    path = slo.write_alerts_artifact(tmp_path / "alerts.json", [],
                                     clock=lambda: 1000.0)
    veto = _veto_both(path, max_age_s=3600.0, clock=lambda: 1000.0 + 7200.0)
    assert veto["allow"] is False and veto["reason"] == "stale"
    assert veto["age_s"] == pytest.approx(7200.0)
    fresh = _veto_both(path, max_age_s=3600.0, clock=lambda: 1060.0)
    assert fresh["allow"] is True and fresh["reason"] == "fresh"


def test_read_promotion_veto_firing_alert_vetoes(tmp_path):
    path = slo.write_alerts_artifact(
        tmp_path / "alerts.json", [],
        extra_alerts=[{"slo": "latency_p99", "alert": True}])
    # one clock reading for both readers: two live readings can round
    # their age differently (0.299 against 0.3 s)
    now = time.time()
    veto = _veto_both(path, clock=lambda: now)
    assert veto["allow"] is False and veto["reason"] == "vetoed"
    assert veto["vetoed"] is True and veto["firing"] == ["latency_p99"]


def test_router_specs_equal_jax():
    assert [dataclasses.astuple(s) for s in slo.router_specs(
        availability=0.95, p99_ms=500.0)] == [
        dataclasses.astuple(s) for s in jslo.router_specs(
            availability=0.95, p99_ms=500.0)]


# ---------------------------------------------------------------------------
# shadow replay


def _shadow_both(tmp_path, demo, prob_a, prob_b, rev_a, rev_b):
    """Both packages' reports (each written to ``{pkg}_report.json``)."""
    reports = {}
    for pkg in PKGS:
        path, _ = _traffic(pkg, tmp_path / f"{pkg}.jsonl", demo, rev=rev_a)
        reports[pkg] = CONT[pkg].shadow_replay(
            path, _stub_engine(pkg, demo[0][pkg], prob=prob_a, rev=rev_a),
            _stub_engine(pkg, demo[0][pkg], prob=prob_b, rev=rev_b),
            clock=lambda: 1.0, out_path=tmp_path / f"{pkg}_report.json")
    mine, ref = reports["port"], dict(reports["jax"])
    assert mine["traffic_path"].endswith("port.jsonl")
    ref["traffic_path"] = mine["traffic_path"]
    assert mine == ref  # PSI, deltas and every bucket row
    return mine


def test_shadow_identical_revs_is_zero_diff(tmp_path, demo):
    report = _shadow_both(tmp_path, demo, 0.5, 0.5, "revA", "revA")
    out = tmp_path / "port_report.json"
    assert report["zero_diff"] is True and report["pass"] is True
    assert report["max_psi"] == 0.0 and report["max_abs_delta"] == 0.0
    assert report["n_replayed"] > 0 and report["buckets"]
    assert json.loads(out.read_text()) == report
    assert continual.shadow_gate(report) == jcont.shadow_gate(report) == (
        True, "shadow gate passed")


def test_shadow_distinct_revs_measures_the_diff(tmp_path, demo):
    report = _shadow_both(tmp_path, demo, 0.5, 0.9, "revA", "revB")
    assert report["zero_diff"] is False
    assert report["max_abs_delta"] == pytest.approx(0.4, abs=1e-6)
    assert report["max_psi"] > 0.25 and report["pass"] is False
    allow, reason = continual.shadow_gate(report)
    assert (allow, reason) == jcont.shadow_gate(report)
    assert allow is False and "max_psi" in reason


def test_shadow_empty_traffic_refuses(tmp_path, demo):
    for pkg in PKGS:
        a = _stub_engine(pkg, demo[0][pkg])
        with pytest.raises(ValueError, match="no scoreable traffic"):
            CONT[pkg].shadow_replay(tmp_path / "absent.jsonl", a, a)


def test_shadow_gate_fail_closed_on_missing_evidence():
    for bad in (None, {}, {"schema": 2, "pass": True}, {"schema": 1},
                {"schema": 1, "pass": False, "max_psi": 1.0,
                 "max_psi_gate": 0.25}):
        assert continual.shadow_gate(bad) == jcont.shadow_gate(bad)
        assert continual.shadow_gate(bad)[0] is False, bad
    assert continual.shadow_gate({"schema": 1, "pass": True})[0] is True


# ---------------------------------------------------------------------------
# retrain


def test_corpus_delta_only_misses_pay_extract(tmp_path):
    out = {}
    for pkg, cache in (("port", ExtractCache(tmp_path / "xc_port")),
                       ("jax", JExtractCache(tmp_path / "xc_jax"))):
        calls = []

        def extract(code):
            calls.append(code)
            if "poison" in code:
                raise RuntimeError("frontend crash")
            return {"n": len(code)}

        sources = {f"s{i}": f"int f{i}() {{ return {i}; }}" for i in range(4)}
        values, first = CONT[pkg].corpus_delta(sources, cache, extract)
        assert len(values) == 4 and len(calls) == 4
        calls.clear()
        sources["s4"] = "int f4() { return 4; }"
        sources["bad"] = "int poison() { return 0; }"
        values, second = CONT[pkg].corpus_delta(sources, cache, extract)
        assert "bad" not in values
        assert sorted(calls) == sorted([sources["s4"], sources["bad"]])
        out[pkg] = (first, second, len(cache))
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"total": 4, "hits": 0, "misses": 4,
                              "failures": 0, "delta_fraction": 1.0}
    assert out["port"][1]["hits"] == 4 and out["port"][1]["misses"] == 1
    assert out["port"][1]["failures"] == 1 and out["port"][2] == 5


def test_no_regression_gate_refuses_each_leg_as_jax(tmp_path):
    ok = {"schema": 1, "pass": True}
    base = {"val_f1": 0.80}
    cases = [
        (({"val_f1": 0.82}, base, ok), {"metric": "val_f1"}),
        (({"val_f1": 0.70}, base, ok), {"metric": "val_f1"}),
        (({"val_f1": 0.79}, base, ok), {"metric": "val_f1", "max_drop": 0.02}),
        (({}, base, ok), {"metric": "val_f1"}),
        (({"val_f1": 0.9}, None, ok), {"metric": "val_f1"}),
        (({"val_f1": 0.9}, base, None), {"metric": "val_f1"}),
        (({"val_loss": 0.3}, {"val_loss": 0.4}, ok),
         {"metric": "val_loss", "higher_is_better": False}),
        (({"val_f1": 0.9}, base, ok),
         {"metric": "val_f1", "ledger_paths": [REPO]}),
    ]
    # a ledger history with a 20 % regression
    for i, v in enumerate([100.0, 101.0, 99.0, 100.0, 120.0]):
        (tmp_path / f"BENCH_t{i:02d}.json").write_text(json.dumps(
            {"emitted_at_unix": 1000 + i, "device_kind": "cpu",
             "step_ms": v}))
    cases.append(((({"val_f1": 0.9}, base, ok)),
                  {"metric": "val_f1", "ledger_paths": [tmp_path]}))
    allows = []
    for args, kw in cases:
        mine = continual.no_regression_gate(*args, **kw)
        assert mine == jcont.no_regression_gate(*args, **kw), kw
        allows.append(mine["allow"])
    assert allows == [True, False, True, False, False, False, True, True,
                      False]
    bad = continual.no_regression_gate(*cases[-1][0], **cases[-1][1])
    assert bad["ledger_ok"] is False
    assert bad["reasons"] == ["perf ledger has a regression verdict"]


def test_run_retrain_journals_and_fails_closed(tmp_path):
    records = {}
    for pkg, cache in (("port", ExtractCache(tmp_path / "xc_port")),
                       ("jax", JExtractCache(tmp_path / "xc_jax"))):
        journal = _Journal()
        ok = {"schema": 1, "pass": True}
        good = CONT[pkg].run_retrain(
            None, tmp_path / "run", sources={"s0": "int f() { return 1; }"},
            cache=cache, extract=lambda code: {"n": len(code)},
            baseline_metrics={"val_f1": 0.8}, shadow_report=ok,
            fit_fn=lambda cfg, run_dir, resume: {"val_f1": 0.85,
                                                 "resume": resume},
            journal=journal, clock=lambda: 5.0)
        assert journal.events == [good]

        def broken_fit(cfg, run_dir, resume):
            raise RuntimeError("OOM")

        bad = CONT[pkg].run_retrain(
            None, tmp_path / "run", sources={"s0": "int f() { return 1; }"},
            cache=cache, extract=lambda code: {"n": len(code)},
            baseline_metrics={"val_f1": 0.8}, shadow_report=ok,
            fit_fn=broken_fit, journal=_Journal(fail=True),
            clock=lambda: 5.0)
        records[pkg] = (good, bad)
    assert records["port"] == records["jax"]
    good, bad = records["port"]
    assert good["promoted_candidate"] is True
    assert good["metrics"]["resume"] is True  # from the last commit
    assert good["delta"]["misses"] == 1 and bad["delta"]["hits"] == 1
    assert bad["promoted_candidate"] is False
    assert bad["gate"]["reasons"][0] == "fine-tune failed: RuntimeError: OOM"


def test_the_default_fit_is_the_ports():
    import inspect

    from deepdfa_tpu_torch.continual import retrain

    src = inspect.getsource(retrain._default_fit)
    assert "deepdfa_tpu_torch.train.fit" in src and "resume=resume" in src


# ---------------------------------------------------------------------------
# the promotion controller on fakes


class _Ring:
    """Fake router with rev book-keeping and a membership-size trace."""

    def __init__(self):
        self.states: dict[str, str] = {}
        self.revs: dict[str, str] = {}
        self.sizes: list[int] = []

    def add_backend(self, spec):
        self.states[str(spec)] = "ready"
        self.sizes.append(len(self.states))

    def remove_backend(self, name):
        ok = self.states.pop(name, None) is not None
        self.sizes.append(len(self.states))
        return ok

    def probe_once(self):
        return dict(self.states)


class _RevHandle:
    def __init__(self, name, cold=0):
        self.name = name
        self.join_cold_compiles = cold
        self.drained = False

    def drain(self):
        self.drained = True


class _RevLauncher:
    def __init__(self, ring, rev, base_port, cold=0):
        self.ring, self.rev, self.base, self.cold = ring, rev, base_port, cold
        self.count = 0
        self.handles: list[_RevHandle] = []

    def spawn(self):
        self.count += 1
        h = _RevHandle(f"127.0.0.1:{self.base + self.count}", self.cold)
        self.ring.revs[h.name] = self.rev
        self.handles.append(h)
        return h


class _Clock:
    """A virtual monotonic clock the fake sleep advances."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _controller(pkg, tmp_path, *, n_prior=2, vetoed=False, journal=None,
                flight=None, drift_probe=None, state_journal=None,
                wall_clock=lambda: 5000.0, alerts_clock=lambda: 5000.0):
    ring = _Ring()
    prior = _RevLauncher(ring, "revA", 9100)
    cand = _RevLauncher(ring, "revB", 9200)
    for _ in range(n_prior):
        ring.add_backend(prior.spawn().name)
    ring.sizes.clear()  # trace only the roll's own membership changes
    extra = [{"slo": "score_drift", "alert": True}] if vetoed else []
    alerts = SLO[pkg].write_alerts_artifact(
        tmp_path / f"{pkg}_alerts.json", [], extra_alerts=extra,
        clock=alerts_clock)
    clock = _Clock()
    pc = CONT[pkg].PromotionController(
        ring, cand, prior, candidate_rev="revB", prior_rev="revA",
        alerts_path=alerts, journal=journal, flight=flight,
        state_journal=state_journal, rev_probe=ring.revs.get,
        drift_probe=drift_probe or (lambda name: ""),
        drift_settle_polls=2, poll_interval_s=0.01, join_timeout_s=5.0,
        clock=clock, sleep=clock.sleep, wall_clock=wall_clock)
    for h in prior.handles:
        pc.adopt(h)
    return pc, ring, cand, prior


_OK_SHADOW = {"schema": 1, "pass": True}


def _both_controllers(tmp_path, run, **kw):
    """``run(pc)`` on each package's controller over its own fakes;
    returns {pkg: (summary, ring, cand, prior, journal, flight)}."""
    out = {}
    for pkg in PKGS:
        journal, flight = _Journal(), _Flight()
        pc, ring, cand, prior = _controller(pkg, tmp_path, journal=journal,
                                            flight=flight, **kw)
        out[pkg] = (run(pc, pkg), ring, cand, prior, journal, flight)
    mine, ref = out["port"][0], out["jax"][0]
    assert mine == ref  # decisions (times on the virtual clock), ring, counts
    assert out["port"][1].sizes == out["jax"][1].sizes
    assert [e["action"] for e in out["port"][4].events] == \
        [e["action"] for e in out["jax"][4].events]
    assert out["port"][5].events == out["jax"][5].events
    return out["port"]


def test_promote_rolls_replica_by_replica(tmp_path):
    out, ring, cand, prior, journal, flight = _both_controllers(
        tmp_path, lambda pc, pkg: pc.promote(_OK_SHADOW))
    assert out["completed"] is True and "rolled_back" not in out
    assert out["ring_by_rev"] == {"revB": sorted(h.name for h in cand.handles)}
    assert out["join_cold_compiles"] == 0 and out["rollback_total"] == 0
    assert min(ring.sizes) >= 2 and max(ring.sizes) == 3
    assert all(h.drained for h in prior.handles)
    actions = [d["action"] for d in out["decisions"]]
    assert actions == ["rollout_start", "warm_join", "drained",
                       "warm_join", "drained", "rolled", "drift_settled",
                       "complete"]
    assert [e["action"] for e in journal.events] == actions
    assert all(e["event"] == "promotion_transition" for e in journal.events)
    assert [k for k, _ in flight.events] == [f"promotion.{a}"
                                             for a in actions]


def test_vetoed_candidate_never_promoted(tmp_path):
    out, ring, cand, prior, _, _ = _both_controllers(
        tmp_path, lambda pc, pkg: pc.promote(_OK_SHADOW), vetoed=True)
    assert out.get("refused") is True and not out.get("completed")
    assert cand.count == 0 and ring.sizes == []
    assert out["ring_by_rev"] == {"revA": sorted(h.name for h in prior.handles)}
    refusal = out["decisions"][0]
    assert (refusal["action"], refusal["gate"], refusal["reason"]) == (
        "refused", "veto", "vetoed")


def test_missing_or_stale_alerts_refuse_the_roll(tmp_path):
    reasons = {}
    for pkg in PKGS:
        ring = _Ring()
        pc = CONT[pkg].PromotionController(
            ring, _RevLauncher(ring, "revB", 9200),
            _RevLauncher(ring, "revA", 9100), candidate_rev="revB",
            prior_rev="revA", alerts_path=tmp_path / "absent.json",
            rev_probe=ring.revs.get)
        out = pc.promote(_OK_SHADOW)
        assert out["refused"] is True
        reasons[pkg] = out["decisions"][0]["reason"]
    assert reasons == {"port": "missing", "jax": "missing"}
    out, _, cand, _, _, _ = _both_controllers(
        tmp_path, lambda pc, pkg: pc.promote(_OK_SHADOW),
        alerts_clock=lambda: 1000.0, wall_clock=lambda: 1000.0 + 7200.0)
    assert out["refused"] is True and cand.count == 0
    assert out["decisions"][0]["reason"] == "stale"


def test_failing_shadow_report_refuses(tmp_path):
    def run(pc, pkg):
        return [pc.promote(report) for report in
                (None, {}, {"schema": 1, "pass": False})]

    outs, ring, cand, _, _, _ = _both_controllers(tmp_path, run)
    for out in outs:
        assert out["refused"] is True
        assert out["decisions"][-1]["gate"] == "shadow"
    assert cand.count == 0 and ring.sizes == []


def test_injected_drift_rolls_back_to_prior_rev(tmp_path):
    def run(pc, pkg):
        fmod = faults if pkg == "port" else jfaults
        with fmod.installed("continual.rollback_trigger@1"):
            return pc.promote(_OK_SHADOW)

    out, ring, _, _, _, _ = _both_controllers(tmp_path, run)
    assert out["rolled_back"] is True and not out.get("completed")
    assert out["rollback_total"] == 1
    assert set(out["ring_by_rev"]) == {"revA"}
    assert len(out["ring_by_rev"]["revA"]) == 2
    assert out["join_cold_compiles"] == 0 and min(ring.sizes) >= 2
    alert = next(d for d in out["decisions"] if d["action"] == "drift_alert")
    assert alert["injected"] is True and alert["rev"] == "revB"
    assert "rollback_complete" in [d["action"] for d in out["decisions"]]


def test_real_drift_alert_sample_triggers_rollback(tmp_path):
    firing = ('deepdfa_serve_score_drift_alert{model_rev="revB@t1"} 1\n'
              'deepdfa_serve_score_drift{model_rev="revB@t1"} 0.41\n')
    out, _, _, _, _, _ = _both_controllers(
        tmp_path, lambda pc, pkg: pc.promote(_OK_SHADOW),
        drift_probe=lambda name: firing)
    assert out["rolled_back"] is True and out["rollback_total"] == 1
    assert set(out["ring_by_rev"]) == {"revA"}
    alert = next(d for d in out["decisions"] if d["action"] == "drift_alert")
    assert alert["rev"] == "revB" and "backend" in alert


def test_drift_alert_firing_parser():
    line = 'deepdfa_serve_score_drift_alert{model_rev="%s"} %s\n'
    cases = [(line % ("revB", "1"), True), (line % ("revB@t2", "1"), True),
             (line % ("revB", "0"), False), (line % ("revA@t1", "1"), False),
             (line % ("revBB", "1"), False), ("", False), (None, False)]
    for text, want in cases:
        assert continual.drift_alert_firing(text, "revB") is want
        assert jcont.drift_alert_firing(text, "revB") is want


def test_converge_rolls_back_from_crash_state(tmp_path):
    def run_rolling(pc, pkg):
        state = pc._state
        ring, cand = pc._router, pc._candidate_launcher
        ring.add_backend(cand.spawn().name)
        state.write(event="promotion_state", phase="rolling",
                    candidate_rev="revB", prior_rev="revA",
                    joined=[{"name": cand.handles[0].name, "pid": None}])
        return pc.converge()

    journals = {pkg: (RunJournal if pkg == "port" else JRunJournal)(
        tmp_path / f"{pkg}_state.json") for pkg in PKGS}
    outs = {}
    for pkg in PKGS:
        pc, ring, cand, _ = _controller(pkg, tmp_path, n_prior=1,
                                        state_journal=journals[pkg])
        outs[pkg] = (run_rolling(pc, pkg), ring.sizes)
    assert outs["port"] == outs["jax"]
    out, sizes = outs["port"]
    assert out["converged"] is True and out["rolled_back"] is True
    assert set(out["ring_by_rev"]) == {"revA"}
    assert out["join_cold_compiles"] == 0 and min(sizes) >= 2
    state = json.loads((tmp_path / "port_state.json").read_text())
    assert state["phase"] == "rolled_back"

    # a complete state: nothing to undo
    def run_complete(pc, pkg):
        pc._state.write(event="promotion_state", phase="complete",
                        candidate_rev="revB", prior_rev="revA", joined=[])
        return pc.converge()

    out, ring, cand, _, _, _ = _both_controllers(
        tmp_path, run_complete,
        state_journal=RunJournal(tmp_path / "complete_state.json"))
    assert out["completed"] is True and out["converged"] is True
    assert cand.count == 0 and ring.sizes == []


def test_stage_candidate_exports_through_warmup(tmp_path, demo):
    reports = {}
    for pkg, store in (("port", WarmStore(tmp_path / "warm_port")),
                       ("jax", JWarmStore(tmp_path / "warm_jax"))):
        eng = _stub_engine(pkg, demo[0][pkg], prob=0.5, rev="revB")
        reports[pkg] = CONT[pkg].stage_candidate(eng, store)
    assert reports["port"] == reports["jax"]
    report = reports["port"]
    assert report["model_rev"] == "revB" and report["buckets"] >= 1
    assert report["hits"] + report["misses"] == report["buckets"]


# ---------------------------------------------------------------------------
# kill -9 mid-rollout: the controller dies, a resumed one converges


_REV_STUB = r'''
import json, os, signal, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

REV = os.environ.get("STUB_REV", "revA")
draining = threading.Event()


class H(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, code, body, ctype="application/json"):
        data = (body if isinstance(body, str) else json.dumps(body)).encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/healthz":
            code = 503 if draining.is_set() else 200
            self._send(code, {"status": "draining" if draining.is_set()
                              else "ok", "draining": draining.is_set(),
                              "warm": True, "model_rev": REV,
                              "replica_id": "stub-" + REV})
        elif self.path == "/metrics":
            self._send(200, "stub_up 1\n", ctype="text/plain; version=0.0.4")
        else:
            self._send(404, {"error": "no route"})

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n)
        if draining.is_set():
            self._send(503, {"error": "draining"})
        else:
            self._send(200, {"results": [{"score": 0.5, "cached": False,
                                          "model_rev": REV}],
                             "bytes": len(raw)})


httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
httpd.daemon_threads = True


def _term(*_):
    draining.set()
    threading.Thread(target=httpd.shutdown, daemon=True).start()


signal.signal(signal.SIGTERM, _term)
print(json.dumps({"status": "serving", "host": "127.0.0.1",
                  "port": httpd.server_address[1],
                  "replica_id": "stub-" + REV,
                  "warm_store": {"buckets": 3, "hits": 3, "misses": 0,
                                 "compile_seconds_saved": 2.5}}),
      flush=True)
httpd.serve_forever()
'''


_CONTROLLER = r'''
"""A promotion controller of the port in a process of its own: rolls revB
through the router's admin surface; with DEEPDFA_FAULTS=continual.rollout_crash@1 it
hard-exits (137) between the first candidate's warm join and the prior
replica's retirement."""
import json
import os
import sys

from deepdfa_tpu_torch.continual.promote import PromotionController
from deepdfa_tpu_torch.resilience.journal import RunJournal
from deepdfa_tpu_torch.serve.autoscaler import (AdminRouterClient,
                                                SubprocessLauncher)

admin_port, stub, state_path, alerts_path = sys.argv[1:5]
client = AdminRouterClient("127.0.0.1", int(admin_port))
cand = SubprocessLauncher([sys.executable, stub],
                          env={**os.environ, "STUB_REV": "revB"},
                          startup_timeout_s=30.0)
prior = SubprocessLauncher([sys.executable, stub],
                           env={**os.environ, "STUB_REV": "revA"},
                           startup_timeout_s=30.0)
pc = PromotionController(client, cand, prior,
                         candidate_rev="revB", prior_rev="revA",
                         alerts_path=alerts_path,
                         state_journal=RunJournal(state_path),
                         drift_settle_polls=1, poll_interval_s=0.05,
                         join_timeout_s=30.0)
out = pc.promote({"schema": 1, "pass": True})
print(json.dumps({"completed": bool(out.get("completed"))}), flush=True)
'''


def _poll(pred, timeout=60.0):
    """Wait for ``pred()`` by polling state (bounded)."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached")
        threading.Event().wait(0.01)


def test_kill9_mid_rollout_converges_without_cold_compiles(tmp_path):
    from deepdfa_tpu_torch.continual.promote import PromotionController
    from deepdfa_tpu_torch.serve.autoscaler import SubprocessLauncher
    from deepdfa_tpu_torch.serve.router import FleetRouter

    stub = tmp_path / "rev_stub.py"
    stub.write_text(_REV_STUB)
    controller = tmp_path / "promotion_controller.py"
    controller.write_text(_CONTROLLER)
    state_path = tmp_path / "promotion_state.json"
    alerts = slo.write_alerts_artifact(tmp_path / "alerts.json", [])

    class _Recording(SubprocessLauncher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.handles = []

        def spawn(self):
            h = super().spawn()
            self.handles.append(h)
            return h

    prior_launcher = _Recording([sys.executable, str(stub)],
                                env={**os.environ, "STUB_REV": "revA"},
                                startup_timeout_s=30.0)
    cand_launcher = _Recording([sys.executable, str(stub)],
                               env={**os.environ, "STUB_REV": "revB"},
                               startup_timeout_s=30.0)
    router = FleetRouter([], port=0, probe_interval_s=0.1,
                         allow_empty=True).start(probe=True)
    for _ in range(2):
        router.add_backend(prior_launcher.spawn().name)

    errors = []
    stop = threading.Event()

    def load():
        import http.client

        i = 0
        while not stop.is_set():
            i += 1
            try:
                conn = http.client.HTTPConnection("127.0.0.1", router.port,
                                                  timeout=10)
                conn.request("POST", "/score",
                             json.dumps({"source": f"int f{i}();"}),
                             headers={"Content-Type": "application/json"})
                code = conn.getresponse().status
                conn.close()
                if code != 200:
                    errors.append(code)
            except OSError:
                errors.append("conn")  # the router itself must stay up
            stop.wait(0.01)

    def served():
        return router.metrics.snapshot()["requests_total"]

    env = {**os.environ}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["DEEPDFA_FAULTS"] = "continual.rollout_crash@1"
    workers = [threading.Thread(target=load, daemon=True) for _ in range(2)]
    orphan_pids = []
    try:
        for w in workers:
            w.start()
        _poll(lambda: served() >= 20)  # load flows through both replicas
        proc = subprocess.run(
            [sys.executable, str(controller), str(router.port), str(stub),
             str(state_path), str(alerts)],
            env=env, cwd=str(REPO), capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 137, (proc.returncode, proc.stderr)
        state = RunJournal(state_path).read()
        assert state["phase"] == "rolling"
        orphan_pids = [row["pid"] for row in state["joined"] if row["pid"]]
        assert len(orphan_pids) == 1
        n = served()
        _poll(lambda: served() >= n + 20)  # the mixed-rev window serves

        resumed = PromotionController(
            router, cand_launcher, prior_launcher,
            candidate_rev="revB", prior_rev="revA", alerts_path=alerts,
            state_journal=RunJournal(state_path),
            drift_settle_polls=1, poll_interval_s=0.05, join_timeout_s=30.0)
        out = resumed.converge()
        n = served()
        _poll(lambda: served() >= n + 20)  # after convergence
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=30)
        rsnap = router.shutdown()
        for h in prior_launcher.handles + cand_launcher.handles:
            h.kill()
            h.wait(timeout=30)
        for pid in orphan_pids:
            try:
                os.kill(int(pid), 9)
            except OSError:
                pass  # already gone after the rollback's SIGTERM

    assert not any(w.is_alive() for w in workers)
    assert out["converged"] is True and out["rolled_back"] is True
    assert out["join_cold_compiles"] == 0
    by_rev = out["ring_by_rev"]
    assert set(by_rev) == {"revA"} and len(by_rev["revA"]) >= 2
    assert errors == [], errors[:10]
    assert rsnap["no_backend_total"] == 0
    assert RunJournal(state_path).read()["phase"] == "rolled_back"
